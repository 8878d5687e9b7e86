"""Dynamic batching: coalesce concurrent requests into padded bucket batches.

- One :class:`DynamicBatcher` per model, living on the server's asyncio loop.
- ``submit`` enqueues (sample, future); the loop takes the head request, then
  admits more until the model's largest bucket is full or ``coalesce_ms``
  elapses.
- The batch goes to the :class:`DeviceRunner`'s single dispatch thread; the
  results resolve each request's future.
- Backpressure: at most ``max_concurrency`` requests in flight; beyond that
  ``submit`` raises :class:`Overloaded` → HTTP 429 with Retry-After.
- Resilience: a request may carry an absolute loop-clock deadline; one
  already expired when the loop pops it is shed with
  :class:`~.resilience.DeadlineExceeded` (504), counted, and never reaches
  the device.  Transient dispatch failures retry with capped, jittered
  backoff, never past the survivors' deadlines, and every outcome feeds the
  model's circuit breaker with its fatal flag.  :meth:`estimate_wait_ms`
  forecasts the queue wait (depth × recent p50 device time) for the
  server's admission-time shedder.
- Tracing: a request may carry its trace's root span; at dispatch the loop
  closes its ``queue`` span (enqueue → dispatch), records the head's
  ``batch_form`` (head in hand → dispatch; also into the perf plane's
  per-model histogram) and opens a ``device`` span a
  member (the batch size and co-batched trace ids), under which the runner
  puts the dispatch thread's ``exec`` span.  Stage times are the
  ``perf_counter`` stamps the rings record.  A shed request's trace ends in
  an errored ``queue`` span and a ``deadline_exceeded`` point: it launches
  nothing.

All batcher state is touched only from the event loop; the one cross-thread
edge is the runner, which returns through ``await``.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, field
from typing import Any

from ..config import ModelConfig
from ..engine.compiled import CompiledModel
from ..engine.runner import DeviceRunner
from ..faults import is_transient
from ..utils.logging import get_logger, log_event
from .metrics import LatencyRing
from .resilience import DeadlineExceeded, ModelResilience

log = get_logger("serving.batcher")


class Overloaded(Exception):
    """More than max_concurrency requests in flight for this model; carries
    the backlog ``depth`` and ``retry_after_s`` for the 429."""

    def __init__(self, msg: str, depth: int = 0, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.depth = depth
        self.retry_after_s = retry_after_s


@dataclass
class _Req:
    sample: dict[str, Any]
    seq_len: int | None
    fut: asyncio.Future
    t_enq: float = field(default_factory=time.perf_counter)
    # Absolute loop-clock deadline (None: none), checked when the loop pops
    # the request and before every (re)dispatch.
    deadline: float | None = None
    # The request's root span (serving/tracing.py), None when untraced.
    span: Any = None


class DynamicBatcher:
    def __init__(self, model: CompiledModel, runner: DeviceRunner, cfg: ModelConfig,
                 ring: LatencyRing | None = None,
                 resilience: ModelResilience | None = None, perf=None):
        self.model = model
        self.runner = runner
        self.coalesce_s = cfg.coalesce_ms / 1000.0
        self.max_concurrency = cfg.max_concurrency
        self.ring = ring or LatencyRing()
        # The perf plane (serving/perfplane.py): the batch_form stage (head
        # in hand → dispatch, the coalescing window paid) per model.
        self.perf = perf
        # The server's per-model handle (retry policy, breaker, counters);
        # an inert one (no retry, no breaker) when built without a server.
        self.resilience = resilience or ModelResilience(name=cfg.name)
        self._queue: asyncio.Queue[_Req] = asyncio.Queue()
        # Multi-tenant co-batch evidence: ``adapter_hook`` (wired by the
        # server) hands each dispatch's adapters to the AdapterManager, which
        # counts the dispatches that mixed more than one into one program.
        self.adapter_hook = None        # guarded-by: event-loop
        # A request deferred from the previous round because its seq length
        # would have dragged the batch into a larger seq bucket.
        self._carry: _Req | None = None  # guarded-by: event-loop
        self._in_flight = 0              # guarded-by: event-loop
        self._stopped = False            # guarded-by: event-loop
        self._task: asyncio.Task | None = None  # guarded-by: event-loop

    def start(self):
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._loop(), name=f"batcher-{self.model.servable.name}")
        return self

    async def stop(self):
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        pending = [self._carry] if self._carry is not None else []
        self._carry = None
        while not self._queue.empty():
            pending.append(self._queue.get_nowait())
        for req in pending:
            if not req.fut.done():
                req.fut.set_exception(RuntimeError("batcher stopped"))
            self.ring.record_error()

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def check_capacity(self, n: int = 1) -> None:
        """Raise :class:`Overloaded` unless n more submits would be admitted."""
        if self._stopped:
            self.ring.record_error()
            raise Overloaded(f"{self.model.servable.name}: batcher stopped; retry",
                             depth=self._in_flight, retry_after_s=1.0)
        if self._in_flight + n > self.max_concurrency:
            self.ring.record_error()
            raise Overloaded(
                f"{self.model.servable.name}: {self._in_flight} in flight + {n} "
                f"requested > max {self.max_concurrency}",
                depth=self._in_flight,
                retry_after_s=max(self.estimate_wait_ms() / 1000.0, 1.0))

    def estimate_wait_ms(self, n: int = 1) -> float:
        """Queue-wait forecast: batches ahead × recent p50 device time (0.0
        before any request has completed)."""
        p50 = self.ring.device_p50()
        if p50 is None:
            return 0.0
        depth = self._queue.qsize() + (1 if self._carry is not None else 0) + n
        batches_ahead = math.ceil(depth / max(self.model.max_batch, 1))
        running = 1 if self._in_flight > self._queue.qsize() else 0
        return (batches_ahead + running) * p50

    def _dec_in_flight(self, _fut) -> None:
        self._in_flight -= 1

    def _enqueue(self, sample: dict[str, Any], seq_len: int | None,
                 deadline: float | None = None, span=None):
        """Admit + enqueue; the in-flight slot is held until the future
        settles, however it settles (result, failure, shed or stop)."""
        self.check_capacity(1)
        fut = asyncio.get_running_loop().create_future()
        self._in_flight += 1
        fut.add_done_callback(self._dec_in_flight)
        self._queue.put_nowait(_Req(sample, seq_len, fut, deadline=deadline, span=span))
        return fut

    async def submit(self, sample: dict[str, Any], seq_len: int | None = None,
                     deadline: float | None = None, span=None) -> Any:
        """Queue one preprocessed sample; resolves to (result, timing), the
        timing with ``t_done``, the device's end as a ``perf_counter``
        stamp."""
        return await self._enqueue(sample, seq_len, deadline, span)

    def submit_many(self, samples, seq_lens, deadline: float | None = None,
                    span=None) -> list:
        """Atomically admit + enqueue the samples of ONE request (all or
        none: no await between the check and the enqueues); ``span`` parents
        every sample's queue and device spans."""
        self.check_capacity(len(samples))
        return [self._enqueue(s, sl, deadline, span) for s, sl in zip(samples, seq_lens)]

    def _seq_cap(self, head: _Req) -> int | None:
        """Seq-bucket ceiling the head request sets for this batch: longer
        requests wait for the next batch instead of dragging every short one
        into a bigger bucket."""
        if self.model.servable.bucket_axes != ("batch", "seq") or head.seq_len is None:
            return None
        try:
            bucket = self.model.bucket_for(1, head.seq_len)
        except ValueError:
            return None  # oversize: _dispatch raises through the futures
        return bucket[1] if len(bucket) > 1 else None

    def _admit(self, batch, req: _Req, seq_cap) -> bool:
        if seq_cap is not None and req.seq_len is not None and req.seq_len > seq_cap:
            self._carry = req
            return False
        batch.append(req)
        return True

    async def _loop(self):
        while True:
            if self._carry is not None:
                batch, self._carry = [self._carry], None
            else:
                batch = [await self._queue.get()]
            try:
                # Batch formation starts with the head in hand.
                t_form0 = time.perf_counter()
                seq_cap = self._seq_cap(batch[0])
                loop = asyncio.get_running_loop()
                deadline = loop.time() + self.coalesce_s
                max_batch = self.model.max_batch
                while len(batch) < max_batch:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        # Window closed: take whatever is already queued.
                        while len(batch) < max_batch and not self._queue.empty():
                            if not self._admit(batch, self._queue.get_nowait(), seq_cap):
                                break
                        break
                    try:
                        req = await asyncio.wait_for(self._queue.get(), remaining)
                    except (asyncio.TimeoutError, TimeoutError):
                        break
                    if not self._admit(batch, req, seq_cap):
                        break
                await self._dispatch(batch, t_form0)
            except asyncio.CancelledError:
                self._fail_batch(batch, RuntimeError("batcher stopped"))
                raise

    def _fail_batch(self, batch: list[_Req], exc: Exception):
        for req in batch:
            if not req.fut.done():
                req.fut.set_exception(exc)
                self.ring.record_error()

    def _shed_expired(self, batch: list[_Req], now: float) -> list[_Req]:
        """Resolve the expired members with 504 and return the survivors:
        work whose client has given up is never sent to the device."""
        live = []
        for req in batch:
            if req.deadline is None or now < req.deadline:
                live.append(req)
            elif not req.fut.done():
                # A future already done was 504'd (and counted) by the
                # server's await bound.
                req.fut.set_exception(DeadlineExceeded(
                    f"{self.model.servable.name}: deadline passed "
                    f"{(now - req.deadline) * 1000.0:.1f} ms before dispatch", stage="queue"))
                self.ring.record_error()
                self.resilience.stats.deadline_queue += 1
                if req.span is not None:
                    # Its whole story is the queue: an errored queue span,
                    # the decision, and no device time after.
                    req.span.child("queue", start=req.t_enq).end(status="error", stage="queue",
                                                                 shed=True)
                    req.span.point("deadline_exceeded", stage="queue")
        return live

    @staticmethod
    def _open_device_spans(batch: list[_Req], t_start: float, attempt: int) -> list:
        """At dispatch: each member's queue span closes (on the first
        attempt: the wait is spent once) and a device span opens (on every
        attempt, so retries show as repeated device stages), naming the
        co-batched requests' traces."""
        spans = []
        for req in batch:
            if req.span is None:
                spans.append(None)
                continue
            if attempt == 0:
                req.span.child("queue", start=req.t_enq).end(end=t_start)
            mates = [r.span.trace.trace_id for r in batch
                     if r is not req and r.span is not None][:8]
            spans.append(req.span.child("device", start=t_start, batch_size=len(batch),
                                        attempt=attempt + 1,
                                        **({"batch_mates": mates} if mates else {})))
        return spans

    async def _dispatch(self, batch: list[_Req], t_form0: float | None = None):
        loop = asyncio.get_running_loop()
        mr = self.resilience
        attempt = 0
        while True:
            # Before EVERY attempt: members expired in the queue, or during a
            # retry's backoff, are shed before any device time is spent.
            batch = self._shed_expired(batch, loop.time())
            if not batch:
                return
            samples = [req.sample for req in batch]
            seq = None
            if self.model.servable.bucket_axes == ("batch", "seq"):
                lens = [req.seq_len for req in batch if req.seq_len is not None]
                seq = max(lens) if lens else None
            t_start = time.perf_counter()
            dev_spans = self._open_device_spans(batch, t_start, attempt)
            head_span = next((sp for sp in dev_spans if sp is not None), None)
            if attempt == 0 and t_form0 is not None:
                if self.perf is not None:
                    self.perf.note_stage(self.model.servable.name, "batch_form",
                                         (t_start - t_form0) * 1000.0)
                if batch[0].span is not None:
                    batch[0].span.child("batch_form", start=t_form0,
                                        batch_size=len(batch)).end(end=t_start)
            if attempt == 0:
                adapters = {req.sample.get("_adapter") for req in batch
                            if isinstance(req.sample, dict)} - {None}
                if adapters:
                    # The rows of this one dispatch gather different tenants'
                    # factors by slot: the evidence that multiplexing
                    # happened, on the head span and the manager's counter.
                    if head_span is not None:
                        head_span.annotate(adapters=sorted(adapters))
                    if self.adapter_hook is not None:
                        self.adapter_hook(adapters)
            try:
                results = await self.runner.run(self.model, samples, seq=seq, span=head_span)
            except Exception as e:
                err = f"{type(e).__name__}: {e}"
                for sp in dev_spans:
                    if sp is not None:
                        sp.end(status="error", error=err)
                # The outcome and its fatal flag: a breaker open on a fatal
                # cause is the watchdog's rebuild signal.
                mr.note_outcome(False, fatal=not is_transient(e))
                delay_ms = mr.retry.backoff_ms(attempt)
                # Retry only a transient fault, within the budget, and while
                # at least one member's deadline outlives the backoff.
                horizon = loop.time() + delay_ms / 1000.0
                survivors = any(req.deadline is None or req.deadline > horizon
                                for req in batch)
                if is_transient(e) and attempt < mr.retry.max_attempts and survivors:
                    mr.stats.retries += 1
                    attempt += 1
                    for req in batch:
                        if req.span is not None:
                            req.span.point("retry", attempt=attempt, delay_ms=round(delay_ms, 1),
                                           error=err)
                    log_event(log, "transient batch retry", model=self.model.servable.name,
                              attempt=attempt, delay_ms=round(delay_ms, 1), error=err,
                              **({"trace_id": batch[0].span.trace.trace_id}
                                 if batch[0].span is not None else {}))
                    await asyncio.sleep(delay_ms / 1000.0)
                    continue
                log.exception("batch failed for %s", self.model.servable.name)
                self._fail_batch(batch, e)
                return
            mr.note_outcome(True)
            if attempt:
                mr.stats.retry_successes += 1
            t_end = time.perf_counter()
            device_ms = (t_end - t_start) * 1000
            for sp in dev_spans:
                if sp is not None:
                    sp.end(end=t_end)
            for req, res in zip(batch, results):
                queue_ms = (t_start - req.t_enq) * 1000
                total_ms = (t_end - req.t_enq) * 1000
                self.ring.record(queue_ms, device_ms, total_ms,
                                 trace_id=req.span.trace.trace_id if req.span is not None else None)
                if not req.fut.done():
                    req.fut.set_result((res, {"queue_ms": round(queue_ms, 3),
                                              "device_ms": round(device_ms, 3),
                                              "total_ms": round(total_ms, 3),
                                              "batch_size": len(batch),
                                              "t_done": t_end}))
            return
