"""Device runner: the single dispatch lane to the device, with two QoS levels.

All device work goes through ONE dispatch thread: the server's asyncio loop
never touches a CUDA tensor, and CUDA work is issued from one thread in the
order the lane pops it.  The lane is a two-level priority queue: every
dispatch carries its model's latency class, and a queued "latency" dispatch
always pops before queued "throughput" work.  Device calls are not
interruptible, so priority acts between them.

The runner also carries the chaos surface (``faults.FaultInjector``): every
batch and chunk dispatch passes its hook on the dispatch thread first, and
``poison`` wedges the runner (every dispatch raises, the probe reports
dead) until a rebuild replaces it.

A traced dispatch (``span``, the batcher's device span) records an ``exec``
span on the dispatch thread around the replay and its synchronize, with
the lane and the wait for it; a chunked one a span a slice
(``chunk_prepare``, ``chunk[i]``, ``chunk_finalize``).  A fault the hook
injects lands in the span as its error.
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from ..faults import FaultInjector
from ..utils.logging import get_logger
from .compiled import CompiledModel

log = get_logger("engine.runner")

LANE_LATENCY = "latency"
LANE_THROUGHPUT = "throughput"
LANES = (LANE_LATENCY, LANE_THROUGHPUT)


class _DaemonDispatchPool:
    """Single DAEMON dispatch thread over a two-level priority queue.

    A daemon thread, not a ThreadPoolExecutor (whose workers the interpreter
    joins at exit), so a dispatch wedged inside a device call cannot hang
    process shutdown.  ``submit``/``submit_lane`` return
    ``concurrent.futures.Future``, for ``asyncio.wrap_future`` and blocking
    callers alike; ``submit`` routes to the latency lane.  With priority off
    the pop order is strict FIFO across lanes.
    """

    def __init__(self, thread_name: str = "cuda-dispatch"):
        # One Condition guards the lanes, the stats and the down flag; the
        # dispatch thread holds it only to pop, never across a device call.
        self._cv = threading.Condition()
        self._lanes: dict[str, deque] = {lane: deque() for lane in LANES}  # guarded-by: _cv
        self._seq = itertools.count()  # guarded-by: _cv
        self._down = False  # guarded-by: _cv
        self._priority = True  # guarded-by: _cv
        self._stats = {lane: {"dispatches": 0, "wait_ms_total": 0.0,
                              "wait_ms_max": 0.0} for lane in LANES}  # guarded-by: _cv
        self._thread = threading.Thread(target=self._loop, name=thread_name,
                                        daemon=True)
        self._thread.start()

    def submit(self, fn, *args, **kwargs) -> Future:
        return self.submit_lane(LANE_LATENCY, fn, *args, **kwargs)

    def submit_lane(self, lane: str, fn, *args, **kwargs) -> Future:
        with self._cv:
            if self._down:
                raise RuntimeError("dispatch pool is shut down")
            f: Future = Future()
            self._lanes[lane].append(
                (next(self._seq), time.perf_counter(), f, fn, args, kwargs))
            self._cv.notify()
            return f

    def set_priority(self, enabled: bool) -> None:
        with self._cv:
            self._priority = bool(enabled)

    @property
    def priority_enabled(self) -> bool:
        with self._cv:
            return self._priority

    def _pop(self):
        """Next (lane, item) under the cv lock; caller guarantees non-empty."""
        hi, lo = self._lanes[LANE_LATENCY], self._lanes[LANE_THROUGHPUT]
        if self._priority or not (hi and lo):
            lane = LANE_LATENCY if hi else LANE_THROUGHPUT
        else:
            lane = LANE_LATENCY if hi[0][0] < lo[0][0] else LANE_THROUGHPUT
        return lane, self._lanes[lane].popleft()

    def _loop(self):
        while True:
            with self._cv:
                while not any(self._lanes.values()) and not self._down:
                    self._cv.wait()
                if not any(self._lanes.values()):
                    return  # down and drained
                lane, (_, t_enq, f, fn, args, kwargs) = self._pop()
                st = self._stats[lane]
                wait_ms = (time.perf_counter() - t_enq) * 1000.0
                st["dispatches"] += 1
                st["wait_ms_total"] += wait_ms
                st["wait_ms_max"] = max(st["wait_ms_max"], wait_ms)
            if not f.set_running_or_notify_cancel():
                continue
            try:
                f.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — the future carries it
                f.set_exception(e)

    def stats_snapshot(self) -> dict[str, dict]:
        """Per-lane depth + dispatch/wait counters (the /metrics numbers)."""
        with self._cv:
            return {lane: {"depth": len(self._lanes[lane]),
                           **{k: round(v, 3) if isinstance(v, float) else v
                              for k, v in self._stats[lane].items()}}
                    for lane in LANES}

    def shutdown(self, cancel_futures: bool = False):
        """Stop taking work and wait (up to 120 s) for the dispatch thread to
        finish what it runs: a process that exits while that thread is
        still inside the framework can abort in its teardown."""
        with self._cv:
            first = not self._down
            self._down = True
            if first and cancel_futures:
                for q in self._lanes.values():
                    while q:
                        q.popleft()[2].cancel()
            self._cv.notify_all()
        if threading.current_thread() is not self._thread:
            self._thread.join(120.0)


@dataclass
class RunStats:
    batches: int = 0
    samples: int = 0
    padded_samples: int = 0
    device_seconds: float = 0.0
    # Chunked dispatches (run_chunked): how many preemption-point slices the
    # model's batches were served in.
    chunks: int = 0
    by_bucket: dict = field(default_factory=dict)


class DeviceRunner:
    """Owns the dispatch thread; exposes an awaitable batch-run API."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._pool = _DaemonDispatchPool()
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        # Chaos surface: per-model injection rules and the poison latch,
        # consulted at the head of every dispatch.
        self.faults = FaultInjector()
        self.stats: dict[str, RunStats] = {}  # guarded-by: _lock
        # Device bytes per resident model (its weights plus its CUDA graph
        # pools), and per :generate KV pool ("<model>:kvcache"): the ledger
        # the lifecycle's HBM budget reads.
        self._resident: dict[str, int] = {}  # guarded-by: _lock
        # The shared probe: concurrent /healthz calls during a wedge share
        # one no-op on the dispatch thread and one timeout, and a verdict is
        # kept for a few seconds.
        self._probe_lock = threading.Lock()
        self._probe_future: Future | None = None  # guarded-by: _probe_lock
        self._probe_verdict = True  # guarded-by: _probe_lock
        self._probe_deadline = 0.0  # guarded-by: _probe_lock
        # No-ops the probe has submitted (one per shared probe).
        self.probe_dispatches = 0  # guarded-by: _probe_lock

    def poison(self, exc: Exception | None):
        """Wedge the runner: while set, every dispatch raises ``exc`` and
        the probe reports dead, a fatal device fault for the 5xx path, the
        health flip and the watchdog's rebuild.  ``None`` clears it.  Flaky
        faults (transient, every Nth, latency) are :attr:`faults` rules and
        leave the probe green."""
        self.faults.poison_exc = exc

    def _count_batch(self, name: str, n: int, bucket: tuple[int, ...]):
        with self._lock:
            st = self.stats.setdefault(name, RunStats())
            st.batches += 1
            st.samples += n
            st.padded_samples += bucket[0] - n
            bk = st.by_bucket.setdefault(str(bucket), {"batches": 0, "samples": 0,
                                                       "rows": 0})
            bk["batches"] += 1
            bk["samples"] += n
            bk["rows"] += bucket[0]

    def _add_device_seconds(self, name: str, seconds: float, chunk: bool = False):
        with self._lock:
            st = self.stats.setdefault(name, RunStats())
            st.device_seconds += seconds
            st.chunks += int(chunk)

    def _run(self, model: CompiledModel, samples: Sequence[dict], seq: int | None, span=None):
        # On the dispatch thread: injected latency occupies the lane as a
        # slow replay would, and a failed dispatch runs nothing.
        t_exec = time.perf_counter()
        tspan = None
        if span is not None:
            # Opened before the fault hook, so that injected latency and
            # faults land inside it; the gap back to the parent's start is
            # the wait for the lane.
            tspan = span.child("exec", lane=model.latency_class, batch=len(samples),
                               lane_wait_ms=round((t_exec - span.t0) * 1000, 3),
                               **({"seq": seq} if seq is not None else {}))
        try:
            self.faults.on_dispatch(model.servable.name)
            t0 = time.perf_counter()
            results, bucket = model.run_batch(samples, seq=seq)
        except BaseException as e:
            if tspan is not None:
                tspan.end(status="error", error=f"{type(e).__name__}: {e}")
            raise
        dt = time.perf_counter() - t0
        if tspan is not None:
            tspan.end(bucket=list(bucket))
        self._add_device_seconds(model.servable.name, dt)
        self._count_batch(model.servable.name, len(samples), bucket)
        return results

    async def run(self, model: CompiledModel, samples: Sequence[dict],
                  seq: int | None = None, span=None) -> list[Any]:
        return await asyncio.wrap_future(self._pool.submit_lane(
            model.latency_class, self._run, model, samples, seq, span))

    async def run_chunked(self, model: CompiledModel, samples: Sequence[dict],
                          seq: int | None = None, span=None) -> list[Any]:
        """Run a chunked servable as short dispatches (QoS preemption points).

        A servable with ``meta['chunked']`` (models/sd15.py) runs prepare →
        K chunk steps → finalize, each slice its own dispatch on the model's
        lane, synchronised on the dispatch thread so its occupancy is real,
        with the lane released between slices: a queued latency dispatch
        runs after at most one chunk instead of the whole program.  The
        state stays on the device between chunks.  A model without the
        contract runs as one :meth:`run`.
        """
        ch = model.servable.meta.get("chunked")
        if ch is None:
            return await self.run(model, samples, seq, span=span)
        name = model.servable.name
        lane = model.latency_class

        def timed(fn, *args, chunk=False, label=""):
            # A span a slice: a latency request stuck behind ONE chunk shows
            # apart from one stuck behind the whole loop.
            tspan = span.child(label, lane=lane) if span is not None else None
            try:
                self.faults.on_dispatch(name)
                t0 = time.perf_counter()
                out = fn(*args)
            except BaseException as e:
                if tspan is not None:
                    tspan.end(status="error", error=f"{type(e).__name__}: {e}")
                raise
            self._add_device_seconds(name, time.perf_counter() - t0, chunk)
            if tspan is not None:
                tspan.end()
            return out

        async def dispatch(fn, *args, chunk=False, label=""):
            if self.faults.poison_exc is not None:
                raise self.faults.poison_exc
            return await asyncio.wrap_future(self._pool.submit_lane(
                lane, timed, fn, *args, chunk=chunk, label=label))

        bucket, state = await dispatch(model.chunk_prepare, samples, label="chunk_prepare")
        for i, rows in enumerate(ch["chunk_rows"]):
            state = await dispatch(model.chunk_step, state, rows, chunk=True, label=f"chunk[{i}]")
        results = await dispatch(model.chunk_finalize, state, samples, label="chunk_finalize")
        self._count_batch(name, len(samples), bucket)
        return results

    def run_sync(self, model: CompiledModel, samples: Sequence[dict],
                 seq: int | None = None) -> list[Any]:
        return self._pool.submit_lane(model.latency_class, self._run,
                                      model, samples, seq).result()

    async def run_fn(self, fn, *args, model: str | None = None):
        """Run ``fn(*args)`` on the dispatch thread and await its result.

        The ``:generate`` lanes' prefills, inserts and segments go through
        here, so all device work stays serialized on the one thread.  It
        runs on the latency lane, since streaming decode is interactive
        work, and it leaves ``RunStats`` alone: device seconds count batch
        and chunk dispatches only.  It honours the poison latch and, with
        ``model`` named, the latency half of a matching dispatch rule (a
        slow device is slow for streams too); failure rules stay off this
        path, where a mid-stream generation has no retry.
        """
        if self.faults.poison_exc is not None:
            raise self.faults.poison_exc
        delay_s = self.faults.dispatch_latency_s(model) if model is not None else 0.0
        if delay_s:
            # Sleep on the dispatch thread, occupying the lane.
            run = fn

            def fn(*a, _run=run, _delay=delay_s):  # noqa: F811
                time.sleep(_delay)
                return _run(*a)
        return await asyncio.wrap_future(self._pool.submit_lane(LANE_LATENCY, fn, *args))

    def run_fn_sync(self, fn, *args, **kwargs):
        """Run ``fn`` on the dispatch thread (latency lane), blocking the
        caller: device work outside a batch (model build, warmup) still
        goes through the one thread that owns the device."""
        return self._pool.submit(fn, *args, **kwargs).result()

    # -- residency accounting -------------------------------------------------
    def track_model(self, name: str, nbytes: int) -> None:
        """Record ``name`` as device-resident with ``nbytes``: a model's
        ``CompiledModel.resident_nbytes()`` (weights plus graph pools, read
        from the caching allocator), or a KV pool's bytes."""
        with self._lock:
            self._resident[name] = int(nbytes)

    def untrack_model(self, name: str) -> None:
        with self._lock:
            self._resident.pop(name, None)

    def resident_bytes(self) -> dict[str, int]:
        with self._lock:
            return dict(self._resident)

    # -- QoS surface ----------------------------------------------------------
    def set_priority(self, enabled: bool) -> None:
        self._pool.set_priority(enabled)

    @property
    def priority_enabled(self) -> bool:
        return self._pool.priority_enabled

    def lane_stats(self) -> dict[str, dict]:
        """Per-class queue depth + dispatch/wait stats for /metrics."""
        out = self._pool.stats_snapshot()
        for st in out.values():
            n = st["dispatches"]
            st["wait_ms_mean"] = round(st["wait_ms_total"] / n, 3) if n else 0.0
        return out

    def _device_check(self) -> bool:
        x = torch.ones(8, device=self.device) * 2
        return bool(x.sum().item() == 16.0)

    def probe(self, timeout_s: float = 300.0, cache_s: float = 5.0) -> bool:
        """Device liveness for /healthz: a tiny op on the dispatch thread (the
        one thread that touches the device), answered within ``timeout_s``.
        A poisoned runner is dead with no dispatch.

        Shared: one no-op is in flight at a time, so concurrent callers
        during a wedge wait on the same future and the same timeout, and a
        verdict stands for ``cache_s``.  A timed-out future is kept: it
        resolves once the lane clears, which makes the next probe quick and
        truthful.
        """
        with self._lock:
            if self._closed:
                return False
        if self.faults.poison_exc is not None:
            return False
        with self._probe_lock:
            if time.monotonic() < self._probe_deadline:
                return self._probe_verdict
            fut = self._probe_future
            if fut is None or fut.done():
                try:
                    fut = self._pool.submit(self._device_check)
                except RuntimeError:  # the pool is shut down
                    return False
                self._probe_future = fut
                self.probe_dispatches += 1
        try:
            verdict = bool(fut.result(timeout=timeout_s))
        except FuturesTimeout:
            log.error("dispatch thread unresponsive for %.0f s", timeout_s)
            verdict = False
        except Exception as e:
            log.error("device probe failed: %s: %s", type(e).__name__, e)
            verdict = False
        with self._probe_lock:
            self._probe_verdict = verdict
            self._probe_deadline = time.monotonic() + cache_s
            # Clear only this future: a racing caller may have installed
            # another after it resolved.
            if self._probe_future is fut and fut.done():
                self._probe_future = None
        return verdict

    def quiesce(self, timeout_s: float) -> bool:
        """Wait until everything queued on the dispatch thread has run: a
        no-op through the lane, answered within ``timeout_s``.  False when
        the thread is wedged or shut down."""
        try:
            self._pool.submit(lambda: None).result(timeout=timeout_s)
        except (FuturesTimeout, RuntimeError):
            return False
        return True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def shutdown(self):
        """Stop the dispatch pool (idempotent); queued work is cancelled."""
        with self._lock:
            self._closed = True
        self._pool.shutdown(cancel_futures=True)
