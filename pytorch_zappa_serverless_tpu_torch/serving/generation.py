"""Continuous batching and token streaming for the generative models.

The port of the JAX package's ``serving/generation.py`` (single host; no
lockstep).  The fixed-batch lane
(``:predict``) runs one whole ``generate`` call a batch: nothing streams
until it ends, and a batch's members are fixed at admission.  These lanes
serve ``:generate`` instead, with every device program at static shapes
(``engine/genkernels.py``):

- :class:`GenerationScheduler`, the slot pool: ``slots`` decode rows over one
  KV pool ``[L, S, total, D]`` on the device, advanced ``segment_tokens``
  steps a segment.  Between segments (host control, no new program) the
  emitted tokens stream to clients, rows that reach EOS or their budget
  retire, and queued requests admit into free slots: same-bucket admissions
  share one prefill, and an insert copies each row into its slot.
- :class:`PagedGenerationScheduler`, the paged pool: sequences hold pages
  (``serving/kvcache.py``) for the tokens they have; prompts prefill in
  bounded chunks interleaved with decode segments, a prompt's whole pages
  freeze into the radix prefix cache (``serving/prefixcache.py``) for later
  prompts to share.  Under pool pressure the newest stream's pages move to
  host memory and it resumes from them when pages free (``kv_migrate``, on
  by default); only when that is off or fails is a stream evicted and
  re-admitted with its emitted tokens as prompt.  A stream can also leave
  for another server and arrive from one (the export and import commands
  behind ``/admin/streams``), and with ``spec_draft`` a draft deploy
  proposes ``spec_k`` tokens a tick that the target verifies in one forward
  (:class:`DraftGate`; ``ops.sampling.speculative_verify``).

A stream's tokens are those of the fixed-batch route: the same prefill, the
same step math, and sampling keyed by (seed, per-row step) alone
(``ops/sampling.py``), so a row's chain depends neither on its slot nor on
the other rows in the pool.

Tracing: a request submitted with its trace's root span gets a ``queue``
span (submit → its first prefill), a ``prefill`` span for each prefill
dispatch or chunk (with its co-batched streams), a ``first_segment`` span
for the segment that gave its first tokens, and at its end a ``decode``
span (admission → end) and a ``finish`` point, cancelled or failed ones
included.

Concurrency: every device call runs on the engine's one dispatch thread
through ``runner.run_fn``; each scheduler is one asyncio task, and request
state is touched only from it.  Clients talk to it through asyncio queues
and futures.
"""

from __future__ import annotations

import asyncio
import collections
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..engine.genkernels import PagedKernels, SlotKernels, unpack
from ..utils.logging import get_logger, log_event
from .kvcache import TRASH_BLOCK, BlockManager, KVPoolExhausted
from .kvmigrate import (MigrationError, MigrationNeedsPages, MigrationStats, PageIntegrityError,
                        pack_page, unpack_page)
from .metrics import TOKEN_LATENCY_BUCKETS_MS, Histogram
from .prefixcache import PrefixCache

log = get_logger("serving.generation")


@dataclass(eq=False)  # identity semantics: requests are unique, hashable
class GenRequest:
    """One streaming generation: admission inputs and client-facing outputs."""

    sample: dict[str, np.ndarray]  # servable.preprocess output
    max_new: int
    submitted: float = field(default_factory=time.perf_counter)
    admitted: float | None = None
    # Device rounds (dispatch + fetch) and segments between submit and the
    # first token.
    rounds_at_submit: int = 0
    segments_at_submit: int = 0
    rounds_to_first_token: int | None = None
    segments_to_first_token: int | None = None
    # Token events stream here; None marks the end.
    events: asyncio.Queue = field(default_factory=asyncio.Queue)
    done: asyncio.Future = field(default_factory=asyncio.Future)
    tokens: list[int] = field(default_factory=list)
    slot: int | None = None
    # Paged lane: evictions under pool pressure, admission order, and the
    # prompt tokens the prefix cache served at the latest admission; whether
    # the draft prefilled beside the target (speculation needs it) and the
    # stream's speculative proposals and acceptances.
    evictions: int = 0
    admit_seq: int = 0
    cached_tokens: int = 0
    has_draft: bool = False
    spec_proposed: int = 0
    spec_accepted: int = 0
    # Live migration: tokens from before this lane owned the stream (an
    # import carries them in ``tokens`` and never streams them again: only
    # events past ``emitted_base`` enter the queue), how often it moved (a
    # swap or an export), and whether it left this lane by a committed
    # export (the SSE writer then ends it with a ``migrated`` event).
    emitted_base: int = 0
    migrations: int = 0
    migrated: bool = False
    # When the first and the latest token reached the event queue.
    first_token_at: float | None = None
    last_token_at: float | None = None
    # The request's root span (serving/tracing.py), None when untraced: the
    # lane records queue, prefill and first_segment spans under it, and
    # decode and the finish point when the stream ends.
    span: Any = None
    queue_traced: bool = False

    def finish(self, error: str | None = None):
        if self.span is not None and not self.done.done():
            # A stream that left by a committed export ends without error.
            failed = error is not None and not self.migrated
            if self.admitted is not None:
                self.span.child("decode", start=self.admitted, tokens=len(self.tokens)).end(
                    status="error" if failed else None)
            self.span.point("finish", tokens=len(self.tokens),
                            **({"error": error} if failed else {}),
                            **({"migrated": True} if self.migrated else {}))
        if not self.done.done():
            if error is None:
                self.done.set_result(list(self.tokens))
            else:
                self.done.set_exception(RuntimeError(error))
                # Retrieved: an abandoned error future (client gone, shutdown)
                # must not log "exception was never retrieved"; awaiting
                # still raises.
                self.done.exception()
        self.events.put_nowait(None)


def _note_token_latency(req: GenRequest, ttft_hist: Histogram, itl_hist: Histogram) -> None:
    """The first token observes submit → now as time to first token; each
    later one the gap since its predecessor (a segment's tokens arrive as a
    burst, ~0 ms apart, as the client receives them)."""
    now = time.perf_counter()
    if req.first_token_at is None:
        req.first_token_at = now
        ttft_hist.observe((now - req.submitted) * 1000.0)
    else:
        itl_hist.observe((now - req.last_token_at) * 1000.0)
    req.last_token_at = now


class DraftGate:
    """Resolves a paged lane's speculative draft every tick: the draft's
    ``CompiledModel`` while it can serve (resident, not quarantined), else
    None, so the lane falls back to plain decode the moment the draft goes
    COLD or sick, holding no reference across a rebuild.  ``enter`` and
    ``exit`` bracket each use, so the lifecycle never demotes the draft
    during a dispatch."""

    def __init__(self, name: str, resolve, enter=None, exit=None):
        self.name = name
        self._resolve = resolve
        self._enter = enter
        self._exit = exit

    def acquire(self):
        """The draft's CompiledModel, or None while it cannot serve; a
        non-None answer must be followed by :meth:`release`."""
        cm = self._resolve()
        if cm is not None and self._enter is not None:
            self._enter(self.name)
        return cm

    def release(self):
        if self._exit is not None:
            self._exit(self.name)


class _Lane:
    """What both schedulers share: the dispatch call, deferred cancellation,
    and the token fan-out of one request."""

    # perf_counter at the latest segment's dispatch: a request's first
    # tokens come from the segment that started there.
    _seg_t0 = 0.0

    def _note_first_segment(self, req: GenRequest):
        req.rounds_to_first_token = self.device_rounds - req.rounds_at_submit
        req.segments_to_first_token = self.segment_rounds - req.segments_at_submit
        if req.span is not None:
            req.span.child("first_segment", start=self._seg_t0, tokens=len(req.tokens)).end()

    @staticmethod
    def _trace_admission(req: GenRequest, t0: float, t1: float, stage: str,
                         mates: list[GenRequest] = (), **attrs):
        """A request's queue span (submit → its first device work) once, and
        the ``stage`` span of one dispatch, naming its co-batched streams."""
        if req.span is None:
            return
        if not req.queue_traced:
            req.queue_traced = True
            req.span.child("queue", start=req.submitted).end(end=t0)
        ids = [m.span.trace.trace_id for m in mates if m is not req and m.span is not None][:8]
        req.span.child(stage, start=t0, **attrs,
                       **({"batch_mates": ids} if ids else {})).end(end=t1)

    def release_kernels(self) -> None:
        """Free the lane's pool and every graph (dispatch thread); the lane
        must not run again."""
        self.kernels.release()

    def _run(self, fn, *args):
        # The latency lane whatever the model's QoS class, as the reference
        # dispatches its streams; named, so a latency fault rule slows them.
        return self.runner.run_fn(fn, *args, model=self.name)

    def cancel(self, req: GenRequest):
        """Release a request whose client disconnected: deferred to the
        scheduler task (the only toucher of slot state); a pending request
        drops before admission, an active one retires at the next segment
        boundary."""
        self._cancelled.add(req)
        self._wake.set()

    @property
    def depth(self) -> int:
        return len(self._pending)

    def _emit(self, req: GenRequest, token: int) -> bool:
        """Record one generated token; True when the request is done.  EOS
        ends the stream and is never an event; the token that spends the
        budget is the last."""
        if token == self.eos_id:
            return True
        req.tokens.append(token)
        req.events.put_nowait(token)
        self.tokens_emitted += 1
        _note_token_latency(req, self.ttft_hist, self.itl_hist)
        return len(req.tokens) >= req.max_new


class GenerationScheduler(_Lane):
    """Slot-pool continuous-batching loop for one generative model."""

    def __init__(self, cm, runner, mc, ring=None):
        meta = cm.servable.meta["continuous"]
        self.cm = cm
        self.runner = runner
        self.ring = ring
        self.name = cm.servable.name
        self.slots: int = meta["slots"]
        self.total: int = meta["total"]
        self.eos_id: int = meta["eos_id"]
        self.max_new: int = meta["max_new"]
        self.seg: int = meta["segment_tokens"]
        self.prompt_buckets: tuple[int, ...] = meta["prompt_buckets"]
        self.detokenize = meta.get("detokenize")
        # Model-shaped admission (Whisper admits audio, GPT-2 token ids):
        # the payload must carry "length" [1] (the first decode position)
        # and may carry the sampling knobs [1].
        self._admit_len_of = meta["admit_len_of"]
        self._collate_admit = meta["collate_admit"]
        # The pool and its programs; the pool is updated in place.
        self.kernels = SlotKernels(cm)
        self._prefill = self.kernels.prefill
        self._segment = self.kernels.segment
        self._insert_from = self.kernels.insert_from
        # Slot state and the pool are "dispatch-serialized": mutated by the
        # *_sync functions on the dispatch thread AND by the scheduler task,
        # never at once (the task awaits every run_fn round trip).
        self.prefill_dispatches = 0  # guarded-by: dispatch-serialized
        S = self.slots
        self._tok = np.zeros((S,), np.int32)    # guarded-by: dispatch-serialized
        self._pos = np.zeros((S,), np.int32)    # guarded-by: dispatch-serialized
        self._step = np.zeros((S,), np.int32)   # guarded-by: dispatch-serialized
        self._finished = np.ones((S,), bool)    # guarded-by: dispatch-serialized
        self._temp = np.zeros((S,), np.float32)  # guarded-by: dispatch-serialized
        self._seed = np.zeros((S,), np.int32)   # guarded-by: dispatch-serialized
        self._topk = np.zeros((S,), np.int32)   # guarded-by: dispatch-serialized
        self._topp = np.ones((S,), np.float32)  # guarded-by: dispatch-serialized
        self._active: dict[int, GenRequest] = {}  # guarded-by: event-loop
        self._free = list(range(S))               # guarded-by: event-loop
        self._pending: collections.deque[GenRequest] = collections.deque()  # guarded-by: event-loop
        self._cancelled: set[GenRequest] = set()  # guarded-by: event-loop
        self._max_pending = int(mc.max_concurrency)
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None  # guarded-by: event-loop
        self._stopped = False  # guarded-by: event-loop
        # Set only if the lane stops for good; /healthz reports it.
        self.fatal: str | None = None  # guarded-by: event-loop
        # Device rounds (one dispatch + fetch each), bumped on the dispatch
        # thread, read by the loop task.
        self.device_rounds = 0   # guarded-by: dispatch-serialized
        self.segment_rounds = 0  # guarded-by: dispatch-serialized
        self.tokens_emitted = 0  # guarded-by: event-loop
        self.ttft_hist = Histogram(TOKEN_LATENCY_BUCKETS_MS)
        self.itl_hist = Histogram(TOKEN_LATENCY_BUCKETS_MS)

    # -- device kernels (all called on the runner's dispatch thread) --------
    def _ensure_cache(self):
        self.kernels.ensure()

    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds the largest bucket "
                         f"{self.prompt_buckets[-1]}")

    def _set_slot(self, slot: int, first_tok: int, payload: dict, j: int):
        self._tok[slot] = first_tok
        self._pos[slot] = int(payload["length"][j])
        self._step[slot] = 0
        self._finished[slot] = False
        self._temp[slot] = float(payload.get("temperature", np.zeros(j + 1))[j])
        self._seed[slot] = int(payload.get("seed", np.zeros(j + 1, np.int32))[j])
        self._topk[slot] = int(payload.get("top_k", np.zeros(j + 1, np.int32))[j])
        self._topp[slot] = float(payload.get("top_p", np.ones(j + 1))[j])

    def _admit_batch_sync(self, group: list, bucket: int):
        """Admit N same-bucket requests with ONE prefill dispatch.

        ``group`` is [(req, slot, payload), ...].  Payloads stack on the
        batch axis and pad to the next power of two (one prefill program per
        (bucket, power-of-two batch)); pad rows compute garbage and are never
        inserted.  One fetch (the first tokens) for the whole group."""
        B = len(group)
        Bp = 1 << (B - 1).bit_length()
        payloads = [p for _, _, p in group]
        batched = {
            k: np.concatenate([p[k] for p in payloads] + [payloads[0][k]] * (Bp - B), axis=0)
            for k in payloads[0]
        }
        self._ensure_cache()
        first = self._prefill(batched)
        self.prefill_dispatches += 1
        for j, (req, slot, payload) in enumerate(group):
            self._insert_from(j, slot)
            self._set_slot(slot, int(first[j]), batched, j)
        self.device_rounds += 1

    def _segment_sync(self):
        """One decode segment over the whole pool (dispatch thread): the
        carries go in, the emits [S, seg] and the new carries come back in
        one fetch; the pool stays on the device."""
        out = self._segment({"tok": self._tok, "pos": self._pos, "step": self._step,
                             "fin": self._finished, "temp": self._temp, "seed": self._seed,
                             "topk": self._topk, "topp": self._topp})
        emits, self._tok, self._pos, self._step, self._finished = unpack(out, self.seg)
        self.device_rounds += 1
        self.segment_rounds += 1
        return emits

    # -- client API ---------------------------------------------------------
    def submit(self, sample: dict, max_new: int | None = None, span=None) -> GenRequest:
        if self._stopped:
            raise RuntimeError("generation scheduler is shut down")
        backlog = len(self._pending) + len(self._active)
        if backlog >= self._max_pending:
            raise OverflowError(f"generation backlog full ({self._max_pending})")
        # An over-length prompt fails here, with a clean error to the client.
        self._bucket_for(self._admit_len_of(sample))
        want = self.max_new if max_new is None else max(1, min(int(max_new), self.max_new))
        req = GenRequest(sample=sample, max_new=want, rounds_at_submit=self.device_rounds,
                         segments_at_submit=self.segment_rounds, span=span)
        self._pending.append(req)
        self._wake.set()
        return req

    def _process_cancellations(self):
        for req in list(self._cancelled):
            self._cancelled.discard(req)
            if req in self._pending:
                self._pending.remove(req)
                req.finish(error="cancelled")
            elif req.slot is not None and self._active.get(req.slot) is req:
                slot = req.slot
                self._finished[slot] = True
                self._tok[slot] = self.eos_id
                del self._active[slot]
                self._free.append(slot)
                req.finish(error="cancelled")
            # else: already finished — nothing to release

    @property
    def active(self) -> int:
        return len(self._active)

    def gen_snapshot(self) -> dict:
        """Lane introspection for /metrics."""
        return {"mode": "slot", "slots": self.slots,
                "active": len(self._active), "pending": len(self._pending),
                "device_rounds": self.device_rounds,
                "segment_rounds": self.segment_rounds,
                "prefill_dispatches": self.prefill_dispatches,
                "tokens_emitted": self.tokens_emitted,
                "latency": {"ttft_ms": self.ttft_hist.snapshot(),
                            "itl_ms": self.itl_hist.snapshot()}}

    def warm(self):
        """Capture the lane's first graphs ahead of traffic (dispatch thread)."""
        self.kernels.warm()

    def start(self):
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop(),
                                                                name=f"gen-{self.name}")
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
        for req in list(self._active.values()) + list(self._pending):
            req.finish(error="generation scheduler shut down")
        self._active.clear()
        self._pending.clear()

    # -- the loop -----------------------------------------------------------
    async def _loop(self):
        while True:
            if not self._pending and not self._active:
                self._wake.clear()
                await self._wake.wait()
            self._process_cancellations()
            # Admit into free slots (prefill runs on the dispatch thread, so
            # it serializes with segments and other models' traffic); same-
            # bucket admissions coalesce into one batched prefill.
            admits: list[tuple[GenRequest, int]] = []
            while self._free and self._pending:
                admits.append((self._pending.popleft(), self._free.pop()))
            groups: dict[int, list] = {}
            for req, slot in admits:
                try:
                    bucket = self._bucket_for(self._admit_len_of(req.sample))
                    payload = self._collate_admit(req.sample, bucket)
                except Exception as e:  # bad sample fails only itself
                    self._free.append(slot)
                    req.finish(error=f"{type(e).__name__}: {e}")
                    continue
                groups.setdefault(bucket, []).append((req, slot, payload))
            group_list = list(groups.items())
            for gi, (bucket, group) in enumerate(group_list):
                t0 = time.perf_counter()
                try:
                    await self._run(self._admit_batch_sync, group, bucket)
                except Exception as e:  # device fault: fail these requests
                    log.exception("admission failed for %s", self.name)
                    for req, slot, _ in group:
                        self._free.append(slot)
                        # A partly admitted batch may have unfrozen some slot
                        # rows; re-pin them so an orphaned row doesn't keep
                        # decoding garbage until reuse.
                        self._finished[slot] = True
                        req.finish(error=f"{type(e).__name__}: {e}")
                    # Requests in groups this round hasn't reached were popped
                    # from _pending but never entered _active: re-queue them,
                    # or a pool reset would orphan them.
                    remaining = [r for _, g in group_list[gi + 1:] for r, _, _ in g]
                    if self._cache_deleted():
                        # The fault tore the pool: fail the in-flight streams
                        # like a segment fault, reset the pool, and re-admit
                        # this round's remaining groups next round (their
                        # slots came from the old free list).
                        for slot, req in list(self._active.items()):
                            req.finish(error=f"{type(e).__name__}: {e} "
                                             "(cache pool lost to a faulted admission)")
                        for r in reversed(remaining):
                            self._pending.appendleft(r)
                        self._reset_pool()
                        break
                    continue
                t1 = time.perf_counter()
                members = [r for r, _, _ in group]
                for req, slot, _ in group:
                    req.slot = slot
                    req.admitted = t1
                    self._active[slot] = req
                    self._trace_admission(req, t0, t1, "prefill", members, bucket=bucket,
                                          batch=len(group))
                # (The first token is computed at admission but streamed by
                # the next segment, which emits the token decided before each
                # step.)
            if not self._active:
                continue
            self._seg_t0 = time.perf_counter()
            try:
                emits = await self._run(self._segment_sync)
            except Exception as e:
                # Device fault mid-segment: fail every in-flight request
                # loudly and reset the pool.
                log.exception("segment failed for %s", self.name)
                for slot, req in list(self._active.items()):
                    req.finish(error=f"{type(e).__name__}: {e}")
                self._reset_pool()
                continue
            self._distribute(emits)

    def _cache_deleted(self) -> bool:
        """True when a pool-writing dispatch faulted part-way."""
        return self.kernels.torn

    def _reset_pool(self):
        self.kernels.reset()
        self._finished[:] = True
        self._active.clear()
        self._free = list(range(self.slots))

    def _distribute(self, emits: np.ndarray):
        """Fan segment output to requests; retire finished slots."""
        for slot, req in list(self._active.items()):
            finished = False
            had_tokens = bool(req.tokens)
            for t in range(emits.shape[1]):
                finished = self._emit(req, int(emits[slot, t]))
                if finished:
                    break
            if not had_tokens and req.tokens:
                self._note_first_segment(req)
            if finished:
                self._finished[slot] = True
                self._tok[slot] = self.eos_id
                del self._active[slot]
                self._free.append(slot)
                if self.ring is not None:
                    total_ms = (time.perf_counter() - req.submitted) * 1000
                    queue_ms = (req.admitted - req.submitted) * 1000
                    self.ring.record(queue_ms, total_ms - queue_ms, total_ms)
                req.finish()
                log_event(log, "generation finished", model=self.name, slot=slot,
                          tokens=len(req.tokens))
        if self._free and self._pending:
            self._wake.set()


# ---------------------------------------------------------------------------
# The paged lane: block-paged KV pool, chunked prefill, prefix cache
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class _PrefillJob:
    """One request mid-chunked-prefill: which chunk is next, into which
    slot, against which prompt ids (eviction continuations extend them)."""

    req: GenRequest
    slot: int
    ids: np.ndarray                       # the whole prompt, int32 [P]
    chunks: list[tuple[int, int]]         # (start, bucket) per chunk
    knobs: tuple[float, int, int, float]  # temperature, seed, top_k, top_p
    aidx: int = 0                         # adapter slot (0: the base)
    next: int = 0
    # Prefix-cache state: tokens already resident in frozen pages (chunk 0
    # starts there), and copy-on-write page pairs (src, dst) the first chunk
    # dispatch copies before any read; the scheduler then drops the held src
    # refs.
    cached: int = 0
    cow: list[tuple[int, int]] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.next >= len(self.chunks)




class PagedGenerationScheduler(_Lane):
    """Continuous batching over a block-paged KV pool, with chunked prefill,
    the prefix cache, live migration and speculative decoding
    (``ModelConfig.kv_cache: "paged"``).

    Against :class:`GenerationScheduler`: one pool of ``kv_num_blocks``
    pages (``serving/kvcache.BlockManager``) instead of ``slots`` max-length
    rows, so sequences hold pages for the tokens they have (the pool's bytes
    are tracked in the runner's residency ledger as ``{model}:kvcache``, a
    draft's pool as ``{model}:draftcache``); prompts prefill in
    ``prefill_chunk_tokens``-bounded chunks, at most one chunk dispatch a
    loop tick between decode segments, so a long prompt cannot stall the
    live streams.

    - **Pressure**: when a stream cannot extend, decayed prefix pages
      reclaim first, then (``kv_migrate``) the newest stream's pages move to
      host memory and it waits, paused, until pages free; it resumes from
      them with nothing recomputed.  Only when that is off or fails is the
      newest stream evicted and re-prefilled.
    - **Migration**: a decoding stream can be paused at a tick boundary,
      its pages read out and it detached (export), and a stream created
      from exported state and pages (import); ``/admin/streams`` drives the
      ``migrate_*`` commands, which the loop runs between ticks.
    - **Speculation**: with a :class:`DraftGate`, a tick where the draft
      can serve and every stream was prefilled on it proposes ``spec_k``
      tokens a row on the draft's pool, and the target verifies them in one
      forward with rejection sampling (one graph); otherwise the tick is a
      plain segment.  Greedy output is plain decoding's.
    - **Adapters**: each stream carries its adapter slot (the sample's
      ``adapter_idx``) through its chunks, its segments, a swap, an export
      and an eviction's continuation; its prefixes freeze under that slot.

    One asyncio task owns all host state and every device call goes through
    ``runner.run_fn``, as in the slot pool.
    """

    # The final (partial) chunk pads to the smallest power of two from this
    # one up that holds it: one chunk program per (bucket, power-of-two
    # group), not one per prompt length.
    _CHUNK_LADDER_MIN = 8

    def __init__(self, cm, runner, mc, ring=None, draft: DraftGate | None = None):
        meta = cm.servable.meta["continuous"]
        if meta.get("paged") is None:
            raise ValueError(
                f"{cm.servable.name}: kv_cache='paged' configured but the servable exposes no "
                "paged kernel contract (meta['continuous']['paged']); use kv_cache='slot'")
        self.cm = cm
        self.runner = runner
        self.ring = ring
        self.name = cm.servable.name
        self.slots: int = meta["slots"]
        self.total: int = meta["total"]
        self.eos_id: int = meta["eos_id"]
        self.max_new: int = meta["max_new"]
        self.seg: int = meta["segment_tokens"]
        self.max_prompt: int = meta["prompt_buckets"][-1]
        self.detokenize = meta.get("detokenize")
        pg = meta["paged"]
        self._prompt_ids = pg["prompt_ids"]
        self._knobs_of = pg["knobs"]
        self._extend_sample = pg["extend_sample"]
        # A stream's adapter slot from its sample (0: the base).
        self._aidx_of = pg["adapter_idx"]
        # Pool layout: block 0 is trash; the default size is the slot pool's
        # worst case (slots x max_blocks + 1), so it serves the same load in
        # the same memory; kv_num_blocks sizes it down.
        self.block_size = max(int(mc.kv_block_size), 1)
        self.max_blocks = -(-self.total // self.block_size)
        auto_blocks = self.slots * self.max_blocks + 1
        self.num_blocks = int(mc.kv_num_blocks) or auto_blocks
        self._mgr = BlockManager(self.num_blocks, self.block_size,
                                 self.max_blocks)  # guarded-by: event-loop
        # Chunked prefill: bounded chunk cost; 0 → one chunk per prompt.
        cap = int(mc.prefill_chunk_tokens)
        self.chunk_cap = cap if cap > 0 else self.max_prompt
        self.spec_k = max(int(mc.spec_k), 1)
        self.draft = draft
        self.spec_draft_name = draft.name if draft is not None else None
        self.kernels = PagedKernels(cm, self.block_size, self.num_blocks, self.spec_k)
        self._prefill_chunk = self.kernels.prefill_chunk
        self._segment = self.kernels.segment
        self._copy_page = self.kernels.copy_page
        self._cache_nbytes = self.kernels.cache_nbytes
        # The draft's kernel set and page pool (the target's block layout and
        # tables), made at the draft's first use.
        self._draft_kernels: PagedKernels | None = None  # guarded-by: dispatch-serialized
        # One KV page's host shape and dtype: the migration's wire geometry.
        L, _, BS, D = self.kernels.shape
        self.page_shape = (L, BS, D)
        self.cache_dtype = self.kernels.dtype
        # Prefix KV cache: matched prefixes skip prefill, CoW keeps
        # divergence exact.  A stream admitted on a hit decodes plain (the
        # draft's pool never prefilled the skipped positions).
        self.prefix_ttl_s = float(mc.prefix_cache_ttl_s)
        self._prefix: PrefixCache | None = None  # guarded-by: event-loop
        if bool(mc.prefix_cache):
            self._prefix = PrefixCache(self._mgr, self.block_size,
                                       max_pages=int(mc.prefix_cache_blocks))
        S = self.slots
        self._tok = np.zeros((S,), np.int32)    # guarded-by: dispatch-serialized
        self._pos = np.zeros((S,), np.int32)    # guarded-by: dispatch-serialized
        self._step = np.zeros((S,), np.int32)   # guarded-by: dispatch-serialized
        self._finished = np.ones((S,), bool)    # guarded-by: dispatch-serialized
        self._temp = np.zeros((S,), np.float32)  # guarded-by: dispatch-serialized
        self._seed = np.zeros((S,), np.int32)   # guarded-by: dispatch-serialized
        self._topk = np.zeros((S,), np.int32)   # guarded-by: dispatch-serialized
        self._topp = np.ones((S,), np.float32)  # guarded-by: dispatch-serialized
        # The chain token at pos - 1 a slot: the draft's backfill feed (a tick
        # that accepted every proposal leaves the draft one KV write behind).
        self._prev = np.zeros((S,), np.int32)   # guarded-by: dispatch-serialized
        # Each slot's adapter (0: the base): a static input of the chunk and
        # segment graphs, so tenants co-decode in one program.  The draft
        # has no adapter stacks: a tick with an adapter stream decodes plain.
        self._aidx = np.zeros((S,), np.int32)   # guarded-by: dispatch-serialized
        self._active: dict[int, GenRequest] = {}  # guarded-by: event-loop
        self._prefilling: collections.deque[_PrefillJob] = collections.deque()  # guarded-by: event-loop
        self._free = list(range(S))               # guarded-by: event-loop
        self._pending: collections.deque[GenRequest] = collections.deque()  # guarded-by: event-loop
        self._cancelled: set[GenRequest] = set()  # guarded-by: event-loop
        # Live KV migration: ``kv_migrate`` puts the swap to host ahead of
        # eviction; ``_swapped`` holds streams swapped out (their pages in
        # host memory) until pages free, ``_detached`` streams paused by an
        # export (pages still in the pool) until its commit or abort, and
        # ``_cmds`` the migration commands the loop runs between ticks.
        self.kv_migrate = bool(mc.kv_migrate)
        self.migration = MigrationStats()
        self._swapped: collections.deque[dict] = collections.deque()  # guarded-by: event-loop
        self._detached: dict[GenRequest, dict] = {}  # guarded-by: event-loop
        self._cmds: collections.deque = collections.deque()  # guarded-by: event-loop
        self._max_pending = int(mc.max_concurrency)
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None  # guarded-by: event-loop
        self._stopped = False  # guarded-by: event-loop
        self.fatal: str | None = None  # guarded-by: event-loop
        self._admit_counter = 0  # guarded-by: event-loop
        # Decode pace EMA (seconds per emitted token): what the exhaustion
        # shed's Retry-After is computed from.
        self._s_per_token = 0.0  # guarded-by: event-loop
        self.device_rounds = 0      # guarded-by: dispatch-serialized
        self.segment_rounds = 0     # guarded-by: dispatch-serialized
        self.prefill_chunks = 0     # guarded-by: dispatch-serialized
        self.spec_proposed = 0      # guarded-by: event-loop
        self.spec_accepted = 0      # guarded-by: event-loop
        self.spec_fallback_ticks = 0  # guarded-by: event-loop
        self.tokens_emitted = 0  # guarded-by: event-loop
        self.ttft_hist = Histogram(TOKEN_LATENCY_BUCKETS_MS)
        self.itl_hist = Histogram(TOKEN_LATENCY_BUCKETS_MS)

    # -- sizing ---------------------------------------------------------------
    def _chunk_plan(self, n: int, start: int = 0) -> list[tuple[int, int]]:
        """(start, bucket) chunks covering an ``n``-token prompt from
        ``start`` (the prefix-cached offset): whole ``chunk_cap`` chunks,
        then one power-of-two-bucketed remainder."""
        chunks = []
        while n - start > self.chunk_cap:
            chunks.append((start, self.chunk_cap))
            start += self.chunk_cap
        rem = n - start
        b = self._CHUNK_LADDER_MIN
        while b < rem:
            b *= 2
        chunks.append((start, min(b, self.chunk_cap)))
        return chunks

    def chunk_buckets(self) -> list[int]:
        """Every chunk length a plan can give."""
        out, b = [], self._CHUNK_LADDER_MIN
        while b < self.chunk_cap:
            out.append(b)
            b *= 2
        return out + [self.chunk_cap]

    def _table_np(self) -> np.ndarray:
        """The decode block table [S, max_blocks]: active rows from the
        manager, every other row all trash (frozen rows write harmlessly)."""
        table = np.full((self.slots, self.max_blocks), TRASH_BLOCK, np.int32)
        for slot, req in self._active.items():
            table[slot] = self._mgr.table_row(req)
        return table

    # -- device kernels (dispatch thread) ------------------------------------
    def _ensure_cache(self):
        self.kernels.ensure()
        self._track_pool()

    def _track_pool(self):
        """The page pools' bytes in the runner's residency ledger: the
        target's as ``{model}:kvcache``, a draft's as ``{model}:draftcache``
        (each its own entry, as the HBM budget counts them)."""
        self.runner.track_model(f"{self.name}:kvcache", self._cache_nbytes)
        dk = self._draft_kernels
        if dk is not None and dk.cache_k is not None:
            self.runner.track_model(f"{self.name}:draftcache", dk.cache_nbytes)

    def _carries(self) -> dict[str, np.ndarray]:
        return {"tok": self._tok, "pos": self._pos, "step": self._step,
                "fin": self._finished, "temp": self._temp, "seed": self._seed,
                "topk": self._topk, "topp": self._topp}

    def _chunk_payload(self, jobs: list[_PrefillJob], bucket: int) -> tuple:
        """Collate one chunk group's host arrays (event-loop side).  Pad rows
        (power-of-two group) carry zeros and an all-trash table."""
        G = len(jobs)
        Gp = 1 << (G - 1).bit_length()
        toks = np.zeros((Gp, bucket), np.int32)
        start = np.zeros((Gp,), np.int32)
        length = np.ones((Gp,), np.int32)
        temp = np.zeros((Gp,), np.float32)
        seed = np.zeros((Gp,), np.int32)
        topk = np.zeros((Gp,), np.int32)
        topp = np.ones((Gp,), np.float32)
        table = np.full((Gp, self.max_blocks), TRASH_BLOCK, np.int32)
        aidx = np.zeros((Gp,), np.int32)
        for j, job in enumerate(jobs):
            s0, cb = job.chunks[job.next]
            sl = job.ids[s0:s0 + cb]
            toks[j, :sl.shape[0]] = sl
            start[j] = s0
            length[j] = job.ids.shape[0]
            temp[j], seed[j], topk[j], topp[j] = job.knobs
            aidx[j] = job.aidx
            table[j] = self._mgr.table_row(job.req)
        return toks, start, length, temp, seed, topk, topp, table, aidx

    def _prefill_chunk_sync(self, payload: tuple, n_jobs: int, draft: PagedKernels | None,
                            cows: list[tuple[int, int]] = ()):
        """One chunk dispatch for a same-bucket group (padded to a power of
        two), and the draft's chunk on its own pool when speculation is live.
        Pending copy-on-write page copies run first: a job whose prefix hit
        diverged mid-page got a fresh page at admission, and its chunk reads
        the copied page's cached positions."""
        self._ensure_cache()
        for src, dst in cows:
            self._copy_page(src, dst)
        first = self._prefill_chunk(payload)
        if draft is not None:
            draft.ensure()
            self._track_pool()
            draft.prefill_chunk(payload)
        self.prefill_chunks += n_jobs
        self.device_rounds += 1
        return first

    def _segment_sync(self, table: np.ndarray):
        """One decode segment over the pool (dispatch thread)."""
        out = self._segment(table, {**self._carries(), "aidx": self._aidx})
        emits, self._tok, self._pos, self._step, self._finished = unpack(out, self.seg)
        # The last step's fed token is the chain token at pos - 1 (EOS for a
        # finished row, which never speculates).
        self._prev = emits[:, -1].astype(np.int32)
        self.device_rounds += 1
        self.segment_rounds += 1
        return emits

    def _spec_tick_sync(self, draft: PagedKernels, table: np.ndarray, corrupt: bool):
        """One speculative tick (dispatch thread): the draft proposes
        ``spec_k`` tokens a row, and the target's verify graph runs its
        forward over them and the rejection sampling.  Returns (n_accept
        [S], out_toks [S, k+1], proposals [S, k], (t0, t1, t2))."""
        t0 = time.perf_counter()
        carries = {**self._carries(), "prev": self._prev}
        props = draft.propose(table, carries, self.kernels.spec_buffer())
        if corrupt:
            # The spec_mismatch fault: every proposal derailed, so the
            # rejection path runs; verification corrects the output.
            props = ((props + 1) % max(self.eos_id, 2)).astype(np.int32)
        t1 = time.perf_counter()
        toks = np.concatenate([self._tok[:, None], props], axis=1).astype(np.int32)
        out = self.kernels.verify(table, toks, carries)
        t2 = time.perf_counter()
        self.device_rounds += 1
        self.segment_rounds += 1
        return out[:, 0], out[:, 1:], props, (t0, t1, t2)

    def _gather_pages_sync(self, blocks: list[int]):
        """Pages to the host (dispatch thread); read only, so a failed read
        leaves the pool whole."""
        pages = self.kernels.read_pages(blocks)
        self.device_rounds += 1
        return pages

    def _scatter_pages_sync(self, pairs):
        """(block, K, V) host pages into the pool, in place (dispatch
        thread)."""
        self._ensure_cache()
        self.kernels.write_pages(pairs)
        self.device_rounds += 1

    def release_kernels(self) -> None:
        """Free the pools and every graph of the lane (dispatch thread): the
        target's and the draft's."""
        self.kernels.release()
        if self._draft_kernels is not None:
            self._draft_kernels.release()

    # -- client API -----------------------------------------------------------
    def submit(self, sample: dict, max_new: int | None = None, span=None) -> GenRequest:
        if self._stopped:
            raise RuntimeError("generation scheduler is shut down")
        backlog = len(self._pending) + len(self._prefilling) + len(self._active)
        if backlog >= self._max_pending:
            raise OverflowError(f"generation backlog full ({self._max_pending})")
        ids = self._prompt_ids(sample)
        plen = int(ids.shape[0])
        if plen > self.max_prompt:
            raise ValueError(f"prompt is {plen} tokens but the longest configured seq "
                             f"bucket is {self.max_prompt}")
        need = self._mgr.blocks_for(plen + 1)
        effective_free = self._mgr.free_blocks
        if self._prefix is not None:
            # Pages held only by decayed prefix nodes are one reclaim() away
            # from free.
            effective_free += self._prefix.reclaimable()
        if need > effective_free and self._pending:
            # Pool exhausted AND a queue already waits: shed with the
            # expected block-release horizon (the server answers 429 with
            # Retry-After).
            raise KVPoolExhausted(
                f"KV pool exhausted ({self._mgr.free_blocks} of {self.num_blocks - 1} blocks "
                f"free, prompt needs {need})",
                retry_after_s=self.expected_release_s(),
                free_blocks=self._mgr.free_blocks, needed_blocks=need)
        want = self.max_new if max_new is None else max(1, min(int(max_new), self.max_new))
        req = GenRequest(sample=sample, max_new=want, rounds_at_submit=self.device_rounds,
                         segments_at_submit=self.segment_rounds, span=span)
        self._pending.append(req)
        self._wake.set()
        return req

    def expected_release_s(self) -> float:
        """When blocks plausibly free: the closest-to-done active stream's
        remaining tokens at the recent decode pace."""
        pace = self._s_per_token or 0.05
        remaining = [req.max_new - len(req.tokens) for req in self._active.values()]
        horizon = min(remaining) * pace if remaining else 1.0
        return float(min(max(horizon, 0.05), 30.0))

    @property
    def active(self) -> int:
        return len(self._active) + len(self._prefilling)

    def spec_live(self) -> bool:
        """Whether the draft can serve now (the ``X-Spec-Draft`` header's
        evidence; a tick also needs every stream prefilled on the draft)."""
        if self.draft is None:
            return False
        cm = self.draft.acquire()
        if cm is None:
            return False
        self.draft.release()
        return True

    def gen_snapshot(self) -> dict:
        """Lane introspection for /metrics."""
        out = {
            "mode": "paged",
            "slots": self.slots,
            "active": len(self._active),
            "prefilling": len(self._prefilling),
            "pending": len(self._pending),
            "kv": self._mgr.snapshot(),
            "prefill_chunks": self.prefill_chunks,
            "chunk_cap": self.chunk_cap,
            "spec": {"draft": self.spec_draft_name, "k": self.spec_k,
                     "proposed": self.spec_proposed, "accepted": self.spec_accepted,
                     "fallback_ticks": self.spec_fallback_ticks},
            "device_rounds": self.device_rounds,
            "segment_rounds": self.segment_rounds,
            "tokens_emitted": self.tokens_emitted,
            "latency": {"ttft_ms": self.ttft_hist.snapshot(),
                        "itl_ms": self.itl_hist.snapshot()},
            "migration": {**self.migration.snapshot(), "enabled": self.kv_migrate,
                          "swapped": len(self._swapped), "detached": len(self._detached)},
        }
        if self._prefix is not None:
            out["prefix"] = self._prefix.snapshot()
        return out

    def invalidate_prefix(self, aidx: int) -> int:
        """Drop every frozen prefix under one adapter slot: the server's
        detach hook, so a reused slot never resolves a detached tenant's
        pages."""
        if self._prefix is None:
            return 0
        return self._prefix.invalidate(aidx)

    def warm(self, draft_cm=None):
        """Capture the lane's first graphs ahead of traffic (dispatch
        thread); with the draft's CompiledModel, its chunk and propose
        graphs and the verify graphs too."""
        self.kernels.warm(self.chunk_buckets(), self.max_blocks)
        if draft_cm is not None:
            dk = self._draft_set(draft_cm)
            dk.warm(self.chunk_buckets(), self.max_blocks, segments=False)
            self.kernels.warm_spec(dk, self.max_blocks)
        if self.kernels.cache_k is not None:
            self._track_pool()

    def start(self):
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._loop(), name=f"gen-paged-{self.name}")
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
        for req in (list(self._active.values()) + [j.req for j in self._prefilling]
                    + list(self._pending) + [rec["req"] for rec in self._swapped]
                    + list(self._detached)):
            req.finish(error="generation scheduler shut down")
        self._active.clear()
        self._prefilling.clear()
        self._pending.clear()
        self._swapped.clear()
        self._detached.clear()
        for _, fut in self._cmds:
            if not fut.done():
                fut.set_exception(RuntimeError("generation scheduler shut down"))
                fut.exception()
        self._cmds.clear()
        self.runner.untrack_model(f"{self.name}:kvcache")
        self.runner.untrack_model(f"{self.name}:draftcache")

    # -- the loop -------------------------------------------------------------
    async def _loop(self):
        while True:
            if not (self._pending or self._prefilling or self._active or self._cmds
                    or self._swapped):
                self._wake.clear()
                await self._wake.wait()
            self._process_cancellations()
            await self._process_cmds()
            if self._prefix is not None and self.prefix_ttl_s > 0:
                self._prefix.decay(self.prefix_ttl_s)
            try:
                await self._admit()
                await self._prefill_tick()
                await self._decode_tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # A device fault that tore the pool: fail every in-flight
                # stream loudly and rebuild the pool, manager included.
                log.exception("paged generation tick failed for %s", self.name)
                self._fail_all_inflight(f"{type(e).__name__}: {e}")
                self._reset_pool()
            if self._swapped and not (self._active or self._prefilling or self._pending
                                      or self._cmds):
                # Only swapped streams are left and none could come back
                # (pages still short): yield instead of spinning.
                await asyncio.sleep(0.005)

    async def _process_cmds(self):
        """Run the queued migration commands at a tick boundary: inside the
        loop task, so they see quiescent slot state and their device calls
        serialize with the ticks.  A failed command fails its caller only,
        unless it tore the pool (then the loop's containment runs)."""
        while self._cmds:
            factory, fut = self._cmds.popleft()
            try:
                res = await factory()
            except asyncio.CancelledError:
                fut.cancel()
                raise
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
                fut.exception()  # a command's caller may be gone
                if self._cache_deleted():
                    self._fail_all_inflight(f"{type(e).__name__}: {e} (pool lost to a "
                                            "faulted migration dispatch)")
                    self._reset_pool()
            else:
                if not fut.done():
                    fut.set_result(res)

    def _run_cmd(self, factory) -> asyncio.Future:
        """Queue one command (a coroutine factory); the loop resolves it."""
        if self._stopped:
            raise RuntimeError("generation scheduler is shut down")
        fut = asyncio.get_running_loop().create_future()
        self._cmds.append((factory, fut))
        self._wake.set()
        return fut

    def _fail_all_inflight(self, msg: str):
        for req in (list(self._active.values()) + [j.req for j in self._prefilling]
                    + [rec["req"] for rec in self._swapped] + list(self._detached)):
            req.finish(error=msg)
        self._active.clear()
        self._prefilling.clear()
        self._swapped.clear()
        self._detached.clear()

    def _reset_pool(self):
        self.kernels.reset()
        if self._draft_kernels is not None:
            self._draft_kernels.reset()
        self._finished[:] = True
        self._aidx[:] = 0
        self._free = list(range(self.slots))
        self._mgr = BlockManager(self.num_blocks, self.block_size, self.max_blocks)
        if self._prefix is not None:
            # The pool's frozen pages went with the fault.
            self._prefix = PrefixCache(self._mgr, self.block_size,
                                       max_pages=self._prefix.max_pages)

    def _process_cancellations(self):
        for req in list(self._cancelled):
            self._cancelled.discard(req)
            if req in self._pending:
                self._pending.remove(req)
                req.finish(error="cancelled")
                continue
            job = next((j for j in self._prefilling if j.req is req), None)
            rec = next((r for r in self._swapped if r["req"] is req), None)
            if job is not None:
                self._prefilling.remove(job)
                self._drop_cows(job)
                self._release(req, job.slot)
                req.finish(error="cancelled")
            elif rec is not None:
                # Swapped out: its pages live only in the host record.
                self._swapped.remove(rec)
                req.finish(error="cancelled")
            elif req in self._detached:
                # Paused by an export whose commit never came: free its pages;
                # a late commit or abort then fails cleanly.
                del self._detached[req]
                self._mgr.free(req)
                req.finish(error="cancelled")
            elif req.slot is not None and self._active.get(req.slot) is req:
                slot = req.slot
                self._finished[slot] = True
                self._tok[slot] = self.eos_id
                del self._active[slot]
                self._release(req, slot)
                req.finish(error="cancelled")

    def _release(self, req: GenRequest, slot: int):
        self._mgr.free(req)
        self._aidx[slot] = 0
        self._free.append(slot)

    # -- admission ------------------------------------------------------------
    def _prefix_match(self, ids: np.ndarray, aidx: int) -> tuple[int, list[int], bool]:
        """Radix lookup for one admission, gated by the prefix chaos hook:
        ``kind="prefix"`` ``mode="poison"`` fails the lookup, and any failed
        lookup, injected or real, falls back to a cold prefill (counted as a
        miss), never to a failed request.  Returns ``(cached_len,
        shared_blocks, force_cow)``; ``mode="cow"`` sets the last."""
        mode = self.runner.faults.on_prefix(self.name)
        try:
            if mode == "poison":
                raise RuntimeError("injected prefix fault (lookup)")
            cached, shared = self._prefix.lookup(aidx, ids, max_tokens=int(ids.shape[0]) - 1)
        except Exception:
            log.exception("prefix lookup failed for %s; cold prefill", self.name)
            self._prefix.misses += 1
            return 0, [], False
        return cached, shared, mode == "cow"

    async def _admit(self):
        # Swapped streams come back first: they were live before anything
        # still queued, and their pages restore without recompute.
        await self._try_swap_in()
        while self._free and self._pending:
            req = self._pending[0]
            try:
                ids = self._prompt_ids(req.sample)
            except Exception as e:  # bad sample fails only itself
                self._pending.popleft()
                req.finish(error=f"{type(e).__name__}: {e}")
                continue
            plen = int(ids.shape[0])
            try:
                aidx = self._aidx_of(req.sample)
            except Exception as e:  # a slot outside the pool fails only itself
                self._pending.popleft()
                req.finish(error=f"{type(e).__name__}: {e}")
                continue
            cached, shared, force_cow = (self._prefix_match(ids, aidx)
                                         if self._prefix is not None else (0, [], False))
            # Shared pages come free; only the uncached tail (and a CoW clone
            # when the hit ends mid-page, or of every shared page under the
            # cow chaos mode) needs fresh pages.
            need = self._mgr.blocks_for(plen + 1)
            partial = cached % self.block_size != 0
            fresh = need - (len(shared) - (1 if partial else 0))
            if force_cow:
                fresh += len(shared) - (1 if partial else 0)
            headroom = fresh + len(self._active)
            if self._mgr.free_blocks < headroom and self._prefix is not None:
                # Decayed prefix pages yield first, protecting the path this
                # admission is about to share.
                self._prefix.reclaim(headroom - self._mgr.free_blocks,
                                     protect=frozenset(shared))
            if self._mgr.free_blocks < headroom:
                # Anti-thrash headroom: without a spare page per live stream
                # an admission just turns into evict → re-prefill → evict.
                # Wait for a retire; decode extension still evicts when truly
                # out of room.
                break
            if not self._mgr.adopt(req, shared, cached):
                break  # max_blocks bounds need: not reached in practice
            # Clone every shared page prefill will write into: the hit's
            # partial tail page, and under the cow chaos mode every one.
            cow_pairs: list[tuple[int, int]] = []
            ok = True
            for i in (range(len(shared)) if (force_cow and shared)
                      else ([len(shared) - 1] if partial else ())):
                pair = self._mgr.cow(req, i)
                if pair is None:
                    ok = False
                    break
                cow_pairs.append(pair)
            if ok:
                ok = self._mgr.extend(req, plen + 1)
            if not ok:
                # Unwind: drop the sequence's refs AND the held CoW sources
                # (cow() pins src for the copy that now never runs), then
                # wait for a retire.
                self._mgr.free(req)
                for src, _ in cow_pairs:
                    self._mgr.decref(src)
                break
            if self._prefix is not None:
                self._prefix.cow_copies += len(cow_pairs)
            if cached and req.span is not None:
                req.span.point("prefix_hit", cached_tokens=cached)
            req.cached_tokens = cached
            self._pending.popleft()
            slot = self._free.pop()
            self._admit_counter += 1
            req.admit_seq = self._admit_counter
            req.slot = slot
            self._finished[slot] = True  # frozen until prefill completes
            draft_ok = False
            if self.draft is not None and not cached:
                # A prefix hit decodes plain: the draft's pool never
                # prefilled the skipped positions.
                cm = self.draft.acquire()
                if cm is not None:
                    self._draft_set(cm)
                    self.draft.release()
                    draft_ok = True
            req.has_draft = draft_ok
            self._prefilling.append(_PrefillJob(
                req=req, slot=slot, ids=ids, chunks=self._chunk_plan(plen, start=cached),
                knobs=self._knobs_of(req.sample), aidx=aidx, cached=cached, cow=cow_pairs))

    def _draft_set(self, draft_cm) -> PagedKernels:
        """The draft's kernel set on ``draft_cm`` (host side): made at first
        use with the target's pool layout and tables, and given a new graph
        set when the draft was demoted and restored since (its pool
        stays)."""
        if self._draft_kernels is None:
            self._draft_kernels = PagedKernels(draft_cm, self.block_size, self.num_blocks,
                                               self.spec_k)
        else:
            self._draft_kernels.rebind(draft_cm)
        return self._draft_kernels

    def _drop_cows(self, job: _PrefillJob):
        """Release a job's pinned copy-on-write source pages: after the copies
        landed, or when the job dies before its first chunk."""
        for src, _ in job.cow:
            self._mgr.decref(src)
        job.cow = []

    async def _prefill_tick(self):
        """At most ONE chunk dispatch: the head job's bucket groups every job
        at the same next-chunk size (burst admissions coalesce); the draft's
        chunk rides along when a job of the group prefills on it."""
        if not self._prefilling:
            return
        bucket = self._prefilling[0].chunks[self._prefilling[0].next][1]
        jobs = [j for j in self._prefilling if j.chunks[j.next][1] == bucket]
        cows = [pair for j in jobs for pair in j.cow]
        draft = None
        if self.draft is not None and any(j.req.has_draft for j in jobs):
            cm = self.draft.acquire()
            if cm is not None:
                draft = self._draft_set(cm)
            else:
                # The draft went away mid-prefill: these streams decode plain.
                for j in jobs:
                    j.req.has_draft = False
        t0 = time.perf_counter()
        try:
            first = await self._run(self._prefill_chunk_sync,
                                    self._chunk_payload(jobs, bucket), len(jobs), draft, cows)
        except Exception as e:
            log.exception("prefill chunk failed for %s", self.name)
            if self._cache_deleted():
                raise  # containment: _loop fails everyone and resets the pool
            for j in jobs:
                self._prefilling.remove(j)
                self._drop_cows(j)
                self._release(j.req, j.slot)
                j.req.finish(error=f"{type(e).__name__}: {e}")
            return
        finally:
            if draft is not None:
                self.draft.release()
        t1 = time.perf_counter()
        members = [j.req for j in jobs]
        for j in jobs:
            # The CoW copies landed with this dispatch.
            self._drop_cows(j)
            self._trace_admission(j.req, t0, t1, "prefill", members, chunk=j.next,
                                  chunks=len(j.chunks), bucket=bucket)
        for j, job in enumerate(jobs):
            job.next += 1
            if not job.done:
                continue
            self._prefilling.remove(job)
            req = job.req
            plen = int(job.ids.shape[0])
            self._tok[job.slot] = int(first[j])
            self._prev[job.slot] = int(job.ids[-1])
            self._pos[job.slot] = plen
            self._step[job.slot] = 0
            self._finished[job.slot] = False
            t, s, tk, tp = job.knobs
            self._temp[job.slot] = t
            self._seed[job.slot] = s
            self._topk[job.slot] = tk
            self._topp[job.slot] = tp
            self._aidx[job.slot] = job.aidx
            self._mgr.note_tokens(req, plen + 1)
            if self._prefix is not None:
                # Freeze the whole-prompt pages for the next matching prompt;
                # a failure here never fails the stream.
                try:
                    self._prefix.insert(job.aidx, job.ids, self._mgr.blocks_of(req))
                except Exception:
                    log.exception("prefix insert failed for %s (stream unaffected)",
                                  self.name)
            req.admitted = time.perf_counter()
            self._active[job.slot] = req

    # -- decode ---------------------------------------------------------------
    def _pick_victim(self, protect: GenRequest) -> GenRequest | None:
        """Evict the newest-admitted stream holding blocks (prefilling or
        active) but ``protect``, and requeue it first."""
        cands: list[tuple[int, GenRequest, int, bool]] = []
        for j in self._prefilling:
            cands.append((j.req.admit_seq, j.req, j.slot, True))
        for slot, req in self._active.items():
            if req is not protect:
                cands.append((req.admit_seq, req, slot, False))
        if not cands:
            return None
        _, req, slot, prefilling = max(cands, key=lambda c: c[0])
        if prefilling:
            job = next(j for j in self._prefilling if j.req is req)
            self._prefilling.remove(job)
            self._drop_cows(job)
        else:
            del self._active[slot]
            self._finished[slot] = True
            self._tok[slot] = self.eos_id
            if req.tokens:
                # The continuation prompt is the prompt and the tokens
                # emitted so far: the re-admitted prefill resumes the stream.
                req.sample = self._extend_sample(req.sample, req.tokens)
        self._release(req, slot)
        req.slot = None
        req.has_draft = False
        req.evictions += 1
        self._mgr.evictions += 1
        self._pending.appendleft(req)
        log_event(log, "kv eviction", model=self.name, tokens=len(req.tokens),
                  evictions=self._mgr.evictions)
        return req

    async def _ensure_blocks(self, span: int) -> None:
        """Every active stream gets blocks for its next ``span`` writes.  On
        exhaustion the pressure ladder runs: decayed prefix pages reclaim
        first (leaf-first, LRU), then (``kv_migrate``) the newest stream is
        swapped to host, and only then is the newest stream evicted; never
        the one being extended: the oldest always completes (the pool holds
        one max-length sequence)."""
        for slot in sorted(self._active):
            req = self._active.get(slot)
            if req is None:
                continue
            need = min(int(self._pos[slot]) + span, self.max_blocks * self.block_size)
            while not self._mgr.extend(req, need):
                if self._prefix is not None and self._prefix.reclaim(1) > 0:
                    continue
                if self.kv_migrate and await self._swap_out_newest(protect=req):
                    continue
                if self._pick_victim(protect=req) is None:
                    break
            self._mgr.note_tokens(req, need)

    def _spec_usable(self) -> tuple[PagedKernels | None, bool]:
        """(the draft's kernel set, corrupt?) when this tick can speculate,
        else (None, False): a draft configured and live, and every active
        stream prefilled on it.  A non-None set holds the draft (release
        it after the tick)."""
        if self.draft is None or not self._active or self._draft_kernels is None:
            return None, False
        if any(self._aidx[slot] for slot in self._active):
            # Adapter streams decode plain: the draft has no adapter stacks,
            # so its proposals would miss the tenant's distribution.
            self.spec_fallback_ticks += 1
            return None, False
        if not all(req.has_draft for req in self._active.values()):
            self.spec_fallback_ticks += 1
            return None, False
        cm = self.draft.acquire()
        if cm is None:
            self.spec_fallback_ticks += 1
            return None, False
        return self._draft_set(cm), self.runner.faults.on_spec(self.name)

    async def _decode_tick(self):
        if not self._active:
            return
        t_tick = time.perf_counter()
        draft, corrupt = self._spec_usable()
        try:
            await self._ensure_blocks(self.spec_k + 1 if draft is not None else self.seg)
            if not self._active:  # everyone evicted or swapped (a tiny pool)
                return
            self._seg_t0 = time.perf_counter()
            if draft is not None:
                n, out, props, (t0, t1, t2) = await self._run(
                    self._spec_tick_sync, draft, self._table_np(), corrupt)
                head = next((r for r in self._active.values() if r.span is not None), None)
                if head is not None:
                    head.span.child("spec_draft", start=t0, k=self.spec_k).end(end=t1)
                    head.span.child("spec_verify", start=t1).end(end=t2)
                emitted_total = self._distribute_spec(n, out, props)
            else:
                emits = await self._run(self._segment_sync, self._table_np())
                emitted_total = self._distribute(emits)
        finally:
            if draft is not None:
                self.draft.release()
        if emitted_total:
            dt = (time.perf_counter() - t_tick) / emitted_total
            self._s_per_token = (0.7 * self._s_per_token + 0.3 * dt
                                 if self._s_per_token else dt)

    # -- emit fan-out ---------------------------------------------------------
    def _retire(self, slot: int, req: GenRequest):
        self._finished[slot] = True
        self._tok[slot] = self.eos_id
        del self._active[slot]
        self._release(req, slot)
        if self.ring is not None:
            total_ms = (time.perf_counter() - req.submitted) * 1000
            queue_ms = (req.admitted - req.submitted) * 1000
            self.ring.record(queue_ms, total_ms - queue_ms, total_ms)
        req.finish()
        log_event(log, "generation finished", model=self.name, slot=slot,
                  tokens=len(req.tokens), paged=True,
                  **({"spec_accepted": req.spec_accepted, "spec_proposed": req.spec_proposed}
                     if req.spec_proposed else {}))

    def _fan_tokens(self, slot: int, req: GenRequest, toks: list[int]) -> int:
        """Feed a tick's tokens to one request, retiring it on EOS or budget;
        returns how many streamed."""
        had_tokens = bool(req.tokens)
        n_before = len(req.tokens)
        finished = False
        for t in toks:
            finished = self._emit(req, int(t))
            if finished:
                break
        if not had_tokens and req.tokens:
            self._note_first_segment(req)
        if finished:
            self._retire(slot, req)
        return len(req.tokens) - n_before

    def _distribute(self, emits: np.ndarray) -> int:
        total = 0
        for slot, req in list(self._active.items()):
            total += self._fan_tokens(slot, req, [int(t) for t in emits[slot]])
        if (self._free and self._pending) or self._prefilling:
            self._wake.set()
        return total

    def _distribute_spec(self, n: np.ndarray, out: np.ndarray, props: np.ndarray) -> int:
        """A speculative tick's fan-out: each row emits its pending token and
        the accepted proposals, and carries the corrected or bonus token as
        its next pending one."""
        total = 0
        k = props.shape[1]
        for slot, req in list(self._active.items()):
            n_s = int(n[slot])
            req.spec_proposed += k
            req.spec_accepted += n_s
            self.spec_proposed += k
            self.spec_accepted += n_s
            toks = [int(self._tok[slot])] + [int(t) for t in props[slot, :n_s]]
            self._prev[slot] = toks[-1]
            self._tok[slot] = int(out[slot, n_s])
            self._pos[slot] += n_s + 1
            self._step[slot] += n_s + 1
            self._mgr.note_tokens(req, int(self._pos[slot]))
            total += self._fan_tokens(slot, req, toks)
        if (self._free and self._pending) or self._prefilling:
            self._wake.set()
        return total

    def _cache_deleted(self) -> bool:
        return self.kernels.torn

    # -- live KV migration ----------------------------------------------------
    # The primitives move a decoding stream: pause it at a tick boundary,
    # copy its pages, resume it from copied pages, on this pool (the swap
    # under pressure) or on another server's (the export and import the
    # server drives over HTTP).  Every state change happens in the loop
    # task: callers outside it go through the migrate_* commands; the swap
    # runs from _ensure_blocks, already inside.

    def _npages(self, pos: int) -> int:
        """Pages holding written KV for positions [0, pos)."""
        return -(-int(pos) // self.block_size)

    def _pause_stream(self, req: GenRequest) -> dict:
        """Detach an active stream at a tick boundary: its slot released, its
        pages kept in the manager, its sampler state returned (the state
        and the pages resume it exactly: the draws depend on (seed, step),
        not on the slot)."""
        slot = req.slot
        state = {"tok": int(self._tok[slot]), "pos": int(self._pos[slot]),
                 "step": int(self._step[slot]), "prev": int(self._prev[slot]),
                 "temp": float(self._temp[slot]), "seed": int(self._seed[slot]),
                 "top_k": int(self._topk[slot]), "top_p": float(self._topp[slot]),
                 "aidx": int(self._aidx[slot])}
        self._finished[slot] = True
        self._aidx[slot] = 0
        self._tok[slot] = self.eos_id
        del self._active[slot]
        self._free.append(slot)
        req.slot = None
        req.has_draft = False
        return state

    def _place_stream(self, req: GenRequest, state: dict, slot: int):
        """Seat a paused or imported stream's state in a free slot."""
        self._tok[slot] = state["tok"]
        self._pos[slot] = state["pos"]
        self._step[slot] = state["step"]
        self._prev[slot] = state["prev"]
        self._temp[slot] = state["temp"]
        self._seed[slot] = state["seed"]
        self._topk[slot] = state["top_k"]
        self._topp[slot] = state["top_p"]
        self._aidx[slot] = int(state.get("aidx", 0))
        self._finished[slot] = False
        req.slot = slot
        self._active[slot] = req

    async def _swap_out_newest(self, protect: GenRequest) -> bool:
        """Swap the newest active stream but ``protect`` to host instead of
        evicting it: it pauses, nothing recomputes, and it resumes from its
        own pages when pages free.  A prefilling job keeps the eviction
        path (it holds no finished KV worth copying)."""
        cands = [(req.admit_seq, slot) for slot, req in self._active.items()
                 if req is not protect]
        if not cands:
            return False
        _, slot = max(cands)
        return await self._swap_out(self._active[slot])

    async def _swap_out(self, req: GenRequest) -> bool:
        mode, lat_s = self.runner.faults.on_migration(self.name)
        if lat_s:
            await asyncio.sleep(lat_s)
        if mode == "drop":
            # The injected drop: abort before any state moves; the ladder
            # falls back to eviction.
            self.migration.failed += 1
            return False
        t0 = time.perf_counter()
        ids = self._prompt_ids(req.sample)
        state = self._pause_stream(req)
        npages = self._npages(state["pos"])
        blocks = self._mgr.blocks_of(req)[:npages]
        try:
            pages = await self._run(self._gather_pages_sync, blocks)
            if mode == "corrupt":
                # Page 0 through the wire pack with a flipped byte: the hash
                # must catch it, and the clean retry reads the pages again
                # (the source pages are still there).
                try:
                    unpack_page(pack_page(0, *pages[0], corrupt=True), self.page_shape,
                                self.cache_dtype)
                except PageIntegrityError:
                    pages = await self._run(self._gather_pages_sync, blocks)
        except Exception:
            if self._cache_deleted():
                raise  # containment: the loop fails everyone and resets
            # The read failed but the pool is whole: resume in place (the
            # slot the pause freed is still free).
            self._place_stream(req, state, self._free.pop())
            self.migration.failed += 1
            log.exception("swap to host failed for %s; the stream resumed", self.name)
            return False
        self._mgr.free(req)
        self._swapped.append({"req": req, "state": state, "ids": ids, "npages": npages,
                              "pages": dict(enumerate(pages))})
        req.migrations += 1
        self.migration.note("pressure", 0, npages, (time.perf_counter() - t0) * 1000.0)
        if req.span is not None:
            req.span.point("migrate_export", cause="pressure", pages=npages)
        log_event(log, "kv migrate-out", model=self.name, tokens=len(req.tokens), pages=npages)
        return True

    async def _try_swap_in(self):
        """Bring swapped streams back, oldest first, when the pool can hold
        them again (the admission's anti-thrash headroom)."""
        while self._swapped and self._free:
            rec = self._swapped[0]
            need = rec["npages"] + 1 + len(self._active)
            if self._mgr.free_blocks < need and self._prefix is not None:
                self._prefix.reclaim(need - self._mgr.free_blocks)
            if self._mgr.free_blocks < need:
                break
            self._swapped.popleft()
            req = rec["req"]
            try:
                hits, _ = await self._attach_stream(req, rec["ids"], rec["state"],
                                                    rec["pages"])
            except MigrationError:
                self._swapped.appendleft(rec)
                break
            if req.span is not None:
                req.span.point("migrate_import", cause="pressure", pages=rec["npages"],
                               dedup_hits=hits)
            log_event(log, "kv migrate-in", model=self.name, tokens=len(req.tokens),
                      pages=rec["npages"], dedup_hits=hits)

    async def _attach_stream(self, req: GenRequest, ids: np.ndarray, state: dict,
                             page_map: dict) -> tuple[int, int]:
        """Restore a stream's pages and state into this pool; returns
        ``(dedup_hits, pages_copied)``.

        Pages wholly covered by prompt tokens resolve through the local
        prefix tree first (adopted, not copied); the rest come from
        ``page_map`` by value.  Raises :class:`MigrationError` (or
        :class:`MigrationNeedsPages`) with no state changed when the pool
        cannot take the stream now."""
        if not self._free:
            raise MigrationError("no free decode slot")
        pos = int(state["pos"])
        aidx = int(state.get("aidx", 0))
        npages = self._npages(pos)
        shared: list[int] = []
        if self._prefix is not None:
            try:
                c, blocks = self._prefix.lookup(aidx, ids, max_tokens=int(ids.shape[0]))
                shared = blocks[:min(c // self.block_size, npages)]
            except Exception:
                shared = []
        missing = [i for i in range(len(shared), npages) if i not in page_map]
        if missing:
            raise MigrationNeedsPages(f"import needs {len(missing)} page values", missing)
        if not self._mgr.adopt(req, shared, len(shared) * self.block_size):
            raise MigrationError("per-stream page table cap exceeded")
        ok = self._mgr.extend(req, pos + 1)
        if not ok and self._prefix is not None:
            self._prefix.reclaim(npages, protect=frozenset(shared))
            ok = self._mgr.extend(req, pos + 1)
        if not ok:
            self._mgr.free(req)
            raise MigrationError("kv pool exhausted")
        table = self._mgr.blocks_of(req)
        pairs = [(table[i], *page_map[i]) for i in range(len(shared), npages)]
        try:
            if pairs:
                await self._run(self._scatter_pages_sync, pairs)
        except Exception:
            if self._cache_deleted():
                raise
            self._mgr.free(req)
            raise
        self._mgr.note_tokens(req, pos)
        self._place_stream(req, state, self._free.pop())
        self._admit_counter += 1
        req.admit_seq = self._admit_counter
        req.has_draft = False
        if req.admitted is None:
            req.admitted = time.perf_counter()
        if self._prefix is not None:
            # Freeze the restored prompt pages, so the next matching prompt
            # (or a later move of this stream) dedupes against them.
            try:
                self._prefix.insert(aidx, ids, self._mgr.blocks_of(req))
            except Exception:
                log.exception("prefix insert after migration failed for %s (stream "
                              "unaffected)", self.name)
        return len(shared), npages - len(shared)

    # -- export and import commands (serving/server.py drives these) ---------
    def migrate_snapshot(self, req: GenRequest) -> asyncio.Future:
        return self._run_cmd(lambda: self._cmd_snapshot(req))

    def migrate_cutover(self, req: GenRequest, have_idx=()) -> asyncio.Future:
        return self._run_cmd(lambda: self._cmd_cutover(req, have_idx))

    def migrate_pages(self, req: GenRequest, indices) -> asyncio.Future:
        return self._run_cmd(lambda: self._cmd_pages(req, indices))

    def migrate_commit(self, req: GenRequest, cause: str = "admin") -> asyncio.Future:
        return self._run_cmd(lambda: self._cmd_commit(req, cause))

    def migrate_abort(self, req: GenRequest) -> asyncio.Future:
        return self._run_cmd(lambda: self._cmd_abort(req))

    def migrate_import(self, ids, emitted, state, page_map, max_new: int | None = None,
                       cause: str = "admin", span=None, aidx: int = 0) -> asyncio.Future:
        return self._run_cmd(lambda: self._cmd_import(ids, emitted, state, page_map, max_new,
                                                      cause, span, aidx))

    async def _cmd_snapshot(self, req: GenRequest) -> dict:
        """Export phase 1: read the stream's complete pages while it keeps
        decoding; pages below the write frontier never change again, so only
        the frontier page (and what decode writes meanwhile) is left for
        the cutover."""
        slot = req.slot
        if slot is None or self._active.get(slot) is not req:
            raise MigrationError("stream is not active (still prefilling, finished, or "
                                 "already detached)")
        pos = int(self._pos[slot])
        frontier = pos // self.block_size
        blocks = self._mgr.blocks_of(req)[:frontier]
        pages = await self._run(self._gather_pages_sync, blocks) if blocks else []
        return {"pages": dict(enumerate(pages)), "frontier": frontier, "pos": pos}

    async def _cmd_cutover(self, req: GenRequest, have_idx) -> dict:
        """Export phase 2: pause the stream at this tick boundary and read
        every page the importer lacks.  The stream stays detached (its
        pages in the pool) until the commit or the abort, so a failed import
        can resume it in place."""
        slot = req.slot
        if slot is None or self._active.get(slot) is not req:
            raise MigrationError("stream is not active")
        ids = self._prompt_ids(req.sample)
        state = self._pause_stream(req)
        npages = self._npages(state["pos"])
        have = {int(i) for i in (have_idx or ())}
        want = [i for i in range(npages) if i not in have]
        blocks = self._mgr.blocks_of(req)
        try:
            pages = (await self._run(self._gather_pages_sync, [blocks[i] for i in want])
                     if want else [])
        except Exception:
            if self._cache_deleted():
                raise
            self._place_stream(req, state, self._free.pop())
            raise
        self._detached[req] = {"state": state, "npages": npages, "ids": ids}
        if req.span is not None:
            req.span.point("migrate_export", cause="admin", pages=npages,
                           delta_pages=len(want))
        # The wire state leaves the slot out: the importer resolves the
        # adapter by name to its own slot.
        return {"state": {k: v for k, v in state.items() if k != "aidx"}, "ids": ids,
                "aidx": state["aidx"], "npages": npages,
                "pages": dict(zip(want, pages)), "emitted": list(req.tokens),
                "max_new": req.max_new}

    async def _cmd_pages(self, req: GenRequest, indices) -> dict:
        """Read given pages of a detached stream again, by value: the
        importer's retry after a failed integrity check."""
        rec = self._detached.get(req)
        if rec is None:
            raise MigrationError("stream is not detached")
        blocks = self._mgr.blocks_of(req)
        want = [int(i) for i in indices]
        for i in want:
            if not 0 <= i < rec["npages"]:
                raise MigrationError(f"page index {i} out of range")
        pages = await self._run(self._gather_pages_sync, [blocks[i] for i in want])
        return {"pages": dict(zip(want, pages))}

    async def _cmd_commit(self, req: GenRequest, cause: str) -> int:
        """Export phase 3: the importer has the stream.  Free its pages and
        end the source stream marked ``migrated`` (the SSE writer ends it
        with a terminal migrated event, no token lost); returns the
        watermark (tokens the source streamed)."""
        rec = self._detached.pop(req, None)
        if rec is None:
            raise MigrationError("stream is not detached")
        self._mgr.free(req)
        req.migrated = True
        req.migrations += 1
        self.migration.by_cause[cause] = self.migration.by_cause.get(cause, 0) + 1
        watermark = len(req.tokens)
        req.finish(error="stream migrated to another replica")
        log_event(log, "stream migrated out", model=self.name, cause=cause,
                  watermark=watermark, pages=rec["npages"])
        return watermark

    async def _cmd_abort(self, req: GenRequest) -> bool:
        """The import failed: resume the detached stream in place (the pause
        cost a tick of stall and nothing else)."""
        rec = self._detached.pop(req, None)
        if rec is None:
            raise MigrationError("stream is not detached")
        if not self._free:
            self._detached[req] = rec
            raise MigrationError("no free slot to reattach")
        self._place_stream(req, rec["state"], self._free.pop())
        self.migration.failed += 1
        log_event(log, "migration aborted; stream resumed in place", model=self.name)
        return True

    async def _cmd_import(self, ids, emitted, state, page_map, max_new, cause, span,
                          aidx: int = 0) -> tuple:
        """Create a stream from exported state: the import half of the
        protocol.  The emitted history preloads ``tokens`` and never enters
        the event queue (``emitted_base`` marks where this lane's stream
        starts), so an attach replays it without duplicates.  ``aidx`` is
        the stream's adapter slot on this replica (0: the base)."""
        t0 = time.perf_counter()
        ids = np.ascontiguousarray(ids, np.int32).reshape(-1)
        state = {**state, "aidx": int(aidx)}
        sample = {"input_ids": ids, "temperature": float(state["temp"]),
                  "seed": int(state["seed"]), "top_k": int(state["top_k"]),
                  "top_p": float(state["top_p"])}
        if aidx:
            sample["adapter_idx"] = np.int32(aidx)
        want = self.max_new if max_new is None else max(1, min(int(max_new), self.max_new))
        req = GenRequest(sample=sample, max_new=want, rounds_at_submit=self.device_rounds,
                         segments_at_submit=self.segment_rounds, span=span)
        req.tokens = [int(t) for t in emitted]
        req.emitted_base = len(req.tokens)
        req.migrations = 1
        hits, copied = await self._attach_stream(req, ids, state, page_map)
        req.cached_tokens = hits * self.block_size
        self.migration.note(cause, hits, copied, (time.perf_counter() - t0) * 1000.0)
        if req.span is not None:
            req.span.point("migrate_import", cause=cause, pages=self._npages(int(state["pos"])),
                           dedup_hits=hits)
        log_event(log, "stream migrated in", model=self.name, cause=cause,
                  emitted=req.emitted_base, dedup_hits=hits, copied=copied)
        if len(req.tokens) >= req.max_new:
            # Exported at its budget's edge: retire now.
            self._retire(req.slot, req)
        self._wake.set()
        return req, hits, copied
