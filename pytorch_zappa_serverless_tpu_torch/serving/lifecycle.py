"""Serverless model residency: lazy activation, scale-to-zero, the HBM budget.

The port's copy of the JAX package's ``serving/lifecycle.py``.  Per model:

    COLD ──ensure_active──▶ WARMING ──build/restore──▶ ACTIVE
      ▲                                                  │ idle_unload_s
      └───────────── demote ◀── DRAINING_IDLE ◀──────────┘

plus **PINNED** (never demoted, built at boot even under ``lazy_load``).
Each non-active model sits on a tier that prices its re-activation:

- ``device``: ACTIVE; weights on the card, every bucket's CUDA graph
  captured.
- ``host``: the weights in pinned host memory, the device copies and every
  graph (and its pool) released.  Re-activation is one host-to-device copy
  plus a capture of every bucket.
- ``disk``: the weights in the streaming checkpoint store
  (``serving/ckptstore.py``, with ``ckpt_store_dir``), the host copy
  freed.  Re-activation streams the chunks through pinned staging onto the
  card (``engine.streamio.device_placer``), then captures.
- ``none``: nothing kept.  Re-activation is a full build and its captures.
  When the store holds the model, its weights stream on a background thread
  while the servable builds and captures on the seed weights, and are then
  copied in place under the captured addresses before the first replay.

Where the port differs from the reference, and why:

- **Graphs go with the weights.**  On the TPU a restore is a device_put
  with zero recompiles.  Here every captured graph holds the addresses of
  the weights it read, so a demotion releases the graphs and their pools
  (a released graph refuses to replay) and every restore captures again.
- **No persistent compile cache.**  The port keeps none, so the ``none``
  tier is a full build plus captures, and the activation estimate has no
  warm-cache discount.
- **Device work only on the dispatch thread.**  The reference builds in the
  loop's executor while other models serve.  Here a capture synchronizes
  the device, empties the allocator's cache and refuses other threads'
  CUDA calls, so restores, builds and captures run on the runner's
  dispatch thread (``runner.run_held``, which marks the thread as held, so
  /healthz answers during them and names the hold); the activation's
  executor thread does the host work around them (seed init and
  quantization, the stream's reads, the store's writes).  The one other
  thread that touches the card, a stream placing weights during a build, holds
  ``engine.compiled.CAPTURE_LOCK`` for each tensor, as every capture does.

Mechanisms, as in the reference: single-flight activation (N concurrent
cold callers share one build), deadline-aware cold admission
(:class:`ColdStart` → 503 ``cold_start`` + ``Retry-After`` +
``estimated_warm_ms``), the idle reaper, the HBM and host budgets (LRU
first; pinned and busy models never demote), ``pin``/``unpin``/``unload``,
``rebind`` after an engine rebuild, activation histograms and per-cause
counters.  ``faults.py`` rules with ``kind="activation"`` fail the build
path and ``kind="ckpt"`` tear or slow the stream.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..config import ServeConfig
from ..utils.aio import cancel_and_wait
from ..utils.logging import get_logger, log_event
from .metrics import Histogram

log = get_logger("serving.lifecycle")

COLD = "cold"
WARMING = "warming"
ACTIVE = "active"
DRAINING_IDLE = "draining_idle"

# The tpuserve_residency_state gauge; PINNED reports its own code.
STATE_CODE = {COLD: 0, WARMING: 1, ACTIVE: 2, DRAINING_IDLE: 3, "pinned": 4}

# Activation times span a host restore's fraction of a second to a
# multi-second build: wider bounds than the request histograms.
ACTIVATION_BUCKETS_MS = (50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                         10000.0, 30000.0, 60000.0, 120000.0, 300000.0)


class ColdStart(Exception):
    """The model is not resident and the request cannot (or will not) wait:
    HTTP 503 with ``Retry-After`` and ``estimated_warm_ms``, while the
    single-flight activation goes on in the background."""

    def __init__(self, msg: str, estimated_warm_ms: float, retry_after_s: float):
        super().__init__(msg)
        self.estimated_warm_ms = estimated_warm_ms
        self.retry_after_s = retry_after_s


@dataclass
class ModelResidency:
    """One model's lifecycle record: state, tier, LRU clock, learned costs."""

    name: str
    # Event-loop-confined; ``lock`` serializes multi-step transitions.
    state: str = COLD               # guarded-by: event-loop
    tier: str = "none"              # guarded-by: event-loop
    pinned: bool = False            # guarded-by: event-loop
    last_used: float = 0.0          # guarded-by: event-loop
    activations: int = 0            # guarded-by: event-loop
    last_activation_ms: float | None = None  # guarded-by: event-loop
    cold_fast_fails: int = 0        # guarded-by: event-loop
    # The last activation's split: load_ms (host-to-device copy, stream or
    # build on the host) and compile_ms (the captures, or the device build).
    last_activation_phases: dict | None = None  # guarded-by: event-loop
    # Requests inside a handler for this model: demotion waits them out.
    inflight: int = 0               # guarded-by: event-loop
    # The CompiledModel kept on the host and disk tiers, awaiting restore.
    cm_host: Any = None             # guarded-by: event-loop
    # The last demotion from the device: its tier, cause, copy ms, and the
    # allocated and reserved device bytes it freed.
    last_demotion: dict | None = None  # guarded-by: event-loop
    # Recent activation ms by the tier activated FROM: the learned half of
    # estimate_warm_ms.
    history: dict[str, deque] = field(default_factory=dict)
    lock: asyncio.Lock = field(default_factory=asyncio.Lock)

    def note_activation(self, from_tier: str, ms: float):
        self.activations += 1
        self.last_activation_ms = round(ms, 3)
        self.history.setdefault(from_tier, deque(maxlen=8)).append(ms)


def _device_memory(device) -> tuple[int, int]:
    """(allocated, reserved) bytes of the caching allocator; 0s on the CPU."""
    if device.type != "cuda":
        return 0, 0
    return torch.cuda.memory_allocated(device), torch.cuda.memory_reserved(device)


def _demote_on_device(cm, keep_host: bool, device) -> dict:
    """One dispatch-thread call: the model's device copies go (into pinned
    host memory with ``keep_host``), the allocator's cache is emptied (a
    demoted model's graph pools with it), and what that freed is measured
    around it, no other device work between."""
    allocated, reserved = _device_memory(device)
    if keep_host:
        out = cm.host_offload() or {}
    else:
        cm.release()
        out = {}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    after = _device_memory(device)
    return {**out, "freed_allocated": allocated - after[0], "freed_reserved": reserved - after[1]}


class LifecycleManager:
    """The server's residency manager (one, started at server start).

    ``build_fn(name, from_tier, host_cm) -> CompiledModel`` is the blocking
    activation body (it runs in the loop's executor and sends its device
    work to the dispatch thread); tests inject a fake.  ``clock`` is the
    idle and LRU clock (monotonic seconds), injectable so idle tests do not
    sleep.
    """

    def __init__(self, server, cfg: ServeConfig, *, build_fn: Callable | None = None,
                 clock: Callable[[], float] = time.monotonic, store: Any = None):
        self.server = server
        self.cfg = cfg
        self.clock = clock
        self._build_fn = build_fn or self._default_build
        # The streaming checkpoint store: the disk tier and the stream during
        # a cold build.  None keeps the ladder device → host → none.
        self.store = store if store is not None else getattr(server, "ckpt_store", None)
        # The build's phase split, written on the executor thread and popped
        # by _activate on the loop.
        self._phases_lock = threading.Lock()
        self._build_phases: dict[str, dict] = {}  # guarded-by: _phases_lock
        self._models: dict[str, ModelResidency] = {}  # guarded-by: event-loop
        self._activating: dict[str, asyncio.Task] = {}  # guarded-by: event-loop
        self._activation_started: dict[str, float] = {}  # guarded-by: event-loop
        self.activation_hists: dict[str, Histogram] = {}  # guarded-by: event-loop
        self.activations_by_cause: dict[str, dict[str, int]] = {}  # guarded-by: event-loop
        self.demotions_by_cause: dict[str, dict[str, int]] = {}  # guarded-by: event-loop
        self._task: asyncio.Task | None = None  # guarded-by: event-loop
        self._over_budget_warned = False  # guarded-by: event-loop
        # The autoscaler's learned keep-warm window per model
        # (serving/autoscale.py), consulted by the reaper in place of
        # idle_unload_s; None answers (thin history) keep the fixed timer.
        self.keepwarm_fn: Callable | None = None  # guarded-by: event-loop
        now = self.clock()
        engine = server.engine
        for mc in cfg.models:
            res = self._models[mc.name] = ModelResidency(name=mc.name, pinned=mc.pinned,
                                                         last_used=now)
            if engine is not None and mc.name in engine.models:
                res.state, res.tier = ACTIVE, "device"
                boot_s = engine.build_seconds.get(mc.name)
                if boot_s:
                    self._record_activation(mc.name, "boot", boot_s * 1000.0, "none")

    # -- plumbing ------------------------------------------------------------
    def start(self):
        if self._task is None and (self.cfg.idle_unload_s > 0 or self.cfg.hbm_budget_bytes > 0
                                   or self.cfg.host_budget_bytes > 0):
            self._task = asyncio.get_running_loop().create_task(self._loop(), name="lifecycle")
        return self

    async def stop(self):
        await cancel_and_wait(self._task)
        self._task = None

    @property
    def names(self):
        return self._models.keys()

    def knows(self, name: str) -> bool:
        return name in self._models

    def residency(self, name: str) -> ModelResidency | None:
        return self._models.get(name)

    def state_of(self, name: str) -> str | None:
        res = self._models.get(name)
        return res.state if res is not None else None

    def note_use(self, name: str):
        """Touch the LRU clock (every work request or submit)."""
        res = self._models.get(name)
        if res is not None:
            res.last_used = self.clock()

    def enter(self, name: str):
        """Open a handler's in-flight window: demotion waits it out."""
        res = self._models.get(name)
        if res is not None:
            res.inflight += 1
            res.last_used = self.clock()

    def exit(self, name: str):
        res = self._models.get(name)
        if res is not None:
            res.inflight -= 1
            res.last_used = self.clock()

    def _busy(self, name: str) -> bool:
        """In-flight work anywhere for this model: the never-evict gate."""
        if self._models[name].inflight > 0:
            return True
        srv = self.server
        b = srv.batchers.get(name)
        if b is not None and (b.queue_depth or b.in_flight):
            return True
        s = srv.schedulers.get(name)
        if s is not None and (s.active or s.depth):
            return True
        jobs = getattr(srv, "jobs", None)
        return bool(jobs is not None and jobs.depths.get(name))

    def _set_phases(self, name: str, phases: dict):
        with self._phases_lock:
            self._build_phases[name] = phases

    # -- activation cost model ----------------------------------------------
    def estimate_warm_ms(self, name: str) -> float:
        """Expected activation ms from the model's current tier: the median
        of this process's recent activations from that tier; else a prior
        for the host (250 ms) and disk (1000 ms) tiers; else the model's
        capture seconds on the clock plus 500 ms; else
        ``activation_estimate_ms``."""
        res = self._models[name]
        tier = res.tier if res.tier in ("host", "disk", "none") else "none"
        hist = res.history.get(tier)
        if hist:
            ordered = sorted(hist)
            return float(ordered[len(ordered) // 2])
        if tier == "host":
            return 250.0
        if tier == "disk":
            return 1000.0
        engine = self.server.engine
        if engine is not None:
            per = engine.clock.per_model().get(name)
            if per and per["seconds"]:
                return per["seconds"] * 1000.0 + 500.0
        return float(self.cfg.activation_estimate_ms)

    def _retry_after_s(self, name: str, est_ms: float) -> float:
        """Seconds until the running (or about to run) activation should have
        the model warm."""
        started = self._activation_started.get(name)
        elapsed = (self.clock() - started) if started is not None else 0.0
        return max(est_ms / 1000.0 - elapsed, 1.0)

    # -- activation ----------------------------------------------------------
    async def ensure_active(self, name: str, *, deadline_ms: float | None = None,
                            cause: str = "request", wait: bool = True):
        """Admission: the ACTIVE CompiledModel, activating on demand.

        Single-flight: concurrent callers share one activation task.  With a
        deadline the call waits within it (the estimate fits) or raises
        :class:`ColdStart` (the activation goes on in the background);
        without one it waits up to ``activation_max_wait_s``.
        """
        res = self._models[name]  # KeyError: the caller's 404
        res.last_used = self.clock()
        engine = self.server.engine
        if res.state == ACTIVE and name in engine.models:
            return engine.models[name]
        task = self._activating.get(name)
        if task is None or task.done():
            task = asyncio.get_running_loop().create_task(self._activate(name, cause),
                                                          name=f"activate-{name}")
            # Fast-fail callers never await it: retrieve the exception so a
            # failed activation does not warn as unretrieved.
            task.add_done_callback(lambda t: t.exception() if not t.cancelled() else None)
            self._activating[name] = task
        est = self.estimate_warm_ms(name)
        if deadline_ms is not None and est > deadline_ms:
            res.cold_fast_fails += 1
            raise ColdStart(f"model {name!r} is {res.state} (activation estimated {est:.0f} ms "
                            f"exceeds the {deadline_ms:.0f} ms deadline); warming in the "
                            "background", estimated_warm_ms=est,
                            retry_after_s=self._retry_after_s(name, est))
        wait_s = deadline_ms / 1000.0 if deadline_ms is not None else self.cfg.activation_max_wait_s
        if not wait or wait_s <= 0:
            res.cold_fast_fails += 1
            raise ColdStart(f"model {name!r} is {res.state}; warming in the background",
                            estimated_warm_ms=est, retry_after_s=self._retry_after_s(name, est))
        try:
            await asyncio.wait_for(asyncio.shield(task), timeout=wait_s)
        except (asyncio.TimeoutError, TimeoutError):
            res.cold_fast_fails += 1
            est = self.estimate_warm_ms(name)
            raise ColdStart(f"model {name!r} still {res.state} after waiting {wait_s:.1f} s "
                            "for activation", estimated_warm_ms=est,
                            retry_after_s=self._retry_after_s(name, max(est, 1000.0))) from None
        return self.server.engine.model(name)

    async def _activate(self, name: str, cause: str):
        """The single-flight activation body: WARMING → build → ACTIVE."""
        res = self._models[name]
        loop = asyncio.get_running_loop()
        async with res.lock:  # waits out a demotion in progress
            if res.state == ACTIVE and name in self.server.engine.models:
                self._activating.pop(name, None)
                return
            self._activation_started[name] = self.clock()
            from_tier = res.tier if res.tier in ("host", "disk") else "none"
            res.state = WARMING
            # Each activation is a trace of its own (GET /admin/trace): an
            # "activate" root, its load and capture phases as children.
            tracer = getattr(self.server, "tracer", None)
            root = (tracer.start("activate", model=name, cause=cause, tier=from_tier)
                    if tracer is not None else None)
            t0 = time.perf_counter()
            try:
                cm = await loop.run_in_executor(None, self._build_fn, name, from_tier,
                                                res.cm_host)
            except BaseException as e:
                if root is not None:
                    root.annotate(error=f"{type(e).__name__}: {e}")
                    tracer.finish(root.trace, "error")
                res.state = COLD
                if getattr(res.cm_host, "tier", res.tier) not in ("host", "disk"):
                    # A restore that failed part-way leaves no tier to retry.
                    res.cm_host, res.tier = None, "none"
                self._activating.pop(name, None)
                self._activation_started.pop(name, None)
                with self._phases_lock:
                    self._build_phases.pop(name, None)
                log_event(log, "activation failed", model=name, cause=cause,
                          error=f"{type(e).__name__}: {e}")
                raise
            ms = (time.perf_counter() - t0) * 1000.0
            engine = self.server.engine
            engine.attach(name, cm)
            res.cm_host = None
            res.tier = "device"
            with self._phases_lock:
                phases = self._build_phases.pop(name, None)
            res.last_activation_phases = (
                {k: (round(v, 3) if isinstance(v, float) else v) for k, v in phases.items()}
                if phases else None)
            if root is not None:
                t = t0
                for key, span_name in (("load_ms", "load_weights"), ("compile_ms", "compile")):
                    if phases and isinstance(phases.get(key), float):
                        root.child(span_name, start=t).end(end=t + phases[key] / 1e3)
                        t += phases[key] / 1e3
                tracer.finish(root.trace, "ok")
            self.server._start_model_lanes(name)
            res.state = ACTIVE
            res.last_used = self.clock()
            self._record_activation(name, cause, ms, from_tier)
            self._activating.pop(name, None)
            self._activation_started.pop(name, None)
            log_event(log, "model activated", model=name, cause=cause, tier_from=from_tier,
                      ms=round(ms, 1), hbm_bytes=engine.runner.resident_bytes().get(name))
        await self.enforce_budget(exclude=name)
        # Device evictions land on the host tier: cascade the rung below.
        await self.enforce_host_budget()

    def _default_build(self, name: str, from_tier: str, host_cm):
        """The blocking activation body (executor thread): restore or build.

        Device work (the copies, the build, the captures) goes to the
        dispatch thread; the host work around it stays here.  The
        ``kind="activation"`` chaos hook fires first (a failed activation
        leaves the model COLD).  A broken disk stream (torn chunks past the
        re-read, a missing chunk or manifest) degrades to the full rebuild,
        never a dead activation.  Fills the phase split for
        ``last_activation_phases``.
        """
        from ..engine import streamio
        from ..engine.loader import build_model, build_servable
        from ..engine.weights import flatten_tree
        from .ckptstore import checkpoint_fingerprint

        engine = self.server.engine
        runner = engine.runner
        runner.faults.on_activation(name)
        phases: dict[str, Any] = {"tier": from_tier}
        if from_tier == "host" and host_cm is not None:
            t = runner.run_held(f"restore {name}", host_cm.device_restore)
            phases.update(load_ms=t["h2d_ms"], compile_ms=t["capture_ms"])
            self._set_phases(name, phases)
            return host_cm
        store = self.store
        stream_failed = False  # a broken stream this activation stays broken
        if from_tier == "disk" and host_cm is not None and store is not None:
            try:
                params, stats = store.load(name, place_fn=streamio.device_placer(engine.device))
                t = runner.run_held(f"restore {name}", host_cm.disk_restore, lambda: params)
                del params
                phases.update(load_ms=stats.load_ms, compile_ms=t["capture_ms"], streamed=True,
                              chunks_streamed=stats.chunks_streamed)
                self._set_phases(name, phases)
                return host_cm
            except Exception as e:
                stream_failed = True
                store.note_degraded()
                log_event(log, "disk-tier stream failed; degrading to a full rebuild",
                          model=name, error=f"{type(e).__name__}: {e}")
                phases = {"tier": from_tier}
        mc = self.cfg.model(name)
        # A manifest staged from an older checkpoint file reads as a miss, or
        # a restart after a checkpoint swap would stream stale weights.
        ckpt_fp = checkpoint_fingerprint(mc.checkpoint)
        # Stream while building: with the model in the store, its weights
        # stream on a thread while the servable builds and captures on its
        # seed weights; they are then copied in place under the captured
        # addresses, before the first replay.
        stream_th = None
        stream_box: list = []
        if store is not None and not stream_failed and store.has(name, fingerprint=ckpt_fp):
            def _pull():
                t = time.perf_counter()
                try:
                    params, stats = store.load(
                        name, place_fn=streamio.device_placer(engine.device))
                    stream_box.append(("ok", params, (time.perf_counter() - t) * 1000.0,
                                       stats.chunks_streamed))
                except Exception as e:
                    stream_box.append(("err", e, 0.0, 0))

            stream_th = threading.Thread(target=_pull, name=f"ckpt-stream-{name}", daemon=True)
            stream_th.start()
        t0 = time.perf_counter()
        servable = build_servable(mc)
        phases["load_ms"] = (time.perf_counter() - t0) * 1000.0
        t1 = time.perf_counter()
        cm = runner.run_held(f"build {name}", build_model, mc, engine.clock, engine.device,
                             warmup=self.cfg.warmup_at_boot, servable=servable)
        phases["compile_ms"] = (time.perf_counter() - t1) * 1000.0
        if stream_th is not None:
            stream_th.join()
            status, payload, stream_ms, chunks = stream_box[0]
            if status == "ok":
                runner.run_held(f"build {name}", cm.copy_in_place, flatten_tree(payload))
                # The stream overlapped the build, so load_ms + compile_ms
                # can exceed the activation's wall time.
                phases.update(load_ms=stream_ms, streamed=True, chunks_streamed=chunks)
            else:
                store.note_degraded()
                phases["streamed"] = False
                log_event(log, "param stream failed; serving the built weights", model=name,
                          error=f"{type(payload).__name__}: {payload}")
            del payload
        self._set_phases(name, phases)
        if store is not None and not store.has(name, fingerprint=ckpt_fp):
            # Write-once staging: the first cold build seeds the store, so
            # every later activation of this model streams.
            try:
                store.put(name, runner.run_held(f"build {name}", cm.host_state),
                          fingerprint=ckpt_fp)
            except Exception:
                log.exception("seeding the checkpoint store for %s failed; streaming stays "
                              "off for this model", name)
        return cm

    def _record_activation(self, name: str, cause: str, ms: float, from_tier: str):
        self._models[name].note_activation(from_tier, ms)
        by = self.activations_by_cause.setdefault(name, {})
        by[cause] = by.get(cause, 0) + 1
        hist = self.activation_hists.get(name)
        if hist is None:
            hist = self.activation_hists[name] = Histogram(ACTIVATION_BUCKETS_MS)
        hist.observe(ms)

    # -- demotion / scale-to-zero -------------------------------------------
    def _disk_save_fn(self, name: str):
        """The store hand-off :meth:`CompiledModel.disk_offload` calls with
        the host copies (write-once: an already-seeded manifest makes it a
        hash pass with no chunk written), under the source checkpoint's
        fingerprint."""
        from .ckptstore import checkpoint_fingerprint

        try:
            ckpt = self.cfg.model(name).checkpoint
        except KeyError:
            ckpt = None
        fp = checkpoint_fingerprint(ckpt)
        return lambda params: self.store.put(name, params, fingerprint=fp)

    async def demote(self, name: str, *, to: str = "host", cause: str = "idle") -> bool:
        """ACTIVE → DRAINING_IDLE → COLD on tier ``host``, ``disk`` or
        ``none``, or down the cold ladder host → disk → none.  Refuses
        (False) for a pinned or busy model.  ``to="disk"`` needs the store;
        without one it lands on the next rung that exists (host stays host,
        a drop goes to none)."""
        res = self._models.get(name)
        if res is None:
            return False
        engine = self.server.engine
        if getattr(engine, "mesh", None) is not None or getattr(engine, "lockstep", None):
            # A world's models never tier: a demotion or a restore on one rank
            # could not be mirrored, nor the shards placed again.
            return False
        async with res.lock:
            if res.pinned:
                return False
            loop = asyncio.get_running_loop()
            if res.state == ACTIVE:
                if self._busy(name):
                    return False
                res.state = DRAINING_IDLE
                engine = self.server.engine
                cm = engine.detach(name)
                adapters = getattr(self.server, "adapters", None)
                if adapters is not None:
                    # The base's adapters go cold with it: their slots are
                    # written again, into a fresh pool, after a restore.
                    adapters.on_base_demoted(name)
                # The lanes are quiet (the busy gate): stopping them routes new
                # arrivals through ensure_active, which waits on res.lock.
                await self.server._stop_model_lanes(name)
                res.cm_host, res.tier = None, "none"
                freed: dict = {}
                if cm is not None:
                    keep = to == "host" or (to == "disk" and self.store is not None)
                    try:
                        freed = await engine.runner.run_fn(_demote_on_device, cm, keep,
                                                           engine.device)
                        if keep:
                            res.cm_host, res.tier = cm, "host"
                    except Exception as e:
                        log_event(log, "demotion's device work failed; the model drops to "
                                  "none", model=name, error=f"{type(e).__name__}: {e}")
                        res.cm_host, res.tier = None, "none"
                if res.tier == "host" and to == "disk" and self.store is not None:
                    try:
                        await loop.run_in_executor(None, cm.disk_offload,
                                                   self._disk_save_fn(name))
                        res.tier = "disk"
                    except Exception as e:
                        # A full or broken disk: the host copy is untouched
                        # (disk_offload drops it only after the store write).
                        log_event(log, "disk offload failed; landing on the host tier",
                                  model=name, error=f"{type(e).__name__}: {e}")
                res.state = COLD
                res.last_demotion = {"tier": res.tier, "cause": cause,
                                     **{k: round(v, 3) if isinstance(v, float) else v
                                        for k, v in freed.items()}}
                self._record_demotion(name, cause)
                log_event(log, "model demoted", model=name, cause=cause, tier=res.tier,
                          **freed)
                return True
            if (res.state == COLD and res.tier == "host" and to == "disk"
                    and self.store is not None and res.cm_host is not None):
                try:
                    await loop.run_in_executor(None, res.cm_host.disk_offload,
                                               self._disk_save_fn(name))
                except Exception as e:
                    log_event(log, "disk offload failed; staying on the host tier", model=name,
                              error=f"{type(e).__name__}: {e}")
                    return False
                res.tier = "disk"
                self._record_demotion(name, cause)
                log_event(log, "model demoted to the disk tier", model=name, cause=cause)
                return True
            if res.state == COLD and res.tier in ("host", "disk") and to == "none":
                res.cm_host, res.tier = None, "none"
                self._record_demotion(name, cause)
                log_event(log, "model dropped to none", model=name, cause=cause)
                return True
            return False

    async def unload(self, name: str, cause: str = "admin") -> bool:
        """Explicit scale-to-zero, all the way to none."""
        res = self._models.get(name)
        if res is None:
            return False
        if res.state == ACTIVE or res.tier in ("host", "disk"):
            return await self.demote(name, to="none", cause=cause)
        return res.state == COLD  # already unloaded counts as success

    def _record_demotion(self, name: str, cause: str):
        by = self.demotions_by_cause.setdefault(name, {})
        by[cause] = by.get(cause, 0) + 1

    async def pin(self, name: str):
        """PINNED: activate if needed and exempt from every demotion."""
        res = self._models[name]
        res.pinned = True
        if res.state != ACTIVE:
            await self.ensure_active(name, cause="pin")

    def unpin(self, name: str):
        self._models[name].pinned = False

    # -- reaper --------------------------------------------------------------
    def _tick_interval(self) -> float:
        if self.cfg.lifecycle_tick_s > 0:
            return self.cfg.lifecycle_tick_s
        if self.cfg.idle_unload_s > 0:
            return min(max(self.cfg.idle_unload_s / 4.0, 0.05), 5.0)
        return 1.0

    def _host_drop_s(self) -> float:
        if self.cfg.host_idle_drop_s > 0:
            return self.cfg.host_idle_drop_s
        return 4.0 * self.cfg.idle_unload_s if self.cfg.idle_unload_s > 0 else float("inf")

    async def _loop(self):
        while True:
            await asyncio.sleep(self._tick_interval())
            try:
                await self.tick_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("lifecycle tick failed; the next interval retries")

    def idle_window_s(self, name: str) -> float:
        """One model's demotion window: the autoscaler's learned keep-warm
        window when it has one, else the fixed ``idle_unload_s`` (thin
        history, a degraded plane, or no autoscaler)."""
        idle = self.cfg.idle_unload_s
        if self.keepwarm_fn is None:
            return idle
        try:
            learned = self.keepwarm_fn(name)
        except Exception:
            log.exception("keepwarm window lookup failed for %s", name)
            return idle
        return float(learned) if learned is not None else idle

    async def tick_once(self):
        """One reaper pass: idle demotions, host-tier drops, the budgets."""
        now = self.clock()
        if self.cfg.idle_unload_s > 0:
            # Host-tier retention after the device demotion: with the fixed
            # timer this is host_idle_drop_s; a learned window shifts it out
            # by as much, so a long keep-warm window never skips the host
            # tier.
            retention = max(self._host_drop_s() - self.cfg.idle_unload_s, 0.0)
            for name, res in list(self._models.items()):
                if res.pinned:
                    continue
                idle = self.idle_window_s(name)
                if res.state == ACTIVE and now - res.last_used >= idle and not self._busy(name):
                    await self.demote(name, to="host", cause="idle")
                elif (res.state == COLD and res.tier == "host"
                      and now - res.last_used >= idle + retention):
                    # With a store the cold ladder lands on disk, else none.
                    await self.demote(name, cause="idle",
                                      to="disk" if self.store is not None else "none")
        await self.enforce_budget()
        await self.enforce_host_budget()

    async def enforce_budget(self, exclude: str | None = None):
        """Demote LRU first until the device ledger fits ``hbm_budget_bytes``.
        ``exclude`` keeps a model just activated from evicting itself.
        PINNED and busy models never evict: with only those left the budget
        stays exceeded (logged once)."""
        budget = self.cfg.hbm_budget_bytes
        if budget <= 0:
            return
        while True:
            resident = self.server.engine.runner.resident_bytes()
            total = sum(resident.values())
            if total <= budget:
                self._over_budget_warned = False
                return
            victims = sorted((res.last_used, name) for name, res in self._models.items()
                             if name in resident and res.state == ACTIVE and not res.pinned
                             and name != exclude and not self._busy(name))
            for _, name in victims:
                if await self.demote(name, to="host", cause="budget"):
                    break
            else:
                if not self._over_budget_warned:
                    self._over_budget_warned = True
                    log.warning("HBM budget exceeded (%d > %d bytes) with no evictable "
                                "model (all pinned or busy)", total, budget)
                return

    def host_bytes(self) -> dict[str, int]:
        """Per-model host-tier bytes (the pinned copies; the host budget's
        ledger)."""
        return {name: int(res.cm_host.param_nbytes()) for name, res in self._models.items()
                if res.tier == "host" and res.cm_host is not None}

    async def enforce_host_budget(self):
        """``hbm_budget_bytes`` one rung down: while host-tier bytes exceed
        ``host_budget_bytes``, LRU host copies demote to disk (or none
        without a store)."""
        budget = self.cfg.host_budget_bytes
        if budget <= 0:
            return
        to = "disk" if self.store is not None else "none"
        while True:
            held = self.host_bytes()
            if sum(held.values()) <= budget:
                return
            victims = sorted((res.last_used, name) for name, res in self._models.items()
                             if name in held and not res.pinned)
            for _, name in victims:
                if await self.demote(name, to=to, cause="host_budget"):
                    break
            else:
                return

    # -- engine rebuilds (serving/watchdog.py, /admin/reload) ----------------
    def rebind(self, cause: str = "recovery"):
        """Re-sync residency after an engine swap: every model in the fresh
        engine is re-activated (counted under ``cause``), every other model
        goes back to COLD.  Host and disk copies survive: a restore copies
        onto the new runner's device."""
        engine = self.server.engine
        now = self.clock()
        for name, res in self._models.items():
            if name in engine.models:
                was_cold = res.state != ACTIVE
                res.state, res.tier = ACTIVE, "device"
                res.cm_host = None
                res.last_used = now
                ms = (engine.build_seconds.get(name) or 0.0) * 1000.0
                self._record_activation(name, cause, ms, "none")
                if was_cold:
                    log_event(log, "model re-activated by rebuild", model=name, cause=cause)
            else:
                if res.tier == "device":
                    res.tier = "none"
                if res.state in (ACTIVE, WARMING, DRAINING_IDLE):
                    res.state = COLD

    # -- introspection -------------------------------------------------------
    def model_snapshot(self, name: str) -> dict | None:
        res = self._models.get(name)
        if res is None:
            return None
        now = self.clock()
        quarantined = getattr(self.server.resilience, "quarantined", set())
        store = self.store
        engine = self.server.engine
        hbm = engine.runner.resident_bytes().get(name, 0) if engine is not None else 0
        host_b = (int(res.cm_host.param_nbytes())
                  if res.tier == "host" and res.cm_host is not None else 0)
        disk_b = store.manifest_nbytes(name) if store is not None else 0
        adapters = getattr(self.server, "adapters", None)
        try:
            mc = self.cfg.model(name)
            family, quality = mc.family or mc.name, mc.quality_rank
        except KeyError:
            family, quality = name, 0
        return {
            "state": res.state,
            # The variant family and rung: the models table groups by them.
            "family": family,
            # Per-tenant adapter residency: a warm tenant's slot is a
            # routing signal.
            **({"adapters": adapters.residency_of(name)}
               if adapters is not None and adapters.names_for(name) else {}),
            "quality_rank": quality,
            "tier": res.tier if res.state != ACTIVE else "device",
            "pinned": res.pinned,
            "quarantined": name in quarantined,
            "last_used_s_ago": round(max(now - res.last_used, 0.0), 3),
            "inflight": res.inflight,
            "activations": res.activations,
            "activations_by_cause": dict(self.activations_by_cause.get(name, {})),
            "demotions_by_cause": dict(self.demotions_by_cause.get(name, {})),
            "last_activation_ms": res.last_activation_ms,
            "last_activation_phases": res.last_activation_phases,
            "last_demotion": res.last_demotion,
            "estimated_warm_ms": round(self.estimate_warm_ms(name), 1),
            "cold_fast_fails": res.cold_fast_fails,
            "hbm_bytes": hbm,
            # The weights wherever they now lie: the device ledger when
            # ACTIVE, the host copies on the host tier, the store's bytes.
            "param_nbytes": hbm if res.state == ACTIVE else (host_b or disk_b),
            "host_bytes": host_b,
            "disk_bytes": disk_b,
        }

    def snapshot(self) -> dict:
        engine = self.server.engine
        resident = engine.runner.resident_bytes() if engine is not None else {}
        held = self.host_bytes()
        return {
            "lazy_load": self.cfg.lazy_load,
            "idle_unload_s": self.cfg.idle_unload_s,
            "hbm_budget_bytes": self.cfg.hbm_budget_bytes,
            "hbm_bytes_total": sum(resident.values()),
            "host_budget_bytes": self.cfg.host_budget_bytes,
            "host_bytes_total": sum(held.values()),
            **({"ckpt_store": self.store.snapshot()} if self.store is not None else {}),
            "models": {name: self.model_snapshot(name) for name in sorted(self._models)},
        }

    def state_code(self, name: str) -> int:
        """The tpuserve_residency_state gauge's value (PINNED wins)."""
        res = self._models[name]
        return STATE_CODE["pinned"] if res.pinned else STATE_CODE[res.state]
