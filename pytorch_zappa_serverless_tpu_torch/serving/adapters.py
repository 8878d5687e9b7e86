"""Multi-tenant adapter serving: one base model, many LoRA tenants.

The port's copy of the JAX package's ``serving/adapters.py``: the lifecycle
manager's (``serving/lifecycle.py``) per-tenant twin, one granularity down.

- **Registry and resolution**: ``ModelConfig.adapters`` declares each base's
  adapters ({name: {checkpoint, alpha, rank, tenants, seed}}); a request
  names one with the ``X-Adapter`` header or the body's ``adapter`` field,
  or through ``X-Tenant`` against the adapter's ``tenants`` list.
- **Residency**: an attached adapter holds one slot of its base's stack pool
  (``ops/lora.py``; slot 0 is the base itself) and sits in the runner's HBM
  ledger as ``{base}:{adapter}``, so the ``hbm_budget_bytes`` the lifecycle
  loop reads prices adapter bytes as it prices models.
- **Single-flight attach** with cold admission: a request whose deadline is
  below the learned attach estimate gets 503 ``adapter_cold`` with
  Retry-After (:class:`AdapterCold`) while the attach goes on; a request
  without a deadline waits on the shared task.
- **Scale-to-zero per tenant**: an adapter idle past
  ``adapter_idle_unload_s`` detaches (its slot zeroed, its ledger entry
  dropped); LRU eviction frees slots for new tenants, and adapter bytes go
  first when the HBM budget tightens.  A base's demotion leaves its
  adapters cold.
- **Co-batching**: attached tenants share the base's batcher; each row
  carries its slot, so different adapters serve from one dispatch.
- **Chaos**: ``faults.py`` rules with ``kind="adapter"`` fail one tenant's
  attach; the base and the other tenants serve on.

On the device the stack pool lies in the base's module and every captured
graph holds its addresses: an attach or a detach writes its slot in place
(``ops.lora.write_slot``), on the dispatch thread through ``runner.run_fn``
(a capture refuses other threads' CUDA calls), and never recaptures.

Everything here is event-loop confined, as the lifecycle manager is; the
weight load runs in the default executor, serialized per adapter by the
single-flight task.  A slot write awaits the dispatch thread, so each pool
holds a lock across choosing, installing and writing a slot and across a
detach's clear and write: no second attach can take a slot mid-write, and
the dispatch thread never reads host stacks that the loop is changing.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any

from ..utils.aio import cancel_and_wait
from ..utils.logging import get_logger, log_event
from .metrics import Histogram

log = get_logger("serving.adapters")

COLD = "cold"
ATTACHING = "attaching"
ACTIVE = "active"

# tpuserve_adapter_residency gauge encoding.
STATE_CODE = {COLD: 0, ATTACHING: 1, ACTIVE: 2}

# Attach wall times span an in-place slot write to a slow checkpoint read.
ATTACH_BUCKETS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                     15000.0)


class AdapterCold(Exception):
    """The adapter is not attached and the request cannot (or will not)
    wait: 503 ``adapter_cold`` with Retry-After, while the single-flight
    attach goes on."""

    def __init__(self, msg: str, estimated_attach_ms: float, retry_after_s: float):
        super().__init__(msg)
        self.estimated_attach_ms = estimated_attach_ms
        self.retry_after_s = retry_after_s


class UnknownAdapter(KeyError):
    """No such adapter registered for this base: 404 upstream, with the
    base's adapters in the body."""


@dataclass
class AdapterResidency:
    """One (base, adapter) record: state, slot, LRU clock, learned cost."""

    base: str
    name: str
    spec: dict[str, Any]
    state: str = COLD            # guarded-by: event-loop
    slot: int = 0                # guarded-by: event-loop (0 = unattached)
    nbytes: int = 0              # guarded-by: event-loop
    last_used: float = 0.0       # guarded-by: event-loop
    inflight: int = 0            # guarded-by: event-loop
    attaches: int = 0            # guarded-by: event-loop
    detaches: int = 0            # guarded-by: event-loop
    served: int = 0              # guarded-by: event-loop
    cold_fast_fails: int = 0     # guarded-by: event-loop
    last_attach_ms: float | None = None  # guarded-by: event-loop
    last_error: str | None = None        # guarded-by: event-loop
    # The loaded factor tree, kept across detach and attach cycles: a
    # re-attach writes the slot again without reading the checkpoint.
    tree: dict | None = None     # guarded-by: event-loop
    history: list = field(default_factory=list)  # guarded-by: event-loop

    @property
    def key(self) -> str:
        return f"{self.base}:{self.name}"

    def note_attach(self, ms: float):
        self.attaches += 1
        self.last_attach_ms = round(ms, 3)
        self.history.append(ms)
        del self.history[:-8]


class _BasePool:
    """One base's slot pool: the host stacks, which record owns each slot,
    and the CompiledModel whose device stacks they mirror.  ``fresh`` until
    its first write: the device stacks may still hold an earlier pool's
    values (a restored base), so that write zeroes every slot."""

    def __init__(self, base: str, meta: dict, cm):
        from ..ops.lora import zero_stacks

        self.base = base
        self.meta = meta  # {slots, rank, targets, dims, layers}
        self.cm = cm
        self.stacks = {f"layer{i}": zero_stacks(meta["slots"], meta["rank"], meta["dims"])
                       for i in range(meta["layers"])}  # guarded-by: event-loop
        self.fresh = True  # guarded-by: lock
        # slot index -> AdapterResidency (slot 0 is never given out).
        self.owners: dict[int, AdapterResidency] = {}  # guarded-by: lock
        # Held across a slot's choice, install and device write, and across
        # a detach's clear and write (both await the dispatch thread).
        self.lock = asyncio.Lock()


class AdapterManager:
    """Per-server adapter residency.

    ``load_fn(base, name, spec, meta) -> tree`` is the blocking load body (run
    in the executor; tests inject a fake).  ``clock`` is the idle and LRU
    clock, injectable so that idle-unload tests do not sleep."""

    def __init__(self, server, cfg, *, load_fn=None, clock=time.monotonic):
        self.server = server
        self.cfg = cfg
        self.clock = clock
        self._load_fn = load_fn or self._default_load
        self._adapters: dict[str, AdapterResidency] = {}  # guarded-by: event-loop
        self._pools: dict[str, _BasePool] = {}  # guarded-by: event-loop
        self._attaching: dict[str, asyncio.Task] = {}  # guarded-by: event-loop
        self._attach_started: dict[str, float] = {}  # guarded-by: event-loop
        self.attach_hists: dict[str, Histogram] = {}  # guarded-by: event-loop
        self._task: asyncio.Task | None = None  # guarded-by: event-loop
        # Co-batch evidence: dispatches that carried more than one adapter
        # (the batcher reports each dispatch's mix through note_batch).
        self.multi_adapter_batches = 0  # guarded-by: event-loop
        # The detach hook: the server points it at the paged lane's prefix
        # invalidation, so a reused slot never resolves a detached tenant's
        # frozen KV.  Called (base, slot).
        self.prefix_invalidate = None  # guarded-by: event-loop
        # The autoscaler's learned keep-warm window, fn("base:adapter") ->
        # seconds | None: the idle reaper holds a tenant's slot that long
        # instead of the fixed timer; None keeps the timer.
        self.keepwarm_fn = None  # guarded-by: event-loop
        for mc in cfg.models:
            for aname, spec in (mc.adapters or {}).items():
                rec = AdapterResidency(base=mc.name, name=aname, spec=dict(spec or {}))
                self._adapters[rec.key] = rec

    # -- plumbing ------------------------------------------------------------
    def start(self):
        if self._task is None and self._adapters:
            self._task = asyncio.get_running_loop().create_task(self._loop(), name="adapters")
        return self

    async def stop(self):
        await cancel_and_wait(self._task)
        self._task = None

    @property
    def enabled(self) -> bool:
        return bool(self._adapters)

    def names_for(self, base: str) -> list[str]:
        return sorted(r.name for r in self._adapters.values() if r.base == base)

    def get(self, base: str, name: str) -> AdapterResidency | None:
        return self._adapters.get(f"{base}:{name}")

    def name_of_slot(self, base: str, slot: int) -> str | None:
        """The adapter that holds ``slot`` on ``base`` now (None for 0)."""
        pool = self._pools.get(base)
        rec = pool.owners.get(int(slot)) if pool is not None and slot else None
        return rec.name if rec is not None else None

    def resolve(self, base: str, adapter: str | None,
                tenant: str | None) -> AdapterResidency | None:
        """Tenant to adapter: the explicit name wins, else the tenant's
        registered adapter; None when the request carries neither.  Raises
        :class:`UnknownAdapter` for a name or tenant this base does not
        serve."""
        if adapter:
            rec = self._adapters.get(f"{base}:{adapter}")
            if rec is None:
                raise UnknownAdapter(adapter)
            return rec
        if tenant:
            for rec in self._adapters.values():
                if rec.base == base and tenant in (rec.spec.get("tenants") or ()):
                    return rec
            raise UnknownAdapter(tenant)
        return None

    # -- the busy bracket (the lifecycle's enter/exit, one level down) -------
    def enter(self, rec: AdapterResidency):
        rec.inflight += 1
        rec.last_used = self.clock()

    def exit(self, rec: AdapterResidency):
        rec.inflight -= 1
        rec.last_used = self.clock()

    def note_served(self, rec: AdapterResidency):
        rec.served += 1

    def note_batch(self, adapters: set[str]):
        """The batcher's evidence hook: one dispatch carried these adapters."""
        if len(adapters) > 1:
            self.multi_adapter_batches += 1

    # -- the pool ------------------------------------------------------------
    def _pool(self, base: str) -> _BasePool:
        """The base's pool, checked against the live CompiledModel: an
        engine rebuild swaps the model out (its stacks with it), so a pool
        of another model resets its records to cold and starts anew."""
        engine = self.server.engine
        cm = engine.models.get(base) if engine is not None else None
        if cm is None:
            raise RuntimeError(f"base model {base!r} is not resident")
        meta = cm.servable.meta.get("adapters")
        if meta is None:
            raise RuntimeError(f"model {base!r} has no adapter slot pool; set adapter_slots "
                               f"in its ModelConfig")
        if getattr(cm, "lockstep", None) is not None:
            # A slot write on rank 0 alone would diverge the ranks' weights.
            raise RuntimeError(f"model {base!r} serves a lockstep world; adapters are "
                               f"single-host only")
        pool = self._pools.get(base)
        if pool is None or pool.cm is not cm:
            if pool is not None:
                for rec in pool.owners.values():
                    self._reset_record(rec)
            pool = self._pools[base] = _BasePool(base, meta, cm)
        return pool

    def on_base_demoted(self, base: str) -> None:
        """The lifecycle's demotion hook: the base's adapters go cold, and
        the next attach starts a fresh pool (which zeroes every device slot
        of the restored base before it writes its own)."""
        pool = self._pools.pop(base, None)
        if pool is not None:
            for rec in pool.owners.values():
                self._reset_record(rec)

    def _reset_record(self, rec: AdapterResidency):
        rec.state, rec.slot, rec.nbytes = COLD, 0, 0
        self.server.engine.runner.untrack_model(rec.key)

    async def _write(self, pool: _BasePool, slot: int) -> None:
        """Host stacks to the device stacks, in place, on the dispatch
        thread: ``slot`` alone, or every slot on the pool's first write."""
        from ..ops.lora import write_slot

        slots = range(pool.meta["slots"]) if pool.fresh else (slot,)
        cm = pool.cm

        def write():
            stacks = cm.servable.module.tree()["__adapters__"]
            for s in slots:
                write_slot(stacks, pool.stacks, s)

        await self.server.engine.runner.run_fn(write)
        pool.fresh = False

    # -- the attach cost model -----------------------------------------------
    def estimate_attach_ms(self, rec: AdapterResidency) -> float:
        if rec.history:
            ordered = sorted(rec.history)
            return float(ordered[len(ordered) // 2])
        return float(self.cfg.adapter_attach_estimate_ms)

    def _retry_after_s(self, rec: AdapterResidency, est_ms: float) -> float:
        started = self._attach_started.get(rec.key)
        elapsed = (self.clock() - started) if started is not None else 0.0
        return max(est_ms / 1000.0 - elapsed, 1.0)

    # -- attach --------------------------------------------------------------
    async def ensure_attached(self, base: str, name: str, *, deadline_ms: float | None = None,
                              cause: str = "request", wait: bool = True) -> int:
        """Admission: the adapter's slot, attaching on demand.

        Single-flight per adapter, with the lifecycle's ``ensure_active``
        deadline and wait contract one level down: raises
        :class:`AdapterCold` when the caller cannot wait out the attach."""
        rec = self._adapters.get(f"{base}:{name}")
        if rec is None:
            raise UnknownAdapter(name)
        rec.last_used = self.clock()
        pool = self._pool(base)
        if rec.state == ACTIVE and pool.owners.get(rec.slot) is rec:
            return rec.slot
        task = self._attaching.get(rec.key)
        if task is None or task.done():
            task = asyncio.get_running_loop().create_task(self._attach(rec, cause),
                                                          name=f"attach-{rec.key}")
            task.add_done_callback(lambda t: t.exception() if not t.cancelled() else None)
            self._attaching[rec.key] = task
        est = self.estimate_attach_ms(rec)
        if deadline_ms is not None and est > deadline_ms:
            rec.cold_fast_fails += 1
            raise AdapterCold(
                f"adapter {name!r} on {base!r} is {rec.state} (attach estimated {est:.0f} ms "
                f"exceeds the {deadline_ms:.0f} ms deadline); attaching in the background",
                estimated_attach_ms=est, retry_after_s=self._retry_after_s(rec, est))
        wait_s = (deadline_ms / 1000.0 if deadline_ms is not None
                  else self.cfg.activation_max_wait_s)
        if not wait or wait_s <= 0:
            rec.cold_fast_fails += 1
            raise AdapterCold(f"adapter {name!r} on {base!r} is {rec.state}; attaching in the "
                              f"background", estimated_attach_ms=est,
                              retry_after_s=self._retry_after_s(rec, est))
        try:
            await asyncio.wait_for(asyncio.shield(task), timeout=wait_s)
        except (asyncio.TimeoutError, TimeoutError):
            rec.cold_fast_fails += 1
            est = self.estimate_attach_ms(rec)
            raise AdapterCold(f"adapter {name!r} on {base!r} still {rec.state} after waiting "
                              f"{wait_s:.1f} s", estimated_attach_ms=est,
                              retry_after_s=self._retry_after_s(rec, max(est, 500.0))) from None
        return rec.slot

    def _free_slot(self, pool: _BasePool) -> int | None:
        """A slot to install into, under ``pool.lock``.  A full pool evicts
        its least recently used idle tenant (its re-attach is cheap, its
        tree is kept); the caller's write of the slot carries the new
        factors over the evicted ones."""
        for slot in range(1, pool.meta["slots"]):
            if slot not in pool.owners:
                return slot
        victims = sorted((rec.last_used, slot) for slot, rec in pool.owners.items()
                         if rec.state == ACTIVE and rec.inflight == 0)
        if not victims:
            return None
        _, slot = victims[0]
        self._release(pool, pool.owners[slot], cause="slots")
        return slot

    async def _attach(self, rec: AdapterResidency, cause: str):
        """The single-flight attach: load, take a slot, write it."""
        from ..ops.lora import adapter_nbytes, clear_slot, install_adapter

        loop = asyncio.get_running_loop()
        pool = self._pool(rec.base)
        self._attach_started[rec.key] = self.clock()
        rec.state = ATTACHING
        tracer = getattr(self.server, "tracer", None)
        root = (tracer.start("adapter_attach", model=rec.base, adapter=rec.name, cause=cause)
                if tracer is not None else None)
        t0 = time.perf_counter()
        try:
            self.server.engine.runner.faults.on_adapter(rec.key)
            if rec.tree is None:
                sp = root.child("load_weights") if root else None
                rec.tree = await loop.run_in_executor(None, self._load_fn, rec.base, rec.name,
                                                      rec.spec, pool.meta)
                if sp is not None:
                    sp.end()
                pool = self._pool(rec.base)  # a rebuild during the load
            async with pool.lock:
                slot = self._free_slot(pool)
                if slot is None:
                    raise RuntimeError(f"no free adapter slot on {rec.base!r} "
                                       f"({pool.meta['slots'] - 1} slots, all busy)")
                rank = int(rec.spec.get("rank") or pool.meta["rank"])
                alpha = float(rec.spec.get("alpha", rank))
                sp = root.child("install", slot=slot) if root else None
                install_adapter(pool.stacks, slot, rec.tree, scaling=alpha / max(rank, 1))
                pool.owners[slot] = rec
                rec.slot = slot
                try:
                    await self._write(pool, slot)
                    if self._pools.get(rec.base) is not pool or pool.owners.get(slot) is not rec:
                        raise RuntimeError(f"the slot pool of {rec.base!r} was reset during "
                                           f"the attach")
                except BaseException:
                    if pool.owners.get(slot) is rec:
                        clear_slot(pool.stacks, slot)
                        pool.owners.pop(slot)
                    rec.slot = 0
                    raise
                if sp is not None:
                    sp.end()
                rec.nbytes = adapter_nbytes(rec.tree)
                self.server.engine.runner.track_model(rec.key, rec.nbytes)
                rec.state = ACTIVE
            rec.last_used = self.clock()
            rec.last_error = None
            ms = (time.perf_counter() - t0) * 1000.0
            rec.note_attach(ms)
            slo = getattr(self.server, "slo", None)
            if slo is not None:
                # The usage ledger: the attach billed to its tenant.
                slo.usage.note_attach(rec.base, rec.name, ms)
            hist = self.attach_hists.get(rec.key)
            if hist is None:
                hist = self.attach_hists[rec.key] = Histogram(ATTACH_BUCKETS_MS)
            hist.observe(ms)
            if root is not None:
                root.end()
                tracer.finish(root.trace, "ok")
            log_event(log, "adapter attached", model=rec.base, adapter=rec.name, slot=slot,
                      cause=cause, ms=round(ms, 2), bytes=rec.nbytes)
        except BaseException as e:
            rec.state = COLD
            rec.last_error = f"{type(e).__name__}: {e}"
            if root is not None:
                root.annotate(error=rec.last_error)
                root.end(status="error")
                tracer.finish(root.trace, "error")
            log_event(log, "adapter attach failed", model=rec.base, adapter=rec.name,
                      cause=cause, error=rec.last_error)
            raise
        finally:
            self._attaching.pop(rec.key, None)
            self._attach_started.pop(rec.key, None)
        await self._enforce_budget(exclude=rec)

    def _default_load(self, base: str, name: str, spec: dict, meta: dict) -> dict:
        """The blocking load (executor thread).

        A checkpoint store hit (keyed ``(base, adapter)``) streams only the
        tenant's chunks; a checkpoint imports (native or torch), then seeds
        the store so that the next attach streams; no checkpoint gives the
        seed's random factors (dev mode, like the model zoo).  A broken
        stream degrades to the whole-file import.  The tree is validated
        against the pool's layout either way: a rank or target mismatch is a
        config error at attach, not wrong math."""
        from ..engine import weights as W
        from ..ops.lora import validate_adapter

        ckpt = spec.get("checkpoint")
        store = getattr(self.server, "ckpt_store", None)
        tree = None
        fp = None
        if store is not None:
            # A manifest staged from an older checkpoint reads as a miss.
            from .ckptstore import checkpoint_fingerprint

            fp = checkpoint_fingerprint(ckpt)
        if store is not None and store.has(base, adapter=name, fingerprint=fp):
            try:
                tree = store.load(base, adapter=name)[0]
            except Exception as e:
                store.note_degraded()
                log_event(log, "adapter stream failed; degrading to the whole-file import",
                          model=base, adapter=name, error=f"{type(e).__name__}: {e}")
        if tree is None and ckpt:
            tree = W.import_adapter(ckpt)
            if store is not None and not store.has(base, adapter=name, fingerprint=fp):
                try:
                    store.put(base, tree, adapter=name, fingerprint=fp)
                except Exception:
                    log.exception("seeding the checkpoint store for adapter %s:%s failed",
                                  base, name)
        elif tree is None:
            tree = W.init_lora(meta["layers"], meta["dims"],
                               int(spec.get("rank") or meta["rank"]), seed=int(spec.get("seed", 0)))
        validate_adapter(tree, meta["dims"], meta["rank"], name=f"{base}:{name}")
        return tree

    # -- detach and scale-to-zero --------------------------------------------
    def _release(self, pool: _BasePool, rec: AdapterResidency, cause: str) -> int:
        """A detach's bookkeeping, under ``pool.lock``: zero the host slot,
        free it, reset the record and drop the slot's prefix tree.  Returns
        the slot; the device write is the caller's."""
        from ..ops.lora import clear_slot

        slot = rec.slot
        clear_slot(pool.stacks, slot)
        pool.owners.pop(slot, None)
        self._reset_record(rec)
        rec.detaches += 1
        if self.prefix_invalidate is not None and slot:
            # Frozen prefix KV is keyed by slot: a reused slot must never
            # resolve this tenant's pages.
            try:
                self.prefix_invalidate(rec.base, slot)
            except Exception:
                log.exception("prefix invalidation failed for %s slot %d", rec.base, slot)
        log_event(log, "adapter detached", model=rec.base, adapter=rec.name, cause=cause)
        return slot

    async def _detach(self, rec: AdapterResidency, cause: str = "idle") -> bool:
        pool = self._pools.get(rec.base)
        if pool is None:
            return False
        async with pool.lock:
            if rec.state != ACTIVE or rec.inflight > 0 or pool.owners.get(rec.slot) is not rec:
                return False
            slot = self._release(pool, rec, cause)
            if pool.cm is self.server.engine.models.get(rec.base):
                await self._write(pool, slot)
        return True

    async def detach(self, base: str, name: str, cause: str = "admin") -> bool:
        rec = self._adapters.get(f"{base}:{name}")
        if rec is None:
            raise UnknownAdapter(name)
        return await self._detach(rec, cause=cause)

    def _idle_s(self) -> float:
        s = self.cfg.adapter_idle_unload_s
        if s < 0:
            return float("inf")
        if s > 0:
            return s
        return self.cfg.idle_unload_s or float("inf")

    async def _loop(self):
        while True:
            await asyncio.sleep(self._tick_interval())
            try:
                await self.tick_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("adapter tick failed; the next interval retries")

    def _tick_interval(self) -> float:
        idle = self._idle_s()
        if idle != float("inf"):
            return min(max(idle / 4.0, 0.05), 5.0)
        return 1.0

    def idle_window_s(self, rec: AdapterResidency) -> float:
        """One tenant's detach window: the autoscaler's learned keep-warm
        window when it has one, else the fixed timer.  A learned window
        replaces a timer and never creates one: with none set (never), no
        tenant is idle-detached, as the lifecycle's reaper demotes no model
        without ``idle_unload_s``."""
        idle = self._idle_s()
        if self.keepwarm_fn is None or idle == float("inf"):
            return idle
        try:
            learned = self.keepwarm_fn(rec.key)
        except Exception:
            log.exception("keepwarm window lookup failed for %s", rec.key)
            return idle
        return float(learned) if learned is not None else idle

    async def tick_once(self):
        """One reaper pass: idle detaches, then the HBM budget."""
        now = self.clock()
        for rec in list(self._adapters.values()):
            if (rec.state == ACTIVE and rec.inflight == 0
                    and now - rec.last_used >= self.idle_window_s(rec)):
                await self._detach(rec, cause="idle")
        await self._enforce_budget()

    async def _enforce_budget(self, exclude: AdapterResidency | None = None):
        """Shed adapter bytes, least recently used first, while the device
        ledger exceeds ``hbm_budget_bytes``: adapters are the cheapest thing
        to evict, so they go before the lifecycle demotes whole models."""
        budget = self.cfg.hbm_budget_bytes
        if budget <= 0:
            return
        while True:
            resident = self.server.engine.runner.resident_bytes()
            if sum(resident.values()) <= budget:
                return
            victims = [rec for rec in self._adapters.values()
                       if rec.state == ACTIVE and rec.inflight == 0 and rec is not exclude]
            if not victims:
                return
            victim = min(victims, key=lambda r: r.last_used)
            if not await self._detach(victim, cause="budget"):
                return

    # -- introspection -------------------------------------------------------
    def adapter_snapshot(self, rec: AdapterResidency) -> dict:
        now = self.clock()
        return {
            "state": rec.state,
            "slot": rec.slot if rec.state == ACTIVE else None,
            "tenants": sorted(rec.spec.get("tenants") or ()),
            "hbm_bytes": rec.nbytes if rec.state == ACTIVE else 0,
            "last_used_s_ago": round(max(now - rec.last_used, 0.0), 3),
            "inflight": rec.inflight,
            "attaches": rec.attaches,
            "detaches": rec.detaches,
            "served": rec.served,
            "cold_fast_fails": rec.cold_fast_fails,
            "last_attach_ms": rec.last_attach_ms,
            "estimated_attach_ms": round(self.estimate_attach_ms(rec), 1),
            **({"last_error": rec.last_error} if rec.last_error else {}),
        }

    def base_snapshot(self, base: str) -> dict:
        """{adapter: snapshot} for one base: the 404 and discovery ladder."""
        return {rec.name: self.adapter_snapshot(rec)
                for rec in self._adapters.values() if rec.base == base}

    def residency_of(self, base: str) -> dict[str, str]:
        """{adapter: state}: the short form ``/v1/models`` carries."""
        return {rec.name: rec.state for rec in self._adapters.values() if rec.base == base}

    def snapshot(self) -> dict:
        by_base: dict[str, dict] = {}
        for rec in self._adapters.values():
            by_base.setdefault(rec.base, {})[rec.name] = self.adapter_snapshot(rec)
        return {
            "enabled": self.enabled,
            "idle_unload_s": None if self._idle_s() == float("inf") else self._idle_s(),
            "multi_adapter_batches": self.multi_adapter_batches,
            "models": {b: dict(sorted(a.items())) for b, a in sorted(by_base.items())},
        }
