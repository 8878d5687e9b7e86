"""Self-healing supervisor: quarantine a poisoned engine, rebuild, swap.

The port's copy of the JAX package's ``serving/watchdog.py``.  Every
``watchdog_interval_s``:

1. **Detect**: the device probe (``DeviceRunner.probe``, which the poison
   latch fails) and a breaker open with a fatal cause
   (``ModelResilience.last_error_fatal``; a breaker open on transient
   flakes heals by half-open probes and triggers nothing).
2. **Quarantine**: the affected models answer 503 + ``Retry-After``
   (``ResilienceHub.quarantined``), so no new work lands on the sick engine.
3. **Rebuild and swap**: ``Server.rebuild_engine()`` in the background.  The
   new engine builds and captures its CUDA graphs on its own runner's
   dispatch thread; the old engine's graphs, graph pools and the
   ``:generate`` lanes' KV pools are freed after the swap.  The swap
   rebinds the residency manager (``LifecycleManager.rebind``): the new
   engine's models count as ``recovery`` activations, and a lazy model
   activated on the old engine goes back to COLD, never ACTIVE on a dead
   engine.
4. **Heal**: requeue the jobs the outage failed, reset the affected
   breakers (their window belongs to the dead engine), lift the quarantine.

Bounded: after ``recover_max_attempts`` consecutive failed rebuilds (with
exponential backoff between them) it **gives up**, so a dead device
converges to 503s, not a rebuild loop.  On CUDA that is the fate of a sticky
error (a device-side assert, an illegal address): the context is unusable,
so no rebuild in the process can succeed and the watchdog ends at
``gave_up`` with ``/healthz`` at 503.  ``recover(manual=True)`` (``POST
/admin/recover``) resets the budget.
"""

from __future__ import annotations

import asyncio
import time

from ..utils.logging import get_logger, log_event

log = get_logger("serving.watchdog")

# Numeric encoding of the Prometheus recovery-state gauge.
RECOVERY_STATE_CODE = {"healthy": 0, "recovering": 1, "gave_up": 2}


class Watchdog:
    """The background recovery loop of one :class:`~.server.Server`."""

    def __init__(self, server, interval_s: float, max_attempts: int = 3,
                 backoff_s: float = 1.0):
        self.server = server
        self.interval_s = interval_s
        self.max_attempts = max(int(max_attempts), 1)
        self.backoff_s = backoff_s
        # Event-loop-confined; ``_lock`` (asyncio) serializes recover()
        # against the tick loop.
        self.state = "healthy"  # guarded-by: event-loop
        self.attempts = 0       # guarded-by: event-loop
        self.recoveries_total = 0  # guarded-by: event-loop
        self.requeued_total = 0    # guarded-by: event-loop
        self.last_reason: str | None = None  # guarded-by: event-loop
        self.last_recovery_ts: float | None = None  # guarded-by: event-loop
        # Seconds of the latest successful rebuild (build, captures, swap).
        self.last_rebuild_s: float | None = None  # guarded-by: event-loop
        self._task: asyncio.Task | None = None  # guarded-by: event-loop
        self._lock = asyncio.Lock()
        self._next_attempt_at = 0.0   # guarded-by: event-loop
        # Wall clock of the first unhealthy observation: jobs that failed
        # after it are outage victims, requeued on recovery.
        self._unhealthy_wall: float | None = None  # guarded-by: event-loop

    def start(self):
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop(), name="watchdog")
        return self

    async def stop(self):
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # -- detection -----------------------------------------------------------
    def _fatal_open_models(self) -> list[str]:
        """Models whose breaker is open on a fatal cause."""
        hub = self.server.resilience
        return sorted(name for name, mr in hub.models.items()
                      if mr.breaker is not None
                      and mr.breaker.state == "open" and mr.last_error_fatal)

    async def _diagnose(self) -> str | None:
        """None when healthy, else why not."""
        if self.server.engine is None:
            return None
        fatal = self._fatal_open_models()
        if fatal:
            return f"breaker open with fatal cause: {', '.join(fatal)}"
        alive = await asyncio.get_running_loop().run_in_executor(None, self.server._probe)
        if not alive:
            return "device probe failed"
        return None

    def _stand_down(self):
        self.server.resilience.quarantined.clear()
        self.state, self.attempts = "healthy", 0
        self._next_attempt_at = 0.0
        self._unhealthy_wall = None

    async def _loop(self):
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.interval_s)
            if self.server.rebuilding:
                # A reload or a recovery is swapping the engine (the old one
                # refuses work meanwhile): judge the result next tick.
                continue
            try:
                reason = await self._diagnose()
                if reason is None:
                    if self.state != "healthy":
                        # Healed without us (the device came back while we
                        # backed off, or an operator reload fixed it).
                        async with self._lock:
                            if self.state != "healthy":
                                self._stand_down()
                                log_event(log, "engine healthy again; standing down")
                    continue
                if self.state == "gave_up":
                    continue  # budget spent: the operator owns it
                if loop.time() < self._next_attempt_at:
                    continue  # backing off between rebuild attempts
                await self.recover(reason)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("watchdog tick failed; the next interval retries")

    # -- recovery ------------------------------------------------------------
    async def recover(self, reason: str = "manual", manual: bool = False) -> dict:
        """Quarantine → rebuild → swap → requeue → reopen; returns the
        snapshot.  ``manual=True`` (``/admin/recover``) resets the attempt
        budget first, so an operator can retry after ``gave_up``."""
        async with self._lock:
            loop = asyncio.get_running_loop()
            hub = self.server.resilience
            if manual:
                self.attempts = 0
                self._next_attempt_at = 0.0
                if self.state == "gave_up":
                    self.state = "healthy"
            else:
                # Diagnose again under the lock: a concurrent manual recovery
                # or reload may have swapped in a healthy engine while the
                # tick's verdict was in flight, or be swapping one now.
                if self.server.rebuilding:
                    return self.snapshot()
                reason = await self._diagnose()
                if reason is None:
                    if self.state != "healthy":
                        self._stand_down()
                    return self.snapshot()
            if self.attempts >= self.max_attempts:
                self.state = "gave_up"
                return self.snapshot()
            self.state = "recovering"
            self.last_reason = reason
            if self._unhealthy_wall is None:
                # Failures started at latest one interval before detection.
                self._unhealthy_wall = time.time() - self.interval_s - 1.0
            targets = (self._fatal_open_models()
                       or (sorted(self.server.engine.models)
                           if self.server.engine is not None else []))
            hub.quarantined.update(targets)
            self.attempts += 1
            log_event(log, "engine recovery started", reason=reason, attempt=self.attempts,
                      max_attempts=self.max_attempts, quarantined=targets)
            t0 = time.perf_counter()
            try:
                await self.server.rebuild_engine(cause="recovery")
            except Exception as e:
                delay = min(self.backoff_s * 2 ** (self.attempts - 1), 60.0)
                self._next_attempt_at = loop.time() + delay
                if self.attempts >= self.max_attempts:
                    # Converge to quarantined 503s, not a rebuild loop.
                    self.state = "gave_up"
                    log.error("engine rebuild failed (%s: %s); attempt budget (%d) spent, "
                              "giving up until POST /admin/recover", type(e).__name__, e,
                              self.max_attempts)
                else:
                    log.warning("engine rebuild failed (%s: %s); retrying in %.1f s "
                                "(attempt %d/%d)", type(e).__name__, e, delay,
                                self.attempts, self.max_attempts)
                return self.snapshot()
            self.last_rebuild_s = time.perf_counter() - t0
            requeued = 0
            if self.server.jobs is not None:
                requeued = self.server.jobs.requeue_failed_since(self._unhealthy_wall)
            self.requeued_total += requeued
            for name in targets:
                mr = hub.models.get(name)
                if mr is not None:
                    mr.last_error_fatal = False
                    if mr.breaker is not None:
                        mr.breaker.reset()
            hub.quarantined.clear()
            self.recoveries_total += 1
            self.attempts = 0
            self._next_attempt_at = 0.0
            self._unhealthy_wall = None
            self.last_recovery_ts = time.time()
            self.state = "healthy"
            log_event(log, "engine recovered", reason=reason, requeued_jobs=requeued,
                      recoveries_total=self.recoveries_total,
                      rebuild_s=round(self.last_rebuild_s, 3))
            return self.snapshot()

    def snapshot(self) -> dict:
        return {"state": self.state,
                "attempts": self.attempts,
                "max_attempts": self.max_attempts,
                "recoveries_total": self.recoveries_total,
                "requeued_jobs_total": self.requeued_total,
                "last_reason": self.last_reason,
                "last_recovery_ts": self.last_recovery_ts,
                "last_rebuild_s": (round(self.last_rebuild_s, 3)
                                   if self.last_rebuild_s is not None else None)}
