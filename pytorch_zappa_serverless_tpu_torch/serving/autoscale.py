"""Predictive autoscaling: demand forecasting, pre-warming, replica sizing.

The port's copy of the JAX package's ``serving/autoscale.py``.  A demand
model per key, fitted online from the request journal, drives three
actuators ahead of predicted demand (after Shahrad et al., "Serverless in
the Wild", ATC '20: per-application inter-arrival histograms instead of a
fixed keep-alive timer):

- **Keep-warm windows** (:meth:`AutoscalePlane.keepwarm_window_s`): each
  key's inter-arrival gaps fill a log-bucketed histogram; the window is a
  high quantile of it, clamped to ``[keepwarm_min_s, keepwarm_max_s]``.
  The lifecycle's and the adapters' reapers consult it per key in place of
  their fixed idle timers, which stay the fallback while history is thin
  (< ``autoscale_min_history`` gaps) or the plane is degraded.
- **Pre-warming** (:meth:`AutoscalePlane.plan`): the next arrival is
  predicted at ``last_arrival + median gap``; when it falls inside the
  key's lead (``estimated_warm_ms`` + ``prewarm_margin_s``) the plane fires
  the single-flight activation paths that demand uses (the model's
  activation, an adapter's attach, and the model's speculative-draft rung),
  so the warm-up ends before the arrival.  While the HBM ledger is at or
  over ``hbm_budget_bytes`` a pre-warm is shed (counted, never fired).
- **Replica sizing** (:func:`desired_replicas`): the pure sizing core a
  fleet router's scale actuator uses, fed by the replicas' queue-wait
  forecasts.

The decision core is deterministic given the journal: an injectable clock,
no wall-clock reads, sorted iteration.  Every pre-warm goes through a keyed
:class:`SingleFlight` gate, and a forecaster that mispredicts degrades to
reactive: each fired pre-warm is watched for its arrival, and
``autoscale_mispredict_limit`` watches in a row that expire unmatched drop
the plane to the fixed timers with no pre-warms for
``autoscale_reactive_hold_s``.  Fault rules of ``kind="demand"`` (modes
``spike`` and ``starve``) hide a burst from the forecaster or plant a
phantom prediction, to drive that ladder in tests.

Surfaces: ``GET /admin/autoscale``, the ``autoscale`` CLI table and the
``tpuserve_autoscale_*`` Prometheus families (``serving/metrics.py``).
Event-loop-confined like the lifecycle and adapter managers: arrivals are
noted from the server's connection loop, and the tick task and every
snapshot run on the same loop.
"""

from __future__ import annotations

import asyncio
import bisect
import time
from typing import Callable

from ..utils.aio import cancel_and_wait
from ..utils.logging import get_logger, log_event
from .slo import RollingWindow

log = get_logger("serving.autoscale")

# Policy modes (ServeConfig.autoscale): "off" = today's reactive behavior,
# "histogram" = learned keep-warm windows only (Shahrad's policy), and
# "predictive" = windows + pre-warming ahead of forecast demand.
MODES = ("off", "histogram", "predictive")

# Numeric encoding for snapshots/dashboards.
MODE_CODE = {"off": 0, "histogram": 1, "predictive": 2}

# Inter-arrival gap bucket upper bounds in seconds (log-ish ladder from
# sub-100ms burst spacing to the hour-scale idle Shahrad's traces show);
# the final implicit bucket is +Inf.
GAP_BUCKETS_S = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                 300.0, 900.0, 3600.0)


class SingleFlight:
    """Keyed async single-flight gate: at most ONE task per key in flight.

    ``launch`` returns the existing task when the key is already running:
    the pre-warm dedupe ("no activation stampede").
    """

    def __init__(self):
        self._tasks: dict[str, asyncio.Task] = {}  # guarded-by: event-loop

    def running(self, key: str) -> bool:
        task = self._tasks.get(key)
        return task is not None and not task.done()

    def launch(self, key: str, factory: Callable, *,
               name: str | None = None) -> asyncio.Task:
        """Start ``factory()`` for ``key`` unless one is already in flight."""
        task = self._tasks.get(key)
        if task is not None and not task.done():
            return task
        task = asyncio.get_running_loop().create_task(
            factory(), name=name or f"flight-{key}")
        # Retrieve the exception so a failed flight never warns unretrieved;
        # callers that care about outcomes await the returned task.
        task.add_done_callback(
            lambda t: t.exception() if not t.cancelled() else None)
        self._tasks[key] = task
        return task

    def snapshot(self) -> dict:
        return {"in_flight": sorted(k for k, t in self._tasks.items()
                                    if not t.done())}


class DemandModel:
    """One key's online demand fit: inter-arrival histogram + rate windows.

    The journal is the sequence of ``note_arrival`` calls; everything else
    is derived deterministically from it — the gap histogram feeds the
    keep-warm quantile, the last arrival + median gap feed the next-arrival
    prediction, and two time-bucketed :class:`~.slo.RollingWindow` rings
    (the same bucketed-window structure the SLO plane maintains) feed the
    short-horizon rate forecaster.
    """

    def __init__(self, clock=time.monotonic, fast_s: float = 30.0,
                 slow_s: float = 300.0):
        self.clock = clock
        # guarded-by: event-loop (one extra slot for the +Inf bucket)
        self.gap_counts = [0] * (len(GAP_BUCKETS_S) + 1)
        self.gap_samples = 0      # guarded-by: event-loop
        self.arrivals = 0         # guarded-by: event-loop
        self.last_arrival: float | None = None  # guarded-by: event-loop
        # RollingWindow self-locks; constructed with the SAME injectable
        # clock so forecast tests never sleep.
        self.fast = RollingWindow(fast_s, clock=clock)
        self.slow = RollingWindow(slow_s, clock=clock)

    def note_arrival(self, now: float | None = None):
        now = self.clock() if now is None else now
        if self.last_arrival is not None:
            gap = max(now - self.last_arrival, 0.0)
            self.gap_counts[bisect.bisect_left(GAP_BUCKETS_S, gap)] += 1
            self.gap_samples += 1
        self.last_arrival = now
        self.arrivals += 1
        self.fast.note(True)
        self.slow.note(True)

    def gap_quantile_s(self, q: float) -> float | None:
        """The q-quantile inter-arrival gap (bucket upper bound), or None
        with no gap history; gaps in the +Inf bucket answer the ladder top
        (the key is effectively idle — no window can cover it)."""
        if not self.gap_samples:
            return None
        target = max(q, 0.0) * self.gap_samples
        acc = 0
        for i, n in enumerate(self.gap_counts):
            acc += n
            if acc >= target and n:
                return (GAP_BUCKETS_S[i] if i < len(GAP_BUCKETS_S)
                        else GAP_BUCKETS_S[-1])
        return GAP_BUCKETS_S[-1]

    def median_gap_s(self) -> float | None:
        return self.gap_quantile_s(0.5)

    @staticmethod
    def _rate(window: RollingWindow) -> float:
        _, total = window.counts()
        return total / window.window_s if window.window_s else 0.0

    def forecast_rps(self) -> float:
        """Short-horizon offered-rate forecast: the fast-window rate plus
        its momentum over the slow window (a ramping key forecasts above
        its current rate; a draining one converges down to it)."""
        fast = self._rate(self.fast)
        slow = self._rate(self.slow)
        return round(fast + max(fast - slow, 0.0), 4)

    def next_expected_in_s(self, now: float) -> float | None:
        """Seconds until the next predicted arrival (0 = overdue), or None
        with no usable periodicity."""
        med = self.median_gap_s()
        if med is None or self.last_arrival is None:
            return None
        return max(self.last_arrival + med - now, 0.0)

    def snapshot(self, now: float) -> dict:
        return {
            "arrivals": self.arrivals,
            "gap_samples": self.gap_samples,
            "forecast_rps": self.forecast_rps(),
            "rate_fast_rps": round(self._rate(self.fast), 4),
            "rate_slow_rps": round(self._rate(self.slow), 4),
            "median_gap_s": self.median_gap_s(),
            "next_expected_in_s": self.next_expected_in_s(now),
            "last_arrival_s_ago": (round(now - self.last_arrival, 3)
                                   if self.last_arrival is not None
                                   else None),
        }


class AutoscalePlane:
    """The per-server autoscaler: demand models per key + the actuators.

    Keys are ``model`` and ``model:adapter`` — the same namespace the HBM
    and usage ledgers price.  The server wires the actuator callables at
    startup (``bind``); tests drive the plane directly with a fake clock
    and fake actuators, which is what makes the decision core's determinism
    pinnable.
    """

    def __init__(self, cfg, clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        mode = str(getattr(cfg, "autoscale", "predictive") or "off")
        if mode not in MODES:
            raise ValueError(f"autoscale must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.quantile = float(getattr(cfg, "keepwarm_quantile", 0.95))
        self.keepwarm_min_s = float(getattr(cfg, "keepwarm_min_s", 1.0))
        self.keepwarm_max_s = float(getattr(cfg, "keepwarm_max_s", 600.0))
        self.min_history = int(getattr(cfg, "autoscale_min_history", 8))
        self.prewarm_margin_s = float(getattr(cfg, "prewarm_margin_s", 1.0))
        self.mispredict_limit = int(getattr(cfg, "autoscale_mispredict_limit",
                                            3))
        self.reactive_hold_s = float(getattr(cfg, "autoscale_reactive_hold_s",
                                             30.0))
        self._models: dict[str, DemandModel] = {}  # guarded-by: event-loop
        self._flight = SingleFlight()
        # Pre-warms awaiting a matching arrival: key -> deadline (clock s).
        self._pending: dict[str, float] = {}  # guarded-by: event-loop
        self.mispredict_streak = 0  # guarded-by: event-loop
        self._degraded_until: float | None = None  # guarded-by: event-loop
        # Counters (the tpuserve_autoscale_* families).
        self.prewarms_by_cause: dict[str, dict[str, int]] = {}  # guarded-by: event-loop
        self.prewarm_hits = 0        # guarded-by: event-loop
        self.prewarm_misses = 0      # guarded-by: event-loop
        self.prewarm_shed_budget = 0  # guarded-by: event-loop
        self.prewarm_errors = 0      # guarded-by: event-loop
        self.degradations = 0        # guarded-by: event-loop
        # Actuator wiring (bind()); all optional so the plane is
        # constructible stand-alone in tests and before engine startup.
        self.activate_fn = None       # guarded-by: event-loop
        self.attach_fn = None         # guarded-by: event-loop
        self.draft_of = None          # guarded-by: event-loop
        self.residency_fn = None      # guarded-by: event-loop
        self.estimate_warm_ms_fn = None  # guarded-by: event-loop
        self.resident_bytes_fn = None    # guarded-by: event-loop
        self.faults = None            # guarded-by: event-loop
        self.model_names: tuple = ()  # guarded-by: event-loop
        self._task: asyncio.Task | None = None  # guarded-by: event-loop

    # -- wiring ---------------------------------------------------------------
    def bind(self, *, activate_fn=None, attach_fn=None, draft_of=None,
             residency_fn=None, estimate_warm_ms_fn=None,
             resident_bytes_fn=None, faults=None, model_names=()):
        """Point the actuators at the live serving stack (server startup)."""
        self.activate_fn = activate_fn
        self.attach_fn = attach_fn
        self.draft_of = draft_of
        self.residency_fn = residency_fn
        self.estimate_warm_ms_fn = estimate_warm_ms_fn
        self.resident_bytes_fn = resident_bytes_fn
        self.faults = faults
        self.model_names = tuple(model_names)
        return self

    def _tick_interval(self) -> float:
        t = float(getattr(self.cfg, "autoscale_tick_s", 0.0))
        return t if t > 0 else 1.0

    def start(self):
        if self._task is None and self.mode == "predictive":
            self._task = asyncio.get_running_loop().create_task(
                self._loop(), name="autoscale")
        return self

    async def stop(self):
        await cancel_and_wait(self._task)
        self._task = None

    async def _loop(self):
        while True:
            await asyncio.sleep(self._tick_interval())
            try:
                self.tick_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("autoscale tick failed; next interval retries")

    # -- the journal ----------------------------------------------------------
    @staticmethod
    def key(model: str, adapter: str | None = None) -> str:
        return f"{model}:{adapter}" if adapter else model

    def note_arrival(self, model: str | None, adapter: str | None = None):
        """Fold one work-request arrival into the key's demand model.

        A ``kind="demand"`` chaos rule in ``spike`` mode drops the
        observation — the burst happens, the forecaster never sees it —
        which is exactly the misprediction the reactive fallback must
        absorb."""
        if model is None or self.mode == "off":
            return
        if (adapter is None and self.faults is not None
                and self.faults.on_demand(model) == "spike"):
            return
        k = self.key(model, adapter)
        dm = self._models.get(k)
        if dm is None:
            dm = self._models[k] = DemandModel(clock=self.clock)
        dm.note_arrival()
        if k in self._pending:
            # The predicted demand arrived: the pre-warm was right.
            self._pending.pop(k, None)
            self.prewarm_hits += 1
            self.mispredict_streak = 0

    # -- keep-warm windows (actuator b) ---------------------------------------
    def degraded(self, now: float | None = None) -> bool:
        if self._degraded_until is None:
            return False
        now = self.clock() if now is None else now
        if now >= self._degraded_until:
            self._degraded_until = None
            self.mispredict_streak = 0
            log_event(log, "autoscale recovered from reactive degradation")
            return False
        return True

    def keepwarm_window_s(self, key: str) -> float | None:
        """The learned keep-warm window for one key, or None → the caller
        falls back to its fixed timer (thin history, plane off/degraded)."""
        if self.mode == "off" or self.degraded():
            return None
        dm = self._models.get(key)
        if dm is None or dm.gap_samples < self.min_history:
            return None
        q = dm.gap_quantile_s(self.quantile)
        if q is None:
            return None
        return min(max(q, self.keepwarm_min_s), self.keepwarm_max_s)

    # -- pre-warming (actuator a) ---------------------------------------------
    def _lead_s(self, key: str) -> float:
        est_ms = 0.0
        if self.estimate_warm_ms_fn is not None:
            try:
                est_ms = float(self.estimate_warm_ms_fn(key) or 0.0)
            except Exception:
                est_ms = 0.0
        return est_ms / 1000.0 + self.prewarm_margin_s

    def _over_budget(self) -> bool:
        budget = int(getattr(self.cfg, "hbm_budget_bytes", 0) or 0)
        if budget <= 0 or self.resident_bytes_fn is None:
            return False
        try:
            return int(self.resident_bytes_fn()) >= budget
        except Exception:
            return False

    def plan(self, now: float | None = None) -> list[dict]:
        """The deterministic decision core: the pre-warm actions due NOW.

        Pure over (journal, residency/estimate suppliers, clock): sorted
        key iteration, no wall-clock reads, no randomness — the same
        journal always plans the same actions (pinned by the tests).  A key is
        due when its predicted next arrival falls inside its activation
        lead time while it is not device-resident.  Budget pressure sheds
        the action (counted) instead of firing it.
        """
        now = self.clock() if now is None else now
        if self.mode != "predictive" or self.degraded(now):
            return []
        actions: list[dict] = []
        over = self._over_budget()
        for k in sorted(self._models):
            dm = self._models[k]
            if dm.gap_samples < self.min_history:
                continue
            state = None
            if self.residency_fn is not None:
                try:
                    state = self.residency_fn(k)
                except Exception:
                    state = None
            if state in ("active", "pinned", "attaching", "warming"):
                continue  # already resident or already on its way
            med = dm.median_gap_s()
            if med is None or dm.last_arrival is None:
                continue
            eta_raw = dm.last_arrival + med - now
            if eta_raw < -med:
                # Long overdue: the periodic model is stale — the demand
                # stream stopped.  Chasing it would re-warm a dead key
                # forever (one wasted cycle per degradation hold); a fresh
                # arrival refreshes last_arrival and re-arms the forecast.
                continue
            eta = max(eta_raw, 0.0)
            if eta <= self._lead_s(k):
                if over:
                    self.prewarm_shed_budget += 1
                    continue
                actions.append({"action": "prewarm", "key": k,
                                "eta_s": round(eta, 3),
                                "cause": "predicted"})
        return actions

    def _watch_s(self, key: str, eta_s: float) -> float:
        """How long a fired pre-warm waits for its matching arrival before
        it counts as a misprediction: the claimed ETA plus one gap of
        grace (bounded below so sub-second noise can't thrash)."""
        dm = self._models.get(key)
        med = dm.median_gap_s() if dm is not None else None
        return min(eta_s + max(med or 0.0, 2.0 * self.prewarm_margin_s, 1.0),
                   self.keepwarm_max_s)

    def _note_prewarm(self, key: str, cause: str):
        per = self.prewarms_by_cause.setdefault(key, {})
        per[cause] = per.get(cause, 0) + 1

    def _fire_prewarm(self, key: str, cause: str, now: float,
                      eta_s: float = 0.0):
        if key in self._pending:
            # One open prediction per key: while a watch is outstanding,
            # re-planning the same key neither re-fires nor pushes the
            # deadline out — a wrong forecast must settle, not renew.
            return
        if self._flight.running(key):
            return  # single-flight: the stampede gate the chaos test pins
        base, _, adapter = key.partition(":")
        self._note_prewarm(key, cause)
        self._pending[key] = now + self._watch_s(key, eta_s)

        async def _do():
            try:
                if adapter:
                    if self.attach_fn is not None:
                        await self.attach_fn(base, adapter, "prewarm")
                elif self.activate_fn is not None:
                    await self.activate_fn(base, "prewarm")
                    # Spec-draft warmup rides the base pre-warm: a predicted
                    # burst on the target means the draft rung is about to
                    # be needed too.
                    draft = self.draft_of(base) if self.draft_of else None
                    if draft:
                        await self.activate_fn(draft, "prewarm_draft")
            except Exception as e:
                self.prewarm_errors += 1
                log_event(log, "pre-warm failed", level="warning", key=key,
                          cause=cause, error=f"{type(e).__name__}: {e}")

        self._flight.launch(key, _do, name=f"prewarm-{key}")

    def _expire_pending(self, now: float):
        for k, deadline in list(self._pending.items()):
            if now >= deadline:
                self._pending.pop(k, None)
                self.prewarm_misses += 1
                self.mispredict_streak += 1
                log_event(log, "pre-warm mispredicted", key=k,
                          streak=self.mispredict_streak)
        if (self.mispredict_streak >= self.mispredict_limit
                and self._degraded_until is None):
            # The degradation ladder's bottom rung: back to today's
            # reactive behavior — no pre-warms, fixed timers — until the
            # hold expires.  A wrong forecaster must never amplify load.
            self._degraded_until = now + self.reactive_hold_s
            self.degradations += 1
            self._pending.clear()
            log_event(log, "autoscale degraded to reactive",
                      level="warning", streak=self.mispredict_streak,
                      hold_s=self.reactive_hold_s)

    def tick_once(self, now: float | None = None):
        """One control tick: settle watches, plan, fire (also callable from
        tests — the loop is just this on a timer)."""
        now = self.clock() if now is None else now
        self._expire_pending(now)
        if self.mode != "predictive" or self.degraded(now):
            return
        actions = self.plan(now)
        if self.faults is not None:
            for m in self.model_names:
                if self.faults.on_demand(m) == "starve":
                    # Phantom prediction chaos: demand that never comes.
                    # The watch expires unmatched and drives the
                    # degradation ladder above.
                    actions.append({"action": "prewarm", "key": m,
                                    "eta_s": 0.0, "cause": "phantom"})
        for act in actions:
            self._fire_prewarm(act["key"], act["cause"], now,
                               eta_s=float(act.get("eta_s", 0.0)))

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> dict:
        now = self.clock()
        planned = {a["key"]: a for a in self.plan(now)}
        models = {}
        for k in sorted(self._models):
            dm = self._models[k]
            models[k] = {
                **dm.snapshot(now),
                "keepwarm_window_s": self.keepwarm_window_s(k),
                "prewarms_by_cause": dict(self.prewarms_by_cause.get(k, {})),
                "prewarm_pending": k in self._pending,
                "planned": (planned[k]["action"] if k in planned else None),
            }
        degraded = self.degraded(now)
        return {
            "mode": self.mode,
            "effective_mode": "reactive" if degraded else self.mode,
            "degraded": degraded,
            "degraded_for_s": (round(self._degraded_until - now, 3)
                               if degraded else None),
            "mispredict_streak": self.mispredict_streak,
            "counters": {
                "prewarms": sum(n for per in self.prewarms_by_cause.values()
                                for n in per.values()),
                "prewarm_hits": self.prewarm_hits,
                "prewarm_misses": self.prewarm_misses,
                "prewarm_shed_budget": self.prewarm_shed_budget,
                "prewarm_errors": self.prewarm_errors,
                "degradations": self.degradations,
            },
            "knobs": {
                "keepwarm_quantile": self.quantile,
                "keepwarm_min_s": self.keepwarm_min_s,
                "keepwarm_max_s": self.keepwarm_max_s,
                "min_history": self.min_history,
                "prewarm_margin_s": self.prewarm_margin_s,
                "mispredict_limit": self.mispredict_limit,
                "reactive_hold_s": self.reactive_hold_s,
            },
            "in_flight": self._flight.snapshot()["in_flight"],
            "models": models,
        }


# -- fleet sizing core (actuator c) --------------------------------------------

def desired_replicas(forecasts: list[dict], current: int, *,
                     target_wait_ms: float, min_replicas: int = 1,
                     max_replicas: int = 8,
                     scale_in_factor: float = 0.25) -> int:
    """Pure fleet-sizing decision: the replica count the queue forecast
    asks for, moving ONE step per call (gradual, oscillation-resistant).

    ``forecasts`` is each routable replica's per-model queue-wait forecast
    in ms (the ``forecast`` block every ``/healthz`` exports).  A replica's load is its worst model's wait; the
    fleet's is the mean over routable replicas — scale out when it exceeds
    ``target_wait_ms``, scale in when it sits under ``target_wait_ms *
    scale_in_factor``.  Deterministic: same forecasts → same answer.
    """
    min_replicas = max(int(min_replicas), 1)
    max_replicas = max(int(max_replicas), min_replicas)
    current = max(int(current), 0)
    clamped = min(max(current, min_replicas), max_replicas)
    if not forecasts:
        return clamped  # nothing routable to read demand from: hold
    loads = [max(f.values()) if f else 0.0 for f in forecasts]
    fleet_wait = sum(loads) / len(loads)
    if fleet_wait > target_wait_ms and current < max_replicas:
        return current + 1
    if fleet_wait < target_wait_ms * scale_in_factor \
            and current > min_replicas:
        return current - 1
    return clamped


def fleet_wait_ms(forecasts: list[dict]) -> float:
    """The aggregate the sizing core reads, exported for observability."""
    if not forecasts:
        return 0.0
    loads = [max(f.values()) if f else 0.0 for f in forecasts]
    return round(sum(loads) / len(loads), 2)
