"""The SLO and goodput plane: objectives, burn rates, the usage ledger.

The port's copy of the JAX package's ``serving/slo.py``: are objectives met
for each model, tenant and family, and at what cost?

- **Definitions** (``ServeConfig.slo`` and the ``slo_*`` defaults): per
  ``model``, ``model:adapter`` tenant, or variant family, a latency
  objective in ms and an availability target.  Keys not configured take the
  profile's defaults.
- **Goodput**: a request is good only if it was served and met its latency
  objective.  Served degraded (below the family ladder's top) met it too and
  counts toward goodput, apart; served late, shed (429/503/504) and errored
  (5xx) burn the error budget.  Fed from the one point every work request
  passes in the server, the paged lane's retire hook and the adapter
  manager's attach.
- **Burn rates**: rolling fast and slow windows per (key, lane), burn =
  bad fraction / error budget, each with its alarm threshold.  The clock is
  injectable, so alarm tests never sleep.
- **Usage ledger**: device ms, KV page-seconds, prefix-cache tokens served
  from frozen pages, and adapter attaches, per ``{base}`` and
  ``{base}:{adapter}``, the keys the HBM ledger prices.
- **Fleet merge** (:func:`merge_slo_snapshots`,
  :func:`merge_histogram_snapshots`, :func:`rollup_metrics`): pure folds of
  several replicas' snapshots into one view; counters sum, burn rates are
  recomputed from the summed window counts, histograms merge bucket by
  bucket.

Surfaces: ``GET /admin/slo``, the ``slo`` block of ``/healthz``, the
``slo`` CLI table, and the ``tpuserve_slo_*`` and ``tpuserve_usage_*``
Prometheus families (``serving/metrics.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

# Terminal classification of one work request.  ``good`` and ``degraded``
# count toward goodput (both met the objective); the rest burn budget.
OUTCOMES = ("good", "degraded", "late", "shed", "error")
_BAD = frozenset(("late", "shed", "error"))

# Numeric encoding for the tpuserve_slo_burn_alarm gauge.
ALARM_CODE = {"ok": 0, "alarm": 1}


@dataclass(frozen=True)
class SLODef:
    """One key's service-level objective.

    ``latency_objective_ms`` 0 means "no latency objective" — every served
    request is on time; ``availability_target`` is the classic SLO fraction
    (0.999 → a 0.1% error budget).
    """

    latency_objective_ms: float = 0.0
    availability_target: float = 0.999

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.availability_target, 1e-9)


class RollingWindow:
    """Time-bucketed good/total counts over a trailing window.

    Fixed ring of ``buckets`` slots, each covering ``window_s / buckets``
    seconds; a slot is lazily reset when its epoch comes around again, so
    ``note``/``counts`` are O(1)/O(buckets) with no timers.  Lock-protected:
    noted from the event loop and the dispatch-side hooks, snapshotted from
    scrapes — the same torn-read posture as metrics.Histogram.
    """

    def __init__(self, window_s: float, buckets: int = 60,
                 clock=time.monotonic):
        self.window_s = float(window_s)
        self._n = max(int(buckets), 2)
        self._bucket_s = self.window_s / self._n
        self._clock = clock
        self._lock = threading.Lock()
        self._good = [0] * self._n    # guarded-by: _lock
        self._total = [0] * self._n   # guarded-by: _lock
        self._epoch = [-1] * self._n  # guarded-by: _lock

    def _slot(self, now: float) -> int:
        """Under the lock: the live slot for ``now``, reset if stale."""
        epoch = int(now / self._bucket_s)
        i = epoch % self._n
        if self._epoch[i] != epoch:
            self._epoch[i] = epoch
            self._good[i] = 0
            self._total[i] = 0
        return i

    def note(self, good: bool):
        with self._lock:
            i = self._slot(self._clock())
            self._total[i] += 1
            if good:
                self._good[i] += 1

    def counts(self) -> tuple[int, int]:
        """(good, total) over the trailing window, from one locked read."""
        with self._lock:
            now_epoch = int(self._clock() / self._bucket_s)
            good = total = 0
            for i in range(self._n):
                if now_epoch - self._epoch[i] < self._n:
                    good += self._good[i]
                    total += self._total[i]
        return good, total


class SLOTracker:
    """One (key, lane)'s objective state: lifetime outcomes + burn windows."""

    def __init__(self, sdef: SLODef, fast_s: float, slow_s: float,
                 clock=time.monotonic):
        self.sdef = sdef
        self.fast = RollingWindow(fast_s, clock=clock)
        self.slow = RollingWindow(slow_s, clock=clock)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self.outcomes: dict[str, int] = {o: 0 for o in OUTCOMES}

    def note(self, outcome: str):
        ok = outcome not in _BAD
        with self._lock:
            self.outcomes[outcome] += 1
        self.fast.note(ok)
        self.slow.note(ok)

    def burn(self, window: RollingWindow) -> float:
        """Bad-fraction / error-budget over one window (0 with no samples).

        1.0 = burning the budget exactly at the rate that exhausts it at
        the SLO horizon; 14.4 over 5 minutes is the canonical page-now
        threshold (we default the fast alarm at 14).
        """
        good, total = window.counts()
        if not total:
            return 0.0
        return ((total - good) / total) / self.sdef.error_budget

    def snapshot(self, fast_alarm: float, slow_alarm: float) -> dict:
        with self._lock:
            outcomes = dict(self.outcomes)
        total = sum(outcomes.values())
        goodput = outcomes["good"] + outcomes["degraded"]
        out = {
            "objective": {
                "latency_objective_ms": self.sdef.latency_objective_ms,
                "availability_target": self.sdef.availability_target,
            },
            "outcomes": outcomes,
            "requests": total,
            "goodput": goodput,
            "goodput_ratio": round(goodput / total, 4) if total else None,
            "windows": {},
        }
        for name, win, threshold in (("fast", self.fast, fast_alarm),
                                     ("slow", self.slow, slow_alarm)):
            good, wtotal = win.counts()
            burn = self.burn(win)
            out["windows"][name] = {
                "window_s": win.window_s,
                "good": good,
                "total": wtotal,
                "burn_rate": round(burn, 3),
                "budget_remaining": round(max(1.0 - burn, 0.0), 4),
                "alarm": burn >= threshold,
            }
        return out


class UsageLedger:
    """Per-tenant resource attribution: who spent what.

    Keys are ``{base}`` for base-model traffic and ``{base}:{adapter}`` for
    tenant traffic, the keys the runner's HBM ledger prices, so cost and
    residency read off one namespace.
    Lock-protected: fed from the event loop (request completions, stream
    retires, attach completions), read from scrapes.
    """

    _FIELDS = ("requests", "device_ms", "kv_block_seconds",
               "prefix_saved_tokens", "attaches", "attach_ms")

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: dict[str, dict[str, float]] = {}  # guarded-by: _lock

    @staticmethod
    def key(model: str, adapter: str | None) -> str:
        return f"{model}:{adapter}" if adapter else model

    def _row(self, model: str, adapter: str | None) -> dict[str, float]:
        """Under the lock: the tenant's accumulator row."""
        k = self.key(model, adapter)
        row = self._rows.get(k)
        if row is None:
            row = self._rows[k] = dict.fromkeys(self._FIELDS, 0.0)
        return row

    def note_request(self, model: str, adapter: str | None,
                     device_ms: float):
        with self._lock:
            row = self._row(model, adapter)
            row["requests"] += 1
            row["device_ms"] += max(float(device_ms), 0.0)

    def note_stream(self, model: str, adapter: str | None, device_ms: float,
                    kv_block_seconds: float, cached_tokens: int):
        """One retired :generate stream's bill: decode wall, the KV pages it
        held integrated over its lifetime, and the prompt tokens the prefix
        cache served for free (the savings side)."""
        with self._lock:
            row = self._row(model, adapter)
            row["requests"] += 1
            row["device_ms"] += max(float(device_ms), 0.0)
            row["kv_block_seconds"] += max(float(kv_block_seconds), 0.0)
            row["prefix_saved_tokens"] += max(int(cached_tokens), 0)

    def note_attach(self, model: str, adapter: str, attach_ms: float):
        with self._lock:
            row = self._row(model, adapter)
            row["attaches"] += 1
            row["attach_ms"] += max(float(attach_ms), 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: {f: (int(v) if f in ("requests", "attaches",
                                            "prefix_saved_tokens")
                            else round(v, 3))
                        for f, v in row.items()}
                    for k, row in sorted(self._rows.items())}


class SLOHub:
    """The per-server SLO registry: trackers per (key, lane) + the ledger.

    ``observe`` is the single classification point — the server's connection
    loop calls it with every work response's terminal evidence
    (status, wall ms, degraded flag, adapter), so no shed/degrade/error
    path needs its own bookkeeping.  Creation of trackers is lock-protected
    (requests and scrapes race); each tracker carries its own locks.
    """

    LANES = ("predict", "generate", "submit")

    def __init__(self, cfg, clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self.fast_window_s = float(getattr(cfg, "slo_fast_window_s", 300.0))
        self.slow_window_s = float(getattr(cfg, "slo_slow_window_s", 3600.0))
        self.fast_alarm = float(getattr(cfg, "slo_fast_burn_alarm", 14.0))
        self.slow_alarm = float(getattr(cfg, "slo_slow_burn_alarm", 6.0))
        self._default = SLODef(
            latency_objective_ms=float(
                getattr(cfg, "slo_latency_objective_ms", 0.0)),
            availability_target=float(
                getattr(cfg, "slo_availability_target", 0.999)))
        # Configured overrides, keyed "model", "model:adapter", or family.
        self._defs: dict[str, SLODef] = {}
        for key, spec in (getattr(cfg, "slo", None) or {}).items():
            self._defs[str(key)] = SLODef(
                latency_objective_ms=float(spec.get(
                    "latency_objective_ms",
                    self._default.latency_objective_ms)),
                availability_target=float(spec.get(
                    "availability_target",
                    self._default.availability_target)))
        self._lock = threading.Lock()
        # guarded-by: _lock (tracker creation; trackers self-lock)
        self._trackers: dict[tuple[str, str], SLOTracker] = {}
        self.usage = UsageLedger()

    # -- definitions ---------------------------------------------------------
    def definition(self, key: str) -> SLODef:
        """Most-specific configured def: exact ``model:adapter`` key, then
        the base model, then the model's family, then the profile default."""
        d = self._defs.get(key)
        if d is not None:
            return d
        base = key.split(":", 1)[0]
        d = self._defs.get(base)
        if d is not None:
            return d
        try:
            fam = self.cfg.model(base).family
        except (KeyError, AttributeError):
            fam = ""
        if fam and fam in self._defs:
            return self._defs[fam]
        return self._default

    def tracker(self, key: str, lane: str) -> SLOTracker:
        with self._lock:
            t = self._trackers.get((key, lane))
            if t is None:
                t = self._trackers[(key, lane)] = SLOTracker(
                    self.definition(key), self.fast_window_s,
                    self.slow_window_s, clock=self._clock)
            return t

    # -- classification ------------------------------------------------------
    def classify(self, key: str, status: int, latency_ms: float,
                 degraded: bool = False, errored: bool = False) -> str | None:
        """Terminal outcome for one response; None = not SLO-relevant.

        4xx client mistakes (bad body, unknown model, declined knobs) are
        the caller's fault and must not burn the server's budget — except
        the shed statuses (429/504) and every 503, which are the server
        saying "not now".
        """
        if status in (429, 503, 504):
            return "shed"
        if errored or status >= 500:
            return "error"
        if status >= 400:
            return None  # client error: not the server's budget
        objective = self.definition(key).latency_objective_ms
        if objective > 0 and latency_ms > objective:
            return "late"
        return "degraded" if degraded else "good"

    def observe(self, model: str, lane: str, status: int, latency_ms: float,
                degraded: bool = False, adapter: str | None = None,
                errored: bool = False) -> str | None:
        """Fold one finished work request in; returns the outcome recorded.

        Tenant-addressed requests are tracked under BOTH the base model key
        and the ``model:adapter`` tenant key, so per-tenant burn and the
        base model's aggregate stay simultaneously queryable.
        """
        key = UsageLedger.key(model, adapter)
        outcome = self.classify(key, status, latency_ms, degraded=degraded,
                                errored=errored)
        if outcome is None:
            return None
        self.tracker(model, lane).note(outcome)
        if adapter:
            self.tracker(key, lane).note(outcome)
        return outcome

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._trackers.items())
        models: dict[str, dict] = {}
        for (key, lane), t in sorted(items):
            models.setdefault(key, {})[lane] = t.snapshot(
                self.fast_alarm, self.slow_alarm)
        return {
            "defaults": {
                "latency_objective_ms": self._default.latency_objective_ms,
                "availability_target": self._default.availability_target,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "fast_burn_alarm": self.fast_alarm,
                "slow_burn_alarm": self.slow_alarm,
            },
            "models": models,
            "usage": self.usage.snapshot(),
        }

    def health_summary(self) -> dict:
        """The compact burn-state block /healthz carries (and the fleet
        router folds into its own health): per-window alarmed keys plus the
        worst live burn rates — enough for an LB or operator glance without
        the full snapshot."""
        with self._lock:
            items = list(self._trackers.items())
        alarms: dict[str, list[str]] = {"fast": [], "slow": []}
        worst = {"fast": 0.0, "slow": 0.0}
        for (key, lane), t in items:
            for name, win, threshold in (("fast", t.fast, self.fast_alarm),
                                         ("slow", t.slow, self.slow_alarm)):
                burn = t.burn(win)
                worst[name] = max(worst[name], burn)
                if burn >= threshold:
                    alarms[name].append(f"{key}|{lane}")
        return {"fast_alarms": sorted(alarms["fast"]),
                "slow_alarms": sorted(alarms["slow"]),
                "worst_fast_burn": round(worst["fast"], 3),
                "worst_slow_burn": round(worst["slow"], 3)}


# -- fleet merge semantics (the router's rollup) -------------------------------

def merge_histogram_snapshots(snaps: list[dict]) -> dict | None:
    """Merge ``Histogram.snapshot()`` dicts bucket-wise.

    Cumulative counts are de-cumulated per snapshot, summed per bound, and
    re-cumulated over the UNION of bounds — so replicas with different
    bucket ladders still merge into one monotonic histogram.
    """
    snaps = [s for s in snaps if s and s.get("count")]
    if not snaps:
        return None
    per_bound: dict[float, int] = {}
    inf_extra = 0
    total, total_sum = 0, 0.0
    for s in snaps:
        prev = 0
        finite = [(float(b), int(n)) for b, n in s["buckets"].items()
                  if b != "+Inf"]
        for bound, acc in sorted(finite):
            per_bound[bound] = per_bound.get(bound, 0) + (acc - prev)
            prev = acc
        inf_extra += int(s["buckets"].get("+Inf", prev)) - prev
        total += int(s["count"])
        total_sum += float(s.get("sum", 0.0))
    out, acc = {}, 0
    for bound in sorted(per_bound):
        acc += per_bound[bound]
        out[f"{bound:g}"] = acc
    out["+Inf"] = acc + inf_extra
    return {"buckets": out, "sum": round(total_sum, 3), "count": total}


def _merge_window(wins: list[dict], budget: float, threshold: float) -> dict:
    good = sum(int(w.get("good", 0)) for w in wins)
    total = sum(int(w.get("total", 0)) for w in wins)
    burn = (((total - good) / total) / budget) if total else 0.0
    return {"window_s": max((float(w.get("window_s", 0.0)) for w in wins),
                            default=0.0),
            "good": good, "total": total,
            "burn_rate": round(burn, 3),
            "budget_remaining": round(max(1.0 - burn, 0.0), 4),
            "alarm": burn >= threshold}


def merge_slo_snapshots(snaps: list[dict]) -> dict:
    """Fold N replicas' ``SLOHub.snapshot()`` dicts into one fleet view.

    Counts SUM; burn rates are RECOMPUTED from the merged window counts
    (averaging per-replica burn rates would let one idle replica mask a
    burning one); alarm thresholds and objectives come from the first
    snapshot that declares them (profiles are fleet-uniform by contract).
    """
    snaps = [s for s in snaps if s]
    defaults = next((s["defaults"] for s in snaps if s.get("defaults")), {})
    fast_alarm = float(defaults.get("fast_burn_alarm", 14.0))
    slow_alarm = float(defaults.get("slow_burn_alarm", 6.0))
    merged: dict[str, dict] = {}
    for s in snaps:
        for key, lanes in (s.get("models") or {}).items():
            for lane, t in lanes.items():
                merged.setdefault(key, {}).setdefault(lane, []).append(t)
    models: dict[str, dict] = {}
    for key, lanes in sorted(merged.items()):
        models[key] = {}
        for lane, ts in lanes.items():
            objective = ts[0].get("objective", {})
            budget = max(1.0 - float(objective.get(
                "availability_target", 0.999)), 1e-9)
            outcomes = {o: sum(int(t.get("outcomes", {}).get(o, 0))
                               for t in ts) for o in OUTCOMES}
            total = sum(outcomes.values())
            goodput = outcomes["good"] + outcomes["degraded"]
            models[key][lane] = {
                "objective": objective,
                "outcomes": outcomes,
                "requests": total,
                "goodput": goodput,
                "goodput_ratio": (round(goodput / total, 4)
                                  if total else None),
                "windows": {
                    name: _merge_window(
                        [t.get("windows", {}).get(name, {}) for t in ts],
                        budget,
                        fast_alarm if name == "fast" else slow_alarm)
                    for name in ("fast", "slow")},
            }
    usage: dict[str, dict] = {}
    for s in snaps:
        for key, row in (s.get("usage") or {}).items():
            acc = usage.setdefault(key, {})
            for f, v in row.items():
                acc[f] = round(acc.get(f, 0) + v, 3)
    return {"defaults": defaults, "models": models,
            "usage": dict(sorted(usage.items())),
            "replicas_merged": len(snaps)}


def rollup_metrics(snaps: list[dict]) -> dict:
    """Aggregate N replicas' ``/metrics`` JSON renders into one fleet view.

    Semantics per family: request/error counters and lifetime rates SUM,
    latency histograms merge bucket-wise (:func:`merge_histogram_snapshots`
    — fleet percentiles come from the merged distribution, never from
    averaging per-replica percentiles), KV pool gauges SUM (the fleet's
    pages), HBM bytes SUM, and the SLO plane merges via
    :func:`merge_slo_snapshots`.
    """
    snaps = [s for s in snaps if s]
    models: dict[str, dict] = {}
    for s in snaps:
        for name, ring in (s.get("models") or {}).items():
            acc = models.setdefault(name, {
                "requests": 0, "errors": 0, "req_per_s_lifetime": 0.0,
                "queue_hists": [], "device_hists": []})
            acc["requests"] += int(ring.get("requests", 0))
            acc["errors"] += int(ring.get("errors", 0))
            acc["req_per_s_lifetime"] = round(
                acc["req_per_s_lifetime"]
                + float(ring.get("req_per_s_lifetime", 0.0)), 2)
            for field in ("queue_hist", "device_hist"):
                if ring.get(field):
                    acc[field + "s"].append(ring[field])
    out_models: dict[str, dict] = {}
    for name, acc in sorted(models.items()):
        row = {"requests": acc["requests"], "errors": acc["errors"],
               "req_per_s_lifetime": acc["req_per_s_lifetime"]}
        for field in ("queue_hist", "device_hist"):
            merged = merge_histogram_snapshots(acc[field + "s"])
            if merged is not None:
                row[field] = merged
        out_models[name] = row
    kv = {"blocks_used": 0, "blocks_total": 0, "evictions": 0}
    saw_kv = False
    for s in snaps:
        gen = s.get("generation") or {}
        for lane in gen.values():
            k = lane.get("kv")
            if not k:
                continue
            saw_kv = True
            kv["blocks_used"] += int(k.get("blocks_used", 0))
            kv["blocks_total"] += int(k.get("blocks_total", 0))
            kv["evictions"] += int(k.get("evictions", 0))
    hbm = sum(int((s.get("hbm") or {}).get("total_bytes", 0)) for s in snaps)
    return {
        "replicas_merged": len(snaps),
        "models": out_models,
        "slo": merge_slo_snapshots([s.get("slo") for s in snaps]),
        **({"kv": kv} if saw_kv else {}),
        **({"hbm_bytes_total": hbm} if hbm else {}),
    }
