"""The fleet control plane: replica registry, residency-aware router,
failover, drain and disaggregated prefill/decode.

The port's copy of the JAX package's ``serving/fleet.py``.  A lightweight
router in front of N ``cli serve`` replicas, sharing nothing with them but
their public HTTP surface; it touches no device, runs no kernel and holds
no weights:

- **Registry and polling**: every ``poll_interval_s`` each replica's
  ``/healthz`` (liveness, drain flag, per-model queue-wait forecast) and
  ``/admin/models`` (residency, ``estimated_warm_ms``) fold into a
  :class:`Replica`; the ``/metrics`` JSON is scraped for the fleet rollup.
- **Residency-aware routing**: a request for model M goes to a replica where
  M is resident, least forecast queue wait among them; a ``cold_start`` 503
  spills to a warm peer while the router activates the cold replica in the
  background (one activation in flight per replica and model).
- **Failure tracking and failover**: quarantine after consecutive connect
  failures, a per-replica circuit breaker, connect- and deadline-aware
  timeouts, ONE failover retry to a different replica, ``Idempotency-Key``
  affinity so resubmits dedupe against the journal that acked them.
- **Drain**: ``POST /admin/fleet {"action": "drain"}`` stops routing at
  once, lets the replica drain its in-flight work, then (a spawned fleet)
  terminates its process.
- **Disaggregated prefill/decode**: a prefill-tagged replica prefills; at
  the first token the stream's pages move (export, import, commit) to a
  decode replica, and the router journals them with the emitted-token
  watermark, so a decode replica's death resumes the stream on a peer with
  no token lost or repeated.
- **Chaos**: :class:`~..faults.FleetFaultInjector` rules (partition,
  slow_replica, replica_kill) on ``/admin/fleet/faults``.

The reference serves and calls with aiohttp; the port serves with its own
framing (``httpframe.py``) and calls with its own client (``httpclient.py``),
both on the standard library.  The router opens a trace per request and
sends its ``traceparent`` downstream, so a replica's span tree parents under
the router's span (one trace id across the processes).
"""

from __future__ import annotations

import asyncio
import json
import math
import random
import re
import time
from collections import OrderedDict
from typing import Any, AsyncIterator, Callable
from urllib.parse import parse_qs

from ..config import FleetConfig
from ..faults import FleetFaultInjector, ReplicaPartitioned
from ..utils.aio import cancel_and_wait
from ..utils.logging import get_logger, log_event
from .autoscale import SingleFlight, desired_replicas, fleet_wait_ms
from .httpclient import ClientPool, ClientResponse, ClientTimeout, ConnectFailed
from .httpframe import HttpError, RawBody, encode, head, keep_alive, read_request
from .metrics import Histogram, _prom_label
from .resilience import CircuitBreaker
from .slo import merge_slo_snapshots, rollup_metrics
from .tracing import Tracer, new_request_id

log = get_logger("serving.fleet")

# Numeric encoding of the Prometheus replica-state gauge.
REPLICA_STATE_CODE = {"unknown": 0, "healthy": 1, "degraded": 2,
                      "draining": 3, "quarantined": 4}

# Hop-by-hop or recomputed headers, never forwarded to a replica.
_SKIP_FWD_HEADERS = {"host", "content-length", "connection", "keep-alive",
                     "transfer-encoding", "accept-encoding", "traceparent"}

# What a dead, partitioned or slow upstream raises at a streaming read: the
# client's connect failures and severed bodies are ConnectionErrors.
_UPSTREAM_ERRORS = (ReplicaPartitioned, ConnectionError, asyncio.TimeoutError, TimeoutError)

# Answer headers copied back from the replica to the client.
_COPY_BACK_HEADERS = ("Content-Type", "Retry-After", "X-Request-Id",
                      "X-Trace-Id", "X-Queue-Ms", "X-Device-Ms",
                      "X-Served-Variant", "X-Degraded")

# Residency state -> routing rank (lower first).  ACTIVE, PINNED and
# DRAINING_IDLE serve at once; WARMING is mid-activation; unknown (no poll
# yet) sorts between WARMING and COLD, so a new replica is still usable.
_WARMTH_RANK = {"active": 0, "pinned": 0, "draining_idle": 0,
                "warming": 1, "cold": 3}

_PREDICT = re.compile(r"^/v1/models/([^:/]+):predict$")
_GENERATE = re.compile(r"^/v1/models/([^:/]+):generate$")
_SUBMIT = re.compile(r"^/v1/models/([^:/]+):submit$")
_JOB = re.compile(r"^/v1/jobs/([^/]+)$")

Reply = tuple[int, Any, dict[str, str]]


class Request:
    """One framed request: header names lowercased, the body read whole."""

    __slots__ = ("method", "path", "query", "headers", "body")

    def __init__(self, method: str, path: str, query: str, headers: dict[str, str],
                 body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body

    def json(self) -> dict:
        """The body as a JSON object ({} when empty); ValueError otherwise."""
        if not self.body:
            return {}
        obj = json.loads(self.body)
        if not isinstance(obj, dict):
            raise ValueError("body must be a JSON object")
        return obj


class Stream:
    """A server-sent event answer: ``events`` yields the body's bytes, each
    written as one chunk as it comes; ``close`` runs once however the
    stream ends (the client gone included)."""

    def __init__(self, headers: dict[str, str], events: AsyncIterator[bytes],
                 close: Callable[[], None]):
        self.headers = headers
        self.events = events
        self._close = close
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._close()


def _json_reply(obj: Any, status: int = 200, headers: dict[str, str] | None = None) -> Reply:
    return status, obj, dict(headers or {})


def _sse(obj: dict) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


class Replica:
    """One replica's registry record: identity, polled state, failure
    tracking.  Confined to the router's event loop."""

    def __init__(self, rid: str, url: str, cfg: FleetConfig, clock=time.monotonic):
        self.id = rid
        self.url = url.rstrip("/")
        self.cfg = cfg
        self.clock = clock
        self.breaker = (CircuitBreaker(threshold=cfg.breaker_threshold,
                                       window=cfg.breaker_window,
                                       min_samples=cfg.breaker_min_samples,
                                       open_s=cfg.breaker_open_s, clock=clock)
                        if cfg.breaker_threshold > 0 else None)
        self.consecutive_failures = 0   # guarded-by: event-loop
        self.forced_quarantine = False  # guarded-by: event-loop
        self.draining = False           # guarded-by: event-loop
        self.replica_draining = False   # guarded-by: event-loop
        self.healthy: bool | None = None  # guarded-by: event-loop
        self.residency: dict[str, dict] = {}   # guarded-by: event-loop
        self.forecast: dict[str, float] = {}   # guarded-by: event-loop
        # Variant families the replica reported: family -> [variants].  A
        # replica where any rung of the ladder is warm counts as warm for
        # family-addressed traffic.
        self.families: dict[str, list[str]] = {}  # guarded-by: event-loop
        # Tenant adapter residency: model -> {adapter: state}.  A warm slot
        # is a routing signal (locality keeps attach churn down).
        self.adapters: dict[str, dict[str, str]] = {}  # guarded-by: event-loop
        self.server_quarantined: set[str] = set()  # guarded-by: event-loop
        # The burn-rate block of the replica's /healthz.
        self.slo_summary: dict = {}  # guarded-by: event-loop
        # The replica's last /metrics JSON, the island the fleet rollup folds;
        # a failed scrape keeps the stale copy.
        self.metrics_json: dict = {}  # guarded-by: event-loop
        self.last_poll: float | None = None  # guarded-by: event-loop
        self.last_error: str | None = None   # guarded-by: event-loop
        self.inflight = 0        # guarded-by: event-loop
        self.routed = 0          # guarded-by: event-loop
        self.failures = 0        # guarded-by: event-loop
        self.quarantines = 0     # guarded-by: event-loop
        self.readmits = 0        # guarded-by: event-loop
        self._was_quarantined = False  # guarded-by: event-loop

    # -- state ---------------------------------------------------------------
    @property
    def quarantined(self) -> bool:
        """Derived, not latched: a clean poll resets the connect-failure
        count and the breaker's cooldown expires on its own."""
        if self.forced_quarantine:
            return True
        if self.consecutive_failures >= max(self.cfg.quarantine_after, 1):
            return True
        return self.breaker is not None and self.breaker.state == "open"

    @property
    def state(self) -> str:
        if self.draining or self.replica_draining:
            return "draining"
        if self.quarantined:
            return "quarantined"
        if self.healthy is None:
            return "unknown"
        return "healthy" if self.healthy else "degraded"

    def routable(self, model: str | None = None) -> bool:
        """May work go here now?  Non-mutating: quarantine, drain and a
        degraded replica exclude it; a per-model quarantine excludes only
        that model (every variant of a family).  The breaker's half-open
        probe is spent by :meth:`ReplicaRegistry.pick` at selection only."""
        if self.draining or self.replica_draining or self.quarantined:
            return False
        if self.healthy is False:
            return False
        if model is not None and all(v in self.server_quarantined
                                     for v in self.variants_of(model)):
            return False
        return True

    def variants_of(self, model: str) -> list[str]:
        """The names ``model`` may resolve to here: a reported family's
        ladder, else the name itself."""
        return self.families.get(model) or [model]

    def model_rank(self, model: str | None) -> int:
        if model is None:
            return 0
        ranks = []
        for v in self.variants_of(model):
            info = self.residency.get(v)
            ranks.append(_WARMTH_RANK.get(info.get("state"), 2) if info is not None else 2)
        return min(ranks) if ranks else 2

    def adapter_rank(self, model: str | None, adapter: str | None) -> int:
        """0 when the tenant's adapter is warm here, 1 attaching, 2
        otherwise; it sorts after model residency."""
        if not adapter or model is None:
            return 0
        for v in self.variants_of(model):
            state = (self.adapters.get(v) or {}).get(adapter)
            if state == "active":
                return 0
            if state == "attaching":
                return 1
        return 2

    def forecast_ms(self, model: str) -> float:
        """Queue-wait forecast of a model or family (the family's minimum)."""
        waits = [self.forecast[v] for v in self.variants_of(model) if v in self.forecast]
        return min(waits) if waits else 0.0

    def estimated_warm_ms(self, model: str | None) -> float | None:
        if not model:
            return None
        ests = [self.residency[v].get("estimated_warm_ms")
                for v in self.variants_of(model) if v in self.residency]
        ests = [e for e in ests if e is not None]
        return min(ests) if ests else None

    # -- outcome tracking ----------------------------------------------------
    def _track_quarantine_edge(self):
        q = self.quarantined
        if q and not self._was_quarantined:
            self.quarantines += 1
            log_event(log, "replica quarantined", replica=self.id, url=self.url,
                      failures=self.consecutive_failures, error=self.last_error)
        elif self._was_quarantined and not q:
            self.readmits += 1
            log_event(log, "replica re-admitted", replica=self.id)
        self._was_quarantined = q

    def note_failure(self, err: BaseException | str, connect: bool = False):
        self.failures += 1
        self.last_error = (f"{type(err).__name__}: {err}" if isinstance(err, BaseException)
                           else str(err))
        if connect:
            # Connect-level failures are the consecutive-failure quarantine's
            # alone: fed to the breaker, a boot window's failed polls would
            # open it, and only real traffic closes a breaker.
            self.consecutive_failures += 1
        elif self.breaker is not None:
            self.breaker.record(False)
        self._track_quarantine_edge()

    def note_success(self):
        self.consecutive_failures = 0
        if self.breaker is not None:
            self.breaker.record(True)
        self._track_quarantine_edge()

    def poll_ok(self, health: dict, models: dict):
        """Fold one successful poll round into the record."""
        self.last_poll = self.clock()
        self.consecutive_failures = 0
        self.replica_draining = bool(health.get("draining"))
        self.healthy = bool(health.get("device_ok", True)) and not self.replica_draining
        self.server_quarantined = set(health.get("quarantined") or ())
        self.slo_summary = dict(health.get("slo") or {})
        self.forecast = {m: float(v) for m, v in (health.get("forecast") or {}).items()}
        res = {}
        fams: dict[str, list[str]] = {}
        adps: dict[str, dict[str, str]] = {}
        for name, m in (models.get("models") or {}).items():
            res[name] = {"state": "pinned" if m.get("pinned") else m.get("state"),
                         "estimated_warm_ms": m.get("estimated_warm_ms")}
            fam = m.get("family")
            if fam:
                fams.setdefault(fam, []).append(name)
            if m.get("adapters"):
                adps[name] = dict(m["adapters"])
        self.residency = res
        self.families = {f: sorted(v) for f, v in fams.items()}
        self.adapters = adps
        self._track_quarantine_edge()

    def poll_failed(self, err: BaseException):
        # One missed poll does not unroute a replica (a busy host can blow
        # one budget); sustained failure quarantines by the threshold.
        self.note_failure(err, connect=True)

    def snapshot(self) -> dict:
        out = {
            "url": self.url,
            "state": self.state,
            "healthy": self.healthy,
            "draining": self.draining or self.replica_draining,
            "quarantined": self.quarantined,
            "forced_quarantine": self.forced_quarantine,
            "consecutive_failures": self.consecutive_failures,
            "inflight": self.inflight,
            "routed": self.routed,
            "failures": self.failures,
            "quarantines": self.quarantines,
            "readmits": self.readmits,
            "last_error": self.last_error,
            "last_poll_s_ago": (round(self.clock() - self.last_poll, 3)
                                if self.last_poll is not None else None),
            "residency": self.residency,
            "forecast": self.forecast,
            "models_quarantined": sorted(self.server_quarantined),
            **({"adapters": self.adapters} if self.adapters else {}),
            **({"slo": self.slo_summary} if self.slo_summary else {}),
        }
        if self.breaker is not None:
            out["breaker"] = {"state": self.breaker.state,
                              "error_rate": round(self.breaker.error_rate(), 3),
                              "opens": self.breaker.opens}
        return out


class ReplicaRegistry:
    """The routing table: replicas and the pick policy.  No I/O: the router
    feeds it poll results, so the policy tests without a network."""

    def __init__(self, cfg: FleetConfig, clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.replicas: dict[str, Replica] = {}  # guarded-by: event-loop
        self._next_id = 0  # guarded-by: event-loop

    def add(self, url: str, rid: str | None = None) -> Replica:
        if rid is None:
            rid = f"r{self._next_id}"
        self._next_id += 1
        r = Replica(rid, url, self.cfg, clock=self.clock)
        self.replicas[rid] = r
        return r

    def remove(self, rid: str) -> bool:
        return self.replicas.pop(rid, None) is not None

    def get(self, rid: str) -> Replica | None:
        return self.replicas.get(rid)

    def pick(self, model: str | None, exclude: set[str] = frozenset(),
             adapter: str | None = None) -> Replica | None:
        """Among routable replicas: resident first (then WARMING, unknown,
        COLD), then the tenant's adapter residency, least forecast queue
        wait, fewest router-side forwards in flight, and the smallest
        activation estimate (an all-cold fleet warms its cheapest)."""
        cands = [r for r in self.replicas.values() if r.id not in exclude and r.routable(model)]
        key = lambda r: (  # noqa: E731  (the selection order in one place)
            r.model_rank(model),
            r.adapter_rank(model, adapter),
            r.forecast_ms(model) if model else
            (sum(r.forecast.values()) / len(r.forecast) if r.forecast else 0.0),
            r.inflight,
            r.estimated_warm_ms(model) or 0.0,
            r.id)
        while cands:
            best = min(cands, key=key)
            # The half-open probe is spent here, on the replica that gets
            # the request, never by a losing candidate.
            if best.breaker is None or best.breaker.allow():
                return best
            cands.remove(best)
        return None

    def states(self) -> dict[str, int]:
        counts = dict.fromkeys(REPLICA_STATE_CODE, 0)
        for r in self.replicas.values():
            counts[r.state] += 1
        return counts

    def min_estimated_warm_ms(self, model: str | None) -> float | None:
        ests = [r.estimated_warm_ms(model) for r in self.replicas.values()]
        ests = [e for e in ests if e is not None]
        return min(ests) if ests else None

    def snapshot(self) -> dict:
        return {rid: r.snapshot() for rid, r in sorted(self.replicas.items())}


class FleetMetrics:
    """The router's counters and histograms, rendered as ``tpuserve_fleet_*``
    (and ``tpuserve_autoscale_scale_events_total``).  Per-replica counts live
    on the :class:`Replica` records."""

    def __init__(self):
        self.requests_total: dict[str, int] = {}     # guarded-by: event-loop
        self.failovers_total: dict[str, int] = {}    # guarded-by: event-loop
        self.spills_total: dict[str, int] = {}       # guarded-by: event-loop
        self.activations_triggered: dict[str, int] = {}  # guarded-by: event-loop
        # Cold spills that found an activation already in flight for the
        # same (replica, model): deduped, not sent again.
        self.activations_deduped: dict[str, int] = {}  # guarded-by: event-loop
        # Replica scale actions (out|in).
        self.scale_events_total: dict[str, int] = {}  # guarded-by: event-loop
        self.shed_total: dict[str, int] = {}         # guarded-by: event-loop
        # Serves below the family ladder's top that passed through.
        self.degraded_total: dict[str, int] = {}     # guarded-by: event-loop
        self.retries_total = 0  # guarded-by: event-loop
        # Disaggregated stream moves by stage: "prefill" (prefill to decode)
        # and "failover" (resumed on a peer after a decode replica died).
        self.migrations_total: dict[str, int] = {}  # guarded-by: event-loop
        self.polls_total = 0    # guarded-by: event-loop
        self.poll_failures_total: dict[str, int] = {}  # guarded-by: event-loop
        self.router_ms: dict[str, Histogram] = {}    # guarded-by: event-loop

    @staticmethod
    def _bump(d: dict, key: str, n: int = 1):
        d[key] = d.get(key, 0) + n

    def observe(self, model: str | None, ms: float, trace_id: str | None = None):
        key = model or "_default"
        if key not in self.router_ms:
            self.router_ms[key] = Histogram()
        self.router_ms[key].observe(ms, trace_id)

    def render(self, registry: ReplicaRegistry, faults: FleetFaultInjector) -> dict:
        return {
            # Every replica's scraped /metrics JSON folded into one view.
            "rollup": rollup_metrics([r.metrics_json for r in registry.replicas.values()]),
            "replicas": registry.snapshot(),
            "replica_states": registry.states(),
            "requests": dict(self.requests_total),
            "failovers": dict(self.failovers_total),
            "retries": self.retries_total,
            "migrations": dict(self.migrations_total),
            "spills": dict(self.spills_total),
            "degraded": dict(self.degraded_total),
            "activations_triggered": dict(self.activations_triggered),
            "activations_deduped": dict(self.activations_deduped),
            "scale_events": dict(self.scale_events_total),
            "shed": dict(self.shed_total),
            "polls": {"total": self.polls_total, "failures": dict(self.poll_failures_total)},
            "router_ms": {m: h.snapshot() for m, h in self.router_ms.items()},
            "faults": faults.snapshot(),
        }

    def render_prometheus(self, registry: ReplicaRegistry, faults: FleetFaultInjector) -> str:
        lines: list[str] = []

        def metric(name, mtype, help_text, samples):
            rows = [(lbl, v) for lbl, v in samples if v is not None]
            if not rows:
                return
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for lbl, v in rows:
                label_s = ",".join(f'{k}="{_prom_label(val)}"' for k, val in sorted(lbl.items()))
                lines.append(f"{name}{{{label_s}}} {v}" if label_s else f"{name} {v}")

        reps = sorted(registry.replicas.items())
        metric("tpuserve_fleet_replica_state", "gauge",
               "Replica state (0=unknown,1=healthy,2=degraded,3=draining,4=quarantined)",
               [({"replica": rid}, REPLICA_STATE_CODE[r.state]) for rid, r in reps])
        metric("tpuserve_fleet_replicas", "gauge", "Replica count per state",
               [({"state": s}, n) for s, n in registry.states().items()])
        metric("tpuserve_fleet_inflight", "gauge", "Router-side in-flight forwards per replica",
               [({"replica": rid}, r.inflight) for rid, r in reps])
        metric("tpuserve_fleet_routed_total", "counter", "Requests answered per replica",
               [({"replica": rid}, r.routed) for rid, r in reps])
        metric("tpuserve_fleet_replica_failures_total", "counter",
               "Forward failures per replica (any reason)",
               [({"replica": rid}, r.failures) for rid, r in reps])
        metric("tpuserve_fleet_quarantines_total", "counter",
               "Routable→quarantined transitions per replica",
               [({"replica": rid}, r.quarantines) for rid, r in reps])
        metric("tpuserve_fleet_readmits_total", "counter",
               "Quarantined→routable transitions per replica",
               [({"replica": rid}, r.readmits) for rid, r in reps])
        metric("tpuserve_fleet_requests_total", "counter", "Requests entering the router per kind",
               [({"kind": k}, v) for k, v in self.requests_total.items()])
        metric("tpuserve_fleet_failovers_total", "counter",
               "Failover attempts by reason "
               "(connect|timeout|cold_start|overloaded|unavailable|error)",
               [({"reason": k}, v) for k, v in self.failovers_total.items()])
        metric("tpuserve_fleet_retries_total", "counter",
               "Total extra routing attempts after the first choice",
               [({}, self.retries_total)] if self.retries_total else [])
        metric("tpuserve_fleet_spills_total", "counter",
               "Cold-start 503s spilled to a warm peer per model",
               [({"model": m}, v) for m, v in self.spills_total.items()])
        metric("tpuserve_fleet_degraded_total", "counter",
               "Degraded (below-ladder-top) serves routed per model/family",
               [({"model": m}, v) for m, v in self.degraded_total.items()])
        metric("tpuserve_fleet_activations_triggered_total", "counter",
               "Background activations the router fired on cold replicas",
               [({"model": m}, v) for m, v in self.activations_triggered.items()])
        metric("tpuserve_autoscale_scale_events_total", "counter",
               "Replica scale actions applied by direction (out|in)",
               [({"direction": d}, v) for d, v in self.scale_events_total.items()])
        metric("tpuserve_fleet_shed_total", "counter",
               "Requests the router shed fleet-wide by reason "
               "(no_replica|all_cold|all_overloaded|all_failed|owner_recovering)",
               [({"reason": k}, v) for k, v in self.shed_total.items()])
        metric("tpuserve_fleet_polls_total", "counter", "Registry poll rounds completed",
               [({}, self.polls_total)] if self.polls_total else [])
        metric("tpuserve_fleet_poll_failures_total", "counter", "Failed replica polls per replica",
               [({"replica": rid}, v) for rid, v in self.poll_failures_total.items()])
        fsnap = faults.snapshot()
        metric("tpuserve_fleet_faults_injected_total", "counter",
               "Fleet chaos faults injected by kind",
               [({"kind": k}, v) for k, v in fsnap["injected"].items()])
        hists = [(lbl, h) for lbl, h in
                 [({"model": m}, h) for m, h in sorted(self.router_ms.items())] if h.count]
        if hists:
            name = "tpuserve_fleet_router_ms"
            lines.append(f"# HELP {name} Router end-to-end time per request "
                         "(ms, includes failover attempts)")
            lines.append(f"# TYPE {name} histogram")
            for lbl, h in hists:
                base = ",".join(f'{k}="{_prom_label(v)}"' for k, v in sorted(lbl.items()))
                for le, acc, _ex in h.rows():
                    lines.append(f'{name}_bucket{{{base},le="{le}"}} {acc}')
                lines.append(f"{name}_sum{{{base}}} {round(h.sum, 3)}")
                lines.append(f"{name}_count{{{base}}} {h.count}")
        return "\n".join(lines) + "\n"


class _BoundedMap(OrderedDict):
    """Insertion-bounded dict of the job, idempotency and stream maps."""

    def __init__(self, capacity: int):
        super().__init__()
        self.capacity = max(int(capacity), 16)

    def put(self, key, value):
        if key in self:
            self.move_to_end(key)
        self[key] = value
        while len(self) > self.capacity:
            self.popitem(last=False)


class _Attempt:
    """One forward attempt's outcome, kept for the shed's recompute."""

    __slots__ = ("replica_id", "status", "retry_after_s", "body")

    def __init__(self, replica_id: str, status: int, retry_after_s: float | None,
                 body: dict | None):
        self.replica_id = replica_id
        self.status = status
        self.retry_after_s = retry_after_s
        self.body = body or {}


class FleetRouter:
    """The control-plane process: registry, router and admin surface.

    ``kill_hook`` and ``terminate_hook`` are optional ``(replica_id) ->
    bool`` callables the fleet command wires (SIGKILL and SIGTERM of a
    spawned replica): the ``replica_kill`` rule and the exit after a drain
    are no-ops without them.  ``spawn_hook`` is the scale-out twin, ``() ->
    url | None``, starting one more replica process.

    :meth:`start` listens (stdlib asyncio, ``httpframe.py`` framing) and
    starts the poll and scale loops; :meth:`stop` ends them."""

    def __init__(self, cfg: FleetConfig, rng: random.Random | None = None,
                 kill_hook: Callable[[str], bool] | None = None,
                 terminate_hook: Callable[[str], bool] | None = None,
                 spawn_hook: Callable[[], str | None] | None = None):
        self.cfg = cfg
        self.rng = rng if rng is not None else random.Random()
        self.registry = ReplicaRegistry(cfg)
        self.metrics = FleetMetrics()
        self.faults = FleetFaultInjector()
        self.tracer = Tracer()
        self.kill_hook = kill_hook
        self.terminate_hook = terminate_hook
        self.spawn_hook = spawn_hook
        # At most ONE background activation in flight per (replica, model).
        self._activation_flight = SingleFlight()
        self._client = ClientPool()  # guarded-by: event-loop
        self._server: asyncio.Server | None = None  # guarded-by: event-loop
        self._conns: set = set()  # guarded-by: event-loop
        self._poll_task: asyncio.Task | None = None  # guarded-by: event-loop
        self._scale_task: asyncio.Task | None = None  # guarded-by: event-loop
        # Affinity: job id -> replica (polls route home) and Idempotency-Key
        # -> replica (resubmits hit the journal that acked the original).
        self._job_affinity = _BoundedMap(cfg.affinity_capacity)
        self._key_affinity = _BoundedMap(cfg.affinity_capacity)
        # Disaggregated streams: stream id -> the migrated manifest and
        # pages and the emitted-token watermark the router has forwarded.
        self._stream_journal = _BoundedMap(cfg.stream_journal_capacity)
        for url in cfg.replicas:
            self.registry.add(str(url))
        self._routes = {
            "/": {"GET": self.handle_root},
            "/healthz": {"GET": self.handle_healthz},
            "/metrics": {"GET": self.handle_metrics},
            "/admin/fleet": {"GET": self.handle_fleet_get, "POST": self.handle_fleet_post},
            "/admin/slo": {"GET": self.handle_admin_slo},
            "/admin/fleet/scale": {"GET": self.handle_scale_get, "POST": self.handle_scale_post},
            "/admin/fleet/faults": {"GET": self.handle_faults_get,
                                    "POST": self.handle_faults_post},
            "/predict": {"POST": self.handle_default},
            "/classify": {"POST": self.handle_default},
        }
        self._patterns = ((_PREDICT, "POST", self.handle_predict),
                          (_GENERATE, "POST", self.handle_generate),
                          (_SUBMIT, "POST", self.handle_submit),
                          (_JOB, "GET", self.handle_job))

    # -- lifecycle -----------------------------------------------------------
    async def start(self, host: str | None = None, port: int | None = None) -> int:
        """Listen and start the loops; returns the bound port."""
        self._server = await asyncio.start_server(
            self._handle_conn, host or self.cfg.host, self.cfg.port if port is None else port)
        loop = asyncio.get_running_loop()
        if self.cfg.poll_interval_s > 0:
            self._poll_task = loop.create_task(self._poll_loop(), name="fleet-poll")
        if self.cfg.autoscale_interval_s > 0:
            # One "auto" scale step per interval off the queue forecast.
            self._scale_task = loop.create_task(self._scale_loop(), name="fleet-scale")
        log_event(log, "fleet router ready",
                  replicas={r.id: r.url for r in self.registry.replicas.values()})
        return self._server.sockets[0].getsockname()[1]

    async def stop(self):
        for attr in ("_poll_task", "_scale_task"):
            await cancel_and_wait(getattr(self, attr))
            setattr(self, attr, None)
        if self._server is not None:
            self._server.close()
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None
        await self._client.close()

    async def _request(self, method: str, url: str, timeout: ClientTimeout,
                       **kw) -> ClientResponse:
        return await self._client.request(method, url, timeout=timeout, **kw)

    # -- the HTTP surface ----------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._conns.add(writer)
        try:
            while True:
                try:
                    req = await read_request(reader)
                except HttpError as e:
                    writer.write(encode(e.status, {"error": str(e)}, {}, keep_alive=False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, path, query, version, headers, body = req
                keep = keep_alive(version, headers)
                reply = await self._dispatch(Request(method, path, query, headers, body))
                if isinstance(reply, Stream):
                    keep = await self._write_stream(writer, reply, keep)
                else:
                    status, obj, extra = reply
                    writer.write(encode(status, obj, extra, keep))
                    await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass  # the client went away or sent an over-long line
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _write_stream(self, writer, stream: Stream, keep: bool) -> bool:
        try:
            writer.write(head(200, ["Content-Type: text/event-stream", "Cache-Control: no-cache",
                                    "Transfer-Encoding: chunked"], stream.headers, keep))
            await writer.drain()
            async for data in stream.events:
                writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return keep
        finally:
            await stream.events.aclose()
            stream.close()

    async def _dispatch(self, req: Request):
        for pattern, method, handler in self._patterns:
            m = pattern.match(req.path)
            if m is not None:
                if req.method != method:
                    return _json_reply({"error": f"{req.path} takes {method}"}, 405)
                args = (m.group(1), req)
                break
        else:
            methods = self._routes.get(req.path)
            if methods is None:
                return _json_reply({"error": f"no route {req.path}"}, 404)
            if req.method not in methods:
                return _json_reply({"error": f"{req.path} takes {' or '.join(methods)}"}, 405)
            handler, args = methods[req.method], (req,)
        try:
            return await handler(*args)
        except ConnectionError:
            raise
        except Exception as e:
            log.exception("fleet handler failed for %s %s", req.method, req.path)
            return _json_reply({"error": f"internal error: {type(e).__name__}"}, 500)

    # -- registry polling ----------------------------------------------------
    async def _poll_loop(self):
        while True:
            await asyncio.sleep(self.cfg.poll_interval_s)
            try:
                await self.poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("fleet poll round failed; the next interval retries")

    async def poll_once(self):
        """One poll round over every replica (the loop is this on a timer)."""
        self.metrics.polls_total += 1
        await asyncio.gather(*[self._poll_replica(r)
                               for r in list(self.registry.replicas.values())])

    async def _get_json(self, url: str, timeout: ClientTimeout, headers=None) -> tuple[int, Any]:
        async with await self._request("GET", url, timeout, headers=headers) as resp:
            raw = await resp.read()
            return resp.status, (json.loads(raw) if raw else {})

    async def _poll_replica(self, r: Replica):
        timeout = ClientTimeout(total=max(self.cfg.poll_interval_s * 2, 2.0),
                                connect=self.cfg.connect_timeout_s)
        try:
            self.faults.check(r.id, poll=True)  # a partition: unreachable
            _, health = await self._get_json(r.url + "/healthz", timeout)
            status, models = await self._get_json(r.url + "/admin/models", timeout)
            if status != 200:
                models = {}
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.metrics._bump(self.metrics.poll_failures_total, r.id)
            r.poll_failed(e)
            return
        r.poll_ok(health, models)
        try:
            # The rollup's scrape: a failed one keeps the stale copy and never
            # counts against the replica's health.
            status, body = await self._get_json(r.url + "/metrics", timeout,
                                                headers={"Accept": "application/json"})
            if status == 200:
                r.metrics_json = body
        except asyncio.CancelledError:
            raise
        except Exception:
            pass

    # -- forwarding ----------------------------------------------------------
    def _fwd_headers(self, req: Request, span) -> dict[str, str]:
        headers = {k: v for k, v in req.headers.items() if k not in _SKIP_FWD_HEADERS}
        # The router's span parents the replica's whole trace.
        headers["traceparent"] = span.traceparent
        return headers

    def _timeout(self, req: Request) -> ClientTimeout:
        """One attempt's budget: a client deadline tightens the total (plus
        grace for the replica's own 504); connect stays short."""
        total = self.cfg.request_timeout_s
        raw = req.headers.get("x-deadline-ms")
        if raw:
            try:
                total = min(total, max(float(raw) / 1000.0 + 0.5, 0.1))
            except ValueError:
                pass
        return ClientTimeout(total=total, connect=self.cfg.connect_timeout_s)

    def _fire_kill(self, r: Replica):
        if self.kill_hook is not None:
            try:
                self.kill_hook(r.id)
                log_event(log, "chaos replica_kill fired", replica=r.id)
            except Exception:
                log.exception("replica_kill hook failed for %s", r.id)

    async def _forward(self, r: Replica, method: str, path: str, body: bytes | None,
                       headers: dict, timeout: ClientTimeout) -> tuple[int, dict, bytes]:
        delay_s = self.faults.check(r.id)  # may raise ReplicaPartitioned
        if self.faults.should_kill(r.id):
            self._fire_kill(r)
        if delay_s:
            await asyncio.sleep(delay_s)
        async with await self._request(method, r.url + path, timeout, data=body,
                                       headers=headers) as resp:
            raw = await resp.read()
            return resp.status, resp.headers, raw

    async def _failover_pause(self):
        base = self.cfg.failover_backoff_ms
        if base > 0:
            await asyncio.sleep(base * (0.5 + self.rng.random() / 2) / 1000.0)

    @staticmethod
    def _parse_json(raw: bytes) -> dict | None:
        if not raw or raw[:1] != b"{":
            return None
        try:
            body = json.loads(raw)
        except ValueError:
            return None
        return body if isinstance(body, dict) else None

    @staticmethod
    def _retry_after_s(headers: dict) -> float | None:
        raw = headers.get("retry-after")
        if raw is None:
            return None
        try:
            return float(raw)
        except ValueError:
            return None

    def _passthrough(self, status: int, headers: dict, raw: bytes, r: Replica,
                     attempts: int) -> Reply:
        out: dict[str, str] = {}
        ctype = "application/octet-stream"
        for h in _COPY_BACK_HEADERS:
            v = headers.get(h.lower())
            if v is None:
                continue
            if h == "Content-Type":
                ctype = v.split(";")[0].strip()
            else:
                out[h] = v
        out["X-Fleet-Replica"] = r.id
        out["X-Fleet-Attempts"] = str(attempts)
        return status, RawBody(raw, ctype), out

    def _trigger_activation(self, r: Replica, model: str):
        """A background activation on a cold replica, single-flight per
        (replica, model): the spilled request is on its way to a warm peer;
        this makes the next one land warm here.  Deduped spills are
        counted, not sent."""
        key = f"{r.id}:{model}"
        if self._activation_flight.running(key):
            self.metrics._bump(self.metrics.activations_deduped, model)
            return
        self.metrics._bump(self.metrics.activations_triggered, model)

        async def _do():
            try:
                timeout = ClientTimeout(total=600.0, connect=self.cfg.connect_timeout_s)
                async with await self._request("POST", r.url + f"/admin/models/{model}",
                                               timeout, json_body={"action": "activate"}) as resp:
                    await resp.read()
                    log_event(log, "background activation finished", replica=r.id, model=model,
                              status=resp.status)
            except Exception as e:
                log_event(log, "background activation failed", level="warning", replica=r.id,
                          model=model, error=f"{type(e).__name__}: {e}")

        self._activation_flight.launch(key, _do, name=f"fleet-activate-{key}")

    # -- the router's own sheds ----------------------------------------------
    def _shed_response(self, reason: str, model: str | None, attempts: list[_Attempt],
                       request_id: str, trace_id: str) -> Reply:
        """The router's own 429/503, recomputed fleet-wide: ``Retry-After``
        is the minimum over what the attempts reported, floored at 1 s;
        ``estimated_wait_ms`` and ``estimated_warm_ms`` the fleet minima."""
        candidates = [a.retry_after_s for a in attempts if a.retry_after_s is not None]
        est_wait = [a.body.get("estimated_wait_ms") for a in attempts]
        est_wait = [e for e in est_wait if isinstance(e, (int, float))]
        est_warm = [a.body.get("estimated_warm_ms") for a in attempts]
        est_warm = [e for e in est_warm if isinstance(e, (int, float))]
        fleet_warm = self.registry.min_estimated_warm_ms(model)
        if fleet_warm is not None:
            est_warm.append(fleet_warm)
        if est_wait:
            candidates.append(min(est_wait) / 1000.0)
        if reason == "all_cold" and est_warm:
            candidates.append(min(est_warm) / 1000.0)
        retry_after_s = min(candidates) if candidates else max(self.cfg.poll_interval_s, 1.0)
        statuses = {a.status for a in attempts}
        status = 429 if statuses and statuses <= {429} else 503
        self.metrics._bump(self.metrics.shed_total, reason)
        body: dict[str, Any] = {
            "error": f"fleet: {reason.replace('_', ' ')}" + (f" for model {model!r}" if model else ""),
            "fleet_shed": reason,
            "replicas_tried": [a.replica_id for a in attempts],
            "replica_states": self.registry.states(),
            "request_id": request_id,
            "trace_id": trace_id,
        }
        if est_wait:
            body["estimated_wait_ms"] = round(min(est_wait), 1)
        if est_warm:
            body["estimated_warm_ms"] = round(min(est_warm), 1)
        return status, body, {"Retry-After": str(max(int(math.ceil(retry_after_s)), 1)),
                              "X-Request-Id": request_id, "X-Trace-Id": trace_id}

    # -- the routing core ----------------------------------------------------
    async def _route_unary(self, kind: str, model: str | None, req: Request, path: str,
                           pin: Replica | None = None, record_job: bool = False,
                           idem_key: str | None = None) -> Reply:
        """One buffered request under the failover contract: a connect-level
        failure retries a DIFFERENT replica (up to ``failover_retries``); a
        ``cold_start`` 503 spills to a warm peer and activates the cold one;
        a 429 or another 503 tries a peer (the work did not run); a replica
        5xx fails over only for a ``predict`` (an ambiguous submit must not
        run twice); everything spent, the router's own shed."""
        t0 = time.monotonic()
        self.metrics._bump(self.metrics.requests_total, kind)
        request_id = req.headers.get("x-request-id") or new_request_id()
        span = self.tracer.start(f"fleet:{kind}", model=model,
                                 traceparent=req.headers.get("traceparent"),
                                 request_id=request_id)
        headers = self._fwd_headers(req, span)
        headers.setdefault("x-request-id", request_id)
        timeout = self._timeout(req)
        max_attempts = 1 + max(self.cfg.failover_retries, 0)
        tried: list[Replica] = []
        attempts: list[_Attempt] = []
        reason = "no_replica"
        try:
            while len(tried) < max_attempts:
                if pin is not None:
                    r = pin if not tried else None
                else:
                    r = self.registry.pick(model, exclude={x.id for x in tried},
                                           adapter=req.headers.get("x-adapter"))
                if r is None:
                    break
                if tried:
                    self.metrics.retries_total += 1
                    await self._failover_pause()
                tried.append(r)
                r.inflight += 1
                try:
                    status, rhdrs, raw = await self._forward(r, "POST", path, req.body, headers,
                                                             timeout)
                except (ReplicaPartitioned, ConnectionError) as e:
                    r.note_failure(e, connect=True)
                    if kind == "submit" and not isinstance(e, (ReplicaPartitioned,
                                                               ConnectFailed)):
                        # A mid-request disconnect is ambiguous for a submit:
                        # the replica may have journaled the ack.  Shed; the
                        # client retries with its Idempotency-Key.
                        span.point("ambiguous_submit", replica=r.id,
                                   error=f"{type(e).__name__}: {e}")
                        attempts.append(_Attempt(r.id, 503, None, None))
                        reason = "all_failed"
                        break
                    self.metrics._bump(self.metrics.failovers_total, "connect")
                    span.point("failover", replica=r.id, reason="connect",
                               error=f"{type(e).__name__}: {e}")
                    attempts.append(_Attempt(r.id, 503, None, None))
                    reason = "all_failed"
                    continue
                except (asyncio.TimeoutError, TimeoutError) as e:
                    r.note_failure(e, connect=True)
                    if kind == "submit":
                        span.point("ambiguous_submit", replica=r.id, reason="timeout")
                        attempts.append(_Attempt(r.id, 503, None, None))
                        reason = "all_failed"
                        break
                    self.metrics._bump(self.metrics.failovers_total, "timeout")
                    span.point("failover", replica=r.id, reason="timeout")
                    attempts.append(_Attempt(r.id, 503, None, None))
                    reason = "all_failed"
                    continue
                finally:
                    r.inflight -= 1
                jbody = self._parse_json(raw)
                if status == 503 and jbody and jbody.get("cold_start"):
                    # Warm peers take THIS request; the cold replica warms
                    # for the next.
                    r.note_success()  # it answered: it is not sick
                    self.metrics._bump(self.metrics.spills_total, model or "_default")
                    self.metrics._bump(self.metrics.failovers_total, "cold_start")
                    span.point("cold_spill", replica=r.id)
                    if model:
                        self._trigger_activation(r, model)
                    attempts.append(_Attempt(r.id, status, self._retry_after_s(rhdrs), jbody))
                    reason = "all_cold"
                    continue
                if status == 429 or status == 503:
                    # Shed before any work ran: a peer may have capacity.
                    if status == 429:
                        r.note_success()
                    else:
                        r.note_failure(f"replica shed 503: {(jbody or {}).get('error', '')}")
                    self.metrics._bump(self.metrics.failovers_total,
                                       "overloaded" if status == 429 else "unavailable")
                    span.point("failover", replica=r.id, status=status)
                    attempts.append(_Attempt(r.id, status, self._retry_after_s(rhdrs), jbody))
                    reason = "all_overloaded" if status == 429 else "all_failed"
                    continue
                if status >= 500 and kind == "predict":
                    # A predict is idempotent: one different replica may
                    # still answer; the breaker takes the failure.
                    r.note_failure(f"replica answered {status}")
                    self.metrics._bump(self.metrics.failovers_total, "error")
                    span.point("failover", replica=r.id, status=status)
                    attempts.append(_Attempt(r.id, status, self._retry_after_s(rhdrs), jbody))
                    reason = "all_failed"
                    continue
                # A terminal answer (success or a non-retryable error).
                if status < 500:
                    r.note_success()
                else:
                    r.note_failure(f"replica answered {status}")
                r.routed += 1
                if status < 400 and rhdrs.get("x-degraded"):
                    self.metrics._bump(self.metrics.degraded_total, model or "_default")
                span.annotate(replica=r.id, http_status=status, attempts=len(tried))
                if record_job and status in (200, 202) and jbody:
                    jid = (jbody.get("job") or {}).get("id")
                    if jid:
                        self._job_affinity.put(jid, r.id)
                    if idem_key:
                        self._key_affinity.put(idem_key, r.id)
                self.tracer.finish(span.trace, "error" if status >= 400 else "ok")
                self.metrics.observe(model, (time.monotonic() - t0) * 1000.0,
                                     span.trace.trace_id)
                return self._passthrough(status, rhdrs, raw, r, len(tried))
            # Every allowed attempt spent, or nothing routable.
            resp = self._shed_response(reason, model, attempts, request_id, span.trace.trace_id)
            span.annotate(shed=reason, attempts=len(tried))
            self.tracer.finish(span.trace, "error")
            self.metrics.observe(model, (time.monotonic() - t0) * 1000.0, span.trace.trace_id)
            return resp
        except asyncio.CancelledError:
            self.tracer.finish(span.trace, "error")
            raise

    # -- handlers: the work surface ------------------------------------------
    async def handle_predict(self, name: str, req: Request) -> Reply:
        return await self._route_unary("predict", name, req, f"/v1/models/{name}:predict")

    async def handle_default(self, req: Request) -> Reply:
        return await self._route_unary("predict", self.cfg.default_model or None, req, req.path)

    async def handle_submit(self, name: str, req: Request) -> Reply:
        idem_key = req.headers.get("idempotency-key")
        if idem_key is None:
            # The body field twin (the replica takes both): the router must
            # see it too, or body-keyed resubmits would dodge the affinity.
            sniffed = self._parse_json(req.body)
            if sniffed and sniffed.get("idempotency_key") is not None:
                idem_key = str(sniffed["idempotency_key"])
        pin = None
        if idem_key:
            rid = self._key_affinity.get(idem_key)
            if rid is not None:
                owner = self.registry.get(rid)
                if owner is not None and owner.routable(name):
                    # The journal that acked this key owns it: resubmits
                    # answer deduped from there.
                    pin = owner
                elif owner is not None:
                    # Running the key on a peer would be the cross-replica
                    # double run the contract forbids: shed; the owner's
                    # journal replays the job when it returns.
                    self.metrics._bump(self.metrics.requests_total, "submit")
                    self.metrics._bump(self.metrics.shed_total, "owner_recovering")
                    request_id = req.headers.get("x-request-id") or new_request_id()
                    return _json_reply(
                        {"error": f"replica {rid!r} owning Idempotency-Key {idem_key!r} is "
                                  f"{owner.state}; its journal replays the job on restart",
                         "fleet_shed": "owner_recovering", "replica": rid,
                         "request_id": request_id}, 503,
                        {"Retry-After": str(max(int(math.ceil(self.cfg.poll_interval_s * 2)), 1)),
                         "X-Request-Id": request_id})
        return await self._route_unary("submit", name, req, f"/v1/models/{name}:submit",
                                       pin=pin, record_job=True, idem_key=idem_key)

    async def handle_job(self, jid: str, req: Request) -> Reply:
        request_id = req.headers.get("x-request-id") or new_request_id()
        timeout = ClientTimeout(total=10.0, connect=self.cfg.connect_timeout_s)
        rid = self._job_affinity.get(jid)
        order: list[Replica] = []
        if rid is not None and self.registry.get(rid) is not None:
            order.append(self.registry.get(rid))
        # Unknown or stale affinity: fan out (a restarted router must still
        # find the jobs a journal restored).
        order += [r for r in self.registry.replicas.values() if r not in order]
        saw_unreachable_owner = False
        for r in order:
            if r.draining and rid != r.id:
                continue
            try:
                status, rhdrs, raw = await self._forward(r, "GET", f"/v1/jobs/{jid}", None,
                                                         {"X-Request-Id": request_id}, timeout)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if rid == r.id:
                    saw_unreachable_owner = True
                r.note_failure(e, connect=True)
                continue
            if status != 404:
                self._job_affinity.put(jid, r.id)
                return self._passthrough(status, rhdrs, raw, r, 1)
        if saw_unreachable_owner or (rid is not None and self.registry.get(rid) is None):
            # The owner is unreachable: the job is not lost (its journal
            # replays on restart), so 503, never a 404 read as "gone".
            return _json_reply(
                {"error": f"job {jid!r} lives on replica {rid!r} which is unreachable; retry "
                          "after it recovers",
                 "fleet_shed": "owner_recovering", "request_id": request_id}, 503,
                {"Retry-After": str(max(int(math.ceil(self.cfg.poll_interval_s * 2)), 1))})
        return _json_reply({"error": "unknown job id", "request_id": request_id}, 404)

    async def handle_generate(self, name: str, req: Request):
        """The streaming proxy: before the first byte, failover retries a
        different replica; after it a retry would repeat tokens, so a
        replica's death ends the stream with a structured error event (in
        disaggregated mode, :meth:`_generate_disagg`, KV-aware failover
        resumes it on a peer first)."""
        if self.cfg.disagg:
            return await self._generate_disagg(name, req)
        self.metrics._bump(self.metrics.requests_total, "generate")
        request_id = req.headers.get("x-request-id") or new_request_id()
        span = self.tracer.start("fleet:generate", model=name,
                                 traceparent=req.headers.get("traceparent"),
                                 request_id=request_id)
        headers = self._fwd_headers(req, span)
        headers.setdefault("x-request-id", request_id)
        timeout = self._timeout(req)
        max_attempts = 1 + max(self.cfg.failover_retries, 0)
        tried: list[Replica] = []
        attempts: list[_Attempt] = []
        reason = "no_replica"
        while len(tried) < max_attempts:
            r = self.registry.pick(name, exclude={x.id for x in tried},
                                   adapter=req.headers.get("x-adapter"))
            if r is None:
                break
            if tried:
                self.metrics.retries_total += 1
                await self._failover_pause()
            tried.append(r)
            r.inflight += 1
            handed_off = False
            try:
                delay_s = self.faults.check(r.id)
                if delay_s:
                    await asyncio.sleep(delay_s)
                up = await self._request("POST", r.url + f"/v1/models/{name}:generate", timeout,
                                         data=req.body, headers=headers)
                if not up.headers.get("content-type", "").startswith("text/event-stream"):
                    async with up:
                        raw = await up.read()
                    jbody = self._parse_json(raw)
                    if up.status in (429, 503):
                        self.metrics._bump(self.metrics.failovers_total,
                                           "overloaded" if up.status == 429 else "unavailable")
                        attempts.append(_Attempt(r.id, up.status,
                                                 self._retry_after_s(up.headers), jbody))
                        reason = "all_overloaded" if up.status == 429 else "all_failed"
                        if jbody and jbody.get("cold_start"):
                            self._trigger_activation(r, name)
                            reason = "all_cold"
                        continue
                    r.routed += 1
                    r.note_success()
                    self.tracer.finish(span.trace, "error" if up.status >= 400 else "ok")
                    return self._passthrough(up.status, up.headers, raw, r, len(tried))
                handed_off = True
                return self._relay(name, r, up, span, request_id)
            except _UPSTREAM_ERRORS as e:
                r.note_failure(e, connect=True)
                self.metrics._bump(self.metrics.failovers_total, "connect")
                attempts.append(_Attempt(r.id, 503, None, None))
                reason = "all_failed"
                continue
            finally:
                if not handed_off:
                    r.inflight -= 1
        resp = self._shed_response(reason, name, attempts, request_id, span.trace.trace_id)
        self.tracer.finish(span.trace, "error")
        return resp

    def _relay(self, name: str, r: Replica, up: ClientResponse, span, request_id: str) -> Stream:
        """The replica's event stream passed on line by line as it comes; a
        death after the first byte ends it with the error event."""

        async def events():
            try:
                async for line in up.iter_lines():
                    yield line
                r.routed += 1
                r.note_success()
                self.tracer.finish(span.trace, "ok")
            except _UPSTREAM_ERRORS as e:
                r.note_failure(e, connect=True)
                self.metrics._bump(self.metrics.failovers_total, "midstream")
                yield self._sse_error_event(name, request_id, span, e, replica_id=r.id)
                self.tracer.finish(span.trace, "error")

        def close():
            up.release()
            r.inflight -= 1
            self.tracer.finish(span.trace, "error")  # a no-op once finished

        return Stream({"X-Fleet-Replica": r.id,
                       "X-Request-Id": up.headers.get("x-request-id", request_id),
                       **({"X-Trace-Id": up.headers["x-trace-id"]}
                          if "x-trace-id" in up.headers else {})}, events(), close)

    # -- disaggregated prefill/decode and KV-aware failover ------------------
    def _sse_error_event(self, model: str, request_id: str, span, err,
                         replica_id: str | None = None) -> bytes:
        """The terminal mid-stream error event: the correlation ids and the
        family-minimum Retry-After (headers are long sent, so the retry
        contract rides the event)."""
        waits = [r.forecast_ms(model) / 1000.0 for r in self.registry.replicas.values()
                 if r.routable(model)]
        retry_s = max(min(waits) if waits else max(self.cfg.poll_interval_s, 1.0), 1.0)
        ev = {"error": f"upstream replica failed mid-stream: {type(err).__name__}: {err}",
              "midstream": True, "request_id": request_id,
              "trace_id": span.trace.trace_id, "retry_after_s": round(retry_s, 3)}
        if replica_id:
            ev["replica"] = replica_id
        span.annotate(error=str(err), midstream=True)
        return _sse(ev)

    @staticmethod
    async def _iter_sse(up: ClientResponse):
        """The parsed ``data:`` JSON events of an event stream."""
        async for line in up.iter_lines():
            if line.startswith(b"data: "):
                try:
                    yield json.loads(line[6:].decode())
                except ValueError:
                    continue

    def _pick_role(self, model: str, role: str,
                   exclude: set[str] = frozenset()) -> Replica | None:
        """A routable replica for one role: ``prefill_replicas`` (urls) tags
        the prefill side, the rest decode; with no tags any distinct
        routable pair disaggregates."""
        prefs = {str(u).rstrip("/") for u in self.cfg.prefill_replicas}
        cands = [r for r in self.registry.replicas.values()
                 if r.id not in exclude and r.routable(model)]
        if prefs:
            tagged = [r for r in cands if (r.url in prefs) == (role == "prefill")]
            if tagged:
                cands = tagged
        if not cands:
            return None
        return min(cands, key=lambda r: (r.model_rank(model), r.forecast_ms(model),
                                         r.inflight, r.id))

    async def _admin_post(self, r: Replica, path: str, body: dict,
                          timeout_s: float = 30.0) -> tuple[int, dict]:
        delay_s = self.faults.check(r.id)
        if self.faults.should_kill(r.id):
            self._fire_kill(r)
        if delay_s:
            await asyncio.sleep(delay_s)
        timeout = ClientTimeout(total=timeout_s, connect=self.cfg.connect_timeout_s)
        async with await self._request("POST", r.url + path, timeout, json_body=body) as resp:
            raw = await resp.read()
            return resp.status, (self._parse_json(raw) or {})

    async def _import_stream(self, dst: Replica, sid: str, manifest: dict, pages: dict,
                             cause: str, src: Replica | None = None) -> bool:
        """One import, resolving 409 ``need`` lists (missing or corrupt
        pages) through the source's ``pages`` phase.  With ``src=None`` (a
        failover: the source is dead) the journaled pages must do."""
        payload = {"manifest": manifest, "pages": list(pages.values()), "cause": cause}
        for attempt in range(3):
            try:
                status, body = await self._admin_post(dst, f"/admin/streams/{sid}/import",
                                                      payload)
            except _UPSTREAM_ERRORS as e:
                dst.note_failure(e, connect=True)
                return False
            if status == 200:
                dst.note_success()
                return True
            need = body.get("need")
            if status == 409 and need and src is not None:
                try:
                    pstat, pres = await self._admin_post(
                        src, f"/admin/streams/{sid}/export", {"phase": "pages", "indices": need})
                except _UPSTREAM_ERRORS:
                    return False
                if pstat != 200:
                    return False
                for p in pres.get("pages", ()):
                    pages[p["i"]] = p
                payload["pages"] = list(pages.values())
                continue
            if status == 503 and attempt < 2:
                await self._failover_pause()
                continue
            log_event(log, "stream import failed", level="warning", stream=sid,
                      replica=dst.id, status=status, error=body.get("error"))
            return False
        return False

    async def _migrate_stream(self, name: str, sid: str, src: Replica, dst: Replica,
                              watermark: int, span) -> dict | None:
        """Move one live stream src -> dst (snapshot, cutover, import,
        commit) and journal its manifest and pages; None when the move
        failed (the source stream resumes in place)."""
        t0 = time.monotonic()
        cut_done = False
        try:
            status, snap = await self._admin_post(src, f"/admin/streams/{sid}/export",
                                                  {"phase": "snapshot"})
            if status != 200:
                raise RuntimeError(f"snapshot failed: {status} {snap.get('error')}")
            pages = {p["i"]: p for p in snap.get("pages", ())}
            status, cut = await self._admin_post(src, f"/admin/streams/{sid}/export",
                                                 {"phase": "cutover", "have": sorted(pages)})
            if status != 200:
                raise RuntimeError(f"cutover failed: {status} {cut.get('error')}")
            cut_done = True
            manifest = cut["manifest"]
            for p in cut.get("pages", ()):
                pages[p["i"]] = p
            if not await self._import_stream(dst, sid, manifest, pages, cause="admin", src=src):
                raise RuntimeError(f"import on {dst.id} failed")
            await self._admin_post(src, f"/admin/streams/{sid}/export",
                                   {"phase": "commit", "cause": "admin"})
            entry = {"sid": sid, "model": name, "manifest": manifest, "pages": pages,
                     "watermark": watermark, "replica": dst.id}
            self._stream_journal.put(sid, entry)
            self.metrics._bump(self.metrics.migrations_total, "prefill")
            span.point("migrate", src=src.id, dst=dst.id, pages=len(pages),
                       ms=round((time.monotonic() - t0) * 1000.0, 1))
            log_event(log, "stream migrated", stream=sid, src=src.id, dst=dst.id,
                      pages=len(pages), watermark=watermark)
            return entry
        except Exception as e:
            log_event(log, "stream migration failed; decode stays on the prefill replica",
                      level="warning", stream=sid, src=src.id, dst=dst.id,
                      error=f"{type(e).__name__}: {e}")
            if cut_done:
                # The source stream is paused mid-export: resume it.
                try:
                    await self._admin_post(src, f"/admin/streams/{sid}/export",
                                           {"phase": "abort"})
                except Exception:
                    log.exception("migration abort failed for %s", sid)
            return None

    async def _generate_disagg(self, name: str, req: Request):
        """Disaggregated ``:generate``: prefill on a prefill-tagged replica,
        move the KV pages to a decode replica at the first token, stream
        the decode from there, and on the decode replica's death resume on
        a peer from the journaled pages, no token lost or repeated."""
        self.metrics._bump(self.metrics.requests_total, "generate")
        request_id = req.headers.get("x-request-id") or new_request_id()
        span = self.tracer.start("fleet:generate_disagg", model=name,
                                 traceparent=req.headers.get("traceparent"),
                                 request_id=request_id)
        headers = self._fwd_headers(req, span)
        headers.setdefault("x-request-id", request_id)
        prefill = self._pick_role(name, "prefill")
        if prefill is None:
            resp = self._shed_response("no_replica", name, [], request_id, span.trace.trace_id)
            self.tracer.finish(span.trace, "error")
            return resp
        timeout = self._timeout(req)
        prefill.inflight += 1
        try:
            delay_s = self.faults.check(prefill.id)
            if self.faults.should_kill(prefill.id):
                self._fire_kill(prefill)
            if delay_s:
                await asyncio.sleep(delay_s)
            up = await self._request("POST", prefill.url + f"/v1/models/{name}:generate",
                                     timeout, data=req.body, headers=headers)
        except _UPSTREAM_ERRORS as e:
            prefill.inflight -= 1
            prefill.note_failure(e, connect=True)
            resp = self._shed_response("all_failed", name,
                                       [_Attempt(prefill.id, 503, None, None)], request_id,
                                       span.trace.trace_id)
            self.tracer.finish(span.trace, "error")
            return resp
        except BaseException:
            prefill.inflight -= 1
            raise
        if not up.headers.get("content-type", "").startswith("text/event-stream"):
            try:
                async with up:
                    raw = await up.read()
            finally:
                prefill.inflight -= 1
            if up.status < 500:
                prefill.note_success()
            else:
                prefill.note_failure(f"replica answered {up.status}")
            self.tracer.finish(span.trace, "error" if up.status >= 400 else "ok")
            return self._passthrough(up.status, up.headers, raw, prefill, 1)
        sid = up.headers.get("x-stream-id")
        held = {"prefill": True}

        def release_prefill():
            if held.pop("prefill", False):
                up.release()
                prefill.inflight -= 1

        async def events():
            jent = None
            watermark = 0
            try:
                tried_migrate = False
                async for ev in self._iter_sse(up):
                    if "token" in ev:
                        yield _sse(ev)
                        watermark += 1
                        if sid and not tried_migrate:
                            # First token: prefill is done; move decode off
                            # the prefill replica now.
                            tried_migrate = True
                            dst = self._pick_role(name, "decode", exclude={prefill.id})
                            if dst is not None:
                                jent = await self._migrate_stream(name, sid, prefill, dst,
                                                                  watermark, span)
                        if jent is not None:
                            break
                        continue
                    if ev.get("migrated"):
                        break  # the source confirmed the cutover
                    yield _sse(ev)
                    if ev.get("done") or "error" in ev:
                        prefill.routed += 1
                        prefill.note_success()
                        self.tracer.finish(span.trace, "error" if "error" in ev else "ok")
                        return
            except _UPSTREAM_ERRORS as e:
                prefill.note_failure(e, connect=True)
                if jent is None:
                    # The prefill replica died before any move: nothing
                    # journaled to resume from.
                    self.metrics._bump(self.metrics.failovers_total, "midstream")
                    yield self._sse_error_event(name, request_id, span, e,
                                                replica_id=prefill.id)
                    self.tracer.finish(span.trace, "error")
                    return
            finally:
                release_prefill()
            if jent is None:
                # A migrated event without a journal entry: nothing to serve.
                yield self._sse_error_event(name, request_id, span,
                                            RuntimeError("stream migrated but no journal entry"))
                self.tracer.finish(span.trace, "error")
                return
            async for data in self._serve_from_decode(name, sid, jent, request_id, span):
                yield data

        def close():
            release_prefill()
            self.tracer.finish(span.trace, "error")  # a no-op once finished

        return Stream({"X-Fleet-Replica": prefill.id, "X-Fleet-Disagg": "1",
                       "X-Request-Id": up.headers.get("x-request-id", request_id),
                       **({"X-Stream-Id": sid} if sid else {}),
                       **({"X-Trace-Id": up.headers["x-trace-id"]}
                          if "x-trace-id" in up.headers else {})}, events(), close)

    async def _serve_from_decode(self, name: str, sid: str, jent: dict, request_id: str,
                                 span) -> AsyncIterator[bytes]:
        """The decode tail from the replica that imported the stream,
        failing over on its death: the journaled pages re-import on a peer,
        which attaches from the emitted-token watermark (greedy and seeded
        decode replays the same chain, and the tokens below the watermark
        are skipped server-side, so the client sees each token once)."""
        current = self.registry.get(jent["replica"])
        failovers = 0
        while True:
            if current is None:
                yield self._sse_error_event(name, request_id, span,
                                            RuntimeError("decode replica left the registry"))
                self.tracer.finish(span.trace, "error")
                return
            attempt_r = current
            attempt_r.inflight += 1
            up = None
            try:
                delay_s = self.faults.check(current.id)
                if self.faults.should_kill(current.id):
                    self._fire_kill(current)
                if delay_s:
                    await asyncio.sleep(delay_s)
                timeout = ClientTimeout(total=self.cfg.request_timeout_s,
                                        connect=self.cfg.connect_timeout_s)
                up = await self._request("GET", current.url + f"/admin/streams/{sid}/attach",
                                         timeout, params={"from": str(jent["watermark"])})
                if not up.headers.get("content-type", "").startswith("text/event-stream"):
                    body = self._parse_json(await up.read()) or {}
                    raise ConnectionError(f"attach answered {up.status}: {body.get('error')}")
                terminal = False
                async for ev in self._iter_sse(up):
                    if "token" in ev:
                        jent["watermark"] += 1
                    yield _sse(ev)
                    if ev.get("done") or "error" in ev or ev.get("migrated"):
                        terminal = True
                        break
                if not terminal:
                    raise ConnectionError("decode stream ended without a terminal event")
                current.routed += 1
                current.note_success()
                self.tracer.finish(span.trace, "ok")
                return
            except _UPSTREAM_ERRORS as e:
                current.note_failure(e, connect=True)
                failovers += 1
                if not self.cfg.kv_failover or failovers > max(self.cfg.failover_retries, 1):
                    self.metrics._bump(self.metrics.failovers_total, "midstream")
                    yield self._sse_error_event(name, request_id, span, e, replica_id=current.id)
                    self.tracer.finish(span.trace, "error")
                    return
                # KV-aware failover: resume on a peer from the journaled pages.
                self.metrics._bump(self.metrics.failovers_total, "kv_failover")
                self.metrics._bump(self.metrics.migrations_total, "failover")
                dead = current
                span.point("kv_failover", dead=dead.id, watermark=jent["watermark"])
                await self._failover_pause()
                peer = (self._pick_role(name, "decode", exclude={dead.id})
                        or self.registry.pick(name, exclude={dead.id}))
                if peer is None or not await self._import_stream(
                        peer, sid, jent["manifest"], jent["pages"], cause="failover"):
                    yield self._sse_error_event(
                        name, request_id, span,
                        RuntimeError(f"no peer could resume stream {sid} after {dead.id} died"))
                    self.tracer.finish(span.trace, "error")
                    return
                jent["replica"] = peer.id
                self._stream_journal.put(sid, jent)
                log_event(log, "kv-aware failover", stream=sid, dead=dead.id,
                          resumed_on=peer.id, watermark=jent["watermark"])
                current = peer
            finally:
                if up is not None:
                    up.release()
                attempt_r.inflight -= 1

    # -- handlers: health, metrics, admin ------------------------------------
    async def handle_root(self, req: Request) -> Reply:
        models = sorted({m for r in self.registry.replicas.values() for m in r.residency})
        return _json_reply({"status": "ok", "framework": "pytorch-zappa-serverless-tpu-torch",
                            "fleet": True, "replicas": len(self.registry.replicas),
                            "models": models})

    def _slo_health(self) -> dict:
        """The replicas' burn-rate blocks: alarmed (key, lane) pairs prefixed
        with the replica, and the worst live burn per window."""
        alarms: dict[str, list[str]] = {"fast": [], "slow": []}
        worst = {"fast": 0.0, "slow": 0.0}
        for rid, r in sorted(self.registry.replicas.items()):
            s = r.slo_summary
            if not s:
                continue
            for win in ("fast", "slow"):
                alarms[win] += [f"{rid}:{k}" for k in (s.get(f"{win}_alarms") or ())]
                worst[win] = max(worst[win], float(s.get(f"worst_{win}_burn", 0.0)))
        return {"fast_alarms": sorted(alarms["fast"]), "slow_alarms": sorted(alarms["slow"]),
                "worst_fast_burn": round(worst["fast"], 3),
                "worst_slow_burn": round(worst["slow"], 3)}

    async def handle_healthz(self, req: Request) -> Reply:
        routable = [r.id for r in self.registry.replicas.values() if r.routable()]
        ok = bool(routable)
        # An SLO alarm says where the budget burns, not that routing failed:
        # it does not flip fleet health.
        return _json_reply({"fleet_ok": ok, "routable": sorted(routable),
                            "replica_states": self.registry.states(),
                            "slo": self._slo_health()}, 200 if ok else 503)

    async def handle_metrics(self, req: Request) -> Reply:
        accept = req.headers.get("accept", "")
        if (parse_qs(req.query).get("format") == ["prometheus"]
                or ("text/plain" in accept and "application/json" not in accept)):
            return 200, self.metrics.render_prometheus(self.registry, self.faults), {}
        return _json_reply({"fleet": self.metrics.render(self.registry, self.faults)})

    async def handle_admin_slo(self, req: Request) -> Reply:
        """Every replica's SLO plane merged into one fleet view (counts sum,
        burn rates recomputed from the merged windows), with each replica's
        own burn summary; the same shape as a replica's, so ``cli slo``
        renders either."""
        merged = merge_slo_snapshots([r.metrics_json.get("slo")
                                      for r in self.registry.replicas.values()])
        return _json_reply({
            **merged, "fleet": True,
            "replicas": {rid: {"url": r.url, "state": r.state,
                               "scraped": bool(r.metrics_json), "slo": r.slo_summary}
                         for rid, r in sorted(self.registry.replicas.items())}})

    # -- the replica scale actuator ------------------------------------------
    def _scale_state(self) -> dict:
        routable = [r for r in self.registry.replicas.values() if r.routable()]
        forecasts = [r.forecast for r in routable]
        current = len([r for r in self.registry.replicas.values()
                       if not (r.draining or r.replica_draining)])
        desired = desired_replicas(forecasts, current,
                                   target_wait_ms=self.cfg.scale_target_wait_ms,
                                   min_replicas=self.cfg.scale_min_replicas,
                                   max_replicas=self.cfg.scale_max_replicas)
        return {"current": current, "routable": len(routable), "desired": desired,
                "fleet_wait_ms": fleet_wait_ms(forecasts),
                "target_wait_ms": self.cfg.scale_target_wait_ms,
                "min_replicas": self.cfg.scale_min_replicas,
                "max_replicas": self.cfg.scale_max_replicas,
                "auto_interval_s": self.cfg.autoscale_interval_s,
                "can_spawn": self.spawn_hook is not None,
                "events": dict(self.metrics.scale_events_total)}

    async def _scale_out(self) -> dict:
        """Spawn one replica process and register it."""
        if self.spawn_hook is None:
            return {"error": "no spawn hook (start the fleet with --spawn or register "
                             "replicas explicitly)"}
        try:
            url = self.spawn_hook()
        except Exception as e:
            log.exception("spawn hook failed")
            return {"error": f"spawn hook failed: {type(e).__name__}: {e}"}
        if not url:
            return {"error": "spawn hook produced no replica"}
        r = self.registry.add(str(url))
        self.metrics._bump(self.metrics.scale_events_total, "out")
        log_event(log, "replica scaled out", replica=r.id, url=r.url)
        return {"direction": "out", "replica": r.id, "url": r.url}

    async def _drain_replica(self, r: Replica, timeout_s: float) -> tuple[bool | None, bool]:
        """Stop routing to ``r`` now, ask it to drain, then terminate its
        process (a spawned fleet): (drained, terminated)."""
        r.draining = True
        drained = None
        try:
            timeout = ClientTimeout(total=timeout_s + 10.0, connect=self.cfg.connect_timeout_s)
            async with await self._request("POST", r.url + "/admin/drain", timeout,
                                           json_body={"timeout_s": timeout_s}) as resp:
                drained = (await resp.json()).get("drained")
        except Exception as e:
            log_event(log, "replica drain call failed", level="warning", replica=r.id,
                      error=f"{type(e).__name__}: {e}")
        terminated = False
        if self.terminate_hook is not None:
            try:
                terminated = bool(self.terminate_hook(r.id))
            except Exception:
                log.exception("terminate hook failed for %s", r.id)
        return drained, terminated

    async def _scale_in(self, timeout_s: float = 10.0) -> dict:
        """Drain, terminate and deregister the least-loaded replica; never
        below ``scale_min_replicas``."""
        live = [r for r in self.registry.replicas.values()
                if not (r.draining or r.replica_draining)]
        if len(live) <= max(self.cfg.scale_min_replicas, 1):
            return {"error": f"at the scale_min_replicas floor ({self.cfg.scale_min_replicas})"}
        victim = min(live, key=lambda r: (r.inflight, fleet_wait_ms([r.forecast]), r.id))
        drained, terminated = await self._drain_replica(victim, timeout_s)
        self.registry.remove(victim.id)
        self.metrics._bump(self.metrics.scale_events_total, "in")
        log_event(log, "replica scaled in", replica=victim.id, drained=drained,
                  terminated=terminated)
        return {"direction": "in", "replica": victim.id, "drained": drained,
                "terminated": terminated}

    async def _scale_step(self) -> dict | None:
        """One step toward the forecast's desired count."""
        state = self._scale_state()
        if state["desired"] > state["current"]:
            return await self._scale_out()
        if state["desired"] < state["current"]:
            return await self._scale_in()
        return None

    async def _scale_loop(self):
        while True:
            await asyncio.sleep(self.cfg.autoscale_interval_s)
            try:
                await self._scale_step()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("fleet scale step failed; the next interval retries")

    async def handle_scale_get(self, req: Request) -> Reply:
        return _json_reply(self._scale_state())

    async def handle_scale_post(self, req: Request) -> Reply:
        """``POST /admin/fleet/scale``: ``{"action": "out"}`` spawns and
        registers one replica; ``"in"`` drains, terminates and deregisters
        the least-loaded one; ``"set"`` with ``count`` steps to N; ``"auto"``
        takes one step toward the forecast's desired count."""
        try:
            body = req.json()
        except ValueError:
            return _json_reply({"error": "body must be a JSON object"}, 400)
        action = body.get("action")
        actions: list[dict] = []
        if action == "out":
            actions.append(await self._scale_out())
        elif action == "in":
            actions.append(await self._scale_in(timeout_s=float(body.get("timeout_s", 10.0))))
        elif action == "auto":
            step = await self._scale_step()
            if step is not None:
                actions.append(step)
        elif action == "set":
            try:
                count = int(body.get("count"))
            except (TypeError, ValueError):
                return _json_reply({"error": "set needs an integer count"}, 400)
            if count < 1 or count > self.cfg.scale_max_replicas:
                return _json_reply({"error": f"count must be in [1, "
                                             f"{self.cfg.scale_max_replicas}] "
                                             f"(scale_max_replicas)"}, 400)
            for _ in range(64):  # bounded: one registry walk a step
                state = self._scale_state()
                if state["current"] == count:
                    break
                step = (await self._scale_out() if state["current"] < count
                        else await self._scale_in())
                actions.append(step)
                if "error" in step:
                    break
        else:
            return _json_reply({"error": f"action must be one of ['out', 'in', 'set', "
                                         f"'auto'], got {action!r}"}, 400)
        errors = [a for a in actions if "error" in a]
        return _json_reply({"action": action, "applied": actions, **self._scale_state()},
                           503 if errors and len(errors) == len(actions) and actions else 200)

    async def handle_fleet_get(self, req: Request) -> Reply:
        return _json_reply({
            "replicas": self.registry.snapshot(),
            "replica_states": self.registry.states(),
            "slo": self._slo_health(),
            "quarantined": {
                "replicas": sorted(rid for rid, r in self.registry.replicas.items()
                                   if r.quarantined),
                "models": {rid: sorted(r.server_quarantined)
                           for rid, r in sorted(self.registry.replicas.items())
                           if r.server_quarantined},
            },
            "metrics": {
                "requests": dict(self.metrics.requests_total),
                "failovers": dict(self.metrics.failovers_total),
                "retries": self.metrics.retries_total,
                "migrations": dict(self.metrics.migrations_total),
                "spills": dict(self.metrics.spills_total),
                "shed": dict(self.metrics.shed_total),
            },
            # Which replica owns each moved stream and its watermark.
            "streams": {sid: {"model": e["model"], "replica": e["replica"],
                              "watermark": e["watermark"], "pages": len(e["pages"])}
                        for sid, e in self._stream_journal.items()},
            "faults": self.faults.snapshot(),
        })

    async def handle_fleet_post(self, req: Request) -> Reply:
        """``POST /admin/fleet``: ``register`` (``url``), ``deregister``,
        ``drain`` (``timeout_s``: stop routing now, drain the replica, then
        terminate a spawned one), ``undrain``, ``quarantine`` and
        ``readmit`` (which also resets the failure counts and the breaker),
        each but the first with ``replica``."""
        try:
            body = req.json()
        except ValueError:
            return _json_reply({"error": "body must be a JSON object"}, 400)
        action = body.get("action")
        if action == "register":
            url = body.get("url")
            if not url:
                return _json_reply({"error": "register needs a url"}, 400)
            r = self.registry.add(str(url))
            log_event(log, "replica registered", replica=r.id, url=r.url)
            return _json_reply({"action": action, "replica": r.id,
                                "fleet": self.registry.snapshot()})
        rid = body.get("replica")
        r = self.registry.get(rid) if rid else None
        if r is None:
            return _json_reply({"error": f"unknown replica {rid!r}; known: "
                                         f"{sorted(self.registry.replicas)}"}, 404)
        if action == "deregister":
            self.registry.remove(rid)
            log_event(log, "replica deregistered", replica=rid)
            return _json_reply({"action": action, "replica": rid,
                                "fleet": self.registry.snapshot()})
        if action == "quarantine":
            r.forced_quarantine = True
            r._track_quarantine_edge()
            return _json_reply({"action": action, "replica": r.snapshot()})
        if action == "readmit":
            r.forced_quarantine = False
            r.consecutive_failures = 0
            if r.breaker is not None:
                r.breaker.reset()
            r._track_quarantine_edge()
            return _json_reply({"action": action, "replica": r.snapshot()})
        if action == "drain":
            drained, terminated = await self._drain_replica(r, float(body.get("timeout_s", 10.0)))
            log_event(log, "replica drained", replica=rid, drained=drained,
                      terminated=terminated)
            return _json_reply({"action": action, "replica": rid, "drained": drained,
                                "terminated": terminated})
        if action == "undrain":
            r.draining = False
            return _json_reply({"action": action, "replica": r.snapshot()})
        return _json_reply({"error": f"action must be one of ['register', 'deregister', "
                                     f"'drain', 'undrain', 'quarantine', 'readmit'], "
                                     f"got {action!r}"}, 400)

    async def handle_faults_get(self, req: Request) -> Reply:
        return _json_reply({"faults": self.faults.snapshot()})

    async def handle_faults_post(self, req: Request) -> Reply:
        """The fleet's chaos rules: unknown fields are 400, and so is a
        clear with any field but ``replica``."""
        try:
            body = req.json()
        except ValueError:
            return _json_reply({"error": "body must be a JSON object"}, 400)
        if body.get("clear"):
            unknown = set(body) - {"clear", "replica"}
            if unknown:
                return _json_reply({"error": f"unknown fault fields {sorted(unknown)}; "
                                             f"allowed with clear: ['clear', 'replica']"}, 400)
            self.faults.clear(body.get("replica"))
        else:
            allowed = {"replica", "kind", "latency_ms", "count"}
            unknown = set(body) - allowed
            if unknown:
                return _json_reply({"error": f"unknown fault fields {sorted(unknown)}; "
                                             f"allowed: {sorted(allowed)}"}, 400)
            try:
                self.faults.configure(**body)
            except (TypeError, ValueError) as e:
                return _json_reply({"error": str(e)}, 400)
        log_event(log, "fleet fault rules updated", **self.faults.snapshot()["injected"])
        return _json_reply({"faults": self.faults.snapshot()})


def run(cfg: FleetConfig, on_router: Callable[[FleetRouter], Any] | None = None,
        **kw) -> None:
    """Serve the router until SIGINT or SIGTERM; ``on_router`` sees it
    before it listens."""
    import signal

    async def main():
        router = FleetRouter(cfg, **kw)
        if on_router is not None:
            on_router(router)
        port = await router.start()
        log_event(log, "fleet router listening", host=cfg.host, port=port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await router.stop()

    asyncio.run(main())
