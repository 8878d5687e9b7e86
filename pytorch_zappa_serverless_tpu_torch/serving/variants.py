"""Objective-driven variant selection: the model-less half of serving.

The port's copy of the JAX package's ``serving/variants.py``.  Clients
address a variant *family* with an *objective* (``max_latency_ms``,
``min_quality``, ``prefer_cost``) and the server picks the deploy from live
evidence, so under overload the server degrades to a cheaper variant before
it sheds the request.

- :class:`FamilyRegistry`: the static half, from config: which deploys form
  a family (``ModelConfig.family``), their quality ladder
  (``quality_rank``, higher = better) and cost priors (``cost_hint_ms``).
- :class:`VariantView`: one candidate's frozen evidence: the batcher's
  queue-wait forecast, the latency ring's device p50, residency and the
  learned ``estimated_warm_ms`` from the lifecycle, breaker and quarantine
  state from the resilience hub.
- :func:`select`: the pure scoring function, (ladder, objective, views,
  brownout) → :class:`Selection`.  No clock, no randomness, no I/O: the
  same inputs always pick the same variant (the brownout hysteresis clock
  lives in ``resilience.BrownoutController``, injected there).
- :class:`VariantHub`: the server's glue: snapshots the evidence, runs the
  brownout controller and keeps the ``tpuserve_variant_*`` counters.

A candidate's prediction is its queue-wait forecast (else its device p50,
else its cost prior) plus the activation estimate when it is not resident.
It is eligible when nothing blocks it (an open breaker, quarantine), its
rank meets ``min_quality`` and its prediction fits the latency bound.  The
highest rank wins (ties: the cheaper prediction) unless ``prefer_cost`` or
brownout turns the family cheapest-first.  Serving below the ladder's top is
``degraded``; an empty eligible set sheds with the family's minimum retry
evidence.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from ..config import ModelConfig, ServeConfig
from ..utils.logging import get_logger, log_event
from .metrics import Histogram
from .resilience import BrownoutController

log = get_logger("serving.variants")

# A selection takes microseconds: sub-ms buckets, so the histogram shows it.
SELECT_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0)


class FamilyRegistry:
    """Static family structure from config: ladders, ranks, cost priors."""

    def __init__(self, models: list[ModelConfig]):
        self._model_family: dict[str, str] = {}
        self._ladders: dict[str, list[ModelConfig]] = {}
        for mc in models:
            fam = mc.family or mc.name
            self._model_family[mc.name] = fam
            self._ladders.setdefault(fam, []).append(mc)
        for ladder in self._ladders.values():
            # Quality-descending, name-tied: the ladder order is the
            # degradation order and must be the same in every process.
            ladder.sort(key=lambda m: (-m.quality_rank, m.name))

    def family_of(self, name: str) -> str | None:
        """The family a model belongs to; None for an unknown name."""
        return self._model_family.get(name)

    def is_family(self, name: str) -> bool:
        return name in self._ladders

    def is_model(self, name: str) -> bool:
        return name in self._model_family

    def ladder(self, family: str) -> list[ModelConfig]:
        return self._ladders.get(family, [])

    def families(self) -> dict[str, list[str]]:
        return {f: [m.name for m in lad] for f, lad in sorted(self._ladders.items())}

    def top_rank(self, family: str) -> int:
        ladder = self.ladder(family)
        return ladder[0].quality_rank if ladder else 0


@dataclass
class Objective:
    """What the client asked for instead of a deploy.

    ``max_latency_ms`` bounds the serve time (it is also the request's
    deadline when the client set none, so an overrun answers 504 rather
    than break the objective in silence); ``min_quality`` floors the
    ``quality_rank``; ``prefer_cost`` picks the cheapest satisfying variant
    even without brownout.
    """

    max_latency_ms: float | None = None
    min_quality: int | None = None
    prefer_cost: bool = False

    @property
    def stated(self) -> bool:
        return (self.max_latency_ms is not None
                or self.min_quality is not None or self.prefer_cost)

    def public(self) -> dict:
        out: dict[str, Any] = {}
        if self.max_latency_ms is not None:
            out["max_latency_ms"] = self.max_latency_ms
        if self.min_quality is not None:
            out["min_quality"] = self.min_quality
        if self.prefer_cost:
            out["prefer_cost"] = True
        return out

    @classmethod
    def parse(cls, headers, body_obj) -> "Objective":
        """The request's objective: a JSON body's ``objective`` field (popped
        by the caller), overridden field by field by the ``X-Objective-*``
        headers (the only channel a binary payload has).  ``headers`` is
        any mapping that answers the headers' names as sent (the port's
        server hands in a case-insensitive view).  ValueError on junk: a
        mistyped objective is a 400, not a silently wrong variant."""
        raw: dict[str, Any] = {}
        if body_obj is not None:
            if not isinstance(body_obj, dict):
                raise ValueError('"objective" must be a JSON object')
            unknown = set(body_obj) - {"max_latency_ms", "min_quality", "prefer_cost"}
            if unknown:
                raise ValueError(f"unknown objective fields {sorted(unknown)}")
            raw.update(body_obj)
        for header, key in (("X-Objective-Max-Latency-Ms", "max_latency_ms"),
                            ("X-Objective-Min-Quality", "min_quality"),
                            ("X-Objective-Prefer-Cost", "prefer_cost")):
            if header in headers:
                raw[key] = headers[header]
        obj = cls()
        if "max_latency_ms" in raw:
            try:
                obj.max_latency_ms = float(raw["max_latency_ms"])
            except (TypeError, ValueError):
                raise ValueError("objective.max_latency_ms must be a number") from None
            if not obj.max_latency_ms > 0:  # NaN fails too
                raise ValueError("objective.max_latency_ms must be > 0")
        if "min_quality" in raw:
            try:
                obj.min_quality = int(raw["min_quality"])
            except (TypeError, ValueError):
                raise ValueError("objective.min_quality must be an integer") from None
        if "prefer_cost" in raw:
            v = raw["prefer_cost"]
            obj.prefer_cost = (v.lower() in ("1", "true", "yes", "on")
                               if isinstance(v, str) else bool(v))
        return obj


@dataclass
class VariantView:
    """One candidate's frozen evidence (pure data: the selector never reads
    live state, which is what makes it deterministic)."""

    name: str
    quality_rank: int = 0
    cost_hint_ms: float = 0.0
    residency: str = "active"        # lifecycle state; "active" when unmanaged
    estimated_warm_ms: float = 0.0   # activation cost if not resident
    forecast_wait_ms: float = 0.0    # the batcher's queue-wait forecast
    device_p50_ms: float | None = None  # the latency ring's recent device p50
    queue_depth: int = 0
    breaker_state: str = "closed"
    breaker_retry_after_s: float = 0.0
    quarantined: bool = False

    @property
    def blocked(self) -> str | None:
        """Why this variant cannot serve at all now (None: it can)."""
        if self.quarantined:
            return "quarantined"
        if self.breaker_state == "open":
            return "breaker_open"
        return None

    def predicted_ms(self) -> float:
        """Expected serve time, plus the activation when not resident.  The
        forecast already prices the request's own batch (depth + 1 times the
        recent p50), so it is the estimate when present; with none, the
        recent device p50, then the config's cost prior."""
        if self.forecast_wait_ms > 0:
            base = self.forecast_wait_ms
        elif self.device_p50_ms is not None:
            base = self.device_p50_ms
        else:
            base = self.cost_hint_ms  # the prior until evidence flows
        warm = self.estimated_warm_ms if self.residency != "active" else 0.0
        return base + warm

    def public(self) -> dict:
        return {"variant": self.name, "quality_rank": self.quality_rank,
                "residency": self.residency,
                "predicted_ms": round(self.predicted_ms(), 2),
                "forecast_wait_ms": round(self.forecast_wait_ms, 2),
                "queue_depth": self.queue_depth,
                "breaker": self.breaker_state,
                **({"blocked": self.blocked} if self.blocked else {})}


@dataclass
class Selection:
    """One selection's verdict and the evidence behind it."""

    family: str
    variant: str | None              # None: shed (no variant fits)
    degraded: bool = False
    preferred_fits: bool = True      # the top rung's verdict (brownout's input)
    brownout: bool = False
    shed_reason: str | None = None
    retry_after_s: float = 1.0       # the family's minimum, for a shed
    estimated_wait_ms: float | None = None
    estimated_warm_ms: float | None = None
    candidates: list[dict] = field(default_factory=list)


def _fits(view: VariantView, objective: Objective, latency_bound_ms: float | None) -> bool:
    if view.blocked:
        return False
    if objective.min_quality is not None and view.quality_rank < objective.min_quality:
        return False
    if latency_bound_ms is not None and view.predicted_ms() > latency_bound_ms:
        return False
    return True


def select(family: str, objective: Objective, views: list[VariantView],
           brownout: bool, latency_bound_ms: float | None = None,
           top_rank: int | None = None) -> Selection:
    """The pure selection function (the module docstring has the model).

    ``latency_bound_ms`` is the effective bound, min(objective
    ``max_latency_ms``, the client's deadline), as the caller computed it.
    ``top_rank`` is the ladder's best rank, so "degraded" means below what
    the family could serve even when the top variant's view is missing.
    """
    if latency_bound_ms is None:
        latency_bound_ms = objective.max_latency_ms
    best_rank = top_rank if top_rank is not None else (
        max((v.quality_rank for v in views), default=0))
    eligible = [v for v in views if _fits(v, objective, latency_bound_ms)]
    preferred_fits = any(v.quality_rank >= best_rank for v in eligible)
    candidates = [v.public() for v in views]
    if not eligible:
        # Shed, with the family's minimum retry evidence, never one
        # variant's.
        waits = [v.forecast_wait_ms for v in views if not v.blocked]
        warms = [v.estimated_warm_ms for v in views if v.residency != "active"]
        retry = [v.breaker_retry_after_s for v in views if v.breaker_state == "open"]
        if waits:
            retry.append(min(waits) / 1000.0)
        if not waits and warms:
            retry.append(min(warms) / 1000.0)
        all_blocked = all(v.blocked for v in views) if views else False
        return Selection(
            family=family, variant=None, preferred_fits=False, brownout=brownout,
            shed_reason="all_blocked" if all_blocked else "no_variant_fits",
            retry_after_s=max(min(retry) if retry else 1.0, 0.05),
            estimated_wait_ms=round(min(waits), 1) if waits else None,
            estimated_warm_ms=round(min(warms), 1) if warms else None,
            candidates=candidates)
    if brownout or objective.prefer_cost:
        # Cheapest first: the prediction, then the lower rung on a tie (a
        # browned-out family sheds load off the expensive variant), then the
        # name.
        key = lambda v: (v.predicted_ms(), v.quality_rank, v.name)  # noqa: E731
    else:
        key = lambda v: (-v.quality_rank, v.predicted_ms(), v.name)  # noqa: E731
    chosen = min(eligible, key=key)
    return Selection(
        family=family, variant=chosen.name, degraded=chosen.quality_rank < best_rank,
        preferred_fits=preferred_fits, brownout=brownout,
        estimated_wait_ms=round(chosen.forecast_wait_ms, 1), candidates=candidates)


class VariantHub:
    """The server's variant machinery: evidence, brownout, counters."""

    def __init__(self, cfg: ServeConfig, clock=time.monotonic):
        self.cfg = cfg
        self.registry = FamilyRegistry(cfg.models)
        self.brownout = BrownoutController(
            mode=cfg.brownout, exit_ticks=cfg.brownout_exit_ticks,
            min_hold_s=cfg.brownout_min_hold_s, clock=clock)
        # family -> variant -> count
        self.selections: dict[str, dict[str, int]] = {}  # guarded-by: event-loop
        self.degraded: dict[str, dict[str, int]] = {}  # guarded-by: event-loop
        self.sheds: dict[str, int] = {}  # guarded-by: event-loop
        self.select_hists: dict[str, Histogram] = {}  # guarded-by: event-loop

    def snapshot_views(self, server, family: str) -> list[VariantView]:
        """Freeze the live serving state into per-variant evidence."""
        views = []
        lc = server.lifecycle
        for mc in self.registry.ladder(family):
            name = mc.name
            view = VariantView(name=name, quality_rank=mc.quality_rank,
                               cost_hint_ms=mc.cost_hint_ms)
            b = server.batchers.get(name)
            if b is not None:
                view.forecast_wait_ms = b.estimate_wait_ms()
                view.queue_depth = b.queue_depth
            ring = server.metrics.models.get(name)
            if ring is not None:
                view.device_p50_ms = ring.device_p50()
            if lc is not None and lc.knows(name):
                state = lc.state_of(name)
                view.residency = "active" if state == "active" else state or "cold"
                if view.residency != "active":
                    view.estimated_warm_ms = lc.estimate_warm_ms(name)
            view.quarantined = name in server.resilience.quarantined
            mr = server.resilience.models.get(name)
            if mr is not None and mr.breaker is not None:
                view.breaker_state = mr.breaker.state
                view.breaker_retry_after_s = mr.breaker.retry_after_s()
            views.append(view)
        return views

    def resolve(self, server, family: str, objective: Objective,
                latency_bound_ms: float | None) -> Selection:
        """One family-addressed selection: evidence, brownout, select; the
        counters and the selection-time histogram updated."""
        t0 = time.perf_counter()
        views = self.snapshot_views(server, family)
        top = self.registry.top_rank(family)
        # The first pass decides pressure; the brownout verdict then biases
        # the final pick (one more pure call on the same snapshot).
        probe = select(family, objective, views, brownout=False,
                       latency_bound_ms=latency_bound_ms, top_rank=top)
        browned = self.brownout.observe(family, probe.preferred_fits)
        sel = (select(family, objective, views, brownout=True,
                      latency_bound_ms=latency_bound_ms, top_rank=top)
               if browned else probe)
        if sel.variant is None:
            self.sheds[family] = self.sheds.get(family, 0) + 1
        else:
            fam_sel = self.selections.setdefault(family, {})
            fam_sel[sel.variant] = fam_sel.get(sel.variant, 0) + 1
            if sel.degraded:
                fam_deg = self.degraded.setdefault(family, {})
                fam_deg[sel.variant] = fam_deg.get(sel.variant, 0) + 1
        hist = self.select_hists.get(family)
        if hist is None:
            hist = self.select_hists[family] = Histogram(SELECT_BUCKETS_MS)
        hist.observe((time.perf_counter() - t0) * 1000.0)
        if sel.variant is None or sel.degraded:
            log_event(log, "variant selection", family=family, variant=sel.variant,
                      degraded=sel.degraded, brownout=sel.brownout, shed=sel.shed_reason,
                      objective=objective.public())
        return sel

    def family_floor(self, server, family: str) -> tuple[float, float | None]:
        """(retry_after_s, estimated_wait_ms) as minima across the family:
        what an exact-variant shed reports when a sibling could serve
        sooner."""
        views = self.snapshot_views(server, family)
        waits = [v.forecast_wait_ms for v in views if not v.blocked]
        if not waits:
            return 1.0, None
        floor = min(waits)
        return max(floor / 1000.0, 0.05), round(floor, 1)

    def snapshot(self) -> dict:
        fams = {}
        for fam in self.registry.families():
            fams[fam] = {
                "ladder": [{"variant": m.name, "quality_rank": m.quality_rank,
                            "cost_hint_ms": m.cost_hint_ms}
                           for m in self.registry.ladder(fam)],
                "selections": dict(self.selections.get(fam, {})),
                "degraded": dict(self.degraded.get(fam, {})),
                "sheds": self.sheds.get(fam, 0),
                "brownout_active": self.brownout.active(fam),
            }
        return {"brownout": self.brownout.snapshot(), "families": fams}
