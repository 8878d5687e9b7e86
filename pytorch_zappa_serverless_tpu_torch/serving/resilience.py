"""Request resilience: deadlines, retry, the per-model circuit breaker, stats.

The port's copy of the JAX package's ``serving/resilience.py`` (the
brownout ladder waits for ``serving/variants.py``).

- **Deadlines**: a request may carry one (the client's ``deadline_ms``, the
  model's, the server's default, capped by the server's maximum); checked
  at admission, re-checked when the batcher pops it (expired work is shed,
  never dispatched), and it bounds the await on the device future.
- **Retry**: a transient dispatch failure (``faults.is_transient``) retries
  with capped exponential backoff and jitter, never past the deadline.
- **Circuit breaker**: per model, closed → open on an error-rate trip →
  half-open probes; an open breaker fast-fails 503, so a sick model cannot
  take the shared dispatch lane from the others.

Everything here is event-loop-confined (no locks): the server and the
batchers mutate it, and ``/metrics`` reads it from the same loop.
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass, field

from ..config import ServeConfig
from ..faults import is_transient
from ..utils.logging import get_logger, log_event

log = get_logger("serving.resilience")


class DeadlineExceeded(Exception):
    """The request's deadline passed before (or while) it could be served.

    ``stage`` records where: ``admission`` (it arrived expired), ``queue``
    (it expired in the batcher and was shed before any device work) or
    ``await`` (it expired while its batch ran).  Maps to HTTP 504.
    """

    def __init__(self, msg: str, stage: str = "queue"):
        super().__init__(msg)
        self.stage = stage


@dataclass
class RetryPolicy:
    """Capped exponential backoff with jitter for transient faults.

    ``max_attempts`` counts retries (0 = off).  Retry k waits
    ``min(base * 2**k, cap)`` scaled by a uniform [0.5, 1.0) jitter, so
    batches that fail together do not retry together.  The jitter source is
    injectable: a test seeds a ``random.Random`` and gets the same delays
    every run.
    """

    max_attempts: int = 0
    base_ms: float = 10.0
    max_ms: float = 1000.0
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def backoff_ms(self, attempt: int) -> float:
        capped = min(self.base_ms * (2 ** attempt), self.max_ms)
        return capped * (0.5 + self.rng.random() / 2)

    @classmethod
    def from_config(cls, cfg: ServeConfig,
                    rng: random.Random | None = None) -> "RetryPolicy":
        return cls(max_attempts=cfg.retry_max_attempts,
                   base_ms=cfg.retry_base_ms, max_ms=cfg.retry_max_ms,
                   **({"rng": rng} if rng is not None else {}))


class CircuitBreaker:
    """Per-model error-rate breaker: closed → open → half-open → closed.

    Outcomes land in a sliding window; once it holds ``min_samples`` and the
    error rate reaches ``threshold`` the breaker OPENS for ``open_s``, and
    ``allow()`` answers False.  Then it is HALF-OPEN: one probe request is
    let through per ``probe_interval_s``; a probe success closes it (the
    window reset), a failure re-opens it (the timer reset).  Probes are
    gated by time, not by tracking the one in flight, so an abandoned probe
    cannot hold the breaker half-open.  The clock is injectable.
    """

    def __init__(self, threshold: float, window: int = 20, min_samples: int = 10,
                 open_s: float = 5.0, probe_interval_s: float | None = None,
                 clock=time.monotonic):
        self.threshold = threshold
        self.min_samples = max(int(min_samples), 1)
        self.open_s = open_s
        self.probe_interval_s = (probe_interval_s if probe_interval_s is not None
                                 else max(min(open_s / 4, 1.0), 0.01))
        self._clock = clock
        self._outcomes: deque[bool] = deque(maxlen=max(int(window), 1))  # guarded-by: event-loop
        self._opened_at: float | None = None  # guarded-by: event-loop
        self._last_probe = 0.0  # guarded-by: event-loop
        self.opens = 0  # guarded-by: event-loop

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.open_s:
            return "half_open"
        return "open"

    def error_rate(self) -> float:
        if not self._outcomes:
            return 0.0
        return 1.0 - sum(self._outcomes) / len(self._outcomes)

    def allow(self) -> bool:
        state = self.state
        if state == "closed":
            return True
        if state == "open":
            return False
        # Half-open: one probe per interval; everyone else fast-fails.
        now = self._clock()
        if now - self._last_probe >= self.probe_interval_s:
            self._last_probe = now
            return True
        return False

    def retry_after_s(self) -> float:
        """Seconds until the next request could be admitted."""
        if self._opened_at is None:
            return 0.0
        remaining = self.open_s - (self._clock() - self._opened_at)
        return remaining if remaining > 0 else self.probe_interval_s

    def record(self, ok: bool):
        state = self.state
        if state == "half_open":
            if ok:
                self._opened_at = None
                self._outcomes.clear()
            else:
                self._opened_at = self._clock()  # a failed probe re-opens
            return
        if state == "open":
            return  # stragglers from before the trip carry no signal
        self._outcomes.append(ok)
        if (len(self._outcomes) >= self.min_samples
                and self.error_rate() >= self.threshold):
            self._opened_at = self._clock()
            self.opens += 1

    def reset(self):
        """Force-close and clear the window: the watchdog calls this after a
        rebuild, since the window's failures belong to the old engine."""
        self._opened_at = None
        self._outcomes.clear()


@dataclass
class ResilienceStats:
    """Per-model counters of what the resilience layer did."""

    deadline_admission: int = 0   # arrived expired → 504
    deadline_queue: int = 0       # shed at the batcher's pop → 504
    deadline_await: int = 0       # expired while its batch ran → 504
    shed_predicted: int = 0       # the queue-wait forecast said hopeless → 429
    retries: int = 0              # transient dispatch retries attempted
    retry_successes: int = 0      # dispatches that succeeded after a retry
    breaker_fast_fails: int = 0   # requests 503'd by an open breaker

    @property
    def deadline_exceeded(self) -> int:
        return self.deadline_admission + self.deadline_queue + self.deadline_await

    def snapshot(self) -> dict:
        return {"deadline_exceeded": {"admission": self.deadline_admission,
                                      "queue": self.deadline_queue,
                                      "await": self.deadline_await,
                                      "total": self.deadline_exceeded},
                "shed": self.shed_predicted,
                "retries": self.retries,
                "retry_successes": self.retry_successes,
                "breaker_fast_fails": self.breaker_fast_fails}


@dataclass
class ModelResilience:
    """The per-model handle the server and the batcher share."""

    name: str
    stats: ResilienceStats = field(default_factory=ResilienceStats)
    breaker: CircuitBreaker | None = None
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    # Whether the latest dispatch failure was fatal.  A breaker open on a
    # fatal cause is the watchdog's rebuild signal; one open on transient
    # flakes heals by half-open probes.
    last_error_fatal: bool = False  # guarded-by: event-loop

    def note_outcome(self, ok: bool, fatal: bool = False):
        """Record a dispatch outcome on the breaker and the fatal flag."""
        self.last_error_fatal = fatal and not ok
        if self.breaker is not None:
            self.breaker.record(ok)


# Numeric encoding of the Prometheus breaker-state gauge.
BREAKER_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}


class ResilienceHub:
    """Per-model resilience state, the drain flag and the quarantine set."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.retry = RetryPolicy.from_config(cfg)
        self.models: dict[str, ModelResilience] = {}  # guarded-by: event-loop
        self.draining = False  # guarded-by: event-loop
        # Models pulled from service while the watchdog rebuilds the engine:
        # their work answers 503 + Retry-After until recovery ends.
        self.quarantined: set[str] = set()  # guarded-by: event-loop

    def model(self, name: str) -> ModelResilience:
        mr = self.models.get(name)
        if mr is None:
            breaker = None
            if self.cfg.breaker_threshold > 0:
                breaker = CircuitBreaker(
                    threshold=self.cfg.breaker_threshold,
                    window=self.cfg.breaker_window,
                    min_samples=self.cfg.breaker_min_samples,
                    open_s=self.cfg.breaker_open_s)
            mr = self.models[name] = ModelResilience(
                name=name, breaker=breaker, retry=self.retry)
        return mr

    def queue_forecast(self, batchers: dict) -> dict[str, float]:
        """Per-model queue-wait forecast in ms (``estimate_wait_ms``): the
        signal the admission shedder compares with a deadline, published on
        ``/healthz``."""
        return {name: round(b.estimate_wait_ms(), 1) for name, b in batchers.items()}

    def snapshot(self) -> dict:
        out: dict = {"draining": self.draining,
                     "quarantined": sorted(self.quarantined), "models": {}}
        for name, mr in self.models.items():
            snap = mr.stats.snapshot()
            if mr.breaker is not None:
                snap["breaker"] = {"state": mr.breaker.state,
                                   "error_rate": round(mr.breaker.error_rate(), 3),
                                   "opens": mr.breaker.opens,
                                   "fatal_cause": mr.last_error_fatal}
            out["models"][name] = snap
        return out


async def run_with_retry(factory, mr: ModelResilience, deadline: float | None,
                         clock, sleep) -> object:
    """Await ``factory()`` under the transient-retry and breaker contract.

    One device attempt a loop; a transient failure retries after capped
    backoff while the budget allows and the deadline (if any) survives the
    delay.  Every attempt's outcome feeds the breaker; the caller checks
    ``allow()`` at admission.  The job lane's path: the batcher has its own
    loop, which also sheds expired batch members between attempts.
    """
    attempt = 0
    while True:
        try:
            result = await factory()
        except Exception as e:
            mr.note_outcome(False, fatal=not is_transient(e))
            delay_ms = mr.retry.backoff_ms(attempt)
            fits = deadline is None or clock() + delay_ms / 1000.0 < deadline
            if is_transient(e) and attempt < mr.retry.max_attempts and fits:
                mr.stats.retries += 1
                attempt += 1
                log_event(log, "transient dispatch retry", model=mr.name,
                          attempt=attempt, delay_ms=round(delay_ms, 1),
                          error=f"{type(e).__name__}: {e}")
                await sleep(delay_ms / 1000.0)
                continue
            raise
        mr.note_outcome(True)
        if attempt:
            mr.stats.retry_successes += 1
        return result
