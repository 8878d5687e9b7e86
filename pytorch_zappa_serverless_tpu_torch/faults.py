"""Fault taxonomy and injection: the chaos surface of the resilience layer.

The port's copy of the JAX package's ``faults.py``.  It defines

- the transient-against-fatal classification that the retry path and the
  circuit breaker key off (:func:`is_transient`), with the CUDA counterpart
  of the reference's XLA status table;
- :class:`FaultInjector`, the config- and ``POST /admin/faults``-driven
  chaos hook on the device runner: fail every Nth dispatch (transient,
  fatal, or a poison that latches), add device latency, fail preprocess,
  fail or copy-on-write the prefix cache's lookups, fail or slow a model's
  activation or one tenant's adapter attach, tear or slow a streamed
  checkpoint's chunk reads, drop, corrupt or slow a live migration step,
  and derail speculative proposals.

The rule schema and its validation are the reference's, so
``/admin/faults`` takes and refuses the same bodies, except that a kind
whose plane the port lacks (the autoscaler's ``demand``) is refused with
the module still to port: a rule that is accepted and never fires would
report chaos that never happens.

At the package top level because ``engine.runner`` (dispatch-side
injection) and ``serving.*`` (retry classification, the admin route) both
need it, and ``engine`` does not import ``serving``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

import torch


class TransientFault(RuntimeError):
    """A dispatch failure worth retrying: the device is expected to recover
    without a rebuild (an injected flake, a transient allocation failure)."""


# Substrings that mark a foreign exception as transient: the reference's
# XLA/TPU runtime statuses, kept so a message carrying one classifies the
# same in both packages.
TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "ABORTED",
    "CANCELLED_BY_PREEMPTION",
    "transient",
)

# Substrings that mark a CUDA failure as fatal whatever else the message
# says.  ``CUDA error:`` is how torch words a failed CUDA call: an illegal
# address, a device-side assert, a launch failure, an illegal instruction
# (a ``hopper::mbar_wait`` trap).  Most of these are sticky: the context is
# unusable afterwards.  ``kernel launch failed`` is a hand kernel's wrapper
# refusing a launch (``ops/_tma.py``'s 9000xx codes, or a cudaError_t).
FATAL_MARKERS = (
    "CUDA error:",
    "kernel launch failed",
)


def is_transient(exc: BaseException) -> bool:
    """Classify an exception as transient (retry) or fatal (fail the request).

    - :class:`TransientFault` (and subclasses): transient.
    - ``torch.OutOfMemoryError`` from the caching allocator: transient, as
      XLA's ``RESOURCE_EXHAUSTED`` is (the allocation may fit once the
      batches ahead have freed theirs).
    - A message with a :data:`FATAL_MARKERS` substring: fatal.
    - A message with a :data:`TRANSIENT_MARKERS` status: transient.
    - Everything else: fatal.  Shape bugs and poisoned runners do not heal
      on a second try, and an unknown error should fail its request rather
      than spend its deadline on doomed retries.
    """
    if isinstance(exc, (TransientFault, torch.OutOfMemoryError)):
        return True
    msg = str(exc)
    if any(m in msg for m in FATAL_MARKERS):
        return False
    return any(m in msg for m in TRANSIENT_MARKERS)


# The reference's kinds whose plane the port has not ported yet, each with
# what it waits for (ROADMAP Queue 1).
REFUSED_KINDS = {
    "demand": "serving/autoscale.py (ROADMAP Queue 1 item 5)",
}


@dataclass
class FaultRule:
    """One injection rule, keyed by model name (or ``*`` for all).

    ``fail_every_n=N`` fails every Nth matching dispatch (1 = every);
    ``count`` bounds how many failures fire before the rule goes inert;
    ``latency_ms`` sleeps on the dispatch thread before the dispatch runs,
    so it occupies the lane as a slow graph replay would; ``preprocess``
    targets the host-side preprocess hook instead of the dispatch.

    ``kind="poison"`` latches :attr:`FaultInjector.poison_exc` when it
    fires: the device is wedged from that dispatch on (every dispatch
    raises, the probe reports dead), the fault the watchdog must detect,
    quarantine and heal with a rebuild.

    ``kind="activation"`` fires on :meth:`FaultInjector.on_activation` at
    the head of a lifecycle activation (the model stays COLD, the next
    demand retries); ``kind="ckpt"`` on :meth:`FaultInjector.on_ckpt` at
    each chunk read of a streamed checkpoint load, ``mode="torn"`` (the
    default) corrupting the chunk and ``mode="slow"`` sleeping
    ``latency_ms`` before it.

    ``kind="prefix"`` fires on :meth:`FaultInjector.on_prefix` at the head
    of each paged admission's radix lookup.  ``mode="poison"`` (the default)
    fails the lookup, so admission falls back to a cold prefill with
    identical tokens; ``mode="cow"`` copies every shared page of a hit,
    again with identical tokens, and ``cow_copies`` counts the copies.

    ``kind="migration"`` fires on :meth:`FaultInjector.on_migration` at the
    head of each live-migration step (export phases, import, the swap to
    host under pressure): ``mode="drop"`` (the default) aborts before any
    state moves, ``"corrupt"`` flips a page's bytes after its hash (the
    importer's verify must catch it and fetch the page again), ``"slow"``
    stretches the step by ``latency_ms``.  ``kind="spec_mismatch"`` fires on
    :meth:`FaultInjector.on_spec` before a speculative tick and derails its
    draft proposals, so the verifier's rejection path runs.

    ``kind="adapter"`` fires on :meth:`FaultInjector.on_adapter` at the head
    of one tenant's adapter attach, keyed ``{base}:{adapter}`` (or the base
    alone, or ``*``): the attach fails and the adapter stays cold.
    """

    model: str = "*"
    fail_every_n: int = 0
    count: int | None = None
    kind: str = "transient"  # transient | fatal | poison | prefix | activation | ckpt
    #                          | migration | spec_mismatch | adapter
    latency_ms: float = 0.0
    preprocess: bool = False
    # kind="prefix": "poison" (fail the lookup) | "cow" (force CoW);
    # kind="ckpt": "torn" (corrupt chunk bytes) | "slow" (per-chunk delay);
    # kind="migration": "drop" | "corrupt" | "slow".
    mode: str = ""
    # Counters, not config: matching calls seen and failures fired.
    seen: int = field(default=0)
    fired: int = field(default=0)

    def public(self) -> dict:
        return {"model": self.model, "fail_every_n": self.fail_every_n,
                "count": self.count, "kind": self.kind,
                "latency_ms": self.latency_ms, "preprocess": self.preprocess,
                "mode": self.mode, "seen": self.seen, "fired": self.fired}


class FaultInjector:
    """Chaos hook on the device runner, driven by ``ServeConfig.faults`` and
    ``POST /admin/faults``.

    Thread-safe: rules are configured from the event loop while
    ``on_dispatch`` runs on the dispatch thread.  ``poison_exc`` is the
    always-fatal hook (``DeviceRunner.poison``): while set, every dispatch
    raises it and the probe reports dead, a wedged device; rules model a
    flaky one, and the probe stays green.
    """

    _KINDS = ("transient", "fatal", "poison", "activation", "spec_mismatch",
              "adapter", "prefix", "migration", "demand", "ckpt")

    # Kinds that are their own firing target: they never fire on dispatch or
    # preprocess and never displace those rules.
    _TARGETED = ("activation", "adapter", "prefix", "ckpt", "migration", "spec_mismatch")

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: list[FaultRule] = []  # guarded-by: _lock
        # A lock-free latch: one attribute reference, written to wedge the
        # device and read at the head of every dispatch.
        self.poison_exc: Exception | None = None
        # guarded-by: _lock
        self.injected = {"dispatch": 0, "preprocess": 0, "activation": 0, "spec": 0,
                         "adapter": 0, "prefix": 0, "migration": 0, "ckpt": 0,
                         "latency_ms": 0.0}

    def configure(self, model: str = "*", fail_every_n: int = 0,
                  count: int | None = None, kind: str = "transient",
                  latency_ms: float = 0.0, preprocess: bool = False,
                  mode: str = "") -> FaultRule:
        if kind not in self._KINDS:
            raise ValueError(f"kind must be one of {self._KINDS}, got {kind!r}")
        if kind in REFUSED_KINDS:
            raise ValueError(f"fault kind {kind!r} targets {REFUSED_KINDS[kind]}, "
                             "which the port does not have yet")
        if fail_every_n < 0 or latency_ms < 0:
            raise ValueError("fail_every_n and latency_ms must be >= 0")
        if count is not None and int(count) < 1:
            raise ValueError("count must be >= 1 when set")
        if mode and kind not in ("prefix", "migration", "ckpt"):
            raise ValueError(
                "mode is a kind='prefix'/'migration'/'demand'/'ckpt' knob")
        if kind == "prefix" and mode not in ("", "poison", "cow"):
            raise ValueError(f"prefix mode must be 'poison' or 'cow', got {mode!r}")
        if kind == "ckpt" and mode not in ("", "torn", "slow"):
            raise ValueError(f"ckpt mode must be 'torn' or 'slow', got {mode!r}")
        if kind == "migration" and mode not in ("", "drop", "corrupt", "slow"):
            raise ValueError(f"migration mode must be 'drop', 'corrupt' or 'slow', got {mode!r}")
        rule = FaultRule(model=model, fail_every_n=int(fail_every_n),
                         count=int(count) if count is not None else None,
                         kind=kind, latency_ms=float(latency_ms),
                         preprocess=bool(preprocess), mode=str(mode))
        with self._lock:
            # One rule per (model, target): reconfiguring replaces.
            def _target(r):
                return r.kind if r.kind in self._TARGETED else "dispatch"

            self._rules = [r for r in self._rules
                           if not (r.model == rule.model
                                   and r.preprocess == rule.preprocess
                                   and _target(r) == _target(rule))]
            self._rules.append(rule)
        return rule

    def clear(self, model: str | None = None):
        with self._lock:
            if model is None:
                self._rules = []
            else:
                self._rules = [r for r in self._rules if r.model != model]

    def snapshot(self) -> dict:
        with self._lock:
            return {"poisoned": self.poison_exc is not None,
                    "rules": [r.public() for r in self._rules],
                    "injected": dict(self.injected)}

    def _match(self, model: str, preprocess: bool, prefix: bool = False,
               activation: bool = False, ckpt: bool = False, migration: bool = False,
               spec: bool = False, adapter: bool = False) -> FaultRule | None:
        for r in self._rules:
            if (r.kind == "adapter") != adapter:
                continue  # adapter rules fire on on_adapter only
            if (r.kind == "prefix") != prefix:
                continue  # prefix rules fire on on_prefix only
            if (r.kind == "activation") != activation:
                continue  # activation rules fire on on_activation only
            if (r.kind == "ckpt") != ckpt:
                continue  # ckpt rules fire on on_ckpt only
            if (r.kind == "migration") != migration:
                continue  # migration rules fire on on_migration only
            if (r.kind == "spec_mismatch") != spec:
                continue  # spec rules fire on on_spec only
            if r.preprocess == preprocess and r.model in ("*", model):
                return r
        return None

    def _fire(self, rule: FaultRule) -> bool:
        """Under the lock: does this call fail, per the rule's cadence?"""
        if rule.fail_every_n <= 0:
            return False
        if rule.count is not None and rule.fired >= rule.count:
            return False
        if rule.seen % rule.fail_every_n == 0:
            rule.fired += 1
            return True
        return False

    def _raise(self, rule: FaultRule, where: str):
        msg = f"injected {rule.kind} fault ({where}, model={rule.model})"
        if rule.kind == "transient":
            raise TransientFault(msg)
        exc = RuntimeError(msg)
        if rule.kind == "poison":
            # Latch: every later dispatch fails and the probe reports dead
            # until a rebuild swaps in a fresh runner.
            self.poison_exc = exc
        raise exc

    def on_dispatch(self, model: str):
        """Called on the DISPATCH THREAD at the head of every device run:
        sleeps the rule's latency (occupying the lane, as a slow replay
        would), then raises if the cadence says so.  Poison comes first: it
        models a device that is gone, not flaky."""
        if self.poison_exc is not None:
            raise self.poison_exc
        with self._lock:
            rule = self._match(model, preprocess=False)
            if rule is None:
                return
            rule.seen += 1
            fire = self._fire(rule)
            latency = rule.latency_ms
            if fire:
                self.injected["dispatch"] += 1
            if latency:
                self.injected["latency_ms"] += latency
        if latency:
            time.sleep(latency / 1000.0)
        if fire:
            self._raise(rule, "dispatch")

    def on_activation(self, model: str):
        """Called (on the activation's build thread) at the head of a
        lifecycle activation, the cold-start twin of :meth:`on_dispatch`.
        Latency rules sleep here too, stretching the activation as a slow
        weight fetch would."""
        with self._lock:
            rule = self._match(model, preprocess=False, activation=True)
            if rule is None:
                return
            rule.seen += 1
            fire = self._fire(rule)
            latency = rule.latency_ms
            if fire:
                self.injected["activation"] += 1
            if latency:
                self.injected["latency_ms"] += latency
        if latency:
            time.sleep(latency / 1000.0)
        if fire:
            self._raise(rule, "activation")

    def on_adapter(self, key: str):
        """Called (on the event loop) at the head of an adapter attach
        (``serving/adapters.py``).  ``key`` is ``{base}:{adapter}``: a rule's
        ``model`` may name the pair, the wildcard, or the base alone to fault
        every tenant's attach on it.  A fired rule fails this attach only: the
        adapter stays cold, the base and its other tenants serve on.  Latency
        rules stretch the attach as a slow adapter fetch would."""
        base = key.split(":", 1)[0]
        with self._lock:
            rule = (self._match(key, preprocess=False, adapter=True)
                    or self._match(base, preprocess=False, adapter=True))
            if rule is None:
                return
            rule.seen += 1
            fire = self._fire(rule)
            latency = rule.latency_ms
            if fire:
                self.injected["adapter"] += 1
            if latency:
                self.injected["latency_ms"] += latency
        if latency:
            time.sleep(latency / 1000.0)
        if fire:
            self._raise(rule, "adapter")

    def on_ckpt(self, model: str) -> tuple[str | None, float]:
        """Called (on the stream's reader thread) at the head of each chunk
        read of a streamed checkpoint load (serving/ckptstore.py): ``(mode,
        latency_s)``, mode ``"torn"`` (the store corrupts the chunk; the
        integrity hash catches it and the pipeline re-reads once, and a
        persistent tear fails the stream naming the chunk) or ``"slow"``
        (the store sleeps first), or ``(None, 0.0)`` when nothing fires.
        Never raises: the chaos target is the re-read and degrade ladder."""
        with self._lock:
            rule = self._match(model, preprocess=False, ckpt=True)
            if rule is None:
                return None, 0.0
            rule.seen += 1
            if not self._fire(rule):
                return None, 0.0
            self.injected["ckpt"] += 1
            latency = rule.latency_ms if rule.mode == "slow" else 0.0
            if latency:
                self.injected["latency_ms"] += latency
            return rule.mode or "torn", latency / 1000.0

    def on_prefix(self, model: str) -> str:
        """Called by the paged scheduler before each admission's prefix
        lookup: the firing rule's mode (``"poison"`` or ``"cow"``), or
        ``""`` when nothing fires.  Never raises: the chaos target is the
        fallback path, not the lane."""
        with self._lock:
            rule = self._match(model, preprocess=False, prefix=True)
            if rule is None:
                return ""
            rule.seen += 1
            if not self._fire(rule):
                return ""
            self.injected["prefix"] += 1
            return rule.mode or "poison"

    def on_migration(self, model: str) -> tuple[str, float]:
        """Called at the head of each live-migration step (an export phase,
        an import, the swap to host under pressure): ``(mode, latency_s)``,
        mode ``"drop"`` (abort before any state moves: the caller falls back
        or answers retryable), ``"corrupt"`` (flip a page's bytes after its
        hash) or ``"slow"`` (the caller sleeps ``latency_s``: returned, not
        slept here, so a caller on the event loop can await it), or ``("",
        0.0)`` when nothing fires.  Never raises."""
        with self._lock:
            rule = self._match(model, preprocess=False, migration=True)
            if rule is None:
                return "", 0.0
            rule.seen += 1
            if not self._fire(rule):
                return "", 0.0
            self.injected["migration"] += 1
            latency = rule.latency_ms if rule.mode == "slow" else 0.0
            if latency:
                self.injected["latency_ms"] += latency
            return rule.mode or "drop", latency / 1000.0

    def on_spec(self, model: str) -> bool:
        """Called by the paged scheduler before a speculative tick: True
        means derail this tick's draft proposals (the verifier's rejection
        sampling must correct them).  Never raises."""
        with self._lock:
            rule = self._match(model, preprocess=False, spec=True)
            if rule is None:
                return False
            rule.seen += 1
            if not self._fire(rule):
                return False
            self.injected["spec"] += 1
            return True

    def dispatch_latency_s(self, model: str) -> float:
        """The matching dispatch rule's latency, without spending a failure
        firing.  ``DeviceRunner.run_fn`` (the ``:generate`` lanes) honours
        it: a slow device is slow for streams too, but failure rules stay
        off the streaming path, where a mid-stream generation has no retry."""
        with self._lock:
            rule = self._match(model, preprocess=False)
            if rule is None or not rule.latency_ms:
                return 0.0
            self.injected["latency_ms"] += rule.latency_ms
            return rule.latency_ms / 1000.0

    def on_preprocess(self, model: str):
        """Called by the server before a payload's preprocess runs."""
        with self._lock:
            rule = self._match(model, preprocess=True)
            if rule is None:
                return
            rule.seen += 1
            if not self._fire(rule):
                return
            self.injected["preprocess"] += 1
        self._raise(rule, "preprocess")

    def apply_config(self, faults: dict[str, dict[str, Any]]):
        """Install rules from ``ServeConfig.faults`` ({model: rule kwargs})."""
        for model, rule in (faults or {}).items():
            self.configure(model=model, **rule)
