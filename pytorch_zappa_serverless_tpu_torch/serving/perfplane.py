"""The perf plane: always-on host profiling and ingest-path attribution.

The port of the JAX package's ``serving/perfplane.py``, three parts:

- **Ingest and egress attribution** (:meth:`PerfPlane.note_stage`,
  :data:`INGEST_STAGES`): the serving path stamps per-(model, stage)
  histograms for the host work around the device: ``payload_read``,
  ``json_decode``, ``b64_decode``, ``binary_decode``, ``validate``,
  ``batch_form``, ``serialize``, ``respond``, and on the acceptor fast lane
  the worker stages ``sock_read``, ``frame_validate`` and ``ring_wait``
  (stamped in the worker processes, stitched in by the pump).  They are
  substages: they overlap the admission → queue → device → respond chain of
  a request's trace and sit beside it.
- **A continuous runtime profiler**: :class:`LoopLagSampler` (the delta
  between when a ``call_later`` callback was due and when it ran: a
  blocking call on the event loop shows here before it shows as tail
  latency) and :class:`StackSampler` (a wall-clock sampler over
  ``sys._current_frames()``, aggregated by collapsed stack into a bounded
  top-K table).  Both take an injectable clock.  The stack sampler only
  reads frames: it never calls into torch or CUDA.
- **Rolling per-model gauges**: samples/s, tokens/s, step ms and the
  dispatch lane's occupied share, by differencing the counters the runner
  (``RunStats``) and the ``:generate`` lanes (``tokens_emitted``) keep, over
  a sliding window; MFU where the model configures ``flops_per_sample``
  and the card is in :data:`CHIP_PEAK_FLOPS`.  ``device_util_pct`` is
  ``RunStats.device_seconds`` per second, and ``device_seconds`` is the host
  clock around each batch's dispatch, as in the reference: the share of
  wall time the dispatch lane was busy with the model, not a device
  counter.

Surfaces: ``GET /admin/perf``, the ``perf`` CLI table, and the
``tpuserve_ingest_ms``, ``tpuserve_loop_lag_*`` and ``tpuserve_perf_*``
Prometheus families.  ``perfplane: false`` makes the module a no-op: no
thread, no timer, no histogram write.
"""

from __future__ import annotations

import sys
import threading
import time

from .metrics import Histogram

# The http → device gap, stage by stage, in pipeline order.
INGEST_STAGES = ("sock_read", "payload_read", "json_decode", "b64_decode",
                 "frame_validate", "binary_decode", "ring_wait", "validate",
                 "batch_form", "serialize", "respond")

# Host stage work: µs to tens of ms.
INGEST_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                     50.0, 100.0, 250.0)

# Event-loop lag: a healthy loop stays under 1 ms; a blocking handler shows
# as a 10-1000 ms spike.
LAG_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                  500.0, 1000.0, 2500.0)

# First-token and inter-token latency bounds.
TOKEN_LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                            500.0, 1000.0, 2500.0, 5000.0)

# Dense bf16 peak FLOP/s a card, by ``torch.cuda.get_device_name()``.  The
# H100 SXM5 part's 989.4e12 is NVIDIA's H100 datasheet figure (dense, no
# sparsity).  An unknown card gives no MFU gauge rather than a guessed one.
CHIP_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def hist_quantile(snap: dict, q: float) -> float | None:
    """Approximate quantile of a ``Histogram.snapshot()`` (cumulative
    buckets keyed by upper bound): linear interpolation inside the bucket
    the rank lands in; the +Inf bucket answers its lower bound (what
    Prometheus's ``histogram_quantile`` would say)."""
    count = snap.get("count", 0)
    if not count:
        return None
    rank = q * count
    prev_bound, prev_cum = 0.0, 0
    for le, cum in snap["buckets"].items():
        if le == "+Inf":
            return prev_bound
        if cum >= rank:
            bound = float(le)
            width = cum - prev_cum
            frac = (rank - prev_cum) / width if width else 1.0
            return round(prev_bound + (bound - prev_bound) * frac, 3)
        prev_bound, prev_cum = float(le), cum
    return prev_bound


class LoopLagSampler:
    """Event-loop responsiveness probe: every ``interval_s`` a
    ``call_later`` callback fires, and the time between when it was due and
    when it ran is time something else held the loop.  The deltas feed a
    histogram and a lifetime max.  :meth:`note` is the measurement core;
    ``clock`` is injectable."""

    def __init__(self, interval_s: float = 0.25, clock=time.monotonic):
        self.interval_s = max(float(interval_s), 0.01)
        self._clock = clock
        self.hist = Histogram(LAG_BUCKETS_MS)
        self.ticks = 0        # guarded-by: event-loop
        self.max_ms = 0.0     # guarded-by: event-loop
        self.last_ms = 0.0    # guarded-by: event-loop
        self._due: float | None = None  # guarded-by: event-loop
        self._handle = None   # guarded-by: event-loop
        self._loop = None     # guarded-by: event-loop
        # Called after every tick (the plane's gauge sampling rides it).
        self.on_tick = None   # guarded-by: event-loop

    def arm(self, now: float | None = None) -> None:
        """Record when the next tick is due."""
        now = self._clock() if now is None else now
        self._due = now + self.interval_s

    def note(self, now: float | None = None) -> float:
        """One tick: lag = actual - due (never negative); re-arms.  Returns
        the lag in ms."""
        now = self._clock() if now is None else now
        lag_ms = max(now - self._due, 0.0) * 1000.0 if self._due else 0.0
        self.ticks += 1
        self.last_ms = lag_ms
        if lag_ms > self.max_ms:
            self.max_ms = lag_ms
        self.hist.observe(lag_ms)
        self.arm(now)
        return lag_ms

    def start(self, loop) -> "LoopLagSampler":
        """Arm on ``loop``; call from the thread that runs it."""
        self._loop = loop
        self.arm(loop.time())
        self._handle = loop.call_later(self.interval_s, self._tick)
        return self

    def _tick(self):
        self.note(self._loop.time())
        if self.on_tick is not None:
            try:
                self.on_tick()
            except Exception:  # noqa: BLE001 — sampling must not kill the timer
                pass
        self._handle = self._loop.call_later(self.interval_s, self._tick)

    def stop(self):
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def snapshot(self) -> dict:
        return {"interval_s": self.interval_s, "ticks": self.ticks,
                "last_ms": round(self.last_ms, 3),
                "max_ms": round(self.max_ms, 3),
                "hist": self.hist.snapshot()}


def _collapse(frame, max_depth: int) -> str:
    """A collapsed stack, outermost first, as ``file:function`` (file
    basenames)."""
    parts: list[str] = []
    while frame is not None and len(parts) < max_depth:
        code = frame.f_code
        parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class StackSampler:
    """Wall-clock thread-stack sampler over ``sys._current_frames()``.

    A background thread wakes ``hz`` times a second and charges the elapsed
    wall interval to every thread's collapsed stack (its name first).  The
    table compacts to the ``topk`` heaviest stacks when it doubles past
    that, folding evicted weight into ``other_s``.  ``frames`` and
    ``clock`` are injectable.
    """

    def __init__(self, hz: float = 7.0, topk: int = 64, max_depth: int = 24,
                 clock=time.monotonic, frames=sys._current_frames):
        self.hz = max(float(hz), 0.1)
        self.topk = max(int(topk), 1)
        self.max_depth = max(int(max_depth), 1)
        self._clock = clock
        self._frames = frames
        self._lock = threading.Lock()
        self._table: dict[str, float] = {}  # guarded-by: _lock
        self.other_s = 0.0                  # guarded-by: _lock
        self.samples = 0                    # guarded-by: _lock
        self.evictions = 0                  # guarded-by: _lock
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._stop = threading.Event()

    @staticmethod
    def _thread_name(ident: int) -> str:
        for t in threading.enumerate():
            if t.ident == ident:
                return t.name
        return f"tid-{ident}"

    def sample_once(self, dt_s: float, skip_ident: int | None = None) -> int:
        """Charge ``dt_s`` wall seconds to every live thread's stack;
        returns how many stacks were charged."""
        rows = [f"{self._thread_name(ident)};{_collapse(frame, self.max_depth)}"
                for ident, frame in self._frames().items() if ident != skip_ident]
        with self._lock:
            self.samples += 1
            for key in rows:
                self._table[key] = self._table.get(key, 0.0) + dt_s
            if len(self._table) > 2 * self.topk:
                self._compact_locked()
        return len(rows)

    def _compact_locked(self):
        keep = sorted(self._table.items(), key=lambda kv: -kv[1])[: self.topk]
        self.other_s += sum(self._table.values()) - sum(s for _, s in keep)
        self.evictions += len(self._table) - len(keep)
        self._table = dict(keep)

    def start(self) -> "StackSampler":
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(target=self._run, name="perf-stack-sampler",
                                                daemon=True)
                self._thread.start()
        return self

    def _run(self):
        me = threading.get_ident()
        last = self._clock()
        while not self._stop.wait(1.0 / self.hz):
            now = self._clock()
            self.sample_once(now - last, skip_ident=me)
            last = now

    def stop(self):
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def snapshot(self, top: int | None = None) -> dict:
        with self._lock:
            rows = sorted(self._table.items(), key=lambda kv: -kv[1])
            other = self.other_s
            samples, evictions = self.samples, self.evictions
        # The total covers the whole table and the evicted weight, so a row's
        # share never over-reports.
        total = sum(s for _, s in rows) + other
        other += sum(s for _, s in rows[(top or self.topk):])
        rows = rows[: (top or self.topk)]
        return {
            "hz": self.hz, "samples": samples, "evictions": evictions,
            "total_s": round(total, 3),
            "stacks": [{"stack": k, "seconds": round(s, 3),
                        "pct": round(100.0 * s / total, 1) if total else 0.0}
                       for k, s in rows],
            **({"other_s": round(other, 3)} if other else {}),
        }


class _Window:
    """A bounded ring of (t, cumulative counters) samples; the gauges are
    the difference quotient between the newest sample and the oldest one
    still inside the window."""

    def __init__(self, window_s: float):
        self.window_s = max(float(window_s), 1.0)
        self._rows: list[tuple[float, dict]] = []  # guarded-by: event-loop

    def push(self, now: float, counters: dict):
        self._rows.append((now, counters))
        floor = now - self.window_s
        while len(self._rows) > 2 and self._rows[1][0] <= floor:
            self._rows.pop(0)

    def rates(self) -> dict | None:
        if len(self._rows) < 2:
            return None
        (t0, a), (t1, b) = self._rows[0], self._rows[-1]
        dt = t1 - t0
        if dt <= 0:
            return None
        out = {f"{k}_per_s": (b.get(k, 0.0) - a.get(k, 0.0)) / dt for k in b}
        out["span_s"] = dt
        return out


class PerfPlane:
    """The server's perf hub: ingest histograms, samplers, gauges.  Always
    constructed (so ``/admin/perf`` and the metric families exist);
    ``perfplane: false`` makes every record call and :meth:`start` a no-op."""

    def __init__(self, cfg=None):
        self.enabled = bool(getattr(cfg, "perfplane", True))
        self.window_s = float(getattr(cfg, "perf_window_s", 30.0))
        self.loop_lag = LoopLagSampler(
            interval_s=float(getattr(cfg, "perf_loop_lag_interval_s", 0.25)))
        self._stack_hz = float(getattr(cfg, "perf_stack_hz", 7.0))
        self.stacks = StackSampler(hz=self._stack_hz,
                                   topk=int(getattr(cfg, "perf_stack_topk", 64)))
        # (model, stage) -> Histogram.  Written on the event loop (handlers,
        # batchers and the ring pump share it); a scrape reads under each
        # histogram's own lock.
        self.ingest: dict[tuple[str, str], Histogram] = {}  # guarded-by: event-loop
        self._windows: dict[str, _Window] = {}  # guarded-by: event-loop
        # Wired by the server: zero-argument callables over the live
        # counters, the model's FLOP hint, and the card's name.
        self.runner_stats = None   # guarded-by: event-loop
        self.gen_snapshots = None  # guarded-by: event-loop
        self.flops_hint = None     # guarded-by: event-loop
        self.device_name = None    # guarded-by: event-loop
        # Resolved at the first gauge read (False: not yet): the engine owns
        # the device, and it is built by then.
        self.peak_flops: float | None | bool = False  # guarded-by: event-loop

    def _peak(self) -> float | None:
        if self.peak_flops is False:
            try:
                name = self.device_name() if self.device_name is not None else None
            except Exception:  # noqa: BLE001 — no card: no gauge
                name = None
            self.peak_flops = CHIP_PEAK_FLOPS.get(name) if name else None
        return self.peak_flops

    def note_stage(self, model: str | None, stage: str, ms: float) -> None:
        """One host stage observation (event loop only)."""
        if not self.enabled or model is None:
            return
        hist = self.ingest.get((model, stage))
        if hist is None:
            hist = self.ingest[(model, stage)] = Histogram(INGEST_BUCKETS_MS)
        hist.observe(ms)

    def observe_models(self, now: float | None = None) -> None:
        """Sample the live counters into the rolling windows (on every lag
        tick)."""
        if not self.enabled:
            return
        now = time.monotonic() if now is None else now
        stats = self.runner_stats() if self.runner_stats is not None else {}
        gens = self.gen_snapshots() if self.gen_snapshots is not None else {}
        for model, st in (stats or {}).items():
            self._push(now, model, {"samples": float(st.samples),
                                    "batches": float(st.batches),
                                    "device_seconds": float(st.device_seconds)})
        for model, snap in (gens or {}).items():
            self._push(now, f"{model}:generate",
                       {"tokens": float(snap.get("tokens_emitted", 0)),
                        "ticks": float(snap.get("segment_rounds", 0))})

    def _push(self, now: float, key: str, counters: dict):
        win = self._windows.get(key)
        if win is None:
            win = self._windows[key] = _Window(self.window_s)
        win.push(now, counters)

    def model_gauges(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for key, win in self._windows.items():
            rates = win.rates()
            if rates is None:
                continue
            row: dict = {"window_s": round(rates["span_s"], 1)}
            if "samples_per_s" in rates:
                row["samples_per_s"] = round(rates["samples_per_s"], 2)
                bps = rates.get("batches_per_s", 0.0)
                dps = rates.get("device_seconds_per_s", 0.0)
                if bps > 0:
                    row["step_ms"] = round(1000.0 * dps / bps, 3)
                row["device_util_pct"] = round(100.0 * dps, 1)
                flops = self.flops_hint(key) if self.flops_hint is not None else None
                peak = self._peak() if flops else None
                if flops and peak and rates["samples_per_s"] > 0:
                    row["mfu_pct"] = round(100.0 * flops * rates["samples_per_s"] / peak, 2)
            if "tokens_per_s" in rates:
                row["tokens_per_s"] = round(rates["tokens_per_s"], 2)
                if rates.get("ticks_per_s"):
                    row["tick_ms"] = round(1000.0 / rates["ticks_per_s"], 3)
            out[key] = row
        return out

    def start(self, loop) -> "PerfPlane":
        """Arm the lag sampler (and with it the gauges) on ``loop``, from the
        thread that runs it, and start the stack sampler."""
        if not self.enabled:
            return self
        self.loop_lag.on_tick = self.observe_models
        self.loop_lag.start(loop)
        if self._stack_hz > 0:
            self.stacks.start()
        return self

    def stop(self):
        self.loop_lag.stop()
        self.stacks.stop()

    def ingest_snapshot(self) -> dict[str, dict[str, dict]]:
        """{model: {stage: histogram snapshot}}, stages in pipeline order."""
        out: dict[str, dict[str, dict]] = {}
        for (model, stage), hist in list(self.ingest.items()):
            out.setdefault(model, {})[stage] = hist.snapshot()
        return {m: {s: st[s] for s in INGEST_STAGES if s in st} for m, st in out.items()}

    def snapshot(self, top_stacks: int = 20) -> dict:
        return {
            "enabled": self.enabled,
            "loop_lag": self.loop_lag.snapshot(),
            "stacks": self.stacks.snapshot(top=top_stacks),
            "models": self.model_gauges(),
            "ingest": self.ingest_snapshot(),
        }
