"""Request metrics: per-model latency rings and the /metrics JSON document.

The JSON parts of the JAX package's ``MetricsHub`` this slice can fill:
p50/p99/mean of queue, device and total ms, requests and errors, lifetime
req/s, batch occupancy per model and bucket, the dispatch lanes, first-
dispatch ("compile") timings, device-resident parameter bytes, and each
``:generate`` lane's snapshot (its ``<name>:generate`` ring sits beside the
models' rings; time to first token and inter-token gaps are
histograms over :data:`TOKEN_LATENCY_BUCKETS_MS`).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

# Bucket bounds (ms) of the per-token histograms: time to first token and
# the gap between tokens, decode cadence included.
TOKEN_LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                            500.0, 1000.0, 2500.0, 5000.0)


class Histogram:
    """Cumulative histogram over fixed bounds: O(1) observe, exact counts.
    Lock-protected: observed from the event loop, read by a scrape."""

    def __init__(self, bounds: tuple[float, ...] = TOKEN_LATENCY_BUCKETS_MS):
        self.bounds = tuple(bounds)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)  # guarded-by: _lock
        self.sum = 0.0    # guarded-by: _lock
        self.count = 0    # guarded-by: _lock

    def observe(self, value: float):
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> dict:
        """Cumulative bucket counts keyed by upper bound."""
        with self._lock:
            counts = list(self._counts)
            total, s = self.count, self.sum
        out, acc = {}, 0
        for bound, n in zip(self.bounds, counts):
            acc += n
            out[f"{bound:g}"] = acc
        out["+Inf"] = total
        return {"buckets": out, "sum": round(s, 3), "count": total}


class LatencyRing:
    """Lock-protected ring of recent (queue_ms, device_ms, total_ms) samples."""

    def __init__(self, maxlen: int = 4096):
        self._samples: deque[tuple[float, float, float]] = deque(maxlen=maxlen)  # guarded-by: _lock
        self._lock = threading.Lock()
        self.count = 0   # guarded-by: _lock
        self.errors = 0  # guarded-by: _lock
        self._t0 = time.monotonic()

    def record(self, queue_ms: float, device_ms: float, total_ms: float):
        with self._lock:
            self._samples.append((queue_ms, device_ms, total_ms))
            self.count += 1

    def record_error(self):
        with self._lock:
            self.errors += 1

    def device_p50(self) -> float | None:
        """Recent p50 device ms, or None before any sample."""
        with self._lock:
            if not self._samples:
                return None
            arr = np.asarray(self._samples, dtype=np.float64)
        return float(np.percentile(arr[:, 1], 50))

    def snapshot(self) -> dict:
        with self._lock:
            arr = np.asarray(self._samples, dtype=np.float64)
            count, errors = self.count, self.errors
        uptime = max(time.monotonic() - self._t0, 1e-9)
        out = {"requests": count, "errors": errors,
               "req_per_s_lifetime": round(count / uptime, 2)}
        if len(arr):
            for i, name in enumerate(("queue_ms", "device_ms", "total_ms")):
                col = arr[:, i]
                out[name] = {"p50": round(float(np.percentile(col, 50)), 3),
                             "p99": round(float(np.percentile(col, 99)), 3),
                             "mean": round(float(col.mean()), 3)}
        return out


class MetricsHub:
    """Registry of per-model rings, rendered for /metrics.  Event-loop
    confined; the rings inside carry their own locks."""

    def __init__(self):
        self.models: dict[str, LatencyRing] = {}  # guarded-by: event-loop
        # () -> {model: gen_snapshot()} of the :generate lanes, set by the
        # server; None before any lane exists.
        self.generation = None  # guarded-by: event-loop

    def ring(self, model: str) -> LatencyRing:
        if model not in self.models:
            self.models[model] = LatencyRing()
        return self.models[model]

    def render(self, engine=None) -> dict:
        out = {"models": {k: r.snapshot() for k, r in self.models.items()}}
        if self.generation is not None:
            out["generation"] = self.generation()
        if engine is None:
            return out
        occ = {}
        for name, st in engine.runner.stats.items():
            total = st.samples + st.padded_samples
            by_bucket = {
                b: {"batches": v["batches"], "samples": v["samples"],
                    "occupancy": round(v["samples"] / v["rows"], 3) if v["rows"] else 1.0}
                for b, v in st.by_bucket.items()}
            occ[name] = {"batches": st.batches, "samples": st.samples,
                         "batch_occupancy": round(st.samples / total, 3) if total else 1.0,
                         "device_seconds": round(st.device_seconds, 3),
                         "by_bucket": by_bucket}
        for name, cm in engine.models.items():
            if cm.graphed:  # the buckets (and variants, chunks) captured as CUDA graphs
                occ.setdefault(name, {})["graphs"] = cm.graphs
        out["runner"] = occ
        out["dispatch"] = {"priority_enabled": engine.runner.priority_enabled,
                           "lanes": engine.runner.lane_stats()}
        out["cold_start"] = {"seconds": round(engine.cold_start_seconds, 3),
                             "compile_entries": engine.clock.entries,
                             "compile_seconds_total": round(engine.clock.total_seconds, 3),
                             "compile_by_model": engine.clock.per_model()}
        by_model = engine.runner.resident_bytes()
        out["hbm"] = {"by_model": by_model, "total_bytes": sum(by_model.values())}
        return out
