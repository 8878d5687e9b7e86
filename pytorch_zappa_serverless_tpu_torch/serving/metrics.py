"""Request metrics: per-model latency rings, the /metrics JSON document and
its Prometheus text exposition.

The parts of the JAX package's ``MetricsHub`` the port's modules fill:
p50/p99/mean of queue, device and total ms (and lifetime histograms of the
first two), requests and errors, lifetime req/s, batch occupancy per model
and bucket, the dispatch lanes, first-dispatch ("compile") timings,
device-resident bytes (weights and graph pools), each ``:generate`` lane's snapshot (its
``<name>:generate`` ring sits beside the models' rings; time to first token
and inter-token gaps are histograms over :data:`TOKEN_LATENCY_BUCKETS_MS`),
the resilience layer (deadlines, retries, breakers, drain, quarantine,
fault injection and recovery), and residency: each model's state, its
activations and demotions by cause, activation times, cold-start
fast-fails, the bytes on each tier and the checkpoint store's streams; and
the request plane: the tracer's counters, the job journal's replay and
dedupes, and the binary lane's requests; and the host ingest planes: the
perf plane's loop lag, ingest-stage histograms and rolling gauges, and the
acceptor workers, their rings and the per-worker telemetry blocks.

:meth:`MetricsHub.render_prometheus` writes the same numbers as text
exposition 0.0.4 under the names, types and label sets of
``tools/metrics_manifest.json``; it emits no family the manifest lacks.
The queue and device histograms carry OpenMetrics exemplars: each bucket
keeps the last ``(trace_id, value, timestamp)`` observed in it, which links
a scraped bucket to ``GET /admin/trace/{id}``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

# Bucket bounds (ms) of the queue and device latency histograms, from sub-ms
# batching to multi-second jobs; +Inf is the last cumulative bucket.
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)
# Bucket bounds (ms) of the per-token histograms: time to first token and
# the gap between tokens, decode cadence included.
TOKEN_LATENCY_BUCKETS_MS = LATENCY_BUCKETS_MS[:-1]


class Histogram:
    """Cumulative histogram over fixed bounds: O(1) observe, exact counts,
    and each bucket's last exemplar ``(trace_id, value, wall ts)``.
    Lock-protected: observed from the event loop, read by a scrape."""

    def __init__(self, bounds: tuple[float, ...] = LATENCY_BUCKETS_MS):
        self.bounds = tuple(bounds)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)  # guarded-by: _lock
        self.sum = 0.0    # guarded-by: _lock
        self.count = 0    # guarded-by: _lock
        self._exemplars: list[tuple[str, float, float] | None] = [None] * (len(self.bounds) + 1)  # guarded-by: _lock

    def observe(self, value: float, trace_id: str | None = None):
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1
            if trace_id:
                self._exemplars[i] = (trace_id, value, time.time())

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

    def rows(self) -> list[tuple[str, int, tuple[str, float, float] | None]]:
        """(le, cumulative count, exemplar) per bucket, +Inf last, from ONE
        locked read, so the +Inf row is never below the buckets under it."""
        with self._lock:
            counts = list(self._counts)
            exemplars = list(self._exemplars)
            total = self.count
        rows, acc = [], 0
        for bound, n, ex in zip(self.bounds, counts, exemplars):
            acc += n
            rows.append((f"{bound:g}", acc, ex))
        rows.append(("+Inf", total, exemplars[-1]))
        return rows


class LatencyRing:
    """Lock-protected ring of recent (queue_ms, device_ms, total_ms) samples,
    feeding lifetime queue and device histograms beside it."""

    def __init__(self, maxlen: int = 4096):
        self._samples: deque[tuple[float, float, float]] = deque(maxlen=maxlen)  # guarded-by: _lock
        self._lock = threading.Lock()
        self.count = 0   # guarded-by: _lock
        self.errors = 0  # guarded-by: _lock
        self._t0 = time.monotonic()
        self.queue_hist = Histogram()
        self.device_hist = Histogram()

    def record(self, queue_ms: float, device_ms: float, total_ms: float,
               trace_id: str | None = None):
        """One request's times; its ``trace_id`` (when traced) becomes the
        exemplar of the buckets it lands in."""
        with self._lock:
            self._samples.append((queue_ms, device_ms, total_ms))
            self.count += 1
        self.queue_hist.observe(queue_ms, trace_id)
        self.device_hist.observe(device_ms, trace_id)

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
        if self.queue_hist.count:
            out["queue_hist"] = self.queue_hist.snapshot()
            out["device_hist"] = self.device_hist.snapshot()
        return out


def _prom_label(value: str) -> str:
    return str(value).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


class MetricsHub:
    """Registry of per-model rings, rendered for /metrics.  Event-loop
    confined; the rings inside carry their own locks."""

    def __init__(self):
        self.models: dict[str, LatencyRing] = {}  # guarded-by: event-loop
        # () -> {model: gen_snapshot()} of the :generate lanes, set by the
        # server; None before any lane exists.
        self.generation = None  # guarded-by: event-loop
        # Wired by the server: the ResilienceHub, the runner's FaultInjector
        # (re-pointed at every rebuild) and the Watchdog.  All optional, so a
        # hub renders without a server.
        self.resilience = None  # guarded-by: event-loop
        self.faults = None  # guarded-by: event-loop
        self.watchdog = None  # guarded-by: event-loop
        # The residency manager (serving/lifecycle.py), and through it the
        # checkpoint store.
        self.lifecycle = None  # guarded-by: event-loop
        # The multi-tenant adapter manager (serving/adapters.py).
        self.adapters = None  # guarded-by: event-loop
        # The request plane: the job queue (its journal's numbers) and the
        # tracer.
        self.jobs = None  # guarded-by: event-loop
        self.tracer = None  # guarded-by: event-loop
        # The tenancy and control planes: the variant hub
        # (serving/variants.py), the SLO hub and its usage ledger
        # (serving/slo.py) and the autoscaler (serving/autoscale.py).
        self.variants = None  # guarded-by: event-loop
        self.slo = None  # guarded-by: event-loop
        self.autoscale = None  # guarded-by: event-loop
        # The host ingest planes: the perf plane (serving/perfplane.py) and
        # () -> the fast path's snapshot (the binary lane's requests by
        # model, the acceptor workers, rings, pump and telemetry).
        self.perf = None  # guarded-by: event-loop
        self.serverpath = None  # guarded-by: event-loop

    def ring(self, model: str) -> LatencyRing:
        if model not in self.models:
            self.models[model] = LatencyRing()
        return self.models[model]

    def render(self, engine=None) -> dict:
        out = {"models": {k: r.snapshot() for k, r in self.models.items()}}
        if self.generation is not None:
            out["generation"] = self.generation()
        if self.resilience is not None:
            out["resilience"] = self.resilience.snapshot()
        if self.faults is not None:
            out["faults"] = self.faults.snapshot()
        if self.watchdog is not None:
            out["recovery"] = self.watchdog.snapshot()
        if self.lifecycle is not None:
            out["lifecycle"] = self.lifecycle.snapshot()
        if self.adapters is not None and self.adapters.enabled:
            out["adapters"] = self.adapters.snapshot()
        if self.jobs is not None and (dsnap := self.jobs.durability_snapshot()) is not None:
            out["durability"] = dsnap
        if self.tracer is not None:
            out["tracing"] = self.tracer.snapshot()
        if self.serverpath is not None:
            out["serverpath"] = self.serverpath()
        if self.variants is not None:
            out["variants"] = self.variants.snapshot()
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        if self.autoscale is not None:
            out["autoscale"] = self.autoscale.snapshot()
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
        # The port's hand-written kernels' launches in this process
        # (ops/counters.py): what a client in another process reads to see
        # its work went through them.
        from ..ops import counters

        out["kernels"] = counters.snapshot()
        return out

    def render_prometheus(self, engine=None) -> str:
        """Text exposition (version 0.0.4) of the same numbers, under the
        families of ``tools/metrics_manifest.json``.  Latency percentiles are
        summary-style quantile series of the recent ring (the JSON numbers);
        the queue and device histograms are lifetime and exact."""
        lines: list[str] = []

        def labels(lbl: dict) -> str:
            return ",".join(f'{k}="{_prom_label(v)}"' for k, v in sorted(lbl.items()))

        def metric(name, mtype, help_text, samples):
            """samples: [(labels, value)]; a family with none is skipped."""
            rows = [(lbl, v) for lbl, v in samples if v is not None]
            if not rows:
                return
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for lbl, v in rows:
                lines.append(f"{name}{{{labels(lbl)}}} {v}" if lbl else f"{name} {v}")

        def histogram(name, help_text, hists):
            """hists: [(labels, rows)], rows as ``Histogram.rows()`` plus the
            sum; a histogram with no observation is skipped.  A bucket with
            an exemplar carries it (``# {trace_id="..."} value ts``)."""
            rows = [(lbl, r, total) for lbl, r, total in hists if r and r[-1][1]]
            if not rows:
                return
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} histogram")
            for lbl, r, total in rows:
                base = labels(lbl)
                sep = "," if base else ""
                for le, acc, ex in r:
                    line = f'{name}_bucket{{{base}{sep}le="{le}"}} {acc}'
                    if ex is not None:
                        tid, val, ts = ex
                        line += f' # {{trace_id="{_prom_label(tid)}"}} {round(val, 3)} {round(ts, 3)}'
                    lines.append(line)
                lines.append(f"{name}_sum{{{base}}} {total}" if base else f"{name}_sum {total}")
                lines.append(f"{name}_count{{{base}}} {r[-1][1]}" if base
                             else f"{name}_count {r[-1][1]}")

        def live(h: Histogram):
            return h.rows(), round(h.sum, 3)

        def snap(s: dict | None):
            """A ``Histogram.snapshot()`` (the form a lane publishes) as rows."""
            if not s:
                return [], 0
            return [(le, acc, None) for le, acc in s["buckets"].items()], s["sum"]

        snaps = {m: r.snapshot() for m, r in self.models.items()}
        metric("tpuserve_requests_total", "counter", "Requests recorded per model",
               [({"model": m}, s["requests"]) for m, s in snaps.items()])
        metric("tpuserve_request_errors_total", "counter", "Failed requests per model",
               [({"model": m}, s["errors"]) for m, s in snaps.items()])
        for stage in ("queue", "device", "total"):
            samples = []
            for m, s in snaps.items():
                col = s.get(f"{stage}_ms")
                if col:
                    samples += [({"model": m, "quantile": "0.5"}, col["p50"]),
                                ({"model": m, "quantile": "0.99"}, col["p99"])]
            metric(f"tpuserve_{stage}_latency_ms", "summary",
                   f"Recent {stage} latency percentiles (ring buffer)", samples)
        histogram("tpuserve_queue_ms", "Batcher queue wait per request (ms, lifetime histogram)",
                  [({"model": m}, *live(r.queue_hist)) for m, r in self.models.items()])
        histogram("tpuserve_device_ms", "Device batch time per request (ms, lifetime histogram)",
                  [({"model": m}, *live(r.device_hist)) for m, r in self.models.items()])
        if engine is not None:
            stats = engine.runner.stats
            metric("tpuserve_batches_total", "counter", "Device batches dispatched",
                   [({"model": m}, st.batches) for m, st in stats.items()])
            metric("tpuserve_batch_samples_total", "counter",
                   "Real (non-padding) samples dispatched",
                   [({"model": m}, st.samples) for m, st in stats.items()])
            metric("tpuserve_batch_occupancy", "gauge",
                   "Real samples / padded batch rows (lifetime)",
                   [({"model": m}, round(st.samples / (st.samples + st.padded_samples), 3)
                     if st.samples + st.padded_samples else 1.0) for m, st in stats.items()])
            metric("tpuserve_device_seconds_total", "counter",
                   "Device-dispatch wall seconds per model (batches and chunks)",
                   [({"model": m}, round(st.device_seconds, 3)) for m, st in stats.items()])
            metric("tpuserve_chunk_dispatches_total", "counter",
                   "Chunked (preemptible) dispatches per model",
                   [({"model": m}, st.chunks) for m, st in stats.items() if st.chunks])
            lanes = engine.runner.lane_stats()
            metric("tpuserve_dispatch_queue_depth", "gauge", "Dispatch items queued per QoS lane",
                   [({"lane": ln}, s["depth"]) for ln, s in lanes.items()])
            metric("tpuserve_dispatch_total", "counter", "Dispatches served per QoS lane",
                   [({"lane": ln}, s["dispatches"]) for ln, s in lanes.items()])
            metric("tpuserve_dispatch_wait_ms_total", "counter",
                   "Cumulative queue wait per QoS lane (ms)",
                   [({"lane": ln}, s["wait_ms_total"]) for ln, s in lanes.items()])
            metric("tpuserve_dispatch_wait_ms_max", "gauge",
                   "Worst queue wait per QoS lane (ms, lifetime)",
                   [({"lane": ln}, s["wait_ms_max"]) for ln, s in lanes.items()])
            metric("tpuserve_cold_start_seconds", "gauge",
                   "Engine boot (weights, warm-up runs, graph captures) seconds",
                   [({}, round(engine.cold_start_seconds, 3))])
            metric("tpuserve_compile_seconds_total", "counter",
                   "Cumulative first-dispatch (build, warm-up, capture) seconds",
                   [({}, round(engine.clock.total_seconds, 3))])
            metric("tpuserve_compiled_buckets", "gauge",
                   "Buckets warmed (captured) vs configured per model",
                   [({"model": m, "state": st}, v) for m, cm in engine.models.items()
                    for st, v in (("compiled", len(cm.warmed_buckets)),
                                  ("configured", len(cm.buckets)))])
            by_clock = engine.clock.per_model()
            metric("tpuserve_compile_entries", "gauge", "First dispatches recorded per model",
                   [({"model": m}, v["entries"]) for m, v in by_clock.items()])
            metric("tpuserve_model_compile_seconds_total", "counter",
                   "Cumulative first-dispatch seconds per model",
                   [({"model": m}, v["seconds"]) for m, v in by_clock.items()])
            metric("tpuserve_hbm_bytes", "gauge",
                   "Device-resident bytes per model (weights and graph pools; <model>:kvcache a KV pool)",
                   [({"model": m}, v) for m, v in engine.runner.resident_bytes().items()])
        if self.resilience is not None:
            from .resilience import BREAKER_STATE_CODE

            rsnap = self.resilience.snapshot()
            per_model = rsnap["models"].items()
            metric("tpuserve_deadline_exceeded_total", "counter",
                   "Requests 504'd per model and stage (admission|queue|await)",
                   [({"model": m, "stage": stage}, v) for m, s in per_model
                    for stage, v in s["deadline_exceeded"].items() if stage != "total"])
            metric("tpuserve_load_shed_total", "counter",
                   "Requests 429'd by the queue-wait estimator per model",
                   [({"model": m}, s["shed"]) for m, s in per_model])
            metric("tpuserve_dispatch_retries_total", "counter",
                   "Transient dispatch retries attempted per model",
                   [({"model": m}, s["retries"]) for m, s in per_model])
            metric("tpuserve_dispatch_retry_success_total", "counter",
                   "Dispatches that succeeded after at least one retry",
                   [({"model": m}, s["retry_successes"]) for m, s in per_model])
            metric("tpuserve_breaker_fast_fails_total", "counter",
                   "Requests 503'd by an open circuit breaker per model",
                   [({"model": m}, s["breaker_fast_fails"]) for m, s in per_model])
            metric("tpuserve_breaker_state", "gauge",
                   "Circuit breaker state (0=closed, 1=half_open, 2=open)",
                   [({"model": m}, BREAKER_STATE_CODE[s["breaker"]["state"]])
                    for m, s in per_model if "breaker" in s])
            metric("tpuserve_breaker_opens_total", "counter",
                   "Circuit breaker closed->open transitions per model",
                   [({"model": m}, s["breaker"]["opens"]) for m, s in per_model
                    if "breaker" in s])
            metric("tpuserve_draining", "gauge", "1 while the server is draining",
                   [({}, int(rsnap["draining"]))])
            metric("tpuserve_quarantined", "gauge",
                   "1 while a model is quarantined for engine recovery",
                   [({"model": m}, 1) for m in rsnap["quarantined"]])
        if self.faults is not None:
            fsnap = self.faults.snapshot()
            metric("tpuserve_faults_injected_total", "counter",
                   "Chaos faults injected by target (dispatch|preprocess|prefix)",
                   [({"target": t}, v) for t, v in fsnap["injected"].items()
                    if t != "latency_ms"])
            metric("tpuserve_fault_rules_active", "gauge",
                   "Fault-injection rules currently installed", [({}, len(fsnap["rules"]))])
        if self.watchdog is not None:
            from .watchdog import RECOVERY_STATE_CODE

            wsnap = self.watchdog.snapshot()
            metric("tpuserve_recovery_state", "gauge",
                   "Watchdog state (0=healthy, 1=recovering, 2=gave_up)",
                   [({}, RECOVERY_STATE_CODE[wsnap["state"]])])
            metric("tpuserve_recoveries_total", "counter",
                   "Successful automatic/manual engine recoveries",
                   [({}, wsnap["recoveries_total"])])
            metric("tpuserve_recovery_attempts", "gauge",
                   "Consecutive failed rebuild attempts (resets on success)",
                   [({}, wsnap["attempts"])])
            metric("tpuserve_recovery_requeued_jobs_total", "counter",
                   "Outage-failed jobs requeued after an engine recovery",
                   [({}, wsnap["requeued_jobs_total"])])
        if self.lifecycle is not None:
            lc = self.lifecycle
            lsnap = lc.snapshot()
            lmodels = lsnap["models"].items()
            metric("tpuserve_residency_state", "gauge",
                   "Residency state (0=cold,1=warming,2=active,3=draining_idle,4=pinned)",
                   [({"model": m}, lc.state_code(m)) for m, _ in lmodels])
            metric("tpuserve_activations_total", "counter",
                   "Model activations by cause (boot|request|job|pin|admin|recovery)",
                   [({"model": m, "cause": c}, n) for m, s in lmodels
                    for c, n in s["activations_by_cause"].items()])
            metric("tpuserve_demotions_total", "counter",
                   "Residency demotions by cause (idle|budget|host_budget|admin)",
                   [({"model": m, "cause": c}, n) for m, s in lmodels
                    for c, n in s["demotions_by_cause"].items()])
            metric("tpuserve_cold_start_fast_fails_total", "counter",
                   "Requests 503'd cold_start (deadline below the activation estimate)",
                   [({"model": m}, s["cold_fast_fails"]) for m, s in lmodels])
            metric("tpuserve_hbm_budget_bytes", "gauge",
                   "Configured device-residency budget (0 = unlimited)",
                   [({}, lsnap["hbm_budget_bytes"])])
            histogram("tpuserve_activation_ms",
                      "Model activation wall time (ms, lifetime histogram)",
                      [({"model": m}, *live(h)) for m, h in lc.activation_hists.items()])
            cs = lsnap.get("ckpt_store")
            metric("tpuserve_residency_tier_bytes", "gauge",
                   "Weight bytes resident per tier (disk = post-dedup store bytes)",
                   [({"tier": "device"}, lsnap["hbm_bytes_total"]),
                    ({"tier": "host"}, lsnap["host_bytes_total"]),
                    ({"tier": "disk"}, cs["physical_bytes"] if cs is not None else 0)])
            if cs is not None:
                metric("tpuserve_ckpt_chunks_streamed_total", "counter",
                       "Chunks read through the streamed-load pipeline",
                       [({"model": k}, n) for k, n in cs["chunks_streamed_total"].items()])
                metric("tpuserve_ckpt_dedup_hits_total", "counter",
                       "Staged chunks already content-present in the store",
                       [({"model": k}, n) for k, n in cs["dedup_hits_total"].items()])
                histogram("tpuserve_ckpt_load_ms", "Streamed checkpoint load wall time (ms)",
                          [({"model": k}, *live(h))
                           for k, h in lc.store.load_hists_snapshot().items()])
        if self.adapters is not None and self.adapters.enabled:
            # Scale-to-zero per tenant, beside the per-model residency above.
            from .adapters import STATE_CODE

            am = self.adapters
            asnap = am.snapshot()
            rows = [(b, a, s) for b, ads in asnap["models"].items() for a, s in ads.items()]
            metric("tpuserve_adapter_residency", "gauge",
                   "Adapter residency (0=cold, 1=attaching, 2=active)",
                   [({"model": b, "adapter": a}, STATE_CODE[s["state"]]) for b, a, s in rows])
            metric("tpuserve_adapter_served_total", "counter",
                   "Requests served per (model, adapter) tenant",
                   [({"model": b, "adapter": a}, s["served"]) for b, a, s in rows])
            metric("tpuserve_adapter_cold_fast_fails_total", "counter",
                   "Requests 503'd adapter_cold (deadline below the attach estimate)",
                   [({"model": b, "adapter": a}, s["cold_fast_fails"]) for b, a, s in rows
                    if s["cold_fast_fails"]])
            metric("tpuserve_adapter_multi_batches_total", "counter",
                   "Device dispatches that co-batched >1 distinct adapter",
                   [({}, asnap["multi_adapter_batches"])])
            histogram("tpuserve_adapter_attach_ms",
                      "Adapter attach wall time (ms, lifetime histogram)",
                      [(dict(zip(("model", "adapter"), key.split(":", 1))), *live(h))
                       for key, h in list(am.attach_hists.items())])
        if self.generation is not None:
            gsnap = self.generation()
            paged = {m: s for m, s in gsnap.items() if "kv" in s}
            metric("tpuserve_kv_blocks_used", "gauge",
                   "KV-cache blocks currently allocated per model",
                   [({"model": m}, s["kv"]["blocks_used"]) for m, s in paged.items()])
            metric("tpuserve_kv_blocks_total", "gauge",
                   "Allocatable KV-cache blocks per model (pool size)",
                   [({"model": m}, s["kv"]["blocks_total"]) for m, s in paged.items()])
            metric("tpuserve_kv_block_evictions_total", "counter",
                   "Streams evicted + re-queued under KV-pool pressure",
                   [({"model": m}, s["kv"]["evictions"]) for m, s in paged.items()])
            metric("tpuserve_prefill_chunks_total", "counter",
                   "Prefill chunks dispatched per model (chunked prefill)",
                   [({"model": m}, s["prefill_chunks"]) for m, s in paged.items()])
            spec = {m: s["spec"] for m, s in paged.items() if s.get("spec")}
            metric("tpuserve_spec_proposed_total", "counter",
                   "Draft tokens proposed per model (speculative decoding)",
                   [({"model": m}, g["proposed"]) for m, g in spec.items()])
            metric("tpuserve_spec_accepted_total", "counter",
                   "Draft tokens accepted by verification per model",
                   [({"model": m}, g["accepted"]) for m, g in spec.items()])
            pref = {m: s["prefix"] for m, s in paged.items() if s.get("prefix")}
            metric("tpuserve_prefix_hits_total", "counter",
                   "Admissions that reused frozen prefix pages per model",
                   [({"model": m}, p["hits"]) for m, p in pref.items()])
            metric("tpuserve_prefix_misses_total", "counter",
                   "Admissions that prefilled cold per model",
                   [({"model": m}, p["misses"]) for m, p in pref.items()])
            metric("tpuserve_prefix_nodes_total", "counter",
                   "Radix-tree nodes ever created per model",
                   [({"model": m}, p["nodes_total"]) for m, p in pref.items()])
            metric("tpuserve_prefix_pages_total", "counter",
                   "KV pages ever frozen into the prefix tree per model",
                   [({"model": m}, p["pages_total"]) for m, p in pref.items()])
            metric("tpuserve_prefix_cow_copies_total", "counter",
                   "Copy-on-write page clones on prefix divergence",
                   [({"model": m}, p["cow_copies"]) for m, p in pref.items()])
            metric("tpuserve_prefix_evictions_total", "counter",
                   "Prefix nodes evicted (LRU decay, reclaim, invalidation)",
                   [({"model": m}, p["evictions"]) for m, p in pref.items()])
            histogram("tpuserve_prefix_cached_tokens",
                      "Prefix tokens served from frozen pages per hit",
                      [({"model": m}, *snap(p.get("cached_tokens"))) for m, p in pref.items()])
            # Live migration: migrations by cause (pressure: swapped to host;
            # failover: resumed after a replica died; admin: operator or
            # router driven), pages by dedup outcome, and the wall time.
            mig = {m: s["migration"] for m, s in paged.items() if s.get("migration")}
            metric("tpuserve_migrations_total", "counter",
                   "Live stream migrations per model by cause (pressure|failover|admin)",
                   [({"model": m, "cause": c}, n) for m, g in mig.items()
                    for c, n in g["by_cause"].items() if n])
            metric("tpuserve_migration_pages_total", "counter",
                   "KV pages moved per model by dedup outcome (hit = adopted from the local "
                   "prefix tree, copied = transferred by value)",
                   [({"model": m, "dedup": d}, n) for m, g in mig.items()
                    for d, n in g["pages"].items() if n])
            histogram("tpuserve_migration_ms", "Stream migration wall time (ms)",
                      [({"model": m}, *snap(g.get("ms"))) for m, g in mig.items()])
            lat = {m: s["latency"] for m, s in gsnap.items() if s.get("latency")}
            histogram("tpuserve_ttft_ms", "Time to first streamed token per request (ms)",
                      [({"model": m}, *snap(v.get("ttft_ms"))) for m, v in lat.items()])
            histogram("tpuserve_itl_ms", "Steady-state inter-token latency (ms)",
                      [({"model": m}, *snap(v.get("itl_ms"))) for m, v in lat.items()])
            metric("tpuserve_tokens_streamed_total", "counter",
                   "Tokens streamed to clients per model (:generate lanes)",
                   [({"model": m}, s["tokens_emitted"]) for m, s in gsnap.items()
                    if s.get("tokens_emitted") is not None])
        if self.variants is not None:
            # Selections and degradations per (family, variant), family
            # sheds, the brownout state and its transitions, and the
            # selection-time histogram.
            vh = self.variants
            fams = vh.snapshot()["families"].items()
            metric("tpuserve_variant_selections_total", "counter",
                   "Family-addressed selections per (family, variant)",
                   [({"family": f, "variant": v}, n)
                    for f, s in fams for v, n in s["selections"].items()])
            metric("tpuserve_variant_degraded_total", "counter",
                   "Selections served below the family's ladder top",
                   [({"family": f, "variant": v}, n)
                    for f, s in fams for v, n in s["degraded"].items()])
            metric("tpuserve_variant_sheds_total", "counter",
                   "Family-addressed requests shed (no variant satisfied the objective)",
                   [({"family": f}, s["sheds"]) for f, s in fams if s["sheds"]])
            metric("tpuserve_variant_brownout_state", "gauge",
                   "Brownout state per family (0=off, 1=active, 2=forced)",
                   [({"family": f}, vh.brownout.state_code(f)) for f, _ in fams])
            metric("tpuserve_variant_brownout_transitions_total", "counter",
                   "Brownout enter/exit transitions per family",
                   [({"family": f, "direction": d}, n)
                    for f, t in vh.brownout.transitions.items() for d, n in t.items() if n])
            histogram("tpuserve_variant_select_ms", "Variant selection wall time per family (ms)",
                      [({"family": f}, *live(h)) for f, h in vh.select_hists.items()])
        if self.slo is not None:
            # Outcomes, goodput, the fast and slow burn rates with their
            # alarms, then the usage ledger keyed like the HBM ledger.
            ssnap = self.slo.snapshot()
            rows = [(key, lane, s) for key, lanes in ssnap["models"].items()
                    for lane, s in lanes.items()]
            metric("tpuserve_slo_requests_total", "counter",
                   "SLO-classified requests per (model, lane, outcome: "
                   "good|degraded|late|shed|error)",
                   [({"model": k, "lane": ln, "outcome": o}, n)
                    for k, ln, s in rows for o, n in s["outcomes"].items() if n])
            metric("tpuserve_slo_goodput_ratio", "gauge",
                   "Lifetime goodput fraction (good+degraded)/total",
                   [({"model": k, "lane": ln}, s["goodput_ratio"]) for k, ln, s in rows])
            metric("tpuserve_slo_burn_rate", "gauge",
                   "Error-budget burn rate per rolling window "
                   "(bad fraction / budget; 1 = exhausts at the horizon)",
                   [({"model": k, "lane": ln, "window": w}, s["windows"][w]["burn_rate"])
                    for k, ln, s in rows for w in ("fast", "slow")])
            metric("tpuserve_slo_burn_alarm", "gauge",
                   "1 while a window's burn rate is over its alarm threshold",
                   [({"model": k, "lane": ln, "window": w}, int(s["windows"][w]["alarm"]))
                    for k, ln, s in rows for w in ("fast", "slow")])
            metric("tpuserve_slo_budget_remaining", "gauge",
                   "max(1 - burn_rate, 0) per rolling window",
                   [({"model": k, "lane": ln, "window": w}, s["windows"][w]["budget_remaining"])
                    for k, ln, s in rows for w in ("fast", "slow")])
            urows = [(dict(zip(("model", "adapter"), (key.split(":", 1) + [""])[:2])), row)
                     for key, row in ssnap["usage"].items()]
            metric("tpuserve_usage_requests_total", "counter",
                   "Requests billed to a tenant's usage ledger row",
                   [(lbl, row["requests"]) for lbl, row in urows])
            metric("tpuserve_usage_device_ms_total", "counter",
                   "Device milliseconds consumed per tenant",
                   [(lbl, row["device_ms"]) for lbl, row in urows])
            metric("tpuserve_usage_kv_block_seconds_total", "counter",
                   "KV page-seconds held per tenant (paged :generate)",
                   [(lbl, row["kv_block_seconds"]) for lbl, row in urows
                    if row["kv_block_seconds"]])
            metric("tpuserve_usage_prefix_saved_tokens_total", "counter",
                   "Prompt tokens served from frozen prefix pages per tenant "
                   "(the prefix cache's savings)",
                   [(lbl, row["prefix_saved_tokens"]) for lbl, row in urows
                    if row["prefix_saved_tokens"]])
            metric("tpuserve_usage_adapter_attach_ms_total", "counter",
                   "Adapter attach wall milliseconds billed per tenant",
                   [(lbl, row["attach_ms"]) for lbl, row in urows if row["attach_ms"]])
        if self.autoscale is not None:
            # The demand forecast, the learned keep-warm window each key
            # earns, and the pre-warms by cause (predicted or phantom).  The
            # scale-events family belongs to a fleet router.
            arows = list(self.autoscale.snapshot()["models"].items())
            metric("tpuserve_autoscale_forecast_rps", "gauge",
                   "Short-horizon offered-rate forecast per demand key",
                   [({"model": k}, m["forecast_rps"]) for k, m in arows])
            metric("tpuserve_autoscale_keepwarm_window_s", "gauge",
                   "Learned keep-warm window per demand key (absent while history is thin "
                   "or the plane is degraded)",
                   [({"model": k}, m["keepwarm_window_s"]) for k, m in arows])
            metric("tpuserve_autoscale_prewarm_total", "counter",
                   "Pre-warm actions fired per (key, cause: predicted|phantom)",
                   [({"model": k, "cause": c}, n) for k, m in arows
                    for c, n in m["prewarms_by_cause"].items() if n])
        if self.perf is not None:
            # Event-loop lag, the stack sampler's census, the per-(model,
            # stage) ingest histograms and the rolling gauges.
            lag = self.perf.loop_lag
            histogram("tpuserve_loop_lag_ms", "Event-loop callback lag: scheduled vs actual (ms)",
                      [({}, *live(lag.hist))])
            metric("tpuserve_loop_lag_max_ms", "gauge",
                   "Worst event-loop lag observed this process (ms)",
                   [({}, round(lag.max_ms, 3) if lag.ticks else None)])
            samples = self.perf.stacks.snapshot(top=1)["samples"]
            metric("tpuserve_stack_samples_total", "counter",
                   "Thread-stack sampler wakeups this process lifetime",
                   [({}, samples or None)])
            histogram("tpuserve_ingest_ms",
                      "Host-side ingest/egress stage wall time per (model, stage): the "
                      "http-to-device gap decomposition",
                      [({"model": m, "stage": st}, *live(h))
                       for (m, st), h in list(self.perf.ingest.items())])
            prow = self.perf.model_gauges().items()
            for fam, key, text in (
                    ("samples_per_s", "samples_per_s",
                     "Rolling-window samples/s per model (perf plane)"),
                    ("tokens_per_s", "tokens_per_s",
                     "Rolling-window streamed tokens/s per generation lane"),
                    ("step_ms", "step_ms", "Rolling-window mean device step time per model (ms)"),
                    ("device_util_pct", "device_util_pct",
                     "Rolling-window dispatch-lane occupancy per model (%)"),
                    ("mfu_pct", "mfu_pct",
                     "Rolling-window MFU per model (needs a flops_per_sample hint; absent "
                     "otherwise)")):
                metric(f"tpuserve_perf_{fam}", "gauge", text,
                       [({"model": m}, r.get(key)) for m, r in prow])
        if self.serverpath is not None:
            # The acceptor workers, their rings (labelled by ring, so a stuck
            # consumer shows as one ring at capacity), the per-worker stats
            # blocks and the pump's ring-wait and occupancy histograms.
            sp = self.serverpath()
            metric("tpuserve_binary_lane_requests_total", "counter",
                   "Requests decoded on the zero-copy binary tensor lane, per model",
                   [({"model": m}, n) for m, n in sorted(sp["binary_requests"].items())])
            metric("tpuserve_ingest_workers", "gauge",
                   "Live SO_REUSEPORT acceptor worker processes (0 = single-process mode)",
                   [({}, sp["ingest_workers"])])
            metric("tpuserve_shm_ring_depth", "gauge",
                   "Occupied slots per shared-memory ring between acceptors and the "
                   "device-dispatch process",
                   [({"ring": r}, d) for r, d in sorted(sp["ring_depth"].items())])
            acc = sp.get("acceptor") or {}
            rows = acc.get("workers") or []
            metric("tpuserve_acceptor_accepts_total", "counter",
                   "HTTP requests accepted per acceptor worker process",
                   [({"worker": str(r["worker"])}, r.get("accepts")) for r in rows])
            metric("tpuserve_acceptor_sheds_total", "counter",
                   "Worker-local sheds per acceptor worker, by HTTP code",
                   [({"worker": str(r["worker"]), "code": code}, r.get(f"shed_{code}"))
                    for r in rows for code in ("400", "413", "415", "429", "504")
                    if r.get(f"shed_{code}")])
            metric("tpuserve_acceptor_responses_total", "counter",
                   "Responses sent per acceptor worker, by outcome",
                   [({"worker": str(r["worker"]), "outcome": oc}, r.get(f"responses_{oc}"))
                    for r in rows for oc in ("ok", "err")])
            metric("tpuserve_acceptor_bytes_total", "counter",
                   "Bytes through each acceptor worker, by direction",
                   [({"worker": str(r["worker"]), "direction": d}, r.get(f"bytes_{d}"))
                    for r in rows for d in ("in", "out")])
            metric("tpuserve_acceptor_worker_up", "gauge",
                   "Acceptor worker liveness (0 = died, awaiting respawn)",
                   [({"worker": str(r["worker"])}, 1 if r.get("up") else 0) for r in rows])
            metric("tpuserve_acceptor_heartbeat_age_s", "gauge",
                   "Seconds since each acceptor worker's liveness heartbeat",
                   [({"worker": str(r["worker"])}, r.get("heartbeat_age_s")) for r in rows])
            if rows:
                metric("tpuserve_acceptor_restarts_total", "counter",
                       "Acceptor worker deaths detected (each is respawned)",
                       [({}, acc.get("restarts", 0))])
            histogram("tpuserve_acceptor_inworker_ms",
                      "In-worker time accept to ring push per acceptor worker (ms)",
                      [({"worker": str(r["worker"])}, *snap(r.get("inworker_ms")))
                       for r in rows])
            histogram("tpuserve_acceptor_ring_wait_ms",
                      "Ring wait worker-push to pump-pop across all workers (ms)",
                      [({}, *snap(acc.get("ring_wait_ms")))])
            histogram("tpuserve_shm_ring_occupancy_pct",
                      "Ring occupancy (% of slots) sampled per busy pump cycle",
                      [({"ring": name}, *snap(h))
                       for name, h in sorted((acc.get("ring_occupancy_pct") or {}).items())])
        dsnap = self.jobs.durability_snapshot() if self.jobs is not None else None
        if dsnap is not None:
            metric("tpuserve_journal_records_appended_total", "counter",
                   "Job-journal records appended this process lifetime",
                   [({}, dsnap["journal"]["appended"])])
            metric("tpuserve_journal_dropped_records", "gauge",
                   "Corrupt/truncated journal records skipped at replay",
                   [({}, dsnap["dropped_records"])])
            metric("tpuserve_recovered_jobs", "gauge",
                   "Unfinished jobs re-enqueued by the boot-time replay",
                   [({}, dsnap["recovered_jobs"])])
            metric("tpuserve_restored_done_jobs", "gauge",
                   "Terminal jobs (results included) restored at replay",
                   [({}, dsnap["restored_done"])])
            metric("tpuserve_journal_replay_ms", "gauge",
                   "Wall milliseconds the boot-time journal replay took",
                   [({}, dsnap["replay_ms"])])
            metric("tpuserve_idempotent_dedupes_total", "counter",
                   "Submits answered with a prior job via Idempotency-Key",
                   [({}, dsnap["deduped_submits"])])
        if self.tracer is not None:
            tsnap = self.tracer.snapshot()
            metric("tpuserve_traces_finished_total", "counter",
                   "Request traces finished this process lifetime",
                   [({}, tsnap["finished"])])
            metric("tpuserve_trace_spans_dropped_total", "counter",
                   "Spans dropped by per-trace span budgets",
                   [({}, tsnap["dropped_spans"])])
            metric("tpuserve_traces_pinned", "gauge",
                   "Flight-recorder pins (slowest / recent errored traces)",
                   [({"kind": "slow"}, tsnap["pinned_slow"]),
                    ({"kind": "errored"}, tsnap["pinned_errored"])])
        return "\n".join(lines) + "\n"
