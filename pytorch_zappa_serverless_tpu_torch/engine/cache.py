"""Capture timing per bucket: the port's cold-start metric.

What the JAX package compiles per bucket, the port captures as a CUDA graph
(``engine.compiled.BucketGraph``), and nothing of it outlives the process.
A cold bucket pays its eager warm-up run (the CUDA context and library
setup, the build of the hand-written kernels at first use, the allocator's
first allocations) and its capture; on the CPU, its first eager dispatch.
``CompileClock`` records those seconds per (model, bucket or graph) for
/metrics and /v1/models, under the JAX package's names.
"""

from __future__ import annotations

import time


class CompileClock:
    """Accumulates per-bucket first-dispatch timings for observability."""

    def __init__(self):
        self.entries: list[dict] = []

    def record(self, model: str, bucket, seconds: float):
        self.entries.append({"model": model, "bucket": list(bucket),
                             "seconds": round(seconds, 3)})

    @property
    def total_seconds(self) -> float:
        return sum(e["seconds"] for e in self.entries)

    def per_model(self) -> dict[str, dict]:
        """{model: {entries, seconds}}: the /metrics breakdown."""
        out: dict[str, dict] = {}
        for e in self.entries:
            m = out.setdefault(e["model"], {"entries": 0, "seconds": 0.0})
            m["entries"] += 1
            m["seconds"] = round(m["seconds"] + e["seconds"], 3)
        return out


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0
