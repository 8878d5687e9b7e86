"""Declarative configuration for the PyTorch/CUDA port.

The port's own copy of the JAX package's ``ModelConfig`` and ``ServeConfig``,
cut to the fields this slice of the port reads; names and defaults are the
same, so a profile written for the JAX package loads here as long as it uses
only these fields.  A file is JSON, or YAML (``yaml`` is imported only when a
YAML file is loaded), optionally with named profiles.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class ModelConfig:
    """Per-model serving configuration."""

    name: str
    # Checkpoint to import at cold start (torch .pt/.pth or .safetensors).
    # None → random-init from a seed with the real architecture.
    checkpoint: str | None = None
    # Batch-size buckets; requests pad up to the smallest bucket that fits.
    batch_buckets: tuple[int, ...] = (1, 4, 8, 16, 32)
    # Sequence-length buckets (token models only).
    seq_buckets: tuple[int, ...] = (128,)
    # Compute dtype on the device; params stay f32 unless extra.params_dtype.
    dtype: str = "bfloat16"
    # Registered builder this deploy name instantiates ("" → the name itself).
    builder: str = ""
    # Max requests in flight before 429 (backpressure).
    max_concurrency: int = 256
    # Batcher coalescing window in milliseconds.
    coalesce_ms: float = 2.0
    # QoS class of the dispatch lane ("latency" | "throughput"); "" defers to
    # the class the model family registered.
    latency_class: str = ""
    # Free-form per-model extras (arch overrides, params_dtype, labels, ...).
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class ServeConfig:
    """Per-deploy profile."""

    profile: str = "dev"
    host: str = "127.0.0.1"
    port: int = 8000
    # Run every (model × bucket) forward once at boot, so the first request
    # pays no first-dispatch cost (kernel build included).
    warmup_at_boot: bool = True
    # Two-level priority dispatch: latency-class work jumps queued
    # throughput work between device calls.  False = one FIFO.
    priority_dispatch: bool = True
    # Async job lane (:submit): per-model backlog bound (429 past it), done
    # jobs kept, retained-result heap budget, and the result TTL.
    job_max_backlog: int = 64
    job_keep_done: int = 256
    job_result_ttl_s: float = 900.0
    job_max_result_mb: float = 64.0
    models: list[ModelConfig] = field(default_factory=list)

    def model(self, name: str) -> ModelConfig:
        for m in self.models:
            if m.name == name:
                return m
        raise KeyError(f"model {name!r} not in profile {self.profile!r}")


def load_config(path: str | Path | None = None,
                profile: str | None = None) -> ServeConfig:
    """Load a ServeConfig from a JSON or YAML file (defaults without one).

    The file may hold several named profiles::

        profiles:
          dev:  {port: 8000, models: [{name: bert_base}]}
          prod: {port: 80, models: [...]}
    """
    if path is None:
        return ServeConfig()
    raw = Path(path).expanduser().read_text()
    if str(path).endswith(".json"):
        data = json.loads(raw)
    else:
        import yaml

        data = yaml.safe_load(raw)
    if not data:
        return ServeConfig()
    if "profiles" in data:
        profile = profile or data.get("default_profile",
                                      next(iter(data["profiles"])))
        data = dict(data["profiles"][profile], profile=profile)
    models = [ModelConfig(**{**m,
                             "batch_buckets": tuple(m.get("batch_buckets",
                                                          (1, 4, 8, 16, 32))),
                             "seq_buckets": tuple(m.get("seq_buckets", (128,)))})
              for m in data.pop("models", [])]
    return ServeConfig(models=models, **data)
