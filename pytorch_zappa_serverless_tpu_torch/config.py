"""Declarative configuration for the PyTorch/CUDA port.

The port's own copy of the JAX package's ``ModelConfig`` and ``ServeConfig``,
cut to the fields this slice of the port reads; names and defaults are the
same, so a profile written for the JAX package loads here as long as it uses
only these fields.  A file is JSON, or YAML (``yaml`` is imported only when a
YAML file is loaded), optionally with named profiles.  ``TPUSERVE_<FIELD>``
environment variables override the top-level fields after the file is read
(:func:`apply_env_overrides`), and with no file the dev profile
(:func:`default_config`) serves every model the port has.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


_ENV_PREFIX = "TPUSERVE_"


def _coerce(value: str, target_type: Any) -> Any:
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    return value


def apply_env_overrides(cfg: ServeConfig, environ: dict[str, str] | None = None) -> ServeConfig:
    """Override top-level ServeConfig fields from ``TPUSERVE_*`` env vars
    (``TPUSERVE_PORT=9123``), in place, and return ``cfg``.

    Each value is coerced by the type of the field's default, so a float
    field loaded from a file as an int still takes "7.5".  ``models`` is
    file-only: structured per-model config does not go in an env var.
    """
    environ = os.environ if environ is None else environ
    for f in dataclasses.fields(ServeConfig):
        key = _ENV_PREFIX + f.name.upper()
        if key not in environ or f.name == "models":
            continue
        target = (type(f.default) if f.default is not dataclasses.MISSING
                  else type(getattr(cfg, f.name)))
        setattr(cfg, f.name, _coerce(environ[key], target))
    return cfg


def load_config(path: str | Path | None = None,
                profile: str | None = None) -> ServeConfig:
    """Load a ServeConfig from a JSON or YAML file, or the dev profile
    without one; ``TPUSERVE_*`` env vars override either.

    The file may hold several named profiles::

        profiles:
          dev:  {port: 8000, models: [{name: bert_base}]}
          prod: {port: 80, models: [...]}
    """
    if path is None:
        return apply_env_overrides(default_config())
    raw = Path(path).expanduser().read_text()
    if str(path).endswith(".json"):
        data = json.loads(raw)
    else:
        import yaml

        data = yaml.safe_load(raw)
    if not data:
        return apply_env_overrides(default_config())
    if "profiles" in data:
        profile = profile or data.get("default_profile",
                                      next(iter(data["profiles"])))
        data = dict(data["profiles"][profile], profile=profile)
    models = [ModelConfig(**{**m,
                             "batch_buckets": tuple(m.get("batch_buckets",
                                                          (1, 4, 8, 16, 32))),
                             "seq_buckets": tuple(m.get("seq_buckets", (128,)))})
              for m in data.pop("models", [])]
    return apply_env_overrides(ServeConfig(models=models, **data))


def default_config() -> ServeConfig:
    """The dev profile: the JAX package's dev zoo, random-init, cut to the
    models the port registers (today bert_base, gpt2 and the tiny sd15)."""
    from . import models as _zoo  # noqa: F401  (populates the registry)
    from .utils.registry import list_models

    registered = set(list_models())
    cfg = ServeConfig(
        profile="dev",
        # Each bucket's first request pays its first dispatch (kernel builds
        # included); production profiles set warmup_at_boot: true.
        warmup_at_boot=False,
        models=[
            ModelConfig(name="resnet18", batch_buckets=(1, 4, 8)),
            ModelConfig(name="resnet50", batch_buckets=(1, 4, 8, 32)),
            ModelConfig(name="efficientnet_b0", batch_buckets=(1, 4, 8)),
            ModelConfig(name="vit_b16", batch_buckets=(1, 4, 8)),
            ModelConfig(name="bert_base", batch_buckets=(1, 4, 8), seq_buckets=(128,)),
            ModelConfig(name="whisper_tiny", batch_buckets=(1, 4),
                        extra={"max_new_tokens": 64}),
            ModelConfig(name="gpt2", batch_buckets=(1, 4), seq_buckets=(64, 128),
                        extra={"max_new_tokens": 32, "params_dtype": "bfloat16"}),
            # The tiny variant at 64x64: a smoke of the async job lane.
            ModelConfig(name="sd15", batch_buckets=(1,),
                        extra={"variant": "tiny", "num_steps": 4,
                               "height": 64, "width": 64}),
        ],
    )
    cfg.models = [m for m in cfg.models if (m.builder or m.name) in registered]
    return cfg
