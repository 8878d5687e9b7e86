"""The Servable contract between models and the serving engine.

Every model exports a :class:`Servable`: an ``nn.Module`` and an ``apply_fn``
over (module, inputs) with host-side pre/post hooks.  The engine owns the
rest (bucketing, padding, placement, dispatch), so models hold no serving
logic and serving holds no model logic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import torch
from torch import nn


@dataclass
class Servable:
    """One deployable model.

    ``apply_fn(module, inputs: dict[str, Tensor]) -> dict[str, Tensor]`` runs
    one padded bucket batch; shapes are static per bucket, and it reads no
    tensor on the host, so that the engine can capture it as a CUDA graph.
    A servable whose batches take different programs (GPT-2's sampling
    gates) sets ``meta["variant_of"](collated numpy batch) -> hashable``
    and ``meta["default_variant"]`` (what warm-up captures); its
    ``apply_fn`` then takes ``variant=`` and the engine keeps one graph per
    bucket and variant.
    """

    name: str
    apply_fn: Callable[[nn.Module, Mapping[str, torch.Tensor]], dict[str, torch.Tensor]]
    module: nn.Module
    # bucket key (e.g. (batch,) or (batch, seq)) -> {input: (shape, torch dtype)}.
    input_spec: Callable[[tuple[int, ...]], dict[str, tuple[tuple[int, ...], torch.dtype]]]
    # Host side: one raw request payload -> dict of per-sample numpy arrays
    # (no batch dim); the engine stacks + pads them into a bucket batch.
    preprocess: Callable[[Any], dict[str, Any]]
    # Host side: (stacked outputs as numpy, sample index) -> JSON-able result.
    postprocess: Callable[[Any, int], Any]
    # Which bucket axes exist: ("batch",) or ("batch", "seq").
    bucket_axes: tuple[str, ...] = ("batch",)
    meta: dict[str, Any] = field(default_factory=dict)
