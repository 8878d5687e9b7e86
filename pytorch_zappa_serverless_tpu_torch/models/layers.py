"""Shared inference-mode layers of the vision zoo (ResNet, EfficientNet).

Each layer holds its weights as the JAX package's flax layer holds them,
f32 at rest and cast to the compute dtype at every use, under the flax
names, so ``engine.weights.params_from_jax`` maps a JAX param tree onto
them (conv ``kernel`` HWIO → ``weight`` OIHW, BN ``scale`` → ``weight``).
Activations are NCHW tensors in ``channels_last`` memory (an NHWC buffer
seen through ``permute(0, 3, 1, 2)``), the layout in which cuDNN runs bf16
convolutions on the tensor cores.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bert import Dense


def _frozen(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"`` on one axis: (before, after), the odd pixel
    after, which makes it asymmetric at stride 2."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv``: ``weight [out, in/groups, kh, kw]`` (f32 at rest),
    input and weight cast to ``dtype``, the bias (if any) added after the
    product in ``dtype``.  ``padding`` is the symmetric pad of every side, or
    ``"same"`` for XLA's SAME rule (explicit ``F.pad``: ``nn.Conv2d``'s own
    "same" refuses stride 2, and is symmetric)."""

    def __init__(self, in_features: int, out_features: int, kernel: int, stride: int = 1,
                 padding: int | str = 0, groups: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = _frozen(out_features, in_features // groups, kernel, kernel)
        self.bias = _frozen(out_features) if bias else None
        self.kernel, self.stride, self.padding, self.groups = kernel, stride, padding, groups
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        pad = self.padding
        if pad == "same":
            (top, bottom), (left, right) = (same_pads(n, self.kernel, self.stride)
                                            for n in x.shape[2:])
            if top != bottom or left != right:
                x = F.pad(x, (left, right, top, bottom))
                pad = 0
            else:
                pad = top if top == left else (top, left)
        y = F.conv2d(x, self.weight.to(self.dtype), None, self.stride, pad, 1, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class FrozenBatchNorm(nn.Module):
    """Inference batch norm, as the JAX package's ``FrozenBatchNorm``: fold
    ``rsqrt(var + eps) * scale`` and the shift in f32, cast both to
    ``dtype``, then ``x * w + b`` in ``dtype`` (two roundings in bf16).  The
    conv weights are left as they are."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight, self.bias, self.mean, self.var = (_frozen(dim) for _ in range(4))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        inv = torch.rsqrt(self.var + self.eps) * self.weight
        w = inv.to(self.dtype)
        b = (self.bias - self.mean * inv).to(self.dtype)
        return x * w[:, None, None] + b[:, None, None]


def init_params(model: nn.Module, seed: int = 0) -> dict:
    """A seed-initialised float param tree in the JAX package's layout for
    a vision model built of :class:`Conv`, :class:`FrozenBatchNorm` and
    ``Dense``, walked in module order from one ``torch.Generator``.

    Convs N(0, 2/fan_out) with fan-out ``out/groups·kh·kw`` (He, fan-out:
    torchvision's ResNet and the TF EfficientNet initializer), dense
    kernels U(±1/sqrt(in)), zero biases; BN unit scale, zero shift and
    non-trivial running statistics (mean N(0, 0.1²), var U(0.75, 1.25)), so
    that a seeded model exercises the fold.  It does not reproduce the JAX
    package's ``jax.random.key(0)`` init; parity tests carry the JAX tree
    across with ``params_from_jax``.
    """
    g = torch.Generator().manual_seed(seed)
    tree: dict = {}
    for name, m in model.named_modules():
        if not isinstance(m, (Conv, FrozenBatchNorm, Dense)):
            continue
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        if isinstance(m, Conv):
            o, i, kh, kw = m.weight.shape
            fan_out = o // m.groups * kh * kw  # a depthwise conv's: kh·kw
            w = torch.randn(o, i, kh, kw, generator=g) * math.sqrt(2.0 / fan_out)
            node["kernel"] = w.permute(2, 3, 1, 0).contiguous().numpy()
            if m.bias is not None:
                node["bias"] = np.zeros(o, np.float32)
        elif isinstance(m, FrozenBatchNorm):
            d = m.weight.shape[0]
            node["scale"] = np.ones(d, np.float32)
            node["bias"] = np.zeros(d, np.float32)
            node["mean"] = (torch.randn(d, generator=g) * 0.1).numpy()
            node["var"] = (torch.rand(d, generator=g) * 0.5 + 0.75).numpy()
        else:
            o, i = m.weight.shape
            bound = 1.0 / math.sqrt(i)
            node["kernel"] = ((torch.rand(i, o, generator=g) * 2 - 1) * bound).numpy()
            node["bias"] = np.zeros(o, np.float32)
    return tree
