"""ResNet-18 / ResNet-50 image classification (BASELINE configs #1 and #2).

The JAX package's ``models/resnet.py`` in PyTorch, layer for layer and
name for name (``conv1``, ``bn1``, ``layer{stage}_{block}`` with
``conv{k}``, ``bn{k}``, ``downsample_conv``, ``downsample_bn``, ``fc``):
conv 7x7/2 → BN → ReLU → max-pool 3x3/2 (pad 1) → four stages → global
mean → ``fc`` in f32.  ResNet-18 is BasicBlock x (2, 2, 2, 2); ResNet-50
Bottleneck x (3, 4, 6, 3) with the stride on the 3x3 (torchvision's v1.5).
Convolutions pad symmetrically by ``(k - 1) // 2`` and run in the compute
dtype (bf16 by default) on ``channels_last`` activations; params are f32
at rest.  The input is the JAX package's NHWC float image, seen as NCHW
through ``permute`` with no copy.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .bert import Dense
from .layers import Conv, FrozenBatchNorm


def _conv(in_features: int, features: int, kernel: int, stride: int = 1, *, dtype) -> Conv:
    return Conv(in_features, features, kernel, stride, (kernel - 1) // 2, dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = _conv(in_features, filters, 3, stride, dtype=dtype)
        self.bn1 = FrozenBatchNorm(filters, dtype=dtype)
        self.conv2 = _conv(filters, filters, 3, dtype=dtype)
        self.bn2 = FrozenBatchNorm(filters, dtype=dtype)
        self.project = stride != 1 or in_features != filters
        if self.project:
            self.downsample_conv = _conv(in_features, filters, 1, stride, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(filters, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4  # output is 4x the bottleneck width

    def __init__(self, in_features: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = _conv(in_features, filters, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(filters, dtype=dtype)
        self.conv2 = _conv(filters, filters, 3, stride, dtype=dtype)
        self.bn2 = FrozenBatchNorm(filters, dtype=dtype)
        self.conv3 = _conv(filters, out, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out, dtype=dtype)
        self.project = stride != 1 or in_features != out
        if self.project:
            self.downsample_conv = _conv(in_features, out, 1, stride, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(y + identity)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block: type, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype=dtype)
        self.blocks: list[str] = []
        in_features = 64
        for i, n_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** i
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block(in_features, filters, stride, dtype))
                self.blocks.append(name)
                in_features = filters * block.expansion
        self.fc = Dense(in_features, num_classes, torch.float32, gather_output=True)

    def forward(self, x):
        """x: NHWC float (normalized) → f32 logits [N, classes]."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NCHW in channels_last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        # jnp.mean over H, W: summed in f32, rounded once to the compute dtype.
        return self.fc(x.mean(dim=(2, 3)).float())


def ResNet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, **kw)


from ..engine.weights import convert_resnet  # noqa: E402
from ..utils.registry import register_model, register_tree  # noqa: E402
from .bert import resolve_dtype  # noqa: E402
from .vision_common import classifier_tree_fn, make_image_classifier  # noqa: E402


def _module(builder, cfg) -> ResNet:
    return builder(dtype=resolve_dtype(cfg.dtype))


def _build(name: str, builder, cfg):
    return make_image_classifier(name, _module(builder, cfg), cfg, convert_resnet)


for _name, _builder in (("resnet18", ResNet18), ("resnet50", ResNet50)):
    register_tree(_name)(classifier_tree_fn(_name, partial(_module, _builder), convert_resnet))


@register_model("resnet18", latency_class="latency")
def build_resnet18(cfg):
    return _build("resnet18", ResNet18, cfg)


@register_model("resnet50", latency_class="latency")
def build_resnet50(cfg):
    return _build("resnet50", ResNet50, cfg)
