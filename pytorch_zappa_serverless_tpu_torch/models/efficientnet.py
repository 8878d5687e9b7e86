"""EfficientNet (B0 by default) image classification (BASELINE config #2).

The JAX package's ``models/efficientnet.py`` in PyTorch, name for name
(``stem_conv``, ``stem_bn``, ``block{i}`` with ``expand_conv``,
``expand_bn``, ``dw_conv``, ``dw_bn``, ``se_reduce``, ``se_expand``,
``project_conv``, ``project_bn``; ``top_conv``, ``top_bn``,
``classifier``): the canonical TF/Keras EfficientNet (MBConv: expand 1x1 →
depthwise kxk → squeeze-excite → project 1x1, residual on stride-1
repeats), BN with ``eps = 1e-3``, SiLU, and the SE width taken from the
block's input dim.

The stem and the depthwise convs use XLA's ``padding="SAME"``, which at
stride 2 puts the odd pixel after (bottom and right): ``layers.Conv`` pads
explicitly by ``layers.same_pads``.  Depthwise convs are grouped convs with
``groups = C`` (weights ``[C, 1, k, k]``).
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from .bert import Dense
from .layers import Conv, FrozenBatchNorm

# Stage definitions (B0 base): in_ch, out_ch, stride, kernel, expand, repeats
_IN_CH = (32, 16, 24, 40, 80, 112, 192)
_OUT_CH = (16, 24, 40, 80, 112, 192, 320)
_STRIDES = (1, 2, 2, 2, 1, 2, 1)
_KERNELS = (3, 3, 5, 3, 5, 5, 3)
_EXPANDS = (1, 6, 6, 6, 6, 6, 6)
_REPEATS = (1, 2, 2, 3, 3, 4, 1)
_EPS = 1e-3


def round_filters(channels: int, width_coefficient: float, divisor: int = 8) -> int:
    """TF width scaling: scale then round to the nearest multiple of divisor."""
    channels *= width_coefficient
    new_c = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * channels:
        new_c += divisor
    return int(new_c)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


class MBConvBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, stride: int, kernel: int,
                 expand_ratio: int, se_ratio: float, residual: bool, dtype: torch.dtype):
        super().__init__()
        expand_dim = in_dim * expand_ratio
        self.expand = expand_ratio != 1
        if self.expand:
            self.expand_conv = Conv(in_dim, expand_dim, 1, dtype=dtype)
            self.expand_bn = FrozenBatchNorm(expand_dim, _EPS, dtype)
        self.dw_conv = Conv(expand_dim, expand_dim, kernel, stride, "same",
                            groups=expand_dim, dtype=dtype)
        self.dw_bn = FrozenBatchNorm(expand_dim, _EPS, dtype)
        se_dim = max(1, int(in_dim * se_ratio))  # from the block INPUT dim (TF rule)
        self.se_reduce = Conv(expand_dim, se_dim, 1, bias=True, dtype=dtype)
        self.se_expand = Conv(se_dim, expand_dim, 1, bias=True, dtype=dtype)
        self.project_conv = Conv(expand_dim, out_dim, 1, dtype=dtype)
        self.project_bn = FrozenBatchNorm(out_dim, _EPS, dtype)
        self.residual = residual

    def forward(self, inputs):
        x = inputs
        if self.expand:
            x = F.silu(self.expand_bn(self.expand_conv(x)))
        x = F.silu(self.dw_bn(self.dw_conv(x)))
        s = F.silu(self.se_reduce(x.mean(dim=(2, 3), keepdim=True)))
        x = x * torch.sigmoid(self.se_expand(s))
        x = self.project_bn(self.project_conv(x))
        return x + inputs if self.residual else x


class EfficientNet(nn.Module):
    def __init__(self, width_coefficient: float = 1.0, depth_coefficient: float = 1.0,
                 hidden_dim: int = 1280, num_classes: int = 1000, se_ratio: float = 0.25,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        rf = partial(round_filters, width_coefficient=width_coefficient)
        self.stem_conv = Conv(3, rf(32), 3, 2, "same", dtype=dtype)
        self.stem_bn = FrozenBatchNorm(rf(32), _EPS, dtype)
        self.blocks: list[str] = []
        for i in range(len(_IN_CH)):
            in_dim, out_dim = rf(_IN_CH[i]), rf(_OUT_CH[i])
            for j in range(round_repeats(_REPEATS[i], depth_coefficient)):
                stride = _STRIDES[i] if j == 0 else 1
                name = f"block{len(self.blocks)}"
                self.add_module(name, MBConvBlock(
                    in_dim if j == 0 else out_dim, out_dim, stride, _KERNELS[i],
                    _EXPANDS[i], se_ratio, stride == 1 and j > 0, dtype))
                self.blocks.append(name)
        self.top_conv = Conv(rf(_OUT_CH[-1]), hidden_dim, 1, dtype=dtype)
        self.top_bn = FrozenBatchNorm(hidden_dim, _EPS, dtype)
        self.classifier = Dense(hidden_dim, num_classes, torch.float32)

    def forward(self, x):
        """x: NHWC float (normalized) → f32 logits [N, classes]."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NCHW in channels_last memory
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = F.silu(self.top_bn(self.top_conv(x)))
        return self.classifier(x.mean(dim=(2, 3)).float())


EfficientNetB0 = partial(EfficientNet, width_coefficient=1.0, depth_coefficient=1.0)


from ..engine.weights import convert_efficientnet  # noqa: E402
from ..utils.registry import register_model, register_tree  # noqa: E402
from .bert import resolve_dtype  # noqa: E402
from .vision_common import classifier_tree_fn, make_image_classifier  # noqa: E402


def _module(cfg) -> EfficientNet:
    return EfficientNetB0(dtype=resolve_dtype(cfg.dtype))


register_tree("efficientnet_b0")(
    classifier_tree_fn("efficientnet_b0", _module, convert_efficientnet))


@register_model("efficientnet_b0", latency_class="latency")
def build_efficientnet_b0(cfg):
    return make_image_classifier("efficientnet_b0", _module(cfg), cfg, convert_efficientnet)
