"""ViT-B/16 image classification in PyTorch, served on ``:predict``.

The JAX package's ``models/vit.py``: a 16x16 stride-16 patch convolution,
a [CLS] token and learned positions, pre-LN encoder layers (BERT's
self-attention, exact-erf GELU FFN), LayerNorm on [CLS] and an f32
classifier.  Weights f32 at rest and cast at every use; LayerNorm and
softmax in f32; attention as two batched products (197 tokens: the scores
are small).  Submodule names are the flax names (``patch_embed``,
``layer{i}.ln_before``, ``attention.query``, ``attention_output``,
``ln_after``, ``intermediate``, ``output``, ``final_ln``, ``classifier``),
so ``engine.weights.params_from_jax`` maps a JAX tree onto it.  It runs no
kernel of the port: cuDNN takes the patch convolution, cuBLAS the products.
Normalization is ViT's mean and std 0.5, on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bert import BertSelfAttention, Dense, resolve_dtype
from .layers import Conv


class ViTLayer(nn.Module):
    """Pre-LN encoder block (HF ViT's ``layernorm_before``/``_after``)."""

    def __init__(self, num_heads: int, head_dim: int, mlp_dim: int, dtype: torch.dtype,
                 ln_eps: float = 1e-12):
        super().__init__()
        d = num_heads * head_dim
        self.ln_before = nn.LayerNorm(d, eps=ln_eps)
        self.attention = BertSelfAttention(num_heads, head_dim, dtype)
        self.attention_output = Dense(d, d, dtype)
        self.ln_after = nn.LayerNorm(d, eps=ln_eps)
        self.intermediate = Dense(d, mlp_dim, dtype)
        self.output = Dense(mlp_dim, d, dtype)
        self.dtype = dtype

    def forward(self, x):
        h = self.ln_before(x.float()).to(self.dtype)
        x = x + self.attention_output(self.attention(h, 0.0))
        h = self.ln_after(x.float()).to(self.dtype)
        return x + self.output(F.gelu(self.intermediate(h)))


class ViTClassifier(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 16, num_layers: int = 12,
                 num_heads: int = 12, head_dim: int = 64, mlp_dim: int = 3072,
                 num_labels: int = 1000, dtype: torch.dtype = torch.bfloat16,
                 ln_eps: float = 1e-12):
        super().__init__()
        d = num_heads * head_dim
        tokens = (image_size // patch_size) ** 2 + 1
        self.shapes = {"d": d, "patch": patch_size, "tokens": tokens, "mlp_dim": mlp_dim,
                       "num_labels": num_labels}
        self.dtype = dtype
        self.patch_embed = Conv(3, d, patch_size, stride=patch_size, bias=True, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d), requires_grad=False)
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, d), requires_grad=False)
        self.layers = [f"layer{i}" for i in range(num_layers)]
        for name in self.layers:
            self.add_module(name, ViTLayer(num_heads, head_dim, mlp_dim, dtype, ln_eps))
        self.final_ln = nn.LayerNorm(d, eps=ln_eps)
        self.classifier = Dense(d, num_labels, torch.float32)

    def forward(self, x):
        """x: normalized NHWC floats → f32 logits [B, num_labels]."""
        dt = self.dtype
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # [B, D, H/p, W/p]
        x = x.flatten(2).transpose(1, 2)  # [B, (H/p)·(W/p), D], rows in (h, w) order
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for name in self.layers:
            x = getattr(self, name)(x)
        return self.classifier(self.final_ln(x[:, 0].float()))


def init_params(model: ViTClassifier, seed: int = 0) -> dict:
    """A seed-initialised float param tree in the JAX package's layout:
    kernels N(0, 1/fan_in) (flax's lecun normal, untruncated), positions
    N(0, 0.02²), a zero [CLS], zero biases and unit LayerNorms, drawn from a
    ``torch.Generator``.  It does not reproduce the JAX package's
    ``jax.random.key(0)`` init; parity tests carry the JAX tree across with
    ``params_from_jax``."""
    g = torch.Generator().manual_seed(seed)
    s = model.shapes
    d, p = s["d"], s["patch"]

    def normal(std, *shape):
        return (torch.randn(*shape, generator=g) * std).numpy()

    def dense(i, o):
        return {"kernel": normal(i ** -0.5, i, o), "bias": np.zeros(o, np.float32)}

    def ln():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    tree = {"patch_embed": {"kernel": normal((p * p * 3) ** -0.5, p, p, 3, d),
                            "bias": np.zeros(d, np.float32)},
            "cls_token": np.zeros((1, 1, d), np.float32),
            "pos_embed": normal(0.02, 1, s["tokens"], d)}
    for name in model.layers:
        tree[name] = {"ln_before": ln(),
                      "attention": {k: dense(d, d) for k in ("query", "key", "value")},
                      "attention_output": dense(d, d), "ln_after": ln(),
                      "intermediate": dense(d, s["mlp_dim"]), "output": dense(s["mlp_dim"], d)}
    tree["final_ln"] = ln()
    tree["classifier"] = dense(d, s["num_labels"])
    return tree


from ..engine.weights import convert_vit  # noqa: E402
from ..utils.registry import register_model, register_tree  # noqa: E402
from .vision_common import IMAGE_SIZE, classifier_tree_fn, make_image_classifier  # noqa: E402


def _module(cfg) -> ViTClassifier:
    arch = {k: int(v) for k, v in dict(cfg.extra.get("arch", {})).items()}
    return ViTClassifier(image_size=int(cfg.extra.get("image_size", IMAGE_SIZE)),
                         num_labels=int(cfg.extra.get("num_labels", 1000)),
                         dtype=resolve_dtype(cfg.dtype), **arch)


def make_vit_servable(name: str, cfg):
    image_size = int(cfg.extra.get("image_size", IMAGE_SIZE))
    return make_image_classifier(name, _module(cfg), cfg, convert_vit, init_fn=init_params,
                                 resize_to=int(image_size * 256 / 224),
                                 num_classes=int(cfg.extra.get("num_labels", 1000)),
                                 norm_mean=(0.5, 0.5, 0.5), norm_std=(0.5, 0.5, 0.5))


register_tree("vit_b16")(classifier_tree_fn("vit_b16", _module, convert_vit, init_params))


@register_model("vit_b16", latency_class="latency")
def build_vit_b16(cfg):
    return make_vit_servable("vit_b16", cfg)
