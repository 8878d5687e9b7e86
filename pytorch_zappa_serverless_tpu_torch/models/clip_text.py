"""CLIP text encoder: the SD-1.5 conditioning tower, in PyTorch.

OpenAI CLIP ViT-L/14's text transformer (vocab 49408, width 768, 12 pre-LN
layers of 12 heads, causal mask, quick-GELU), as functions over a param dict
in the port's layout (``engine.weights.params_from_jax`` of the JAX
package's tree).  Numerics follow the JAX package's ``models/clip_text.py``:
products in ``dtype``, LayerNorm and softmax in f32, a finite ``-1e9``
causal mask.  At 77 tokens the scores are materialised (no kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 77
    bot_id: int = 49406  # <|startoftext|>
    eot_id: int = 49407  # <|endoftext|> (also the pad token in SD)

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


VIT_L14 = CLIPTextConfig()


def _ln(p, x, eps=1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"], p["bias"], eps).to(x.dtype)


def _dense(p, x):
    return F.linear(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype))


def _quick_gelu(x):
    # CLIP's activation: x * sigmoid(1.702 x) (not the erf/tanh GELU).
    return x * torch.sigmoid(1.702 * x)


def encode_text(params: dict, ids: torch.Tensor, cfg: CLIPTextConfig = VIT_L14,
                dtype=torch.bfloat16) -> torch.Tensor:
    """ids [B, T] int → last hidden state [B, T, width] (after the final
    LayerNorm: what SD-1.5 conditions on)."""
    B, T = ids.shape
    x = (params["token_embedding"].to(dtype)[ids.long()]
         + params["pos_embedding"].to(dtype)[None, :T])
    t = torch.arange(T, device=ids.device)
    causal = torch.where(t[None, :] <= t[:, None], 0.0, -1e9).float()[None, None]
    scale = cfg.head_dim ** -0.5
    for i in range(cfg.layers):
        p = params[f"layer{i}"]
        h = _ln(p["ln1"], x)
        q = _dense(p["q"], h) * scale
        k = _dense(p["k"], h)
        v = _dense(p["v"], h)
        q, k, v = (z.reshape(B, T, cfg.heads, cfg.head_dim).transpose(1, 2) for z in (q, k, v))
        scores = (q @ k.transpose(-1, -2)).float() + causal
        probs = scores.softmax(-1).to(dtype)
        attn = (probs @ v).transpose(1, 2).reshape(B, T, cfg.width)
        x = x + _dense(p["out"], attn)
        h = _ln(p["ln2"], x)
        x = x + _dense(p["fc2"], _quick_gelu(_dense(p["fc1"], h)))
    return _ln(params["final_ln"], x)


def init_clip_text_params(seed: int = 0, cfg: CLIPTextConfig = VIT_L14, rng=None) -> dict:
    """Seed-initialised weights in the JAX package's layout, byte for byte
    the JAX function's (the same ``default_rng`` draws in the same order)."""
    g = np.random.default_rng(seed) if rng is None else rng

    def dense(i, o):
        return {"kernel": (g.standard_normal((i, o)) * 0.02).astype(np.float32),
                "bias": np.zeros((o,), np.float32)}

    def ln(d):
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    D = cfg.width
    params = {
        "token_embedding": (g.standard_normal((cfg.vocab_size, D)) * 0.02).astype(np.float32),
        "pos_embedding": (g.standard_normal((cfg.max_len, D)) * 0.01).astype(np.float32),
        "final_ln": ln(D),
    }
    for i in range(cfg.layers):
        params[f"layer{i}"] = {
            "ln1": ln(D), "q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
            "out": dense(D, D), "ln2": ln(D),
            "fc1": dense(D, cfg.mlp_dim), "fc2": dense(cfg.mlp_dim, D),
        }
    return params
