"""Stable-Diffusion VAE decoder in PyTorch: latents [B,h,w,4] → RGB [B,8h,8w,3].

Only the decoder half is on the serving path (txt2img never encodes
pixels).  Architecture mirrors diffusers ``AutoencoderKL``'s decoder for
SD-1.5: post_quant 1x1 conv → conv_in 4→512 → mid (resnet, single-head
self-attention, resnet) → 4 up blocks of 3 resnets, 2x nearest upsample
between, channels (512, 512, 256, 128) → GroupNorm/SiLU → conv_out 3.
Layouts and numerics are the UNet's (``models/sd_unet.py``); VAE norms use
eps 1e-6.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .sd_unet import _conv, _dense, _group_norm, _upsample_nearest2x


@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    # Decoder stage channels deepest-first (diffusers block_out_channels
    # reversed): conv_in lands at up_channels[0].
    up_channels: tuple[int, ...] = (512, 512, 256, 128)
    resnets_per_block: int = 3
    groups: int = 32
    scaling_factor: float = 0.18215  # latent scale; SD-1.5 vae/config.json


SD15_VAE = VAEConfig()


def _resnet(p, x, groups):
    """VAE ResnetBlock2D: the UNet's with no time embedding."""
    h = F.silu(_group_norm(p["norm1"], x, groups, eps=1e-6))
    h = _conv(p["conv1"], h)
    h = F.silu(_group_norm(p["norm2"], h, groups, eps=1e-6))
    h = _conv(p["conv2"], h)
    if "shortcut" in p:
        x = _conv(p["shortcut"], x, padding=0)
    return x + h


def _mid_attention(p, x, groups):
    """Single-head spatial self-attention over h*w tokens (AttnBlock).

    Materialised scores, as the JAX package's ``_mid_attention`` computes
    them by design: one head of width 512 gives the flash kernel no
    head-parallel work, and the one [B, 4096, 4096] score tensor per decode
    is small next to the decoder's convolutions.
    """
    B, C, H, W = x.shape
    h = _group_norm(p["norm"], x, groups, eps=1e-6).permute(0, 2, 3, 1).reshape(B, H * W, C)
    q = _dense(p["q"], h)
    k = _dense(p["k"], h)
    v = _dense(p["v"], h)
    scores = (q @ k.transpose(1, 2)).float() * (C ** -0.5)
    probs = scores.softmax(-1).to(v.dtype)
    out = _dense(p["out"], probs @ v)
    return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


def vae_decode(params: dict, latents: torch.Tensor, cfg: VAEConfig = SD15_VAE,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Scaled latents [B,h,w,4] → RGB float32 in [0,1], [B, 8h, 8w, 3]."""
    x = (latents / cfg.scaling_factor).to(dtype).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    x = _conv(params["post_quant"], x, padding=0)
    x = _conv(params["conv_in"], x)
    p = params["mid"]
    x = _resnet(p["res0"], x, cfg.groups)
    x = _mid_attention(p["attn"], x, cfg.groups)
    x = _resnet(p["res1"], x, cfg.groups)
    n = len(cfg.up_channels)
    for b in range(n):
        p = params[f"up{b}"]
        for r in range(cfg.resnets_per_block):
            x = _resnet(p[f"res{r}"], x, cfg.groups)
        if b < n - 1:
            x = _conv(p["up"], _upsample_nearest2x(x))
    x = F.silu(_group_norm(params["norm_out"], x, cfg.groups, eps=1e-6))
    x = _conv(params["conv_out"], x).float()
    return torch.clamp(x / 2.0 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)


def init_vae_params(seed: int = 0, cfg: VAEConfig = SD15_VAE, rng=None) -> dict:
    """Seed-initialised weights in the JAX package's layout, byte for byte
    the JAX function's (the same ``default_rng`` draws in the same order)."""
    g = np.random.default_rng(seed) if rng is None else rng

    def conv(i, o, k=3):
        fan_in = i * k * k
        return {"kernel": (g.standard_normal((k, k, i, o)) / np.sqrt(fan_in)).astype(np.float32),
                "bias": np.zeros((o,), np.float32)}

    def dense(i, o):
        return {"kernel": (g.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": np.zeros((o,), np.float32)}

    def norm(c):
        return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}

    def resnet(i, o):
        p = {"norm1": norm(i), "conv1": conv(i, o), "norm2": norm(o), "conv2": conv(o, o)}
        if i != o:
            p["shortcut"] = conv(i, o, k=1)
        return p

    ch = cfg.up_channels
    C0 = ch[0]
    params = {
        "post_quant": conv(cfg.latent_channels, cfg.latent_channels, k=1),
        "conv_in": conv(cfg.latent_channels, C0),
        "mid": {"res0": resnet(C0, C0),
                "attn": {"norm": norm(C0), "q": dense(C0, C0), "k": dense(C0, C0),
                         "v": dense(C0, C0), "out": dense(C0, C0)},
                "res1": resnet(C0, C0)},
        "norm_out": norm(ch[-1]), "conv_out": conv(ch[-1], 3),
    }
    c_in = C0
    for b in range(len(ch)):
        p = {}
        for r in range(cfg.resnets_per_block):
            p[f"res{r}"] = resnet(c_in, ch[b])
            c_in = ch[b]
        if b < len(ch) - 1:
            p["up"] = conv(ch[b], ch[b])
        params[f"up{b}"] = p
    return params
