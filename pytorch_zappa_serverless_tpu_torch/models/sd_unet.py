"""Stable-Diffusion 1.5 UNet (UNet2DConditionModel) in PyTorch.

The epsilon-prediction denoiser: latents [B,h,w,4] + timestep + CLIP text
states [B,77,768] → noise estimate [B,h,w,4], as functions over a param
dict in the port's layout (``engine.weights.params_from_jax`` of the JAX
package's tree: conv weights OIHW, dense weights [out, in]).

The public layout is the JAX package's NHWC; inside, activations are NCHW
tensors in ``channels_last`` memory, which is NHWC in memory, so the
entry and exit permutes and the token views of the spatial transformers
move no bytes.  Numerics follow the JAX package's ``models/sd_unet.py``:

- convs and dense layers in ``dtype`` (weights cast at use, so weights held
  in ``dtype`` already give the same values); the time MLP in f32;
- GroupNorm with the JAX formula (per-channel f32 means, group
  ``E[x²] − E[x]²`` clamped at 0, one ``x·a + b``), LayerNorm in f32;
- GEGLU with the erf GELU; nearest-2x upsampling;
- self- and cross-attention with ``ops.flash_attention.attention``'s
  dispatch: the self-attention at the 64x64 and 32x32 latent levels (4096
  and 1024 tokens) runs this module's ``flash`` (the kernel), ten launches
  per UNet call at 512x512; cross-attention over 77 text tokens and the
  16x16/8x8 levels stay on the dispatcher's materialised path.

Architecture constants mirror SD-1.5 (diffusers ``unet/config.json``):
channels (320, 640, 1280, 1280), 2 resnets per block, cross-attention in
down blocks 0-2 / mid / up blocks 1-3, 8 heads at every resolution.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import counters
from ..ops.flash_attention import FLASH_MIN_TOKENS, attention, flash_attention


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # Which down blocks carry cross-attention transformers (mirrored on the
    # up path); SD-1.5: all but the deepest.
    attn_blocks: tuple[bool, ...] = (True, True, True, False)
    heads: int = 8
    context_dim: int = 768
    groups: int = 32
    time_dim_mult: int = 4  # time_embed_dim = block_channels[0] * 4

    @property
    def time_dim(self) -> int:
        return self.block_channels[0] * self.time_dim_mult


SD15_UNET = UNetConfig()

# The kernel behind every self-attention at >= FLASH_MIN_TOKENS tokens.  A
# check may set it to ``flash_attention_reference`` (the plain version) to
# hold a UNet call against it on the same weights and inputs.
flash = flash_attention


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding, diffusers convention
    (flip_sin_to_cos=True, downscale_freq_shift=0 → [cos | sin] halves).
    t [B] → [B, dim] float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _group_norm(p, x, groups, eps=1e-5):
    """GroupNorm over [B, C, *spatial] with the JAX package's formula: stats
    from per-channel f32 means (equal-size groups make the group mean the
    mean of its channels' means), variance ``E[x²] − E[x]²`` clamped at 0,
    and one fused ``x·a + b`` with per-(batch, channel) a and b."""
    B, C = x.shape[:2]
    g = min(groups, C)
    spatial = tuple(range(2, x.ndim))
    x32 = x.float()
    mu_c = x32.mean(spatial)                                     # [B, C]
    ex2_c = x32.square().mean(spatial)
    mu_g = mu_c.view(B, g, C // g).mean(-1)                      # [B, g]
    ex2_g = ex2_c.view(B, g, C // g).mean(-1)
    var = torch.clamp_min(ex2_g - mu_g.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(C // g, dim=-1)                # [B, C]
    mu_bc = mu_g.repeat_interleave(C // g, dim=-1)
    a = inv_c * p["weight"].float()
    b = p["bias"].float() - mu_bc * a
    shape = (B, C) + (1,) * len(spatial)
    return (x32 * a.view(shape) + b.view(shape)).to(x.dtype)


def _conv(p, x, stride=1, padding=1):
    return F.conv2d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype),
                    stride=stride, padding=padding)


def _dense(p, x):
    b = p.get("bias")
    return F.linear(x, p["weight"].to(x.dtype), None if b is None else b.to(x.dtype))


def _resnet_block(p, x, temb, groups):
    """diffusers ResnetBlock2D: GN→SiLU→conv→(+temb)→GN→SiLU→conv, skip."""
    h = F.silu(_group_norm(p["norm1"], x, groups))
    h = _conv(p["conv1"], h)
    h = h + _dense(p["time_emb"], F.silu(temb))[:, :, None, None]
    h = F.silu(_group_norm(p["norm2"], h, groups))
    h = _conv(p["conv2"], h)
    if "shortcut" in p:
        x = _conv(p["shortcut"], x, padding=0)
    return x + h


def _attention(q, k, v, heads):
    """q [B,Tq,C], k/v [B,Tk,C] (projected) → [B,Tq,C]: this module's
    ``flash`` at ``FLASH_MIN_TOKENS`` and above (the dispatcher's rule),
    the dispatcher's materialised path below."""
    B, Tq, C = q.shape
    if min(Tq, k.shape[1]) < FLASH_MIN_TOKENS:
        return attention(q, k, v, heads)
    qh, kh, vh = (x.reshape(B, x.shape[1], heads, C // heads) for x in (q, k, v))
    return flash(qh, kh, vh).reshape(B, Tq, C)


def _ln(p, x, eps=1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"], p["bias"], eps).to(x.dtype)


def _transformer_block(p, x, context, heads):
    """BasicTransformerBlock: self-attn → cross-attn → GEGLU FF (all pre-LN)."""
    h = _ln(p["ln1"], x)
    x = x + _dense(p["self_out"],
                   _attention(_dense(p["self_q"], h), _dense(p["self_k"], h),
                              _dense(p["self_v"], h), heads))
    h = _ln(p["ln2"], x)
    x = x + _dense(p["cross_out"],
                   _attention(_dense(p["cross_q"], h), _dense(p["cross_k"], context),
                              _dense(p["cross_v"], context), heads))
    h = _ln(p["ln3"], x)
    value, gate = _dense(p["ff1"], h).chunk(2, dim=-1)
    return x + _dense(p["ff2"], value * F.gelu(gate))


def _spatial_transformer(p, x, context, heads, groups):
    """Transformer2DModel: GN → 1x1 proj_in → tokens → block → 1x1 proj_out."""
    B, C, H, W = x.shape
    h = _group_norm(p["norm"], x, groups, eps=1e-6)
    h = _conv(p["proj_in"], h, padding=0)
    h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)   # tokens in h*W + w order
    h = _transformer_block(p["block"], h, context, heads)
    h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return x + _conv(p["proj_out"], h, padding=0)


def _upsample_nearest2x(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def unet_apply(params: dict, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
               cfg: UNetConfig = SD15_UNET, dtype=torch.bfloat16) -> torch.Tensor:
    """latents [B,h,w,4] + t [B] + context [B,77,ctx] → eps [B,h,w,4] (f32)."""
    unet_apply.calls += 1
    x = latents.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    context = context.to(dtype)
    temb = timestep_embedding(t, cfg.block_channels[0])
    temb = _dense(params["time_mlp2"], F.silu(_dense(params["time_mlp1"], temb))).to(dtype)

    x = _conv(params["conv_in"], x)
    skips = [x]
    n_blocks = len(cfg.block_channels)

    for b in range(n_blocks):
        p = params[f"down{b}"]
        for r in range(cfg.layers_per_block):
            x = _resnet_block(p[f"res{r}"], x, temb, cfg.groups)
            if cfg.attn_blocks[b]:
                x = _spatial_transformer(p[f"attn{r}"], x, context, cfg.heads, cfg.groups)
            skips.append(x)
        if b < n_blocks - 1:
            x = _conv(p["down"], x, stride=2)
            skips.append(x)

    p = params["mid"]
    x = _resnet_block(p["res0"], x, temb, cfg.groups)
    x = _spatial_transformer(p["attn"], x, context, cfg.heads, cfg.groups)
    x = _resnet_block(p["res1"], x, temb, cfg.groups)

    for ui, b in enumerate(reversed(range(n_blocks))):
        p = params[f"up{ui}"]
        for r in range(cfg.layers_per_block + 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = _resnet_block(p[f"res{r}"], x, temb, cfg.groups)
            if cfg.attn_blocks[b]:
                x = _spatial_transformer(p[f"attn{r}"], x, context, cfg.heads, cfg.groups)
        if ui < n_blocks - 1:
            x = _conv(p["up"], _upsample_nearest2x(x))

    x = F.silu(_group_norm(params["norm_out"], x, cfg.groups))
    return _conv(params["conv_out"], x).float().permute(0, 2, 3, 1)


# UNet calls in this process, on any device: a run holds the flash kernel's
# launches against it (ten per call at 512x512).
counters.register(unet_apply, "calls")


def init_unet_params(seed: int = 0, cfg: UNetConfig = SD15_UNET, rng=None) -> dict:
    """Seed-initialised weights in the JAX package's layout, byte for byte
    the JAX function's (the same ``default_rng`` draws in the same order)."""
    g = np.random.default_rng(seed) if rng is None else rng

    def conv(i, o, k=3):
        fan_in = i * k * k
        return {"kernel": (g.standard_normal((k, k, i, o)) / np.sqrt(fan_in)).astype(np.float32),
                "bias": np.zeros((o,), np.float32)}

    def dense(i, o, bias=True):
        p = {"kernel": (g.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)}
        if bias:
            p["bias"] = np.zeros((o,), np.float32)
        return p

    def norm(c):
        return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}

    def resnet(i, o):
        p = {"norm1": norm(i), "conv1": conv(i, o), "time_emb": dense(cfg.time_dim, o),
             "norm2": norm(o), "conv2": conv(o, o)}
        if i != o:
            p["shortcut"] = conv(i, o, k=1)
        return p

    def transformer(c):
        ctx = cfg.context_dim
        return {
            "norm": norm(c), "proj_in": conv(c, c, k=1), "proj_out": conv(c, c, k=1),
            "block": {
                "ln1": norm(c), "self_q": dense(c, c, bias=False),
                "self_k": dense(c, c, bias=False), "self_v": dense(c, c, bias=False),
                "self_out": dense(c, c),
                "ln2": norm(c), "cross_q": dense(c, c, bias=False),
                "cross_k": dense(ctx, c, bias=False), "cross_v": dense(ctx, c, bias=False),
                "cross_out": dense(c, c),
                "ln3": norm(c), "ff1": dense(c, 8 * c), "ff2": dense(4 * c, c),
            },
        }

    ch = cfg.block_channels
    n = len(ch)
    params = {
        "time_mlp1": dense(ch[0], cfg.time_dim), "time_mlp2": dense(cfg.time_dim, cfg.time_dim),
        "conv_in": conv(cfg.in_channels, ch[0]),
        "norm_out": norm(ch[0]), "conv_out": conv(ch[0], cfg.out_channels),
    }
    c_in = ch[0]
    for b in range(n):
        p = {}
        for r in range(cfg.layers_per_block):
            p[f"res{r}"] = resnet(c_in, ch[b])
            if cfg.attn_blocks[b]:
                p[f"attn{r}"] = transformer(ch[b])
            c_in = ch[b]
        if b < n - 1:
            p["down"] = conv(ch[b], ch[b])
        params[f"down{b}"] = p
    params["mid"] = {"res0": resnet(ch[-1], ch[-1]), "attn": transformer(ch[-1]),
                     "res1": resnet(ch[-1], ch[-1])}
    # Up blocks: resnet r consumes the skip pushed by the down path, in
    # reverse push order.
    skip_ch = [ch[0]]
    for b in range(n):
        skip_ch.extend([ch[b]] * cfg.layers_per_block)
        if b < n - 1:
            skip_ch.append(ch[b])
    c_in = ch[-1]
    for ui, b in enumerate(reversed(range(n))):
        p = {}
        for r in range(cfg.layers_per_block + 1):
            p[f"res{r}"] = resnet(c_in + skip_ch.pop(), ch[b])
            if cfg.attn_blocks[b]:
                p[f"attn{r}"] = transformer(ch[b])
            c_in = ch[b]
        if ui < n - 1:
            p["up"] = conv(ch[b], ch[b])
        params[f"up{ui}"] = p
    return params
