"""Flash attention: the SD-1.5 UNet's long self-attention, on Hopper.

``flash_attention(q, k, v)`` takes ``q [B, Tq, H, D]`` and ``k, v
[B, Tk, H, D]`` and returns ``[B, Tq, H, D]`` in q's dtype: blocked online-
softmax attention that never materialises the ``[B, H, Tq, Tk]`` score
tensor (at the UNet's 64x64 latents that tensor is 4096 x 4096 per head).

- On a CUDA tensor the wrapper launches the hand-written kernel
  (``csrc/flash_attention.cu``) on the current stream, or raises.  The bf16
  kernel reads q, k and v by TMA through their own strides; an operand
  whose base or strides TMA cannot describe (:func:`tma_describable`) is
  first copied into a padded buffer (:func:`padded_copy`) and goes to the
  same kernel.
- On a CPU tensor it computes :func:`flash_attention_reference`, the plain
  PyTorch version of the same function.

The numerics are the JAX package's Pallas kernel's: f32 scores times
``1/sqrt(D)``, an optional ``kv_mask [B, Tk]`` as an additive ``-1e9``,
``causal`` as ``-1e9`` above the diagonal, f32 softmax statistics, P cast to
the input dtype before P.V with f32 accumulation, and a fully masked row
giving a uniform distribution (finite, never NaN).

``attention`` is the ``[B, T, C]`` dispatcher the UNet calls: the kernel at
``min(Tq, Tk) >= FLASH_MIN_TOKENS``, the JAX package's materialised path
below it (products in the working dtype, f32 softmax).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import counters
from ._tma import launch_error, padded_copy, tma_describable

_NEG_INF = -1e9
_DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 160  # SD-1.5's widest head (1280 / 8)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, kv_mask):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q [B,Tq,H,D], k/v [B,Tk,H,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, D = q.shape
    if k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    Tk = k.shape[1]
    if causal and Tq != Tk:
        raise ValueError(f"causal needs Tq == Tk, got {Tq} != {Tk}")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Tk):
        raise ValueError(f"kv_mask must be [B, Tk] = {(B, Tk)}, got {tuple(kv_mask.shape)}")


def _mask_bias(kv_mask: torch.Tensor) -> torch.Tensor:
    """[B, Tk] attend mask -> f32 additive bias of 0 / -1e9."""
    return torch.where(kv_mask.bool(), 0.0, _NEG_INF).to(torch.float32)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, kv_mask=None,
                              sm_scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version: the kernel's arithmetic on the whole key
    axis at once (one max, one sum), with the score tensor materialised."""
    _check(q, k, v, causal, kv_mask)
    Tq, D = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        s = s + _mask_bias(kv_mask)[:, None, None, :]
    if causal:
        t = torch.arange(Tq, device=q.device)
        s = torch.where(t[:, None] >= t[None, :], s, _NEG_INF)
    m = torch.clamp_min(s.amax(-1, keepdim=True), _NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = acc / torch.where(l == 0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


_SIGNATURES = {"flash_attention_fwd": (
    ctypes.c_int, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}


def _kernel_lib():
    from . import _build

    return _build.load("flash_attention.cu", _SIGNATURES)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, kv_mask=None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Blocked online-softmax attention, ``[B, Tq, H, D] -> [B, Tq, H, D]``.

    ``kv_mask``: optional ``[B, Tk]`` (True = attend).  ``sm_scale``
    defaults to ``1/sqrt(D)``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.
    """
    _check(q, k, v, causal, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, kv_mask=kv_mask,
                                         sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or f32 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {D}")
    if k.device != q.device or v.device != q.device or (
            kv_mask is not None and kv_mask.device != q.device):
        raise ValueError(f"operands on different devices: q {q.device}, k {k.device}, "
                         f"v {v.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs the head dim (last axis) contiguous")
    if q.dtype == torch.bfloat16:
        q, k, v = (x if tma_describable(x) else padded_copy(x) for x in (q, k, v))
    bias = _mask_bias(kv_mask).contiguous() if kv_mask is not None else None
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    rc = _kernel_lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        B, Tq, Tk, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {launch_error(rc)} "
                           f"(B={B}, Tq={Tq}, Tk={Tk}, H={H}, D={D})")
    flash_attention.launches += 1
    counters.add_flops("flash_attention", flash_attention_flops(B, Tq, Tk, H, D))
    return out


def flash_attention_flops(b: int, tq: int, tk: int, h: int, d: int) -> int:
    """Operations of one call, as ``torch.utils.flop_counter`` counts the
    plain version's two batched products: Q·Kᵀ and P·V, 2·B·H·Tq·Tk·D each
    (a causal call's skipped blocks included, as the plain version
    computes them)."""
    return 4 * b * h * tq * tk * d


# Launches of the CUDA kernel in this process (the plain version on CPU
# tensors does not count): a run reads it to show the main path used the
# kernel.
counters.register(flash_attention)

# Streaming beats materialised scores once the score tensor is large; below
# this the two batched products are as fast (CLIP-77, cross-attention over
# 77 text tokens, the UNet's 16x16 and 8x8 levels).
FLASH_MIN_TOKENS = 1024


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
              causal: bool = False, kv_mask=None) -> torch.Tensor:
    """``[B, T, C]``-layout multi-head attention with kernel dispatch.

    q ``[B, Tq, C]``, k/v ``[B, Tk, C]`` already projected; returns
    ``[B, Tq, C]``: :func:`flash_attention` at ``min(Tq, Tk) >=
    FLASH_MIN_TOKENS``, the materialised scores below it.
    """
    B, Tq, C = q.shape
    Tk = k.shape[1]
    if causal and Tq != Tk:
        raise ValueError(f"causal needs Tq == Tk, got {Tq} != {Tk}")
    hd = C // heads
    qh = q.reshape(B, Tq, heads, hd)
    kh = k.reshape(B, Tk, heads, hd)
    vh = v.reshape(B, Tk, heads, hd)
    if min(Tq, Tk) >= FLASH_MIN_TOKENS:
        return flash_attention(qh, kh, vh, causal=causal, kv_mask=kv_mask).reshape(B, Tq, C)
    scores = (qh.transpose(1, 2) @ kh.permute(0, 2, 3, 1)).float() * (hd ** -0.5)
    if kv_mask is not None:
        scores = scores + _mask_bias(kv_mask)[:, None, None, :]
    if causal:
        t = torch.arange(Tq, device=q.device)
        scores = torch.where(t[:, None] >= t[None, :], scores, _NEG_INF)
    probs = scores.softmax(-1).to(vh.dtype)
    return (probs @ vh.transpose(1, 2)).transpose(1, 2).reshape(B, Tq, C)
