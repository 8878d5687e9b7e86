"""W8A16 matrix product: the int8 serving lane's kernel, on Hopper.

``int8_matmul(x [M, K], w_q [K, N] int8, scale [N] f32) -> [M, N]`` computes
``(x @ w_q) * scale`` with f32 accumulation and the per-column scale applied
once to the accumulator, so a dequantised copy of the weights never exists in
device memory (the reason the kernel exists: a plain ``x @ (w_q * scale)``
reads the int8 weights and then writes and reads a bf16 copy, more bytes than
serving bf16 weights directly).

- On a CUDA tensor the wrapper launches the hand-written kernel
  (``csrc/int8_matmul.cu``) on the current stream, or raises.  For bf16
  activations :func:`plan` picks the kernel's tile and its split of K, and
  the kernel reads x and w_q by TMA through their row strides; an operand
  TMA cannot describe (:func:`tma_describable`) is first copied into a
  padded buffer (:func:`padded_copy`) and goes to the same kernel.
- On a CPU tensor it computes :func:`int8_matmul_reference`, the plain
  PyTorch version of the same function.

``quantize_per_channel`` / ``pad_weights`` / ``quantize_tree`` are the host
side of the lane, numpy copies of the JAX package's functions that give the
same bytes.  Layouts are the JAX package's: ``w_q`` is ``[K, N]`` (input
rows, output columns).  The kernel handles ragged M, K and N itself (TMA
zero-fills past them), so ``pad_weights`` is not needed for correctness.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import counters
from ._tma import launch_error, padded_copy, tma_describable


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def quantize_per_channel(w, axis: int = 0):
    """Symmetric int8 quantization of ``w`` per OUTPUT channel.

    ``axis`` is the reduction (input) axis of the matmul the weight will be
    used in; scales live on the other (output) axis.  Returns
    (w_q int8 same shape, scale fp32 [N]) with ``w ≈ w_q * scale``.
    """
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=axis)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.round(w / np.expand_dims(scale, axis)), -127, 127)
    return w_q.astype(np.int8), scale


def pad_weights(w_q, scale):
    """Pad quantized weights to multiples of 128 on both axes.

    Pad columns carry zero weights and scale 1.0, so they produce exact
    zeros; callers slice ``[..., :N]`` off the result (a zero logit could win
    an argmax over all-negative real logits otherwise).
    """
    w_q = np.asarray(w_q)
    scale = np.asarray(scale, np.float32)
    K, N = w_q.shape
    k_p, n_p = _round_up(K, 128), _round_up(N, 128)
    w_pad = np.zeros((k_p, n_p), np.int8)
    w_pad[:K, :N] = w_q
    s_pad = np.ones((n_p,), np.float32)
    s_pad[:N] = scale
    return w_pad, s_pad


def quantize_tree(params, min_size: int = 1 << 16):
    """Replace every ``{"kernel": 2-D float}`` node with int8 + scale.

    Walks a nested-dict param tree in the JAX package's layout (kernels
    ``[in, out]``); kernels smaller than ``min_size`` elements stay float.
    Biases and norms are untouched.
    """

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if (k == "kernel" and hasattr(v, "ndim") and v.ndim == 2
                    and np.asarray(v).dtype.kind == "f"
                    and np.asarray(v).size >= min_size):
                out["kernel_q"], out["scale"] = quantize_per_channel(
                    np.asarray(v), axis=0)
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return walk(params)


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version: f32 product of the exact int8 values."""
    return ((x.float() @ w_q.float()) * scale).to(out_dtype or x.dtype)


_DTYPES = (torch.bfloat16, torch.float32)


# The card the planner fills, and the kernel's tiles.
SMS = 132
BK = 64           # K per ring stage
MAX_CLUSTER = 8   # the portable thread-block cluster size: the most K splits
SMALL_M = 128     # up to here one consumer warpgroup (64 rows) per block
DECODE_BLOCKS = 192  # blocks a weight-bound product aims for (~1.5 per SM)
# The (rows, columns) output tiles the kernel is built for.
TILES = ((64, 32), (64, 64), (64, 128), (128, 256))


class Plan(NamedTuple):
    """One launch of the bf16 kernel: ``bm x bn`` output tiles, K cut into
    ``splits`` slices reduced inside a cluster of ``cluster`` blocks along
    the grid's third axis (``cluster == splits``)."""

    bm: int
    bn: int
    splits: int
    cluster: int


def plan(m: int, k: int, n: int) -> Plan:
    """The tile and K split of one bf16 product ``[m, k] @ [k, n]``, tuned
    on the H100 with ``tools/int8_ablation.py --sweep``.

    Up to ``SMALL_M`` rows (decode, one BERT sequence) the weight bytes
    bound the product, and what matters is enough blocks in flight to
    stream them from every SM: 64-row tiles (two blocks fit on an SM) and
    about ``DECODE_BLOCKS`` blocks, from 128-column tiles alone where they
    are that many (the lm head), else 64 or 32 columns with K split over up
    to ``MAX_CLUSTER`` slices.  Above it the tensor cores bound it: 128 x 256
    tiles (one block per SM) where they fill half a wave, K split into
    slices of at least 12 K tiles where it is long, and else 64 x 64 tiles,
    two blocks per SM, whole K (BERT's 768 x 768 at M = 1024: 192 blocks).
    """
    k_tiles = -(-k // BK)
    if m <= SMALL_M:
        row_tiles = -(-m // 64)
        if row_tiles * -(-n // 128) >= DECODE_BLOCKS:
            return Plan(64, 128, 1, 1)
        bn = 64 if row_tiles * -(-n // 64) * MAX_CLUSTER >= DECODE_BLOCKS else 32
        tiles = row_tiles * -(-n // bn)
        splits = min(MAX_CLUSTER, k_tiles, -(-DECODE_BLOCKS // tiles))
        return Plan(64, bn, splits, splits)
    tiles = -(-m // 128) * -(-n // 256)
    if tiles >= SMS // 2:
        return Plan(128, 256, 1, 1)
    if k_tiles >= 24:
        splits = max(1, min(MAX_CLUSTER, k_tiles // 12, SMS // tiles))
        return Plan(128, 256, splits, splits)
    return Plan(64, 64, 1, 1)


_SIGNATURES = {"w8a16_matmul": (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p])}


def _kernel_lib():
    from . import _build

    return _build.load("int8_matmul.cu", _SIGNATURES)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """``x [M, K] @ dequant(w_q [K, N], scale [N]) -> [M, N]``.

    ``out_dtype`` defaults to x.dtype; pass ``torch.float32`` for logits-style
    consumers (the accumulator is f32 either way).  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"int8_matmul wants x [M,K], w_q [K,N], scale [N]; got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    K2, N = w_q.shape
    if K != K2 or scale.shape[0] != N:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"int8_matmul takes bf16/f32 activations and output, "
                        f"got x {x.dtype}, out {out_dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"w_q must be int8 and scale float32, got {w_q.dtype}, "
                        f"{scale.dtype}")
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, got {x.device}")
    if w_q.device != x.device or scale.device != x.device:
        raise ValueError(f"operands on different devices: x {x.device}, w_q "
                         f"{w_q.device}, scale {scale.device}")
    if not (x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul needs contiguous row-major operands")
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    p = plan(M, K, N)
    if x.dtype == torch.bfloat16:
        x, w_q = (t if tma_describable(t) else padded_copy(t) for t in (x, w_q))
    rc = _kernel_lib().w8a16_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), M, K, N,
        x.stride(0), w_q.stride(0), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), p.bm, p.bn, p.splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: {launch_error(rc)} "
                           f"(M={M}, K={K}, N={N}, plan {tuple(p)})")
    int8_matmul.launches += 1
    return y


# Launches of the CUDA kernel in this process (the plain version on CPU
# tensors does not count): a run reads it to show the main path used the
# kernel.
counters.register(int8_matmul)


def dense_maybe_int8(p: dict, x: torch.Tensor, matmul=int8_matmul) -> torch.Tensor:
    """A dense layer from a param dict, dispatching on its keys.

    Quantized params carry ``kernel_q`` int8 [K, N] + ``scale`` f32 [N];
    float params carry ``kernel`` [K, N].  Leading dims of ``x`` flatten to
    M.  The int8 product comes back in x.dtype and the bias is added in
    x.dtype, as in the JAX package.  ``matmul`` lets a caller hold the
    kernel against :func:`int8_matmul_reference` on the same layer.
    """
    if "kernel_q" not in p:
        y = x @ p["kernel"].to(x.dtype)
        return y + p["bias"].to(x.dtype) if "bias" in p else y
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, x.shape[-1]).contiguous(), p["kernel_q"], p["scale"])
    y = y.reshape(*lead, -1)
    return y + p["bias"].to(x.dtype) if "bias" in p else y
