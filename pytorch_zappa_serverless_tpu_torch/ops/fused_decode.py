"""Fused decode-step kernels: one GPT-2 block of one decode step in two
launches, on Hopper.

- :func:`fused_attn_step` (and ``_int8``): LN1 → fused QKV projection → this
  step's K/V rows written into the per-layer ``[T, S, D]`` caches at
  ``pos[s]``, in place → masked softmax attention over the cache → out
  projection → residual.
- :func:`fused_mlp_step` (and ``_int8``): LN2 → fc1 → GELU → fc2 → residual.

Layouts and call signatures are the JAX package's ``ops/fused_decode.py``:
``x [S, D]``; dense weights ``[in, out]`` (``wqkv [D, 3D]`` in q|k|v column
order); caches ``[T, S, D]`` (time-major); ``pos [S]`` int32;
``mask_bias [T, S, 1]`` f32, added to the scores as given (0 where a key is
visible, -1e9 elsewhere).  The int8 variants take int8 ``[K, N]`` weights
and f32 per-column scales, applied to the f32 accumulator.

Numerics: LN in f32 with the population variance; products accumulate in
f32; ``h`` after LN, ``qkv``, the attention context and the GELU output are
rounded to the activation dtype; scores, probabilities and P·V stay f32
(the unfused ``models/gpt2._attn`` rounds P before P·V; this does not).

**In place.** The caches are updated in place and returned as the same
tensors, as the JAX kernels alias them (``input_output_aliases``).  A write
position outside ``[0, T)`` is clamped into it.  ``x_out`` is a new tensor.

- On a CUDA tensor each wrapper launches its hand-written kernel
  (``csrc/fused_decode.cu``, one cooperative launch per call) on the current
  stream, or raises.
- On a CPU tensor it computes the plain PyTorch version
  (:func:`fused_attn_step_reference`, :func:`fused_mlp_step_reference`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# The kernels' limits (csrc/fused_decode.cu).
MAX_ROWS = 64
MAX_HEAD_DIM = 128
MAX_CACHE = 32768
_TILE_N, _WARPS, _KS_MAX = 64, 8, 256


def _check_head_layout(D: int, heads: int) -> None:
    """Heads split d_model evenly.  (The JAX kernels' even-head and
    head_dim == 64 rules are Mosaic lane-tiling rules and do not apply.)"""
    if heads < 1 or D % heads != 0:
        raise ValueError(f"fused decode attention: d_model {D} not divisible by heads {heads}")


def _ln(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _proj(h: torch.Tensor, w: torch.Tensor, scale, bias: torch.Tensor) -> torch.Tensor:
    """f32 product of the exact weight values, the column scale on the
    accumulator (int8), plus the bias."""
    acc = h.float() @ w.float()
    if scale is not None:
        acc = acc * scale.float()
    return acc + bias.float()


def fused_attn_step_reference(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, cache_k, cache_v,
                              pos, mask_bias, *, heads: int, eps: float = 1e-5,
                              sqkv=None, sout=None):
    """The plain PyTorch version of the attention step (bf16 weights, or int8
    with ``sqkv``/``sout``).  Updates the caches in place, as the kernel."""
    S, D = x.shape
    T = cache_k.shape[0]
    hd = D // heads
    x32 = x.float()
    h = _ln(x32, ln_scale, ln_bias, eps).to(x.dtype)
    qkv = _proj(h, wqkv, sqkv, bqkv).to(x.dtype)
    q, k_new, v_new = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    rows = torch.arange(S, device=x.device)
    at = pos.long().clamp(0, T - 1)
    cache_k[at, rows] = k_new.to(cache_k.dtype)
    cache_v[at, rows] = v_new.to(cache_v.dtype)
    qf = (q.float() * hd ** -0.5).view(S, heads, hd)
    scores = torch.einsum("shd,tshd->tsh", qf, cache_k.float().view(T, S, heads, hd))
    scores = scores + mask_bias.float()
    e = torch.exp(scores - scores.amax(0, keepdim=True))
    probs = e / e.sum(0, keepdim=True)
    ctx = torch.einsum("tsh,tshd->shd", probs, cache_v.float().view(T, S, heads, hd))
    y = _proj(ctx.reshape(S, D).to(x.dtype), wout, sout, bout)
    return (x32 + y).to(x.dtype), cache_k, cache_v


def fused_mlp_step_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5,
                             approx_gelu: bool = True, s1=None, s2=None):
    """The plain PyTorch version of the MLP step (bf16 weights, or int8 with
    ``s1``/``s2``)."""
    x32 = x.float()
    h = _ln(x32, ln_scale, ln_bias, eps).to(x.dtype)
    h1 = F.gelu(_proj(h, w1, s1, b1), approximate="tanh" if approx_gelu else "none")
    return (x32 + _proj(h1.to(x.dtype), w2, s2, b2)).to(x.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_decode_grid": (_I, [_I] * 4),
    "fused_attn_step_launch": (_I, [_I] + [_P] * 16 + [_I] * 4 + [_F, _F] + [_I] * 3 + [_P]),
    "fused_mlp_step_launch": (_I, [_I] + [_P] * 12 + [_I] * 3 + [_F] + [_I] * 4 + [_P]),
}


def _kernel_lib():
    from . import _build

    return _build.load("fused_decode.cu", _SIGNATURES)


_grids: dict[tuple, int] = {}


def _grid(mlp: bool, int8: bool, S: int, T: int, device: torch.device) -> int:
    """Blocks of one cooperative launch (all resident), per kernel and shape."""
    key = (mlp, int8, S, T, device.index)
    if key not in _grids:
        with torch.cuda.device(device):
            grid = _kernel_lib().fused_decode_grid(int(mlp), int(int8), S, T)
        if grid <= 0:
            raise RuntimeError(f"fused decode kernel cannot be sized: CUDA error {-grid} "
                               f"(S={S}, T={T})")
        _grids[key] = grid
    return _grids[key]


def slab_rows(K: int, N: int, grid: int) -> int:
    """K rows per slab of a ``[K, N]`` projection, so that its (64-column
    tile, K slab) work items about fill the grid once."""
    tiles = -(-N // _TILE_N)
    ks = -(-K // max(1, grid // tiles))
    return max(_WARPS, min(_KS_MAX, -(-ks // _WARPS) * _WARPS))


def _partials(S: int, device, *shapes) -> torch.Tensor:
    """f32 scratch for the largest projection's partial sums."""
    numel = max(-(-K // ks) * S * N for K, N, ks in shapes)
    return torch.empty(numel, dtype=torch.float32, device=device)


def _check_cuda(name: str, x: torch.Tensor, operands: dict, int8: bool, weights: tuple) -> None:
    """Raise on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")
    for key, t in operands.items():
        if t.device != x.device:
            raise ValueError(f"{name}: operands on different devices: x {x.device}, "
                             f"{key} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous row-major operands ({key} is not)")
    want_w = torch.int8 if int8 else torch.bfloat16
    for key in weights:
        if operands[key].dtype != want_w:
            raise TypeError(f"{name} takes {want_w} weights, got {key} {operands[key].dtype}")
    for key, t in operands.items():
        if key in weights or key in ("x", "cache_k", "cache_v", "pos"):
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes f32 norms, biases, scales and mask, got {key} "
                            f"{t.dtype}")
    for key in ("x", "cache_k", "cache_v"):
        if key in operands and operands[key].dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bf16 activations and caches, got {key} "
                            f"{operands[key].dtype}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{name} takes at most {MAX_ROWS} rows, got {x.shape[0]}")


def _attn(x, ln_scale, ln_bias, wqkv, bqkv, sqkv, wout, bout, sout, cache_k, cache_v, pos,
          mask_bias, heads: int, eps: float):
    name = "fused_attn_step" + ("_int8" if sqkv is not None else "")
    if x.ndim != 2:
        raise ValueError(f"{name} wants x [S, D], got {tuple(x.shape)}")
    S, D = x.shape
    _check_head_layout(D, heads)
    T = cache_k.shape[0]
    shapes = {"ln_scale": (D,), "ln_bias": (D,), "wqkv": (D, 3 * D), "bqkv": (3 * D,),
              "wout": (D, D), "bout": (D,), "cache_k": (T, S, D), "cache_v": (T, S, D),
              "pos": (S,), "mask_bias": (T, S, 1)}
    operands = {"ln_scale": ln_scale, "ln_bias": ln_bias, "wqkv": wqkv, "bqkv": bqkv,
                "wout": wout, "bout": bout, "cache_k": cache_k, "cache_v": cache_v,
                "pos": pos, "mask_bias": mask_bias}
    if sqkv is not None:
        shapes.update(sqkv=(3 * D,), sout=(D,))
        operands.update(sqkv=sqkv, sout=sout)
    for key, shape in shapes.items():
        if tuple(operands[key].shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got {tuple(operands[key].shape)}")
    if x.device.type == "cpu":
        return fused_attn_step_reference(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, cache_k,
                                         cache_v, pos, mask_bias, heads=heads, eps=eps,
                                         sqkv=sqkv, sout=sout)
    int8 = sqkv is not None
    _check_cuda(name, x, {"x": x, **operands}, int8, ("wqkv", "wout"))
    if pos.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 pos, got {pos.dtype}")
    if D // heads > MAX_HEAD_DIM or not 1 <= T <= MAX_CACHE:
        raise ValueError(f"{name} takes head_dim <= {MAX_HEAD_DIM} and 1 <= T <= {MAX_CACHE}, "
                         f"got head_dim {D // heads}, T {T}")
    grid = _grid(False, int8, S, T, x.device)
    ks_qkv, ks_out = slab_rows(D, 3 * D, grid), slab_rows(D, D, grid)
    part = _partials(S, x.device, (D, 3 * D, ks_qkv), (D, D, ks_out))
    ctx = torch.empty((S, D), dtype=x.dtype, device=x.device)
    x_out = torch.empty_like(x)
    rc = _kernel_lib().fused_attn_step_launch(
        int(int8), x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
        sqkv.data_ptr() if int8 else None, bqkv.data_ptr(), wout.data_ptr(),
        sout.data_ptr() if int8 else None, bout.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), pos.data_ptr(), mask_bias.data_ptr(), x_out.data_ptr(),
        part.data_ptr(), ctx.data_ptr(), S, D, T, heads, eps, (D // heads) ** -0.5,
        ks_qkv, ks_out, grid, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} (S={S}, D={D}, "
                           f"T={T}, heads={heads}, grid={grid})")
    fused_attn_step.launches += 1
    return x_out, cache_k, cache_v


def fused_attn_step(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, cache_k, cache_v, pos,
                    mask_bias, *, heads: int, eps: float = 1e-5):
    """One attention block of one decode step, fused, bf16 weights.

    Returns ``(x_out, cache_k, cache_v)``; the caches are the tensors passed
    in, updated in place at ``pos``.
    """
    return _attn(x, ln_scale, ln_bias, wqkv, bqkv, None, wout, bout, None, cache_k, cache_v,
                 pos, mask_bias, heads, eps)


def fused_attn_step_int8(x, ln_scale, ln_bias, wqkv_q, bqkv, sqkv, wout_q, bout, sout,
                         cache_k, cache_v, pos, mask_bias, *, heads: int, eps: float = 1e-5):
    """W8A16 variant of :func:`fused_attn_step`: int8 ``[K, N]`` weights and
    f32 per-column scales.  Counts in ``fused_attn_step.launches``."""
    return _attn(x, ln_scale, ln_bias, wqkv_q, bqkv, sqkv, wout_q, bout, sout, cache_k, cache_v,
                 pos, mask_bias, heads, eps)


def _mlp(x, ln_scale, ln_bias, w1, b1, s1, w2, b2, s2, eps: float, approx_gelu: bool):
    name = "fused_mlp_step" + ("_int8" if s1 is not None else "")
    if x.ndim != 2 or w1.ndim != 2:
        raise ValueError(f"{name} wants x [S, D], w1 [D, F]; got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}")
    S, D = x.shape
    Fd = w1.shape[1]
    shapes = {"ln_scale": (D,), "ln_bias": (D,), "w1": (D, Fd), "b1": (Fd,), "w2": (Fd, D),
              "b2": (D,)}
    operands = {"ln_scale": ln_scale, "ln_bias": ln_bias, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    if s1 is not None:
        shapes.update(s1=(Fd,), s2=(D,))
        operands.update(s1=s1, s2=s2)
    for key, shape in shapes.items():
        if tuple(operands[key].shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got {tuple(operands[key].shape)}")
    if x.device.type == "cpu":
        return fused_mlp_step_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps,
                                        approx_gelu=approx_gelu, s1=s1, s2=s2)
    int8 = s1 is not None
    _check_cuda(name, x, {"x": x, **operands}, int8, ("w1", "w2"))
    grid = _grid(True, int8, S, 0, x.device)
    ks1, ks2 = slab_rows(D, Fd, grid), slab_rows(Fd, D, grid)
    part = _partials(S, x.device, (D, Fd, ks1), (Fd, D, ks2))
    h1 = torch.empty((S, Fd), dtype=x.dtype, device=x.device)
    x_out = torch.empty_like(x)
    rc = _kernel_lib().fused_mlp_step_launch(
        int(int8), x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
        s1.data_ptr() if int8 else None, b1.data_ptr(), w2.data_ptr(),
        s2.data_ptr() if int8 else None, b2.data_ptr(), x_out.data_ptr(), part.data_ptr(),
        h1.data_ptr(), S, D, Fd, eps, int(approx_gelu), ks1, ks2, grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} (S={S}, D={D}, "
                           f"F={Fd}, grid={grid})")
    fused_mlp_step.launches += 1
    return x_out


def fused_mlp_step(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5,
                   approx_gelu: bool = True):
    """One MLP block of one decode step, fused: LN + fc1 + GELU + fc2 +
    residual.  ``x [S, D]``; ``w1 [D, F]``; ``w2 [F, D]``; bf16 weights."""
    return _mlp(x, ln_scale, ln_bias, w1, b1, None, w2, b2, None, eps, approx_gelu)


def fused_mlp_step_int8(x, ln_scale, ln_bias, w1_q, b1, s1, w2_q, b2, s2, *,
                        eps: float = 1e-5, approx_gelu: bool = True):
    """W8A16 variant of :func:`fused_mlp_step`.  Counts in
    ``fused_mlp_step.launches``."""
    return _mlp(x, ln_scale, ln_bias, w1_q, b1, s1, w2_q, b2, s2, eps, approx_gelu)


# Launches of the CUDA kernels in this process, each variant of a wrapper
# counted on the bf16 one (the plain version on CPU tensors does not count):
# a run reads them to show the decode loop used the kernels.
fused_attn_step.launches = 0
fused_mlp_step.launches = 0
