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
  (``csrc/fused_decode.cu``, one cooperative launch of thread-block clusters
  per call, sized by :func:`plan`) on the current stream, or raises.
- On a CPU tensor it computes the plain PyTorch version
  (:func:`fused_attn_step_reference`, :func:`fused_mlp_step_reference`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import counters
from ._tma import launch_error

# The kernels' limits (csrc/fused_decode.cu).
MAX_ROWS = 64
MAX_HEAD_DIM = 128
MAX_CACHE = 32768


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
    "fused_decode_clusters": (_I, [_I] * 5),
    "fused_attn_step_launch": (_I, [_I] + [_P] * 15 + [_I] * 4 + [_F, _F] + [_P, _P]),
    "fused_mlp_step_launch": (_I, [_I] + [_P] * 11 + [_I] * 3 + [_F, _I] + [_P, _P]),
}


def _kernel_lib():
    from . import _build

    return _build.load("fused_decode.cu", _SIGNATURES)


# -- the launch plan (csrc/fused_decode.cu: Plan) ------------------------------

CLUSTER = 8  # blocks per cluster: the split-K ranks of an item
SMEM_LIMIT = 232_448  # shared memory a block can use on an H100
_WARPS = 8
SEG = 64  # columns of a segment: one TMA box of 128 (bf16) or 64 (int8) bytes a row
_MAX_COLS = 256  # columns of a column-tile item
_FIXED_END = 64 + 2 * MAX_ROWS * 4 + _WARPS * MAX_HEAD_DIM * 4  # mbarriers, LN stats, reductions
_MLP_CLUSTERS = 16  # 128 of the card's 132 SMs


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class ProjPlan:
    """How one projection ``[K, N]`` is cut: ``kslice`` K rows per rank of a
    cluster, streamed in chunks of ``kch`` rows (``nch`` per rank; one chunk
    when the slice fits its ring, at most 256 rows, a TMA box's limit),
    ``ncols`` output columns per item made of ``nseg`` segments of
    ``SEG`` columns, each a swizzled ``[kch, SEG]`` tile of ``stride``-byte
    rows in a ring stage; ``segw`` columns of an item for one head's q (k,
    v) on attention's QKV; ``items`` items over the clusters; and whether a
    TMA tensor map can describe the weights (``tma``: 16-byte-aligned base
    and rows)."""

    kslice: int
    kch: int
    nch: int
    ncols: int
    segw: int
    nseg: int
    stride: int
    items: int
    tma: int

    def ring_bytes(self) -> int:
        return (1 if self.nch == 1 else 2) * self.nseg * self.kch * self.stride


@dataclass(frozen=True)
class Plan:
    """One launch: ``ncl`` clusters of ``C`` blocks, projection ``a`` (LN
    input: QKV or fc1) and ``b`` (out or fc2), the activation and partial
    tiles' row strides, whether the cached K/V rows of a block's attention
    rows are prefetched into shared memory, and the shared-memory offsets."""

    C: int
    ncl: int
    a: ProjPlan
    b: ProjPlan
    hs_stride: int
    p_stride: int
    kv_smem: int
    rows_per_rank: int
    off_ring_a: int
    off_ring_b: int
    off_hs: int
    off_part: int
    off_own: int
    off_sc: int
    off_kv: int
    smem: int

    def ints(self) -> list[int]:
        out = [self.C, self.ncl]
        for p in (self.a, self.b):
            out += [getattr(p, f.name) for f in dataclasses.fields(p)]
        return out + [getattr(self, f.name) for f in dataclasses.fields(self)[4:]]


def _hs_stride(nbytes: int) -> int:
    """Bytes an activation row takes: 16 mod 128, so that the 8 rows of an
    mma fragment fall in different banks."""
    stride = _up(nbytes, 16)
    while stride % 128 != 16:
        stride += 16
    return stride


def plan(kind: str, S: int, D: int, N: int, T: int, heads: int, wbytes: int, ncl: int,
         aligned: bool = True, C: int = CLUSTER, limit: int = SMEM_LIMIT) -> Plan | None:
    """The launch plan of one kernel at ``ncl`` clusters, or None if no
    chunking fits ``limit`` bytes of shared memory.

    ``kind`` "attn": projection a is the fused QKV ``[D, 3D]`` cut by head
    (one head's q, k and v columns per item), b the out projection
    ``[D, D]``; "mlp": a is fc1 ``[D, N]``, b fc2 ``[N, D]``.  ``aligned``:
    the operands' base addresses are 16-byte aligned (TMA).  Each projection's K
    rows split over the C ranks of a cluster; its first chunks, and for
    attention the cached K/V rows of a rank's rows of the head, are
    prefetched at kernel start where they fit; a slice larger than the
    budget streams through a ring of two chunks."""
    attn = kind == "attn"
    hd = D // heads if attn else 0
    S8 = 64 if S > 8 else 8  # activation rows of the mma tiles: 8, or 64
    rows_per_rank = -(-S // C)

    def proj(K, NN, ncols, segw, items):
        kslice = _up(-(-K // C), 16)
        kch = _chunk(kslice, 256)
        return ProjPlan(kslice, kch, kslice // kch, ncols, segw, ncols // SEG, SEG * wbytes,
                        items, int(aligned and (NN * wbytes) % 16 == 0))

    if attn:
        segw = _up(hd, SEG)
        a = proj(D, 3 * D, 3 * segw, segw, heads)
    else:
        ncols = min(_MAX_COLS, _up(-(-N // ncl), SEG))
        a = proj(D, N, ncols, SEG, -(-N // ncols))
    ncols_b = min(_MAX_COLS, _up(-(-D // ncl), SEG))
    b = proj(D if attn else N, D, ncols_b, SEG, -(-D // ncols_b))
    kv_ok = attn and aligned and D % 8 == 0 and hd % 8 == 0
    tb = min(T, 256)
    kv_region = _up(-(-T // tb) * tb * hd * 2, 128)

    def layout(a, b, kv, share_sc=False):
        """Offsets and total.  ``share_sc``: the scores reuse the partial
        tile, which every rank has read before attention starts."""
        off = _FIXED_END
        offs = {}
        hs_stride = _hs_stride(2 * max(a.kch, b.kch))
        part = S8 * (max(a.ncols, b.ncols) + 4) * 4
        sc = _up(T, 4) * 4 if attn else 0
        for name, size in (("ring_a", a.ring_bytes()), ("ring_b", b.ring_bytes()),
                           ("hs", S8 * hs_stride),
                           ("part", max(part, sc) if share_sc else part),
                           ("own", rows_per_rank * 3 * a.segw * 4 if attn else 0),
                           ("sc", 0 if share_sc else sc),
                           ("kv", rows_per_rank * 2 * kv_region if kv else 0)):
            off = _up(off, 1024 if name.startswith("ring") else 128)  # swizzle atoms
            offs[name] = off
            off += size
        if share_sc:
            offs["sc"] = offs["part"]
        return Plan(C, ncl, a, b, hs_stride, max(a.ncols, b.ncols) + 4, int(kv), rows_per_rank,
                    offs["ring_a"], offs["ring_b"], offs["hs"], offs["part"], offs["own"],
                    offs["sc"], offs["kv"], off)

    p = layout(a, b, kv_ok)
    share = False
    if p.smem > limit:
        p = layout(a, b, False)
    if p.smem > limit and attn:
        share = True
        p = layout(a, b, False, share)
    while p.smem > limit:
        # the larger ring takes the next smaller chunk
        rings = sorted((q.ring_bytes(), name) for name, q in (("a", p.a), ("b", p.b))
                       if q.kch > 16)
        if not rings:
            return None
        name = rings[-1][1]
        q = getattr(p, name)
        kch = _chunk(q.kslice, q.kch - 16)
        q = dataclasses.replace(q, kch=kch, nch=q.kslice // kch)
        p = layout(q if name == "a" else p.a, q if name == "b" else p.b, False, share)
    return p


def _chunk(kslice: int, most: int) -> int:
    """The largest multiple of 16 that divides ``kslice`` and is at most
    ``most``: a rank's chunks are then all full."""
    return max(k for k in range(16, min(most, kslice) + 1, 16) if kslice % k == 0)


def _segment_col(q: ProjPlan, D: int, hd: int, head_item: bool, item: int, sg: int) -> int:
    """The first weight column of segment ``sg`` of an item (csrc
    ``segment_col``): a head's q, k and v columns take ``nseg / 3``
    segments each, a column-tile item's segments lie side by side."""
    if not head_item:
        return item * q.ncols + sg * SEG
    per = q.nseg // 3
    return (sg // per) * D + item * hd + (sg % per) * SEG


def _chunk_rows(q: ProjPlan, K: int, rank: int, chunk: int) -> tuple[int, int]:
    """The K rows ``[k0, k1)`` of a rank's chunk (csrc ``chunk_rows``)."""
    s0 = rank * q.kslice
    k0 = s0 + chunk * q.kch
    return k0, max(k0, min(K, s0 + q.kslice, k0 + q.kch))


def assignments(p: Plan, kind: str, D: int, N: int, heads: int):
    """Every (projection, K rows, weight columns) whose products a block
    keeps, walked as the kernel walks them: its cluster's items, its rank's
    chunks, each chunk's segments of ``SEG`` columns, from the plan's own
    fields through the kernel's ``chunk_rows`` and ``segment_col``.  Of a
    segment, the columns its epilogue reads: those below N, or a head's
    first ``head_dim`` of its q (k, v) columns (at head_dim < SEG a box also
    reads the next head's columns, whose products are dropped).  Tests hold
    this to every weight byte exactly once."""
    attn = kind == "attn"
    hd = D // heads
    for name, q, K, NN in (("a", p.a, D, 3 * D if attn else N), ("b", p.b, D if attn else N, D)):
        head_item = attn and name == "a"
        for cid in range(p.ncl):
            for item in range(cid, q.items, p.ncl):
                for rank in range(p.C):
                    for c in range(q.nch):
                        k0, k1 = _chunk_rows(q, K, rank, c)
                        for sg in range(q.nseg):
                            col0 = _segment_col(q, D, hd, head_item, item, sg)
                            if head_item:
                                width = min(SEG, hd - (sg % (q.nseg // 3)) * SEG)
                            else:
                                width = min(SEG, NN - col0)
                            if k1 > k0 and width > 0:
                                yield name, k0, k1, col0, width


_plans: dict[tuple, tuple[Plan, ctypes.Array]] = {}


def _plan(kind: str, int8: bool, S: int, D: int, N: int, T: int, heads: int, aligned: bool,
          device: torch.device) -> tuple[Plan, ctypes.Array]:
    """The plan of one launch shape (cached), its cluster count checked
    against what the card can hold resident at that plan's shared memory."""
    key = (kind, int8, S, D, N, T, heads, aligned, device.index)
    if key not in _plans:
        ncl = heads if kind == "attn" else _MLP_CLUSTERS
        with torch.cuda.device(device):
            while True:
                p = plan(kind, S, D, N, T, heads, 1 if int8 else 2, ncl, aligned)
                if p is None:
                    raise ValueError(f"fused {kind} step: no shared-memory plan fits (S={S}, "
                                     f"D={D}, N={N}, T={T})")
                fits = _kernel_lib().fused_decode_clusters(int(kind == "mlp"), int(int8),
                                                           int(S > 8), p.C, p.smem)
                if fits < 0:
                    raise RuntimeError(f"fused {kind} step cannot be sized: CUDA error {-fits}")
                if fits >= ncl:
                    break
                if fits == 0:
                    raise RuntimeError(f"fused {kind} step: not one cluster of {p.C} blocks "
                                       f"with {p.smem} bytes of shared memory fits the card")
                ncl = fits
        _plans[key] = (p, (ctypes.c_int * len(p.ints()))(*p.ints()))
    return _plans[key]


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    aligned = _aligned(x, wqkv, wout, cache_k, cache_v)
    p, plan_ints = _plan("attn", int8, S, D, 3 * D, T, heads, aligned, x.device)
    ctx = torch.empty((S, D), dtype=x.dtype, device=x.device)
    x_out = torch.empty_like(x)
    rc = _kernel_lib().fused_attn_step_launch(
        int(int8), x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
        sqkv.data_ptr() if int8 else None, bqkv.data_ptr(), wout.data_ptr(),
        sout.data_ptr() if int8 else None, bout.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), pos.data_ptr(), mask_bias.data_ptr(), x_out.data_ptr(),
        ctx.data_ptr(), S, D, T, heads, eps, (D // heads) ** -0.5, plan_ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {launch_error(rc)} (S={S}, D={D}, "
                           f"T={T}, heads={heads}, plan={p})")
    (fused_attn_step_int8 if int8 else fused_attn_step).launches += 1
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
    f32 per-column scales."""
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p, plan_ints = _plan("mlp", int8, S, D, Fd, 1, 1, _aligned(x, w1, w2), x.device)
    h1 = torch.empty((S, Fd), dtype=x.dtype, device=x.device)
    x_out = torch.empty_like(x)
    rc = _kernel_lib().fused_mlp_step_launch(
        int(int8), x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
        s1.data_ptr() if int8 else None, b1.data_ptr(), w2.data_ptr(),
        s2.data_ptr() if int8 else None, b2.data_ptr(), x_out.data_ptr(), h1.data_ptr(),
        S, D, Fd, eps, int(approx_gelu), plan_ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {launch_error(rc)} (S={S}, D={D}, "
                           f"F={Fd}, plan={p})")
    (fused_mlp_step_int8 if int8 else fused_mlp_step).launches += 1
    return x_out


def fused_mlp_step(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5,
                   approx_gelu: bool = True):
    """One MLP block of one decode step, fused: LN + fc1 + GELU + fc2 +
    residual.  ``x [S, D]``; ``w1 [D, F]``; ``w2 [F, D]``; bf16 weights."""
    return _mlp(x, ln_scale, ln_bias, w1, b1, None, w2, b2, None, eps, approx_gelu)


def fused_mlp_step_int8(x, ln_scale, ln_bias, w1_q, b1, s1, w2_q, b2, s2, *,
                        eps: float = 1e-5, approx_gelu: bool = True):
    """W8A16 variant of :func:`fused_mlp_step`."""
    return _mlp(x, ln_scale, ln_bias, w1_q, b1, s1, w2_q, b2, s2, eps, approx_gelu)


# Launches of the CUDA kernels in this process, per entry point (the plain
# version on CPU tensors does not count): a run reads them to show the
# decode loop used the kernels.
for _fn in (fused_attn_step, fused_attn_step_int8, fused_mlp_step, fused_mlp_step_int8):
    counters.register(_fn)
