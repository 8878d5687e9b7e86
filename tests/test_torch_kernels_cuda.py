"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports only numpy, torch and the port, so the machine with the card runs
it without JAX and without the suite's conftest::

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances, int8_matmul: bf16 output ``rtol = atol = 2e-2`` (one bf16
rounding of an f32 accumulator, as tests/test_int8_matmul.py holds the TPU
kernel); f32 output ``atol = 1e-3 · max|y|`` (the summation order of an f32
accumulator).  flash_attention, per element ``|y - want| <= atol +
rtol·|want|``: bf16 ``atol = 2e-3, rtol = 2^-6`` (rtol is two bf16
roundings at the bottom of a binade, one on each side; atol covers outputs
near 0, where P rounded to bf16 against a running rather than the final max
is what differs); f32 ``atol = rtol = 1e-4`` (the kernel's exponential is
the special-function unit's, a few ulp from ``torch.exp``, and it sums per
64-key tile).  The bf16 cases include the redesigned kernel's tiling edges:
a Q tile cut short (Tq = 100), a ragged last K tile (Tk = 130), causal
128-row tiles, a head dim TMA cannot read in place (D = 20, copied by the
wrapper) and a fully masked batch row at 4096 tokens.  At [2, 4096, 8, 40]
the bf16 limit is ~2.3e-3 for the outputs' typical |y| of ~0.02, tight
enough to reject a kernel that takes sm_scale from a padded head dim (a
test below plants that fault).
fused_attn_step / fused_mlp_step: per element ``atol = 1e-3, rtol = 2^-7``
(``FUSED_TOL`` below gives the reasons), the K/V rows written at ``pos``
within one bf16 ulp and every other cache entry untouched.
"""

import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA
from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as P


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, k, n, device, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32) * 0.5
    w_q, scale = P.quantize_per_channel(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
    return (torch.from_numpy(x).to(device), torch.from_numpy(w_q).to(device),
            torch.from_numpy(scale).to(device))


# GPT-2 small's int8 layer projections (K, N): q|k|v fused, out, fc1, fc2.
GPT2_KN = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 768, 3072), (128, 3072, 768), (3, 100, 50),
                                   (1, 768, 768), (5, 36, 200),  # padded copies of x, w_q
                                   (8, 768, 50304)]              # the lm head
                         + [(m, k, n) for m in (1, 8, 16, 64, 512) for k, n in GPT2_KN])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
def test_int8_matmul_matches_plain(cuda_device, m, k, n, x_dtype, out_dtype):
    x, w_q, scale = _operands(m, k, n, cuda_device)
    x = x.to(x_dtype)
    before = P.int8_matmul.launches
    got = P.int8_matmul(x, w_q, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert P.int8_matmul.launches == before + 1
    want = P.int8_matmul_reference(x, w_q, scale, out_dtype)
    assert got.dtype == want.dtype and got.shape == (m, n)
    if out_dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    else:
        atol = 1e-3 * want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 768, 768), (1, 3072, 768), (16, 768, 2304),
                                   (128, 3072, 768), (1024, 3072, 768)])
def test_int8_matmul_split_k_is_deterministic(cuda_device, m, k, n):
    """The K slices are summed in fixed rank order: two launches agree bit
    for bit."""
    assert P.plan(m, k, n).splits > 1
    x, w_q, scale = _operands(m, k, n, cuda_device)
    x = x.bfloat16()
    first = P.int8_matmul(x, w_q, scale)
    assert all(torch.equal(first, P.int8_matmul(x, w_q, scale)) for _ in range(3))


@pytest.mark.cuda
def test_int8_matmul_refuses_too_few_registers(cuda_device):
    """A build whose consumers ask setmaxnreg for more registers than the
    block holds must refuse to launch (error 900002), not wait forever."""
    from pytorch_zappa_serverless_tpu_torch.tools import int8_ablation

    lib = int8_ablation.build("register_guard")
    x, w_q, scale = _operands(8, 768, 768, cuda_device)
    kernel_lib, before = P._kernel_lib, P.int8_matmul.launches
    P._kernel_lib = lambda: lib
    try:
        with pytest.raises(RuntimeError, match="too few registers"):
            P.int8_matmul(x.bfloat16(), w_q, scale)
    finally:
        P._kernel_lib = kernel_lib
    torch.cuda.synchronize()
    assert P.int8_matmul.launches == before


@pytest.mark.cuda
def test_int8_matmul_raises_on_what_the_kernel_does_not_take(cuda_device):
    x, w_q, scale = _operands(8, 64, 32, cuda_device)
    before = P.int8_matmul.launches
    with pytest.raises(ValueError, match="contiguous"):
        P.int8_matmul(x.bfloat16().t().contiguous().t(), w_q, scale)
    with pytest.raises(ValueError, match="different devices"):
        P.int8_matmul(x.bfloat16(), w_q.cpu(), scale)
    assert P.int8_matmul.launches == before


FLASH_TOL = {torch.bfloat16: (2e-3, 2 ** -6), torch.float32: (1e-4, 1e-4)}


def _qkv(b, tq, tk, h, d, dtype, device, seed=7):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, t, h, d, generator=g).to(device, dtype) for t in (tq, tk, tk))


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dtype,causal,masked", [
    (2, 4096, 4096, 8, 40, torch.bfloat16, False, False),   # SD-1.5 64x64 level
    (2, 1024, 1024, 8, 80, torch.bfloat16, False, False),   # SD-1.5 32x32 level
    (1, 1024, 1024, 4, 64, torch.bfloat16, False, False),
    (2, 1000, 1000, 2, 40, torch.bfloat16, False, True),    # ragged T, masked keys
    (1, 1000, 1000, 2, 40, torch.bfloat16, True, False),    # causal, ragged
    (1, 300, 77, 2, 64, torch.bfloat16, False, False),      # Tk < one tile
    (1, 300, 300, 2, 64, torch.float32, False, True),
    (1, 300, 300, 2, 40, torch.float32, True, False),
    (1, 128, 128, 1, 128, torch.float32, False, False),
    (2, 1024, 1024, 8, 160, torch.bfloat16, False, False),  # SD-1.5 32x32 at 1024x1024
    (1, 200, 200, 2, 160, torch.float32, False, True),
    (2, 100, 100, 2, 40, torch.bfloat16, False, False),    # Tq below one 128-row Q tile
    (1, 256, 130, 2, 64, torch.bfloat16, False, False),    # Tk: one 128-key tile + a ragged one
    (1, 256, 256, 2, 64, torch.bfloat16, True, False),     # causal on 128-row tiles
    (2, 1024, 1024, 8, 20, torch.bfloat16, False, False),  # D = 20: the wrapper's padded copy
    (2, 4096, 4096, 8, 40, torch.bfloat16, False, "row"),  # batch row 1 fully masked
])
def test_flash_attention_matches_plain(cuda_device, b, tq, tk, h, d, dtype, causal, masked):
    q, k, v = _qkv(b, tq, tk, h, d, dtype, cuda_device)
    mask = None
    if masked == "row":
        mask = torch.ones(b, tk, dtype=torch.bool, device=cuda_device)
        mask[1] = False
    elif masked:
        mask = torch.arange(tk, device=cuda_device)[None, :] < torch.tensor(
            [tk - 37 * i for i in range(b)], device=cuda_device)[:, None]
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    want = FA.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
    assert got.dtype == dtype and got.shape == (b, tq, h, d)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_flash_attention_tolerance_rejects_the_padded_scale(cuda_device):
    """At the 4096-token shape, a kernel that scales by 1/sqrt(48) (D = 40
    padded to 48) instead of 1/sqrt(40) must fail the check."""
    q, k, v = _qkv(2, 4096, 4096, 8, 40, torch.bfloat16, cuda_device)
    want = FA.flash_attention_reference(q, k, v).float()
    bad = FA.flash_attention(q, k, v, sm_scale=48 ** -0.5).float()
    atol, rtol = FLASH_TOL[torch.bfloat16]
    assert not torch.allclose(bad, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_flash_attention_fully_masked_row_is_uniform(cuda_device):
    q, k, v = _qkv(2, 256, 256, 2, 40, torch.bfloat16, cuda_device)
    mask = torch.ones(2, 256, dtype=torch.bool, device=cuda_device)
    mask[1] = False
    got = FA.flash_attention(q, k, v, kv_mask=mask).float()
    assert torch.isfinite(got).all()
    uniform = v[1].float().mean(0).expand_as(got[1])
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got[1], uniform, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_flash_attention_reads_strided_inputs(cuda_device):
    """q, k, v as head-split views of one fused [B, T, 3·C] projection."""
    qkv = torch.randn(2, 1024, 3 * 320, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = (t.view(2, 1024, 8, 40) for t in qkv.split(320, dim=-1))
    assert not q.is_contiguous()
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_reference(q, k, v)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv(1, 64, 64, 2, 40, torch.bfloat16, cuda_device)
    before = FA.flash_attention.launches
    with pytest.raises(TypeError, match="bf16 or f32"):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(*_qkv(1, 64, 64, 1, 192, torch.bfloat16, cuda_device))
    with pytest.raises(ValueError, match="last axis"):
        FA.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="different devices"):
        FA.flash_attention(q, k.cpu(), v)
    assert FA.flash_attention.launches == before


# fused decode steps, kernel vs plain version, per element |y - want| <=
# atol + rtol·|want|: rtol = 2^-7 is one bf16 ulp at the bottom of a binade
# (the two sides round nearly equal f32 sums to bf16 and may land one ulp
# apart); atol = 1e-3 covers outputs near 0, where a bf16 rounding of an
# intermediate (h, qkv, ctx, h1) that falls the other way moves the f32 sum by
# ~1e-4.  The cache rows written at pos[s] are bf16 roundings of q/k/v: within
# one ulp; every other cache entry is untouched, byte for byte.
FUSED_TOL = (1e-3, 2 ** -7)


def _fused_operands(S, D, H, T, F, int8, device, seed=8, pos=None):
    from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as FD

    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    def weight(k, n):
        w = rand(k, n, scale=0.02)
        if int8:
            w_q, s = P.quantize_per_channel(w.numpy())
            return torch.from_numpy(w_q).to(device), torch.from_numpy(s).to(device)
        return w.to(device, torch.bfloat16), None

    if pos is None:
        pos = torch.randint(0, T, (S,), generator=g)
    pos = torch.as_tensor(pos, dtype=torch.int32)
    mask = (torch.arange(T)[:, None, None] <= pos[None, :, None].long())
    ops = {"x": rand(S, D).to(device, torch.bfloat16),
           "ln_scale": (1 + rand(D, scale=0.1)).to(device), "ln_bias": rand(D, scale=0.1).to(device),
           "bqkv": rand(3 * D, scale=0.01).to(device), "bout": rand(D, scale=0.01).to(device),
           "b1": rand(F, scale=0.01).to(device), "b2": rand(D, scale=0.01).to(device),
           "cache_k": rand(T, S, D, scale=0.5).to(device, torch.bfloat16),
           "cache_v": rand(T, S, D, scale=0.5).to(device, torch.bfloat16),
           "pos": pos.to(device),
           "mask_bias": torch.where(mask, 0.0, -1e9).float().to(device)}
    for name, (k, n) in {"wqkv": (D, 3 * D), "wout": (D, D), "w1": (D, F), "w2": (F, D)}.items():
        ops[name], ops["s" + name[1:]] = weight(k, n)
    return FD, ops


def _attn_call(FD, o, H, kernel, int8):
    ck, cv = o["cache_k"].clone(), o["cache_v"].clone()
    if int8:
        fn = FD.fused_attn_step_int8 if kernel else FD.fused_attn_step_reference
        if kernel:
            return fn(o["x"], o["ln_scale"], o["ln_bias"], o["wqkv"], o["bqkv"], o["sqkv"],
                      o["wout"], o["bout"], o["sout"], ck, cv, o["pos"], o["mask_bias"],
                      heads=H)
        return fn(o["x"], o["ln_scale"], o["ln_bias"], o["wqkv"], o["bqkv"], o["wout"],
                  o["bout"], ck, cv, o["pos"], o["mask_bias"], heads=H, sqkv=o["sqkv"],
                  sout=o["sout"])
    fn = FD.fused_attn_step if kernel else FD.fused_attn_step_reference
    return fn(o["x"], o["ln_scale"], o["ln_bias"], o["wqkv"], o["bqkv"], o["wout"], o["bout"],
              ck, cv, o["pos"], o["mask_bias"], heads=H)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,H,T", [(8, 768, 12, 96), (1, 768, 12, 96), (3, 768, 12, 96),
                                     (8, 768, 12, 1), (64, 768, 12, 96), (8, 128, 4, 32),
                                     (5, 384, 3, 200),
                                     # one row, all rows; one key, 1024 keys
                                     (1, 768, 12, 1), (64, 768, 12, 1), (1, 768, 12, 1024),
                                     (64, 768, 12, 1024),
                                     # an odd head count whose rows no bulk copy can
                                     # address (hd 12)
                                     (3, 60, 5, 7),
                                     # QKV and out slices past the shared-memory budget: the ring
                                     (8, 4096, 32, 96),
                                     # 64 rows at head_dim 128: the scores share the partials
                                     (64, 1024, 8, 4096)])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_attn_step_matches_plain(cuda_device, S, D, H, T, int8):
    FD, o = _fused_operands(S, D, H, T, 4 * D, int8, cuda_device)
    counter = FD.fused_attn_step_int8 if int8 else FD.fused_attn_step
    before = counter.launches
    x, ck, cv = _attn_call(FD, o, H, True, int8)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    wx, wk, wv = _attn_call(FD, o, H, False, int8)
    assert x.dtype == torch.bfloat16 and x.shape == (S, D) and torch.isfinite(x.float()).all()
    atol, rtol = FUSED_TOL
    torch.testing.assert_close(x.float(), wx.float(), rtol=rtol, atol=atol)
    rows = torch.arange(S, device=cuda_device)
    at = o["pos"].long()
    for got, want, before_c in ((ck, wk, o["cache_k"]), (cv, wv, o["cache_v"])):
        torch.testing.assert_close(got[at, rows].float(), want[at, rows].float(),
                                   rtol=2 ** -7, atol=1e-6)
        got, before_c = got.clone(), before_c.clone()
        got[at, rows] = 0
        before_c[at, rows] = 0
        assert torch.equal(got, before_c)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_fused_attn_step_edges(cuda_device, int8):
    """pos = 0 and T-1, and a fully masked row (finite, uniform over keys)."""
    S, D, H, T = 4, 768, 12, 96
    FD, o = _fused_operands(S, D, H, T, 4 * D, int8, cuda_device, pos=[0, T - 1, 0, 7])
    o["mask_bias"][:, 3] = -1e9  # row 3 sees no key
    x, _, _ = _attn_call(FD, o, H, True, int8)
    wx, _, _ = _attn_call(FD, o, H, False, int8)
    assert torch.isfinite(x.float()).all()
    atol, rtol = FUSED_TOL
    torch.testing.assert_close(x.float(), wx.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,F", [(8, 768, 3072), (1, 768, 3072), (3, 768, 3072),
                                   (64, 768, 3072), (5, 384, 1000),
                                   # fc2's K slice past the budget: the ring
                                   (8, 768, 16384), (64, 768, 16384),
                                   # rows no bulk copy can address
                                   (2, 60, 200)])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_mlp_step_matches_plain(cuda_device, S, D, F, int8):
    FD, o = _fused_operands(S, D, 12 if D % 12 == 0 else 3, 8, F, int8, cuda_device)
    args = (o["x"], o["ln_scale"], o["ln_bias"], o["w1"], o["b1"])
    counter = FD.fused_mlp_step_int8 if int8 else FD.fused_mlp_step
    before = counter.launches
    if int8:
        x = FD.fused_mlp_step_int8(*args, o["s1"], o["w2"], o["b2"], o["s2"])
        want = FD.fused_mlp_step_reference(*args, o["w2"], o["b2"], s1=o["s1"], s2=o["s2"])
    else:
        x = FD.fused_mlp_step(*args, o["w2"], o["b2"])
        want = FD.fused_mlp_step_reference(*args, o["w2"], o["b2"])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    atol, rtol = FUSED_TOL
    torch.testing.assert_close(x.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_fused_decode_raises_on_what_the_kernel_does_not_take(cuda_device):
    FD, o = _fused_operands(8, 768, 12, 96, 3072, False, cuda_device)
    counters = (FD.fused_attn_step, FD.fused_attn_step_int8, FD.fused_mlp_step,
                FD.fused_mlp_step_int8)
    before = [c.launches for c in counters]
    base = dict(o)
    cases = [({"x": o["x"].float()}, TypeError, "bf16"),
             ({"wqkv": o["wqkv"].t().contiguous().t()}, ValueError, "contiguous"),
             ({"bqkv": o["bqkv"].cpu()}, ValueError, "different devices"),
             ({"pos": o["pos"].long()}, TypeError, "int32")]
    for change, exc, match in cases:
        o = {**base, **change}
        with pytest.raises(exc, match=match):
            FD.fused_attn_step(o["x"], o["ln_scale"], o["ln_bias"], o["wqkv"], o["bqkv"],
                               o["wout"], o["bout"], o["cache_k"], o["cache_v"], o["pos"],
                               o["mask_bias"], heads=12)
    o = base
    with pytest.raises(TypeError, match="int8"):
        FD.fused_mlp_step_int8(o["x"], o["ln_scale"], o["ln_bias"], o["w1"], o["b1"],
                               o["b1"], o["w2"], o["b2"], o["b2"])
    with pytest.raises(ValueError, match="rows"):
        big = torch.zeros(65, 768, dtype=torch.bfloat16, device=cuda_device)
        FD.fused_mlp_step(big, o["ln_scale"], o["ln_bias"], o["w1"], o["b1"], o["w2"], o["b2"])
    assert [c.launches for c in counters] == before


@pytest.mark.cuda
def test_gpt2_float_lm_head_returns_the_f32_accumulator(cuda_device):
    """The float lane's tied lm head on a bf16 table (``params_dtype:
    bfloat16``): bf16 products summed in f32 and returned in f32, never
    rounded to bf16, as the JAX package's ``preferred_element_type=f32``.
    Against the same exact products summed in f64: within f32 summation
    error (1e-5 of the largest logit; a bf16 rounding is ~2e-3 of a logit)."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G

    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 768, generator=g).to(cuda_device, torch.bfloat16)
    wte = (torch.randn(50257, 768, generator=g) * 0.02).to(cuda_device, torch.bfloat16)
    got = G._logits({"wte": wte}, x)
    want = x.double() @ wte.double().t()
    assert got.dtype == torch.float32 and got.shape == (8, 50257)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["hs over ring b", "smem short", "partial rows short"])
def test_fused_decode_refuses_a_plan_out_of_place(cuda_device, monkeypatch, fault):
    """The kernel checks the plan's shared-memory layout against the sizes it
    indexes: a region over the one before it, a total past smem or a partial
    tile narrower than an item is refused before the launch."""
    import ctypes
    import dataclasses

    FD, o = _fused_operands(8, 768, 12, 96, 3072, False, cuda_device)
    aligned = True
    for kind, N, T, H in (("attn", 3 * 768, 96, 12), ("mlp", 3072, 1, 1)):
        p, _ = FD._plan(kind, False, 8, 768, N, T, H, aligned, o["x"].device)
        bad = {"hs over ring b": dataclasses.replace(p, off_hs=p.off_ring_b),
               "smem short": dataclasses.replace(p, smem=p.smem - 128),
               "partial rows short": dataclasses.replace(p, p_stride=p.p_stride - 16)}[fault]
        key = (kind, False, 8, 768, N, T, H, aligned, o["x"].device.index)
        monkeypatch.setitem(FD._plans, key, (bad, (ctypes.c_int * 32)(*bad.ints())))
    before = (FD.fused_attn_step.launches, FD.fused_mlp_step.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        _attn_call(FD, o, 12, True, False)
    with pytest.raises(RuntimeError, match="launch failed"):
        FD.fused_mlp_step(o["x"], o["ln_scale"], o["ln_bias"], o["w1"], o["b1"], o["w2"],
                          o["b2"])
    assert (FD.fused_attn_step.launches, FD.fused_mlp_step.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_fused_steps_are_bitwise_repeatable(cuda_device, int8):
    """Two launches on the same inputs give the same bytes: the split-K sums
    run in a fixed rank order, with no atomics."""
    S, D, H, T, F = 8, 768, 12, 96, 3072
    FD, o = _fused_operands(S, D, H, T, F, int8, cuda_device)
    runs = [_attn_call(FD, o, H, True, int8) for _ in range(2)]
    torch.cuda.synchronize()
    for got, again in zip(*runs):
        assert torch.equal(got, again)
    args = (o["x"], o["ln_scale"], o["ln_bias"], o["w1"], o["b1"])
    if int8:
        mlps = [FD.fused_mlp_step_int8(*args, o["s1"], o["w2"], o["b2"], o["s2"]) for _ in range(2)]
    else:
        mlps = [FD.fused_mlp_step(*args, o["w2"], o["b2"]) for _ in range(2)]
    assert torch.equal(mlps[0], mlps[1])
