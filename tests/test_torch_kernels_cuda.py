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
Captured CUDA graphs (``engine.compiled``), on tiny BERT, GPT-2 and SD-1.5
configurations and the bench lanes: a replay equals the eager run byte for
byte, batches replayed in turn each give their own result, interleaved SD
jobs keep their own state, and the counters add exactly a graph's launches
per replay; the Gumbel draw's bits are the same on the CPU and the card.
The vision classifiers' captured graphs (ResNet-18/50, EfficientNet-B0 at
64x64) replay as their eager forward byte for byte, and their top-k orders
ties as on the CPU.  The :generate lanes' graphs (``engine/genkernels.py``:
prefill, insert, segment, paged chunk and page copy) replay as the same
calls run eagerly on a second pool, byte for byte; an insert reads its row
and slot from device scalars; and a stream's tokens are the same in any
slot.  An adapter slot written in place under a captured bucket graph
serves the tenant at the next replay with no capture, and zeroed gives the
base's bytes back; the regime-routed lane's shared leaves have one address
on the card, after the move and after a host-tier restore.  A fleet router
(``cli fleet --spawn 2``) in front of two replica processes on the card
answers as the replica it routed to, and the replicas' ``int8_matmul``
counts move by exactly the bucket graph's launches a routed forward.  A
mesh of one (a world of one rank over NCCL) captures its collectives in its
bucket graphs and replays as its eager forward and the meshless model, byte
for byte.
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


# Whisper-tiny's int8 decoder products (K, N): q/k/v/out/cq/cout, fc1, fc2,
# and the padded lm head with f32 logits; at decode M = B (1, 4), at the
# prompt's prefill M = 4B (4, 16).  At K = 384 the split-K plans give each
# cluster rank exactly one 64-wide K tile.
WHISPER_KN = [(384, 384), (384, 1536), (1536, 384)]
WHISPER_HEAD = (384, 51968)
WHISPER_PLANS = {(384, 384): (64, 32, 6, 6), (384, 1536): (64, 64, 6, 6),
                 (1536, 384): (64, 32, 8, 8), WHISPER_HEAD: (64, 128, 1, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", WHISPER_KN + [WHISPER_HEAD])
def test_int8_matmul_whisper_shapes(cuda_device, m, k, n):
    assert tuple(P.plan(m, k, n)) == WHISPER_PLANS[k, n]
    out_dtype = torch.float32 if (k, n) == WHISPER_HEAD else torch.bfloat16
    x, w_q, scale = _operands(m, k, n, cuda_device, seed=m + k)
    x = x.bfloat16()
    got = P.int8_matmul(x, w_q, scale, out_dtype=out_dtype)
    want = P.int8_matmul_reference(x, w_q, scale, out_dtype)
    if out_dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 768, 768), (1, 3072, 768), (16, 768, 2304),
                                   (128, 3072, 768), (1024, 3072, 768),
                                   (4, 384, 384), (4, 384, 1536), (16, 1536, 384)])
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


# -- captured CUDA graphs (engine.compiled) ---------------------------------------
#
# A bucket's captured graph replays the same kernels in the same order as an
# eager run of its apply_fn, so the two agree byte for byte; the counters
# count device executions (an eager run counts, a capture none, each replay
# what the graph holds).

TINY_BERT = {"num_layers": 2, "num_heads": 2, "head_dim": 64, "mlp_dim": 256,
             "vocab_size": 512, "max_position": 64}
TINY_GPT2 = {"vocab_size": 512, "d_model": 128, "layers": 2, "heads": 2, "ffn_dim": 256,
             "max_positions": 128, "eos_id": 511}


def _engine(name, **kw):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    return build_engine(ServeConfig(models=[ModelConfig(name=name, **kw)]), device="cuda")


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(x.dtype == b[k].dtype and x.shape == b[k].shape
                                        and x.tobytes() == b[k].tobytes()
                                        for k, x in a.items())


def _replays_in_turn(eng, name, batches, per_replay):
    """Every batch replayed in turn, twice, each against its eager result,
    and each replay's counts exactly ``per_replay``."""
    from pytorch_zappa_serverless_tpu_torch.ops import counters

    cm = eng.model(name)
    run = eng.runner.run_fn_sync
    eager = [run(cm.forward_eager, b) for b in batches]
    for b in batches:
        run(cm.forward, b)  # captured, where new
    for _ in range(2):
        for b, want in zip(batches, eager):
            before = counters.snapshot()
            got = run(cm.forward, b)
            assert counters.delta(before) == {k: per_replay.get(k, 0) for k in before}
            assert _same(got, want)
    return cm


@pytest.mark.cuda
def test_capture_counts_the_eager_run_and_each_replay(cuda_device):
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import capture

    x, w_q, scale = _operands(8, 768, 768, cuda_device)
    x = x.bfloat16()
    before = P.int8_matmul.launches
    with torch.inference_mode():
        cap = capture(lambda: P.int8_matmul(P.int8_matmul(x, w_q, scale), w_q, scale),
                      cuda_device)
        assert P.int8_matmul.launches == before + 2  # the eager warm-up run only
        assert cap.launches["int8_matmul"] == 2
        got = cap.replay().clone()
        assert P.int8_matmul.launches == before + 4
        want = P.int8_matmul(P.int8_matmul(x, w_q, scale), w_q, scale)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_host_read_under_capture_raises(cuda_device):
    """No eager fallback: a capture that reads the device on the host raises,
    and the card stays usable."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import capture

    x = torch.ones(8, device=cuda_device)
    with pytest.raises(RuntimeError):
        capture(lambda: bool((x * 2).sum() > 0), cuda_device)
    assert (x * 2).sum().item() == 16.0


@pytest.mark.cuda
def test_noise_bits_are_the_same_on_cpu_and_cuda(cuda_device):
    from pytorch_zappa_serverless_tpu_torch.ops import sampling as PS

    seeds = torch.tensor([0, 7, -3, 2**31 - 1], dtype=torch.int32)
    t = torch.tensor([0, 1, 31, 5], dtype=torch.int32)
    cpu = PS.uniform_bits(seeds, t, 50257)
    assert torch.equal(PS.uniform_bits(seeds.to(cuda_device), t.to(cuda_device), 50257).cpu(),
                       cpu)
    g = PS.gumbel_noise(seeds, t, 50257, cuda_device)
    assert g.is_cuda and torch.isfinite(g).all()
    torch.testing.assert_close(g.cpu(), PS.gumbel_noise(seeds, t, 50257, torch.device("cpu")),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_bert_graphs_replay_as_eager(cuda_device):
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    eng = _engine("bert_base", dtype="bfloat16", seq_buckets=(16,), batch_buckets=(1, 4),
                  extra={"arch": TINY_BERT, "params_dtype": "int8"})
    try:
        cm = eng.model("bert_base")
        assert cm.graphs == ["(1, 16)", "(4, 16)"]
        samples = [cm.servable.preprocess({"text": " ".join(["word"] * (3 + i))})
                   for i in range(4)]
        batches = [default_collate(samples[:1], (1, 16), cm.servable.input_spec((1, 16))),
                   default_collate(samples, (4, 16), cm.servable.input_spec((4, 16))),
                   default_collate(samples[2:], (4, 16), cm.servable.input_spec((4, 16)))]
        _replays_in_turn(eng, "bert_base", batches, {"int8_matmul": 6 * 2})
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_gpt2_variants_replay_as_eager(cuda_device):
    """Greedy (captured at warm-up) and a sampled, filtered variant (captured
    lazily, on the clock) at both buckets."""
    eng = _engine("gpt2", dtype="bfloat16", seq_buckets=(8,), batch_buckets=(1, 4),
                  extra={"arch": TINY_GPT2, "params_dtype": "int8", "max_new_tokens": 5,
                         "quantize_min_size": 1024})
    try:
        cm = eng.model("gpt2")
        assert cm.graphs == ["(1, 8) greedy", "(4, 8) greedy"]
        sv = cm.servable

        def batch(bodies, bucket):
            return sv.meta["collate"]([sv.preprocess(b) for b in bodies], bucket,
                                      sv.input_spec(bucket))

        greedy = [{"input_ids": list(range(3 + i, 8 + i))} for i in range(4)]
        sampled = [{**b, "temperature": 0.9, "top_k": 20, "top_p": 0.9, "seed": i}
                   for i, b in enumerate(greedy)]
        _replays_in_turn(eng, "gpt2", [batch(greedy[:1], (1, 8)), batch(sampled[:1], (1, 8)),
                                       batch(greedy, (4, 8)), batch(sampled[1:], (4, 8)),
                                       batch(greedy[1:3], (4, 8))],
                         {"int8_matmul": (4 * 2 + 1) * (1 + 5)})
        assert "(4, 8) sampled+filtered" in cm.graphs
        assert [1, 8, "sampled+filtered"] in [e["bucket"] for e in eng.clock.entries]
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_sd_chunk_graph_keeps_interleaved_jobs_apart(cuda_device):
    """Two jobs' chunks taking turns on the one chunk graph give each job's
    own latents, byte for byte those of the job run alone; each replay adds
    the launches of one eager chunk (the flash route at 32x32 latents)."""
    from pytorch_zappa_serverless_tpu_torch.ops import counters

    eng = _engine("sd15", dtype="bfloat16", batch_buckets=(1,),
                  extra={"variant": "tiny", "height": 256, "width": 256, "num_steps": 4,
                         "chunk_steps": 2})
    try:
        cm = eng.model("sd15")
        ch = cm.servable.meta["chunked"]
        jobs = [[cm.servable.preprocess({"prompt": p, "seed": i})]
                for i, p in enumerate(("a red fox", "a blue boat"))]
        run = eng.runner.run_fn_sync

        def alone(samples):
            _, state = cm.chunk_prepare(samples)
            for rows in ch["chunk_rows"]:
                state = cm.chunk_step(state, rows)
            return state["latents"].cpu()

        def interleaved():
            states = [cm.chunk_prepare(s)[1] for s in jobs]
            for rows in ch["chunk_rows"]:
                states = [cm.chunk_step(st, rows) for st in states]
            return [st["latents"].cpu() for st in states]

        def eager_chunk_launches():
            _, state = cm.chunk_prepare(jobs[0])
            before = counters.snapshot()
            with torch.inference_mode():
                ch["chunk"](cm.servable.module.tree(), state, ch["chunk_rows"][0])
            return counters.delta(before)

        want = [run(alone, s) for s in jobs]
        assert all(torch.equal(a, b) for a, b in zip(run(interleaved), want))
        per_chunk = run(eager_chunk_launches)
        assert per_chunk["flash_attention"] > 0 and per_chunk["unet_apply"] == 2

        def one_replay():
            _, state = cm.chunk_prepare(jobs[1])
            before = counters.snapshot()
            cm.chunk_step(state, ch["chunk_rows"][0])
            return counters.delta(before)

        assert run(one_replay) == per_chunk
        assert len([g for g in cm.graphs if g.startswith("chunk")]) == 1
    finally:
        eng.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("lane_name", ["seg1", "fused", "fused_int8"])
def test_bench_lane_graph_replays_as_eager(cuda_device, lane_name):
    import dataclasses

    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    cfg = dataclasses.replace(G.SMALL, **TINY_GPT2)
    lane = BF.build_lanes(cfg, cuda_device)[lane_name]
    BF.step_graph(lane, cfg)
    start = lane.state()
    eager = [BF.eager_step(lane, cfg) for _ in range(8)]
    after = lane.state()
    lane.set_state(start)
    replayed = [BF.step(lane, cfg).clone() for _ in range(8)]
    assert all(torch.equal(a, b) for a, b in zip(eager, replayed))
    assert all(torch.equal(a, b) for a, b in zip(after, lane.state()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet18", "resnet50", "efficientnet_b0"])
def test_vision_graphs_replay_as_eager(cuda_device, name):
    """Each bucket's captured graph (normalize, the bf16 channels_last
    convolutions, softmax, top-k) equals the eager forward byte for byte:
    the capture and the eager run take the same cuDNN algorithms.  No kernel
    of the port runs on this path."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    eng = _engine(name, dtype="bfloat16", batch_buckets=(1, 4),
                  extra={"image_size": 64, "resize_to": 72})
    try:
        cm = eng.model(name)
        assert cm.graphs == ["(1,)", "(4,)"]
        rng = np.random.default_rng(0)
        samples = [cm.servable.preprocess(rng.integers(0, 256, (64, 64, 3), np.uint8))
                   for _ in range(4)]
        batches = [default_collate(samples[:1], (1,), cm.servable.input_spec((1,))),
                   default_collate(samples, (4,), cm.servable.input_spec((4,))),
                   default_collate(samples[1:], (4,), cm.servable.input_spec((4,)))]
        cm = _replays_in_turn(eng, name, batches, {})
        out = eng.runner.run_fn_sync(cm.forward, batches[1])["topk_packed"]
        assert out.shape == (4, 10) and np.isfinite(out).all()
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_vision_topk_orders_ties_as_on_the_cpu(cuda_device):
    """Among equal probabilities the lower index first on the card too (the
    stable sort), as ``jax.lax.top_k`` and the CPU order them."""
    from pytorch_zappa_serverless_tpu_torch.models.vision_common import topk_first_index

    rng = np.random.default_rng(1)
    probs = torch.from_numpy(rng.integers(0, 4, (32, 1000)).astype(np.float32) / 4)
    probs[5] = 0.0
    want = topk_first_index(probs, 5)
    got = topk_first_index(probs.to(cuda_device), 5)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert got[1][5].tolist() == [0, 1, 2, 3, 4]


TINY_WHISPER = {"d_model": 128, "encoder_layers": 2, "decoder_layers": 2, "heads": 2,
                "ffn_dim": 256, "vocab_size": 512, "target_positions": 96}


@pytest.mark.cuda
@pytest.mark.parametrize("params_dtype", ["int8", None])
def test_whisper_graphs_replay_as_eager(cuda_device, params_dtype):
    """Each bucket's captured graph (the encoder, cross K/V, the prompt's
    prefill and every greedy step) equals the eager call byte for byte; on
    the int8 lane each replay runs (8 x 2 + 1) x (1 + 6) int8 products."""
    rng = np.random.default_rng(0)
    extra = {"arch": TINY_WHISPER, "max_new_tokens": 6, "quantize_min_size": 1024,
             **({"params_dtype": params_dtype} if params_dtype else {})}
    eng = _engine("whisper_tiny", dtype="bfloat16", batch_buckets=(1, 2), extra=extra)
    try:
        mels = rng.standard_normal((3, 80, 3000)).astype(np.float32)
        batches = [{"mel": mels[:1]}, {"mel": mels[:2]}, {"mel": mels[1:]}]
        per = {"int8_matmul": 17 * 7} if params_dtype else {}
        cm = _replays_in_turn(eng, "whisper_tiny", batches, per)
        assert cm.graphs == ["(1,)", "(2,)"]
        out = eng.runner.run_fn_sync(cm.forward, batches[1])["tokens"]
        assert out.shape == (2, 6) and out.dtype == np.int32
    finally:
        eng.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("name,extra", [
    ("vit_b16", {"image_size": 64, "arch": {"num_layers": 2}}),
    ("bert_embed", {"arch": TINY_BERT})])
def test_vit_and_bert_embed_graphs_replay_as_eager(cuda_device, name, extra):
    """ViT and ``bert_embed`` run no kernel of the port; their captured
    graphs equal the eager call byte for byte."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    rng = np.random.default_rng(1)
    eng = _engine(name, dtype="bfloat16", batch_buckets=(1, 4), seq_buckets=(32,), extra=extra)
    try:
        cm = eng.model(name)
        if name == "vit_b16":
            samples = [cm.servable.preprocess(rng.integers(0, 256, (64, 64, 3), np.uint8))
                       for _ in range(4)]
            buckets = [(1,), (4,), (4,)]
        else:
            samples = [cm.servable.preprocess({"input_ids": rng.integers(1, 500, n).tolist()})
                       for n in (5, 32, 17, 9)]
            buckets = [(1, 32), (4, 32), (4, 32)]
        parts = [samples[:1], samples, samples[1:]]
        batches = [default_collate(p, b, cm.servable.input_spec(b))
                   for p, b in zip(parts, buckets)]
        _replays_in_turn(eng, name, batches, {})
    finally:
        eng.shutdown()


# The :generate lanes' graphs (engine/genkernels.py), each against the same
# program run eagerly on a second pool: outputs and pools byte for byte
# (the paged pool but its trash page, whose colliding writes are unordered).

GEN = {"gen_slots": 4, "segment_tokens": 3, "quantize_min_size": 1024}


def _gen_cm(name, params_dtype, **kw):
    if name == "gpt2":
        extra = {"arch": TINY_GPT2, "max_new_tokens": 8, **GEN}
        eng = _engine("gpt2", dtype="bfloat16", batch_buckets=(1,), seq_buckets=(8, 16),
                      extra={**extra, **({"params_dtype": params_dtype} if params_dtype else {})},
                      **kw)
    else:
        extra = {"arch": TINY_WHISPER, "max_new_tokens": 8, **GEN}
        eng = _engine("whisper_tiny", dtype="bfloat16", batch_buckets=(1,),
                      extra={**extra, **({"params_dtype": params_dtype} if params_dtype else {})},
                      **kw)
    return eng, eng.model(name)


def _admit_payload(cm, rng, n):
    meta = cm.servable.meta["continuous"]
    if "input_ids" in meta["admit_spec"](8):
        samples = [cm.servable.preprocess({"input_ids": rng.integers(1, 500, k).tolist(),
                                           "temperature": t, "seed": 3, "top_k": 5})
                   for k, t in zip((5, 8, 3, 7)[:n], (0.0, 1.2, 0.0, 0.9))]
        parts = [meta["collate_admit"](s, 8) for s in samples]
    else:
        parts = [{**meta["collate_admit"]({"mel": rng.standard_normal((80, 3000))
                                                  .astype(np.float32)}, 1),
                  "temperature": np.asarray([t], np.float32)}
                 for t in (0.0, 1.2, 0.0, 0.9)[:n]]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _carries(S, active, first, payload):
    c = {"tok": np.full(S, 0, np.int32), "pos": np.zeros(S, np.int32),
         "step": np.zeros(S, np.int32), "fin": np.ones(S, bool),
         "temp": np.zeros(S, np.float32), "seed": np.zeros(S, np.int32),
         "topk": np.zeros(S, np.int32), "topp": np.ones(S, np.float32)}
    for j, slot in enumerate(active):
        c["tok"][slot], c["pos"][slot], c["fin"][slot] = first[j], payload["length"][j], False
        c["temp"][slot], c["seed"][slot] = payload["temperature"][j], payload["seed"][j]
        c["topk"][slot], c["topp"][slot] = payload["top_k"][j], payload["top_p"][j]
    return c


def _bits(t: torch.Tensor) -> bytes:
    return t.cpu().view(torch.uint8 if t.element_size() == 1 else torch.int16
                        if t.element_size() == 2 else torch.int32).numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name,params_dtype", [("gpt2", "int8"), ("gpt2", None),
                                               ("whisper_tiny", "int8")])
def test_slot_lane_graphs_replay_as_eager(cuda_device, name, params_dtype):
    """Prefill (a batch of 2), two inserts and two segments (one greedy and
    one sampled, filtered row) replayed against the same calls eagerly:
    first tokens, packed emits and carries, and the pools byte for byte; a
    segment replay runs 3 positions' int8 products on the int8 lane."""
    from pytorch_zappa_serverless_tpu_torch.engine.genkernels import SlotKernels, unpack

    eng, cm = _gen_cm(name, params_dtype)
    try:
        run = eng.runner.run_fn_sync
        rng = np.random.default_rng(0)
        payload = _admit_payload(cm, rng, 2)
        sets = [SlotKernels(cm), SlotKernels(cm, graphed=False)]
        assert sets[0].graphs.graphed and not sets[1].graphs.graphed
        outs = []
        for k in sets:
            run(k.ensure)
            first = run(k.prefill, payload)
            run(k.insert_from, 1, 3)
            run(k.insert_from, 0, 0)
            c = _carries(4, [0, 3], first, payload)
            segs = []
            for _ in range(2):
                out = run(k.segment, c)
                segs.append(out)
                _, c["tok"], c["pos"], c["step"], c["fin"] = unpack(out, 3)
            outs.append((first, segs, _bits(k.cache_k), _bits(k.cache_v)))
        (f0, s0, k0, v0), (f1, s1, k1, v1) = outs
        assert f0.tobytes() == f1.tobytes()
        assert all(a.tobytes() == b.tobytes() for a, b in zip(s0, s1))
        assert k0 == k1 and v0 == v1
        per = sets[0].graphs.per_run
        seg_keys = [key for key in per if key[0] == "segment"]
        assert len(seg_keys) == 1 and per[("insert",)] == {k: 0 for k in per[("insert",)]}
        layers = 2
        want = (8 * layers + 1 if name == "whisper_tiny" else 4 * layers + 1) * 3
        assert per[seg_keys[0]]["int8_matmul"] == (want if params_dtype else 0)
        assert set(sets[0].graphs.labels) <= set(cm.graphs)
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_insert_reads_its_slot_and_row_from_device_scalars(cuda_device):
    """An insert into slot 3 after one into slot 0 writes slot 3 (and
    leaves slot 0 as it was): ``j`` and ``slot`` are static inputs, not
    host ints baked into the capture."""
    from pytorch_zappa_serverless_tpu_torch.engine.genkernels import SlotKernels

    eng, cm = _gen_cm("gpt2", "int8")
    try:
        run = eng.runner.run_fn_sync
        k = SlotKernels(cm)
        run(k.ensure)
        rng = np.random.default_rng(1)
        run(k.prefill, _admit_payload(cm, rng, 1))
        run(k.insert_from, 0, 0)
        slot0 = k.cache_k[:, 0].clone()
        run(k.prefill, _admit_payload(cm, rng, 2))
        run(k.insert_from, 1, 3)
        torch.cuda.synchronize()
        assert torch.equal(k.cache_k[:, 3], k.stage_k[:, 1])
        assert torch.equal(k.cache_k[:, 0], slot0)
        assert not torch.equal(k.cache_k[:, 3], slot0)
        assert cm.graphs.count("generate insert") == 1
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_paged_lane_graphs_replay_as_eager(cuda_device):
    """Two chunks of one prompt and one of another (two chunk graphs), a
    copy-on-write page copy and two segments, replayed against the same
    calls eagerly: outputs and every page but the trash page byte for
    byte."""
    from pytorch_zappa_serverless_tpu_torch.engine.genkernels import PagedKernels, unpack

    eng, cm = _gen_cm("gpt2", "int8", kv_cache="paged", kv_block_size=4)
    try:
        run = eng.runner.run_fn_sync
        rng = np.random.default_rng(2)
        MB = 6  # ceil((16 + 8) / 4)
        ids = rng.integers(1, 500, 12).astype(np.int32)
        # Every position a row writes has a page of its own: only the pad
        # row and the finished rows write the trash page.
        table = np.zeros((1, MB), np.int32)
        table[0, :5] = [1, 2, 3, 4, 8]
        table_b = np.zeros((2, MB), np.int32)
        table_b[0, :3] = [5, 6, 9]

        def chunk(toks, start, length, tab):
            G = toks.shape[0]
            return (toks, np.asarray(start, np.int32), np.asarray(length, np.int32),
                    np.zeros(G, np.float32), np.zeros(G, np.int32), np.zeros(G, np.int32),
                    np.ones(G, np.float32), tab, np.zeros(G, np.int32))

        outs = []
        for k in (PagedKernels(cm, 4, 16, 4), PagedKernels(cm, 4, 16, 4, graphed=False)):
            run(k.ensure)
            f1 = run(k.prefill_chunk, chunk(ids[None, :8], [0], [12], table))
            f2 = run(k.prefill_chunk, chunk(np.pad(ids[None, 8:], ((0, 0), (0, 4))), [8], [12],
                                            table))
            f3 = run(k.prefill_chunk, chunk(np.stack([ids[:8], np.zeros(8, np.int32)]),
                                            [0, 0], [5, 1], table_b))
            run(k.copy_page, 2, 7)
            seg_table = np.zeros((4, MB), np.int32)
            seg_table[0], seg_table[2] = table[0], table_b[0]
            c = {"tok": np.asarray([f2[0], 0, f3[0], 0], np.int32),
                 "pos": np.asarray([12, 0, 5, 0], np.int32), "step": np.zeros(4, np.int32),
                 "fin": np.asarray([False, True, False, True]),
                 "temp": np.asarray([0, 0, 1.1, 0], np.float32),
                 "seed": np.asarray([0, 0, 9, 0], np.int32), "topk": np.zeros(4, np.int32),
                 "topp": np.asarray([1, 1, 0.9, 1], np.float32)}
            segs = []
            for _ in range(2):
                out = run(k.segment, seg_table, c)
                segs.append(out)
                _, c["tok"], c["pos"], c["step"], c["fin"] = unpack(out, 3)
            outs.append((f1, f2, f3, segs, _bits(k.cache_k[:, 1:]), _bits(k.cache_v[:, 1:]),
                         k))
        a, b = outs
        # The chunks' first tokens, but the pad row's of the third: its
        # all-trash table reads the trash page, whose colliding writes land
        # in either order.
        for x, y in zip(a[:3], b[:3]):
            assert x[:1].tobytes() == y[:1].tobytes()
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a[3], b[3]))
        assert a[4] == b[4] and a[5] == b[5]
        kg = a[6]
        assert torch.equal(kg.cache_k[:, 7], kg.cache_k[:, 2])
        assert sorted(kg.graphs.labels) == sorted(
            ["generate chunk 8 1", "generate chunk 8 2", "generate copy_page",
             "generate segment sampled+filtered"])
        assert kg.graphs.per_run[("chunk", 8, 1)]["int8_matmul"] == 9
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_a_stream_is_the_same_in_any_slot(cuda_device):
    """One prompt decoded from slot 0 beside another stream, then from slot
    3 beside a different one, on the replayed graphs: the same tokens, byte
    for byte (a row's chain depends neither on its slot nor on its
    neighbours)."""
    from pytorch_zappa_serverless_tpu_torch.engine.genkernels import SlotKernels, unpack

    eng, cm = _gen_cm("gpt2", "int8")
    try:
        run = eng.runner.run_fn_sync
        meta = cm.servable.meta["continuous"]
        rng = np.random.default_rng(3)

        def payload(ids, t):
            s = cm.servable.preprocess({"input_ids": ids, "temperature": t, "seed": 5,
                                        "top_p": 0.8})
            return meta["collate_admit"](s, 8)

        mine = payload(rng.integers(1, 500, 6).tolist(), 1.0)
        k = SlotKernels(cm)
        streams = []
        for slot, other_slot, other in ((0, 1, [7, 8, 9]), (3, 2, [400, 2, 77, 5, 6])):
            run(k.reset)
            run(k.ensure)
            S = 4
            c = _carries(S, [], [], mine)
            for s_, p in ((other_slot, payload(other, 0.0)), (slot, mine)):
                first = run(k.prefill, p)
                run(k.insert_from, 0, s_)
                c2 = _carries(S, [s_], first, p)
                for key in c:
                    c[key][s_] = c2[key][s_]
            toks = []
            for _ in range(3):
                out = run(k.segment, c)
                emits, c["tok"], c["pos"], c["step"], c["fin"] = unpack(out, 3)
                toks.extend(emits[slot].tolist())
            streams.append(toks)
        assert streams[0] == streams[1]
    finally:
        eng.shutdown()


# -- residency: graphs go with the weights (serving/lifecycle.py) -------------

def _bert_batches(cm):
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    samples = [cm.servable.preprocess({"text": " ".join(["word"] * (3 + i))}) for i in range(4)]
    return [default_collate(samples[:1], (1, 16), cm.servable.input_spec((1, 16))),
            default_collate(samples, (4, 16), cm.servable.input_spec((4, 16)))]


@pytest.mark.cuda
def test_restored_model_recaptures_and_replays_as_eager(cuda_device, tmp_path):
    """Host and disk demotions release every graph (an old graph refuses to
    replay); each restore captures every bucket anew, whose replays equal
    the eager run and the answers before the demotion, byte for byte."""
    from pytorch_zappa_serverless_tpu_torch.engine import streamio
    from pytorch_zappa_serverless_tpu_torch.serving.ckptstore import CheckpointStore

    eng = _engine("bert_base", dtype="bfloat16", seq_buckets=(16,), batch_buckets=(1, 4),
                  extra={"arch": TINY_BERT, "params_dtype": "int8"})
    try:
        cm = eng.model("bert_base")
        run = eng.runner.run_fn_sync
        batches = _bert_batches(cm)
        first = [run(cm.forward, b) for b in batches]
        assert cm.resident_nbytes() > cm.param_nbytes() > 0  # the graph pool counts
        store = CheckpointStore(tmp_path / "store")
        for tier in ("host", "disk"):
            old = list(cm._graphs.values())
            captures = cm.captures
            run(cm.host_offload)
            assert cm.tier == "host" and cm.resident_nbytes() == 0
            assert all(t.is_pinned() for t in cm._tensors().values())
            for g in old:
                with pytest.raises(RuntimeError, match="released"):
                    run(g.run, batches[0])
            if tier == "host":
                run(cm.device_restore)
            else:
                cm.disk_offload(lambda tree: store.put("bert_base", tree))
                assert all(t.is_meta for t in cm._tensors().values())
                params, _ = store.load("bert_base", place_fn=streamio.device_placer("cuda"))
                run(cm.disk_restore, lambda: params)
            assert cm.tier == "device" and cm.captures == captures + len(cm.buckets)
            assert not set(map(id, cm._graphs.values())) & set(map(id, old))
            _replays_in_turn(eng, "bert_base", batches, {"int8_matmul": 6 * 2})
            assert all(_same(run(cm.forward, b), want) for b, want in zip(batches, first))
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_stream_while_build_copy_lands_under_captured_addresses(cuda_device, tmp_path):
    """Streamed weights copied in place after the captures: the addresses
    stay, and the replays answer with the streamed weights (as the eager run
    on them does), not the seed weights they were captured on."""
    from pytorch_zappa_serverless_tpu_torch.engine import streamio
    from pytorch_zappa_serverless_tpu_torch.engine.weights import flatten_tree, unflatten_tree
    from pytorch_zappa_serverless_tpu_torch.serving.ckptstore import CheckpointStore

    eng = _engine("bert_base", dtype="bfloat16", seq_buckets=(16,), batch_buckets=(1, 4),
                  extra={"arch": TINY_BERT})
    try:
        cm = eng.model("bert_base")
        run = eng.runner.run_fn_sync
        batches = _bert_batches(cm)
        seeded = [run(cm.forward, b) for b in batches]
        shifted = {k: v + 0.05 * torch.randn_like(v) if v.is_floating_point() else v
                   for k, v in flatten_tree(run(cm.host_state)).items()}
        store = CheckpointStore(tmp_path / "store")
        store.put("bert_base", unflatten_tree(shifted))
        params, _ = store.load("bert_base", place_fn=streamio.device_placer("cuda"))
        ptrs = {k: t.data_ptr() for k, t in cm._tensors().items()}
        graphs = dict(cm._graphs)
        run(cm.copy_in_place, flatten_tree(params))
        assert {k: t.data_ptr() for k, t in cm._tensors().items()} == ptrs
        assert cm._graphs == graphs  # no new capture
        got = [run(cm.forward, b) for b in batches]
        want = [run(cm.forward_eager, b) for b in batches]
        assert all(_same(g, w) for g, w in zip(got, want))
        assert not any(_same(g, s) for g, s in zip(got, seeded))
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_bf16_stream_loads_on_the_card(cuda_device, tmp_path):
    """A bf16 stream placed on the card through pinned staging on the copy
    stream: the device tensors hold the file's bytes."""
    from pytorch_zappa_serverless_tpu_torch.engine import streamio
    from pytorch_zappa_serverless_tpu_torch.engine import weights as W

    g = torch.Generator().manual_seed(0)
    tree = {"wte": torch.randn(513, 96, generator=g).to(torch.bfloat16),
            "h0": {"w": torch.randn(96, 96, generator=g).to(torch.bfloat16),
                   "q": torch.randint(-128, 127, (96, 64), generator=g, dtype=torch.int8)}}
    path = tmp_path / f"m{W.STREAM_SUFFIX}"
    W.save_stream(tree, path, chunk_bytes=4096)
    got, stats = W.open_stream(path, place_fn=streamio.device_placer("cuda"))
    flat = W.flatten_tree(got)
    streamio.adopt(flat.values(), "cuda")
    assert stats.chunks_streamed > 1
    for name, want in W.flatten_tree(tree).items():
        assert flat[name].is_cuda and flat[name].dtype == want.dtype
        assert torch.equal(flat[name].cpu().view(torch.uint8), want.view(torch.uint8))


def _sd_tiny():
    return _engine("sd15", dtype="bfloat16", batch_buckets=(1,),
                   extra={"variant": "tiny", "height": 256, "width": 256, "num_steps": 4,
                          "chunk_steps": 2})


@pytest.mark.cuda
def test_sd_queue_job_replays_the_job_lanes_graphs(cuda_device):
    """``queue_job`` (what the bench times of a job) replays the graphs the
    job lane captured and no other: its outputs equal a job through
    ``chunk_prepare``, ``chunk_step`` and ``chunk_finalize`` byte for byte,
    with the same launches and no new capture."""
    from pytorch_zappa_serverless_tpu_torch.ops import counters

    eng = _sd_tiny()
    try:
        cm = eng.model("sd15")
        ch = cm.servable.meta["chunked"]
        samples = [cm.servable.preprocess({"prompt": "a red fox", "seed": 3})]

        def lane():
            before = counters.snapshot()
            _, state = cm.chunk_prepare(samples)
            for rows in ch["chunk_rows"]:
                state = cm.chunk_step(state, rows)
            return cm.chunk_finalize(state, samples)[0]["pixels"], counters.delta(before)

        def queued():
            graphs, before = cm.graphs, counters.snapshot()
            out = cm.queue_job(samples)
            launches = counters.delta(before)
            assert cm.graphs == graphs
            host = {k: v.cpu().numpy() for k, v in out.items()}
            return cm.servable.postprocess(host, 0)["pixels"], launches

        want, want_launches = eng.runner.run_fn_sync(lane)
        got, launches = eng.runner.run_fn_sync(queued)
        assert np.array_equal(got, want)
        assert launches == want_launches and launches["flash_attention"] > 0
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_sd_prepare_and_finalize_graphs_replay_as_eager(cuda_device):
    """SD-1.5's prepare (the CLIP encode) and finalize (the VAE decode) are
    captured a bucket at warm-up: each replay equals its eager run byte for
    byte, launches no kernel of the port (exact counts: none), keeps a job's
    state its own when another job's prepare replays after it, and a
    demotion releases both graphs while a restore captures them again."""
    from pytorch_zappa_serverless_tpu_torch.ops import counters

    eng = _sd_tiny()
    try:
        cm = eng.model("sd15")
        ch = cm.servable.meta["chunked"]
        assert any(g.startswith("prepare") for g in cm.graphs)
        assert any(g.startswith("finalize") for g in cm.graphs)
        jobs = [[cm.servable.preprocess({"prompt": p, "seed": i})]
                for i, p in enumerate(("a red fox", "a blue boat"))]
        run = eng.runner.run_fn_sync

        def check():
            states = []
            for samples in jobs:
                _, want = cm.chunk_prepare_eager(samples)
                before = counters.snapshot()
                _, got = cm.chunk_prepare(samples)
                assert counters.delta(before) == dict.fromkeys(before, 0)
                assert got.keys() == want.keys()
                assert all(torch.equal(got[k], want[k]) for k in want)
                states.append((got, {k: v.clone() for k, v in want.items()}))
            # The first job's state survived the second job's replay.
            got, want = states[0]
            assert all(torch.equal(got[k], want[k]) for k in want)
            for (state, _), samples in zip(states, jobs):
                for rows in ch["chunk_rows"]:
                    state = cm.chunk_step(state, rows)
                want = cm.chunk_finalize_eager(state, samples)
                before = counters.snapshot()
                got = cm.chunk_finalize(state, samples)
                assert counters.delta(before) == dict.fromkeys(before, 0)
                assert np.array_equal(got[0]["pixels"], want[0]["pixels"])
            return got[0]["pixels"]

        first = run(check)
        graphs = cm.graphs
        run(cm.host_offload)
        assert cm.graphs == []
        run(cm.device_restore)
        assert sorted(cm.graphs) == sorted(graphs)
        assert np.array_equal(run(check), first)
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_a_profile_open_across_a_restore_capture(cuda_device):
    """The profiler started on the dispatch thread stays open while a host
    restore captures every bucket again there: the captures succeed, the
    replays equal the eager forward byte for byte, and the window names the
    replayed graphs' kernels."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate
    from pytorch_zappa_serverless_tpu_torch.utils import xplane

    eng = _engine("resnet18", dtype="bfloat16", batch_buckets=(1, 4),
                  extra={"image_size": 64, "resize_to": 72})
    try:
        cm = eng.model("resnet18")
        run = eng.runner.run_fn_sync
        rng = np.random.default_rng(0)
        samples = [cm.servable.preprocess(rng.integers(0, 255, (64, 64, 3)).astype(np.uint8))
                   for _ in range(4)]
        batch = default_collate(samples, (4,), cm.servable.input_spec((4,)))
        want = run(cm.forward_eager, batch)
        cap = xplane.Capture(cuda=True)
        run(cap.start)
        try:
            assert xplane.busy()
            with pytest.raises(xplane.ProfilerBusy):
                run(xplane.Capture(cuda=True).start)
            run(cm.host_offload)
            run(cm.device_restore)
            got = run(cm.forward, batch)
        finally:
            run(cap.stop)
        assert not xplane.busy()
        assert _same(got, want)
        top = xplane.top_ops(cap.prof, 50)
        assert top["ops"] and top["device_compute_ms"] > 0
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_spec_graphs_replay_as_eager(cuda_device):
    """The speculative tick's graphs on the card: an int8 target's chunk and
    a bf16 draft's chunk on their own pools, then the draft's propose and the
    target's verify (its forward and the rejection sampling in one graph),
    greedy and sampled, replayed against the same calls run eagerly on second
    pools: proposals, accepted counts, output tokens and every page but the
    trash page byte for byte; the verify graph's products run at S x (k + 1)
    rows (one int8_matmul launch a projection and one for the head)."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
    from pytorch_zappa_serverless_tpu_torch.engine.genkernels import PagedKernels
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    extra = {"arch": TINY_GPT2, "max_new_tokens": 8, **GEN}
    eng = build_engine(ServeConfig(models=[
        ModelConfig(name="gpt2", dtype="bfloat16", batch_buckets=(1,), seq_buckets=(8, 16),
                    kv_cache="paged", kv_block_size=4, spec_draft="gpt2_draft", spec_k=3,
                    extra={**extra, "params_dtype": "int8"}),
        ModelConfig(name="gpt2_draft", builder="gpt2", dtype="bfloat16", batch_buckets=(1,),
                    seq_buckets=(8, 16), extra={**extra, "params_dtype": "bfloat16"})]),
        device="cuda")
    try:
        run = eng.runner.run_fn_sync
        cm, dcm = eng.model("gpt2"), eng.model("gpt2_draft")
        rng = np.random.default_rng(4)
        S, K, MB = 4, 3, 6
        ids = [rng.integers(1, 500, n).astype(np.int32) for n in (7, 5)]
        table = np.zeros((S, MB), np.int32)
        table[0], table[2] = [1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]
        toks = np.zeros((2, 8), np.int32)
        for j, x in enumerate(ids):
            toks[j, :len(x)] = x
        chunk = (toks, np.zeros(2, np.int32), np.asarray([7, 5], np.int32),
                 np.zeros(2, np.float32), np.zeros(2, np.int32), np.zeros(2, np.int32),
                 np.ones(2, np.float32), table[[0, 2]], np.zeros(2, np.int32))
        outs = []
        for graphed in (None, False):
            k = PagedKernels(cm, 4, 16, K, graphed=graphed)
            d = PagedKernels(dcm, 4, 16, K, graphed=graphed)
            run(k.ensure)
            run(d.ensure)
            first = run(k.prefill_chunk, chunk)
            run(d.prefill_chunk, chunk)
            buf = run(k.spec_buffer)
            got = [first.tobytes()]
            for temp in (0.0, 1.1):
                c = {"tok": np.asarray([first[0], 0, first[1], 0], np.int32),
                     "pos": np.asarray([7, 0, 5, 0], np.int32), "step": np.zeros(S, np.int32),
                     "fin": np.asarray([False, True, False, True]),
                     "temp": np.asarray([temp, 0, temp, 0], np.float32),
                     "seed": np.asarray([3, 0, 9, 0], np.int32), "topk": np.zeros(S, np.int32),
                     "topp": np.asarray([1, 1, 0.9, 1], np.float32),
                     "prev": np.asarray([ids[0][-1], 0, ids[1][-1], 0], np.int32)}
                props = run(d.propose, table, c, buf)
                vt = np.concatenate([c["tok"][:, None], props], axis=1).astype(np.int32)
                out = run(k.verify, table, vt, c)
                got += [props[[0, 2]].tobytes(), out[[0, 2]].tobytes()]
            got += [_bits(k.cache_k[:, 1:]), _bits(d.cache_v[:, 1:])]
            outs.append((got, k, d))
        (a, kg, dg), (b, _, _) = outs
        assert a == b
        assert sorted(kg.graphs.labels) == sorted(
            ["generate chunk 8 2", "generate verify greedy", "generate verify sampled+filtered"])
        assert sorted(dg.graphs.labels) == sorted(
            ["generate chunk 8 2", "generate propose greedy",
             "generate propose sampled+filtered"])
        for key in kg.graphs._graphs:
            if key[0] == "verify":
                assert kg.graphs.per_run[key]["int8_matmul"] == 9
        for key in dg.graphs._graphs:
            assert dg.graphs.per_run[key].get("int8_matmul", 0) == 0
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_pages_read_and_write_in_place_under_captured_graphs(cuda_device):
    """A page read to pinned host memory and written back into other pages
    lands in the pool's own tensors (their addresses unchanged), so a
    captured segment that reads those pages reads the written values: its
    tokens from the copied pages equal its tokens from the originals."""
    from pytorch_zappa_serverless_tpu_torch.engine.genkernels import PagedKernels

    eng, cm = _gen_cm("gpt2", "int8", kv_cache="paged", kv_block_size=4)
    try:
        run = eng.runner.run_fn_sync
        k = PagedKernels(cm, 4, 16, 4)
        run(k.ensure)
        ids = np.random.default_rng(5).integers(1, 500, 8).astype(np.int32)
        table = np.zeros((4, 6), np.int32)
        table[0, :3] = [1, 2, 3]
        first = run(k.prefill_chunk, (ids[None], np.zeros(1, np.int32),
                                      np.asarray([8], np.int32), np.zeros(1, np.float32),
                                      np.zeros(1, np.int32), np.zeros(1, np.int32),
                                      np.ones(1, np.float32), table[:1], np.zeros(1, np.int32)))
        ptr = (k.cache_k.data_ptr(), k.cache_v.data_ptr())
        pages = run(k.read_pages, [1, 2, 3])
        assert pages[0][0].is_pinned() and tuple(pages[0][0].shape) == k.shape[:1] + k.shape[2:]
        run(k.write_pages, [(b, kk, vv) for b, (kk, vv) in zip([7, 8, 9], pages)])
        assert (k.cache_k.data_ptr(), k.cache_v.data_ptr()) == ptr
        assert torch.equal(k.cache_k[:, 7:10], k.cache_k[:, 1:4])
        c = {"tok": np.asarray([first[0], 0, 0, 0], np.int32),
             "pos": np.asarray([8, 0, 0, 0], np.int32), "step": np.zeros(4, np.int32),
             "fin": np.asarray([False, True, True, True]), "temp": np.zeros(4, np.float32),
             "seed": np.zeros(4, np.int32), "topk": np.zeros(4, np.int32),
             "topp": np.ones(4, np.float32)}
        moved = table.copy()
        moved[0, :3] = [7, 8, 9]
        a = run(k.segment, moved, c)  # reads the written copies
        b = run(k.segment, table, c)  # reads the originals
        assert a[0].tobytes() == b[0].tobytes()
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_adapter_slot_written_in_place_under_captured_graphs(cuda_device):
    """An attach writes its slot into the stacks a captured bucket graph
    reads, under their addresses: the next replay serves the tenant's rows
    (equal to the eager run) and the base's rows unchanged, with no new
    capture; a detach (the slot zeroed) brings the base's bytes back."""
    from pytorch_zappa_serverless_tpu_torch.engine import weights as W
    from pytorch_zappa_serverless_tpu_torch.ops import lora as L

    eng = _engine("gpt2", dtype="bfloat16", batch_buckets=(4,), seq_buckets=(8,),
                  adapter_slots=2, adapter_rank=4,
                  extra={"arch": TINY_GPT2, "max_new_tokens": 8})
    try:
        cm = eng.model("gpt2")
        run = eng.runner.run_fn_sync
        meta = cm.servable.meta["adapters"]
        rng = np.random.default_rng(11)
        samples = [cm.servable.preprocess({"input_ids": rng.integers(1, 500, 6).tolist()})
                   for _ in range(4)]
        for s, slot in zip(samples, (0, 1, 0, 1)):
            s["adapter_idx"] = np.int32(slot)
        batch = cm.servable.meta["collate"](samples, (4, 8), cm.servable.input_spec((4, 8)))
        base = run(cm.forward, batch)
        captures = cm.captures
        stacks = cm.servable.module.tree()["__adapters__"]
        ptrs = [t.data_ptr() for layer in stacks.values() for n in layer.values()
                for t in n.values()]
        host = {f"layer{i}": L.zero_stacks(meta["slots"], meta["rank"], meta["dims"])
                for i in range(meta["layers"])}
        L.install_adapter(host, 1, W.init_lora(meta["layers"], meta["dims"], 4, seed=3),
                          scaling=64.0)
        run(L.write_slot, stacks, host, 1)
        tenant = run(cm.forward, batch)
        assert cm.captures == captures
        assert _same(tenant, run(cm.forward_eager, batch))
        toks = tenant["tokens"]
        assert toks[[0, 2]].tobytes() == base["tokens"][[0, 2]].tobytes()
        assert toks[[1, 3]].tobytes() != base["tokens"][[1, 3]].tobytes()
        L.clear_slot(host, 1)
        run(L.write_slot, stacks, host, 1)
        assert _same(run(cm.forward, batch), base) and cm.captures == captures
        stacks = cm.servable.module.tree()["__adapters__"]
        assert ptrs == [t.data_ptr() for layer in stacks.values() for n in layer.values()
                        for t in n.values()]
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_auto_shared_leaves_have_one_address(cuda_device):
    """The regime-routed lane's embeddings and LayerNorms lie once on the
    card: the decode tree reads the bf16 tree's tensors, every tensor of
    the module has its own address, after the move to the card and after
    a host-tier restore, and the restore keeps the bytes and the answers."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G

    eng = _engine("gpt2", dtype="bfloat16", batch_buckets=(1, 4), seq_buckets=(8,),
                  extra={"arch": TINY_GPT2, "max_new_tokens": 8, "quantize_min_size": 1024,
                         "params_dtype": "auto", "int8_crossover_batch": 2})
    try:
        cm = eng.model("gpt2")
        run = eng.runner.run_fn_sync

        def check():
            tree = cm.servable.module.tree()
            dec = G.int8_view(tree, G.GPT2Config(**TINY_GPT2).layers)
            for leaf in ("wte", "wpe"):
                assert dec[leaf].data_ptr() == tree["bf16"][leaf].data_ptr()
            assert dec["layer0"]["ln1"]["scale"].data_ptr() == \
                tree["bf16"]["layer0"]["ln1"]["scale"].data_ptr()
            ptrs = [t.data_ptr() for t in cm.servable.module.buffers()]
            assert len(ptrs) == len(set(ptrs)) and all(t.is_cuda
                                                       for t in cm.servable.module.buffers())

        rng = np.random.default_rng(12)
        batches = []
        for b in (1, 4):
            samples = [cm.servable.preprocess({"input_ids": rng.integers(1, 500, 6).tolist()})
                       for _ in range(b)]
            batches.append(cm.servable.meta["collate"](samples, (b, 8),
                                                       cm.servable.input_spec((b, 8))))
        check()
        nbytes = cm.param_nbytes()
        first = [run(cm.forward, b) for b in batches]
        run(cm.host_offload)
        run(cm.device_restore)
        check()
        assert cm.param_nbytes() == nbytes
        assert all(_same(run(cm.forward, b), want) for b, want in zip(batches, first))
    finally:
        eng.shutdown()


def _fleet(tmp_path, n: int = 2):
    """``cli fleet --spawn n`` with a tiny BERT on the int8 lane, on the
    card: (router port, replica ports, the process); the fleet tears its
    replicas down when it ends."""
    import json
    import subprocess
    import sys
    import time
    import urllib.request

    from pytorch_zappa_serverless_tpu_torch.tools.crashtest import _free_port, free_port_run

    router = _free_port()
    base = free_port_run(n, avoid=(router,))
    cfg = {"warmup_at_boot": True, "fleet": {"poll_interval_s": 0.2, "spawn_base_port": base},
           "models": [{"name": "bert_int8", "builder": "bert_base", "dtype": "bfloat16",
                       "batch_buckets": [1], "seq_buckets": [16], "coalesce_ms": 0.0,
                       "extra": {"params_dtype": "int8", "quantize_min_size": 1024,
                                 "arch": {"num_layers": 2, "num_heads": 2, "head_dim": 64,
                                          "mlp_dim": 512, "vocab_size": 512}}}]}
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(cfg))
    proc = subprocess.Popen([sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli",
                             "fleet", "--config", str(path), "--spawn", str(n), "--port",
                             str(router)], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{router}/admin/fleet",
                                        timeout=2) as r:
                reps = json.loads(r.read())["replicas"]
            if len(reps) == n and all(v["state"] == "healthy" for v in reps.values()):
                return router, [base + i for i in range(n)], proc
        except OSError:
            pass
        time.sleep(0.25)
    proc.kill()
    raise AssertionError("the fleet never came up healthy")


def _post(port: int, path: str, body: dict):
    import json
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read()), dict(r.headers)


def _int8_launches(port: int) -> int:
    import json
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return int(json.loads(r.read())["kernels"].get("int8_matmul", 0))


@pytest.mark.cuda
def test_fleet_router_answers_as_the_replica_on_the_card(cuda_device, tmp_path):
    """A router in front of two replica processes on the card answers each
    predict as the replica it routed to answers the same request."""
    router, ports, proc = _fleet(tmp_path)
    try:
        rng = np.random.default_rng(18)
        for _ in range(6):
            body = {"input_ids": rng.integers(1, 511, 12).tolist()}
            routed, hdrs = _post(router, "/v1/models/bert_int8:predict", body)
            direct, _ = _post(ports[int(hdrs["X-Fleet-Replica"][1:])],
                              "/v1/models/bert_int8:predict", body)
            assert routed["predictions"] == direct["predictions"]
    finally:
        proc.terminate()
        proc.wait(timeout=60)


@pytest.mark.cuda
def test_fleet_replicas_launch_exactly_their_replays(cuda_device, tmp_path):
    """Each routed forward is one replay of the bucket graph: the replicas'
    ``int8_matmul`` counts move by exactly the graph's launches per request
    (12: q, k, v, out, fc1 and fc2 of 2 layers)."""
    router, ports, proc = _fleet(tmp_path)
    try:
        before = sum(_int8_launches(p) for p in ports)
        n = 8
        for i in range(n):
            _post(router, "/v1/models/bert_int8:predict", {"input_ids": [5 + i, 6, 7]})
        after = sum(_int8_launches(p) for p in ports)
        assert after - before == n * 12, (before, after)
    finally:
        proc.terminate()
        proc.wait(timeout=60)


# -- the mesh of one (parallel/mesh.py) ------------------------------------------

@pytest.mark.cuda
def test_mesh_of_one_graphs_hold_their_collectives_and_replay_as_eager(cuda_device):
    """A world of one over NCCL: every bucket graph captures the TP
    all-reduces (two a layer) and the DP gather, and its replay equals the
    eager forward and the meshless model's byte for byte (a sum over one
    rank and a gather of one are copies)."""
    import torch.distributed as dist

    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    mc = ModelConfig(name="bert_base", dtype="bfloat16", batch_buckets=(1, 4),
                     seq_buckets=(16,), extra={"arch": {"num_layers": 2, "num_heads": 4,
                                                        "head_dim": 16, "mlp_dim": 128}})
    assert not dist.is_initialized()
    meshed = build_engine(ServeConfig(mesh={"data": 1, "model": 1}, models=[mc]), "cuda")
    plain = build_engine(ServeConfig(models=[mc]), "cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        assert meshed.world_snapshot()["nccl"]
        cm, base = meshed.model("bert_base"), plain.model("bert_base")
        assert cm.tp_size == 1 and base.mesh is None
        held = cm.graph_collectives
        assert len(held) == 2 and all(c == {"all_reduce": 4, "all_gather": 1}
                                      for c in held.values()), held
        assert all(c == {} for c in base.graph_collectives.values())
        rng = np.random.default_rng(9)
        for b in (1, 4):
            batch = {"input_ids": rng.integers(0, 30522, (b, 16)).astype(np.int32),
                     "attention_mask": np.ones((b, 16), np.int32),
                     "token_type_ids": np.zeros((b, 16), np.int32)}
            batch["attention_mask"][:, 12:] = 0
            replay = meshed.runner.run_fn_sync(cm.forward, batch)["probs"]
            eager = meshed.runner.run_fn_sync(cm.forward_eager, batch)["probs"]
            want = plain.runner.run_fn_sync(base.forward, batch)["probs"]
            assert replay.tobytes() == eager.tobytes() == want.tobytes()
    finally:
        meshed.shutdown()
        plain.shutdown()
        dist.destroy_process_group()
