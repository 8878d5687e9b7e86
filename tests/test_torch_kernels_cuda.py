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
64-key tile).  At [2, 4096, 8, 40] the bf16 limit is ~2.3e-3 for the
outputs' typical |y| of ~0.02, tight enough to reject a kernel that takes
sm_scale from the padded head dim (a test below plants that fault).
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 768, 3072), (128, 3072, 768), (3, 100, 50),
                                   (1, 768, 768)])
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
])
def test_flash_attention_matches_plain(cuda_device, b, tq, tk, h, d, dtype, causal, masked):
    q, k, v = _qkv(b, tq, tk, h, d, dtype, cuda_device)
    mask = None
    if masked:
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
    padded to the wmma width) instead of 1/sqrt(40) must fail the check."""
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
