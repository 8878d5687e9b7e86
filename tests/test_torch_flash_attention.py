"""The port's flash attention on the CPU against the JAX package's.

On a CPU tensor the port's ``flash_attention`` is its plain version
(``flash_attention_reference``); the JAX side is the Pallas kernel in
interpret mode, as ``tests/test_flash_attention.py`` runs it.  The same numpy
inputs go to both.

Tolerances: f32 ``atol = rtol = 2e-5`` (the same f32 arithmetic in another
summation order: the Pallas kernel rescales per key block, the plain version
takes one max over all keys); bf16 ``atol = 2e-3, rtol = 2^-6`` (P is
rounded to bf16 before P.V on both sides, relative to a different running
max, and each side rounds its output to bf16 once: two roundings at the
bottom of a binade).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.ops import flash_attention as J
from pytorch_zappa_serverless_tpu_torch.ops import _build
from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as P
from pytorch_zappa_serverless_tpu_torch.tools import flash_ablation as ablation


def _qkv(rng, b, tq, tk, h, d):
    return (rng.standard_normal((b, tq, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32))


def _jax(q, k, v, dtype=jnp.float32, **kw):
    out = J.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                            block_q=128, block_k=128, **kw)
    return np.asarray(out, np.float32)


def _port(q, k, v, dtype=torch.float32, **kw):
    out = P.flash_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("tq,tk,h,d", [
    (256, 256, 2, 64),     # block-multiple
    (200, 200, 2, 64),     # ragged in both T dims
    (512, 77, 1, 64),      # the cross-attention shape class (small Tk)
    (1024, 1024, 8, 64),   # the self-attention shape class
    (1024, 1024, 8, 40),   # SD-1.5 64x64 level head dim
    (1024, 1024, 8, 80),   # SD-1.5 32x32 level head dim
])
def test_matches_jax_f32(rng, tq, tk, h, d):
    q, k, v = _qkv(rng, 1, tq, tk, h, d)
    np.testing.assert_allclose(_port(q, k, v), _jax(q, k, v), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [40, 64])
def test_matches_jax_bf16(rng, d):
    q, k, v = _qkv(rng, 2, 384, 384, 4, d)
    np.testing.assert_allclose(_port(q, k, v, torch.bfloat16),
                               _jax(q, k, v, jnp.bfloat16), atol=2e-3, rtol=2 ** -6)


def test_matches_jax_kv_mask(rng):
    q, k, v = _qkv(rng, 2, 256, 256, 2, 64)
    mask = np.arange(256)[None, :] < np.array([170, 31])[:, None]
    np.testing.assert_allclose(_port(q, k, v, kv_mask=torch.from_numpy(mask)),
                               _jax(q, k, v, kv_mask=jnp.asarray(mask)),
                               atol=2e-5, rtol=2e-5)


def test_matches_jax_causal(rng):
    q, k, v = _qkv(rng, 1, 300, 300, 2, 64)
    np.testing.assert_allclose(_port(q, k, v, causal=True), _jax(q, k, v, causal=True),
                               atol=2e-5, rtol=2e-5)


def test_fully_masked_row_is_uniform_and_finite(rng):
    """Every key of batch row 1 masked: both packages give the uniform
    distribution over the keys (the mean of v), never NaN."""
    q, k, v = _qkv(rng, 2, 256, 256, 2, 40)
    mask = np.ones((2, 256), bool)
    mask[1] = False
    got = _port(q, k, v, kv_mask=torch.from_numpy(mask))
    want = _jax(q, k, v, kv_mask=jnp.asarray(mask))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    uniform = np.broadcast_to(v[1].mean(0), got[1].shape)
    np.testing.assert_allclose(got[1], uniform, atol=2e-5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_causal_needs_square(rng):
    q, k, v = _qkv(rng, 1, 64, 32, 1, 64)
    with pytest.raises(ValueError, match="causal"):
        P.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    with pytest.raises(ValueError, match="causal"):
        J.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True)


@pytest.mark.parametrize("t,causal,masked", [
    (1024 + 64, False, True),   # flash route: at FLASH_MIN_TOKENS and above
    (128, True, False),         # materialised route
    (1023, False, True),        # just below the threshold
])
def test_attention_dispatch_matches_jax(rng, t, causal, masked):
    B, H, D = 1, 4, 40
    q, k, v = (rng.standard_normal((B, t, H * D)).astype(np.float32) for _ in range(3))
    mask = np.arange(t)[None, :] < t - 100 if masked else None
    got = P.attention(*(torch.from_numpy(x) for x in (q, k, v)), heads=H, causal=causal,
                      kv_mask=None if mask is None else torch.from_numpy(mask))
    want = J.attention(*(jnp.asarray(x) for x in (q, k, v)), heads=H, causal=causal,
                       kv_mask=None if mask is None else jnp.asarray(mask))
    assert got.shape == (B, t, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_attention_routes_long_sequences_to_flash(rng, monkeypatch):
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return P.flash_attention_reference(*args, **kw)

    monkeypatch.setattr(P, "flash_attention", spy)
    x = torch.from_numpy(rng.standard_normal((1, 1024, 64)).astype(np.float32))
    short = x[:, :1023]
    P.attention(x, x, x, heads=2)
    P.attention(short, short, short, heads=2)
    P.attention(x, x[:, :77], x[:, :77], heads=2)
    assert calls == [(1, 1024, 2, 32)]


def test_cpu_call_does_not_count_a_launch(rng):
    q, k, v = _qkv(rng, 1, 64, 64, 1, 40)
    before = P.flash_attention.launches
    P.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    P.attention(*(torch.from_numpy(x).reshape(1, 64, 40) for x in (q, k, v)), heads=1)
    assert P.flash_attention.launches == before


def test_wrapper_checks_shapes():
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        P.flash_attention(x, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8))
    with pytest.raises(ValueError, match="kv_mask"):
        P.flash_attention(x, x, x, kv_mask=torch.ones(1, 9, dtype=torch.bool))


def _fused_views(b=2, t=64, heads=8, d=40):
    """q, k, v as head-split views of one fused [B, T, 3·C] projection."""
    qkv = torch.zeros(b, t, 3 * heads * d, dtype=torch.bfloat16)
    return tuple(x.view(b, t, heads, d) for x in qkv.split(heads * d, dim=-1))


def _odd_base(b=2, t=64, heads=8, d=40):
    """q starting one element into its storage; k and v contiguous."""
    flat = torch.zeros(1 + b * t * heads * d, dtype=torch.bfloat16)
    q = flat[1:].view(b, t, heads, d)
    return q, torch.zeros_like(q), torch.zeros_like(q)


def _unet_views(b=2, t=64, heads=8, d=40):
    """The UNet's [B, T, C] projections reshaped to [B, T, H, D]."""
    return tuple(torch.zeros(b, t, heads * d, dtype=torch.bfloat16).reshape(b, t, heads, d)
                 for _ in range(3))


@pytest.mark.parametrize("make,want", [
    (_unet_views, (True, True, True)),                       # strides 80 B, 640 B
    (_fused_views, (True, True, True)),                      # strides 80 B, 1920 B; +640 B
    (lambda: _unet_views(d=20), (False, False, False)),      # D = 20: 40-byte head stride
    (_odd_base, (False, True, True)),                        # base 2 bytes off
])
def test_tma_describable_says_which_operands_need_a_copy(make, want):
    q, k, v = make()
    assert tuple(P.tma_describable(x) for x in (q, k, v)) == want


@pytest.mark.parametrize("make", [lambda: _unet_views(d=20), _odd_base])
def test_padded_copy_is_describable_and_keeps_the_result(rng, make):
    q, k, v = make()
    for x in (q, k, v):  # fill the views in place with seeded values
        x.copy_(torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)))
    copies = [P.padded_copy(x) for x in (q, k, v)]
    for x, c in zip((q, k, v), copies):
        assert P.tma_describable(c) and c.shape == x.shape and c.stride(-1) == 1
        assert c.stride(2) % 8 == 0 and torch.equal(c, x)
    want = P.flash_attention_reference(q, k, v)
    assert torch.equal(P.flash_attention_reference(*copies), want)
    assert torch.equal(P.flash_attention(*copies), want)  # the CPU route: the plain version


def test_padded_copy_rounds_the_head_dim_up_to_16_bytes():
    x = torch.zeros(1, 4, 2, 20, dtype=torch.bfloat16)
    c = P.padded_copy(x)
    assert c.stride() == (4 * 2 * 24, 2 * 24, 24, 1)
    assert P.padded_copy(torch.zeros(1, 4, 2, 40, dtype=torch.bfloat16)).stride(2) == 40


@pytest.mark.parametrize("name", sorted(ablation.VARIANTS))
def test_ablation_variants_apply_to_the_kernel_source(name):
    """Each variant of tools/flash_ablation takes out one part of the kernel
    source as it stands: its substitutions match exactly once."""
    source = (_build.CSRC / ablation.SOURCE).read_text()
    assert (ablation.apply_variant(source, name) == source) == (name == "kernel")
