"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's ``ring_attention`` and plain attention.

The port's ring runs over a 4-rank ``gloo`` world (``tests/torch_worlds.py``,
one process a rank, the K/V rotations ``dist.batch_isend_irecv``); the JAX
ring over a 4-device slice of the 8-device CPU mesh (``tests/conftest.py``).
The cases are those of the JAX package's ``tests/test_ring_attention.py``.
Tolerances: f32 ``atol = rtol = 3e-5`` (the online-softmax combine is exact;
only the order of the sums moves), bf16 ``4e-2`` against plain attention in
f32 and ``2**-7`` relative against the JAX ring in bf16 (one bf16 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_zappa_serverless_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pytorch_zappa_serverless_tpu.parallel.ring_attention import ring_attention as jax_ring
from torch_worlds import ring_world, run_world

N = 4
_rng = np.random.default_rng(11)


def _qkv(B, T, H, D):
    return tuple(_rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))


def _naive(q, k, v, *, causal=False, kv_mask=None):
    q32, k32, v32 = (np.asarray(x, np.float32) for x in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q32, k32) / np.sqrt(q32.shape[-1])
    if kv_mask is not None:
        s = np.where(kv_mask[:, None, None, :], s, -1e9)
    if causal:
        t = np.arange(q32.shape[1])
        s = np.where(t[:, None] >= t[None, :], s, -1e9)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v32)


_MASK = np.arange(128)[None, :] < np.array([100, 37])[:, None]
CASES = {
    "full": (_qkv(2, 256, 4, 32), {}),
    "causal": (_qkv(2, 256, 4, 32), {"causal": True}),
    "kv_mask": (_qkv(2, 128, 2, 16), {"kv_mask": _MASK}),
    "causal_kv_mask": (_qkv(2, 128, 2, 16), {"kv_mask": _MASK, "causal": True}),
    "bf16_causal": (_qkv(1, 256, 2, 32), {"causal": True, "dtype": "bfloat16"}),
    "scaled": (_qkv(1, 64, 2, 16), {"sm_scale": 0.1}),
    "ragged": (_qkv(1, 102, 1, 8), {}),  # 102 % 4 != 0: refused
}


@pytest.fixture(scope="module")
def port_outs():
    cases = [(*qkv, kw) for qkv, kw in CASES.values()]
    return dict(zip(CASES, run_world(N, ring_world, cases)))


def _jax(name):
    (q, k, v), kw = CASES[name]
    kw = dict(kw)
    dt = jnp.bfloat16 if kw.pop("dtype", "float32") == "bfloat16" else jnp.float32
    if "kv_mask" in kw:
        kw["kv_mask"] = jnp.asarray(kw["kv_mask"])
    mesh = jax_make_mesh({"seq": N}, devices=jax.devices()[:N])
    return np.asarray(jax_ring(*(jnp.asarray(x, dt) for x in (q, k, v)), mesh, **kw),
                      np.float32)


@pytest.mark.parametrize("name", ["full", "causal", "kv_mask", "causal_kv_mask", "scaled"])
def test_ring_matches_plain_attention_and_the_jax_ring_f32(port_outs, name):
    status, dtype, got = port_outs[name]
    assert status == "ok" and dtype == "torch.float32"
    (q, k, v), kw = CASES[name]
    if "sm_scale" in kw:
        want = _naive(q * kw["sm_scale"] * np.sqrt(q.shape[-1]), k, v)
    else:
        want = _naive(q, k, v, causal=kw.get("causal", False), kv_mask=kw.get("kv_mask"))
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, _jax(name), atol=3e-5, rtol=3e-5)


def test_ring_bf16_matches_plain_attention_and_the_jax_ring(port_outs):
    status, dtype, got = port_outs["bf16_causal"]
    assert status == "ok" and dtype == "torch.bfloat16"
    (q, k, v), _ = CASES["bf16_causal"]
    np.testing.assert_allclose(got, _naive(q, k, v, causal=True), atol=4e-2, rtol=4e-2)
    want = _jax("bf16_causal")
    np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max(), rtol=2 ** -7)


def test_ring_refuses_a_length_the_axis_does_not_divide(port_outs):
    status, kind, msg = port_outs["ragged"]
    assert (status, kind) == ("error", "ValueError")
    assert msg == "seq len 102 not divisible by seq=4"
    (q, k, v), _ = CASES["ragged"]
    mesh = jax_make_mesh({"seq": N}, devices=jax.devices()[:N])
    with pytest.raises(ValueError, match="seq len 102 not divisible by seq=4"):
        jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh)


def test_ring_at_world_of_one_is_plain_attention():
    """A ring of one rank: the home chunk alone, no rotation."""
    import torch
    import torch.distributed as dist

    from pytorch_zappa_serverless_tpu_torch.parallel import mesh as PM
    from pytorch_zappa_serverless_tpu_torch.parallel.ring_attention import (
        ring_attention_local)

    (q, k, v), _ = CASES["kv_mask"]
    assert not dist.is_initialized()
    PM.init_distributed("", 1, 0, device="cpu")  # a loopback world of one, torn down below
    try:
        got = ring_attention_local(*(torch.from_numpy(x) for x in (q, k, v)),
                                   torch.from_numpy(_MASK), group=dist.group.WORLD, causal=True)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, causal=True, kv_mask=_MASK),
                               atol=3e-5, rtol=3e-5)
