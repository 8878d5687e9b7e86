"""The port's fused decode steps (pytorch_zappa_serverless_tpu_torch/ops/
fused_decode.py) held against the JAX package's Pallas kernels, which run in
interpret mode on the CPU, at tests/test_fused_decode.py's shapes (S=8,
D=128, H=4, T=32, F=512).  On CPU tensors the port's wrappers compute their
plain versions.

Tolerances:

- ``x_out``: relative max error <= 2e-2, the JAX test's own bound (both sides
  round h, qkv, ctx and x_out to bf16 after f32 sums of other orders);
- the K/V rows written at ``pos[s]``: within one bf16 ulp of JAX's (each is
  one rounding of an f32 sum);
- every other cache entry: byte-identical to its input, and the caches
  returned are the tensors passed in (updated in place).

Odd head counts, which the JAX kernels refuse (a Mosaic lane-tiling rule),
are held against an independent numpy version of the same arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.ops import fused_decode as JF
from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as PF
from pytorch_zappa_serverless_tpu_torch.ops.int8_matmul import quantize_per_channel

SHAPES = dict(S=8, D=128, H=4, T=32, F=512)
BF16_ULP = 2.0 ** -7  # relative, at the bottom of a binade


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _inputs(S, D, T, F, seed=0):
    """numpy operands (bf16 ones already rounded) and the mask of pos."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    a = {"x": r(S, D), "lns": 1 + r(D, scale=0.1), "lnb": r(D, scale=0.1),
         "wqkv": r(D, 3 * D, scale=0.05), "bqkv": r(3 * D, scale=0.01),
         "wout": r(D, D, scale=0.05), "bout": r(D, scale=0.01),
         "w1": r(D, F, scale=0.05), "b1": r(F, scale=0.01),
         "w2": r(F, D, scale=0.05), "b2": r(D, scale=0.01),
         "ck": r(T, S, D, scale=0.1), "cv": r(T, S, D, scale=0.1),
         "pos": (rng.integers(1, T - 1, (S,)) if T > 2 else np.zeros(S)).astype(np.int32)}
    for k in ("x", "wqkv", "wout", "w1", "w2", "ck", "cv"):
        a[k] = _bf16(a[k]).float().numpy()
    a["mask"] = np.where(np.arange(T)[:, None, None] <= a["pos"][None, :, None],
                         0.0, -1e9).astype(np.float32)
    return a


def _j(a, k):
    dt = jnp.bfloat16 if k in ("x", "wqkv", "wout", "w1", "w2", "ck", "cv") else None
    return jnp.asarray(a[k], dt)


def _t(a, k):
    if k in ("x", "wqkv", "wout", "w1", "w2", "ck", "cv"):
        return _bf16(a[k])
    return torch.from_numpy(a[k].copy())


def _quant(a):
    q = {}
    for k in ("wqkv", "wout", "w1", "w2"):
        q[k + "_q"], q["s" + k[1:]] = quantize_per_channel(a[k], axis=0)
    return q


def _attn_jax(a, H, q=None):
    if q is None:
        out = JF.fused_attn_step(_j(a, "x"), _j(a, "lns"), _j(a, "lnb"), _j(a, "wqkv"),
                                 _j(a, "bqkv"), _j(a, "wout"), _j(a, "bout"), _j(a, "ck"),
                                 _j(a, "cv"), _j(a, "pos"), _j(a, "mask"), heads=H)
    else:
        out = JF.fused_attn_step_int8(
            _j(a, "x"), _j(a, "lns"), _j(a, "lnb"), jnp.asarray(q["wqkv_q"]), _j(a, "bqkv"),
            jnp.asarray(q["sqkv"]), jnp.asarray(q["wout_q"]), _j(a, "bout"),
            jnp.asarray(q["sout"]), _j(a, "ck"), _j(a, "cv"), _j(a, "pos"), _j(a, "mask"),
            heads=H)
    return [np.asarray(o, np.float32) for o in out]


def _attn_port(a, H, q=None, ck=None, cv=None):
    ck = _t(a, "ck") if ck is None else ck
    cv = _t(a, "cv") if cv is None else cv
    if q is None:
        return PF.fused_attn_step(_t(a, "x"), _t(a, "lns"), _t(a, "lnb"), _t(a, "wqkv"),
                                  _t(a, "bqkv"), _t(a, "wout"), _t(a, "bout"), ck, cv,
                                  _t(a, "pos"), _t(a, "mask"), heads=H)
    tq = {k: torch.from_numpy(v) for k, v in q.items()}
    return PF.fused_attn_step_int8(_t(a, "x"), _t(a, "lns"), _t(a, "lnb"), tq["wqkv_q"],
                                   _t(a, "bqkv"), tq["sqkv"], tq["wout_q"], _t(a, "bout"),
                                   tq["sout"], ck, cv, _t(a, "pos"), _t(a, "mask"), heads=H)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.fixture(scope="module")
def inputs():
    s = SHAPES
    return _inputs(s["S"], s["D"], s["T"], s["F"])


def _check_caches(a, got_k, got_v, want_k, want_v):
    S = a["x"].shape[0]
    rows, at = np.arange(S), a["pos"]
    for got, want, before in ((got_k, want_k, a["ck"]), (got_v, want_v, a["cv"])):
        g = got.float().numpy()
        # the rows written at pos[s]: one bf16 rounding of an f32 sum each
        np.testing.assert_allclose(g[at, rows], want[at, rows], rtol=BF16_ULP, atol=1e-6)
        assert not np.allclose(g[at, rows], before[at, rows])
        # everything else: byte-identical to the input
        keep = np.ones(g.shape[:2], bool)
        keep[at, rows] = False
        assert g[keep].tobytes() == before[keep].tobytes()


@pytest.mark.parametrize("int8", [False, True])
def test_fused_attn_step_matches_jax(inputs, int8):
    a, H = inputs, SHAPES["H"]
    q = _quant(a) if int8 else None
    jx, jk, jv = _attn_jax(a, H, q)
    ck, cv = _t(a, "ck"), _t(a, "cv")
    before = PF.fused_attn_step.launches
    x, ck2, cv2 = _attn_port(a, H, q, ck, cv)
    assert PF.fused_attn_step.launches == before  # the plain version does not count
    assert ck2 is ck and cv2 is cv
    assert x.dtype == torch.bfloat16 and x.shape == a["x"].shape
    assert _rel(x.float().numpy(), jx) <= 2e-2
    _check_caches(a, ck, cv, jk, jv)


@pytest.mark.parametrize("int8", [False, True])
def test_fused_mlp_step_matches_jax(inputs, int8):
    a = inputs
    args_j = (_j(a, "x"), _j(a, "lns"), _j(a, "lnb"))
    args_p = (_t(a, "x"), _t(a, "lns"), _t(a, "lnb"))
    if int8:
        q = _quant(a)
        want = JF.fused_mlp_step_int8(*args_j, jnp.asarray(q["w1_q"]), _j(a, "b1"),
                                      jnp.asarray(q["s1"]), jnp.asarray(q["w2_q"]),
                                      _j(a, "b2"), jnp.asarray(q["s2"]))
        tq = {k: torch.from_numpy(v) for k, v in q.items()}
        got = PF.fused_mlp_step_int8(*args_p, tq["w1_q"], _t(a, "b1"), tq["s1"], tq["w2_q"],
                                     _t(a, "b2"), tq["s2"])
    else:
        want = JF.fused_mlp_step(*args_j, _j(a, "w1"), _j(a, "b1"), _j(a, "w2"), _j(a, "b2"))
        got = PF.fused_mlp_step(*args_p, _t(a, "w1"), _t(a, "b1"), _t(a, "w2"), _t(a, "b2"))
    assert got.dtype == torch.bfloat16 and got.shape == a["x"].shape
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 2e-2


@pytest.mark.parametrize("int8", [False, True])
def test_fused_attn_step_ignores_keys_past_pos(inputs, int8):
    """Keys and values beyond pos[s], poisoned to ±50, leave row s's output
    unchanged: the mask bias removes them exactly."""
    a, H = inputs, SHAPES["H"]
    q = _quant(a) if int8 else None
    base = _attn_port(a, H, q)[0]
    poisoned = dict(a)
    T, S = a["ck"].shape[:2]
    beyond = np.arange(T)[:, None] > a["pos"][None, :]
    rng = np.random.default_rng(11)
    for k in ("ck", "cv"):
        c = a[k].copy()
        c[beyond] = np.where(rng.random(c[beyond].shape) < 0.5, -50.0, 50.0)
        poisoned[k] = c
    got = _attn_port(poisoned, H, q)[0]
    assert torch.equal(got, base)


def _dequant(a, q):
    d = dict(a)
    for k in ("wqkv", "wout", "w1", "w2"):
        d[k] = q[k + "_q"].astype(np.float32) * q["s" + k[1:]][None, :]
    return d


def test_int8_matches_bf16_on_dequantised_weights(inputs):
    """The int8 variants against the bf16 plain versions on the dequantised
    weights rounded to bf16: the same products up to that one rounding of
    each weight (relative 2^-9) and the scale's place on the accumulator."""
    a, H = inputs, SHAPES["H"]
    q = _quant(a)
    deq = _dequant(a, q)
    x8, k8, v8 = _attn_port(a, H, q)
    xb, kb, vb = _attn_port(deq, H)
    assert _rel(x8.float().numpy(), xb.float().numpy()) <= 2e-2
    assert _rel(k8.float().numpy(), kb.float().numpy()) <= 2e-2
    tq = {k: torch.from_numpy(v) for k, v in q.items()}
    m8 = PF.fused_mlp_step_int8(_t(a, "x"), _t(a, "lns"), _t(a, "lnb"), tq["w1_q"],
                                _t(a, "b1"), tq["s1"], tq["w2_q"], _t(a, "b2"), tq["s2"])
    mb = PF.fused_mlp_step(_t(deq, "x"), _t(deq, "lns"), _t(deq, "lnb"), _t(deq, "w1"),
                           _t(deq, "b1"), _t(deq, "w2"), _t(deq, "b2"))
    assert _rel(m8.float().numpy(), mb.float().numpy()) <= 2e-2


def _attn_numpy(a, H):
    """The attention step in numpy, independent of both packages."""
    def bf(x):
        return _bf16(x).float().numpy()

    S, D = a["x"].shape
    T, hd = a["ck"].shape[0], D // H
    x32 = a["x"]
    mu, var = x32.mean(-1, keepdims=True), x32.var(-1, keepdims=True)
    h = bf((x32 - mu) / np.sqrt(var + 1e-5) * a["lns"] + a["lnb"])
    qkv = bf(h.astype(np.float64) @ a["wqkv"] + a["bqkv"])
    q, k_new, v_new = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    ck, cv = a["ck"].copy(), a["cv"].copy()
    ck[a["pos"], np.arange(S)] = k_new
    cv[a["pos"], np.arange(S)] = v_new
    scores = np.einsum("shd,tshd->tsh", q.reshape(S, H, hd) * hd ** -0.5,
                       ck.reshape(T, S, H, hd)) + a["mask"]
    e = np.exp(scores - scores.max(0, keepdims=True))
    p = e / e.sum(0, keepdims=True)
    ctx = bf(np.einsum("tsh,tshd->shd", p, cv.reshape(T, S, H, hd)).reshape(S, D))
    return x32 + ctx @ a["wout"] + a["bout"], ck, cv


@pytest.mark.parametrize("S,D,H,T", [(8, 96, 3, 32), (3, 60, 5, 7), (2, 128, 1, 1)])
def test_fused_attn_step_odd_heads_matches_numpy(S, D, H, T):
    a = _inputs(S, D, T, 4 * D, seed=S + H)
    want_x, want_k, want_v = _attn_numpy(a, H)
    ck, cv = _t(a, "ck"), _t(a, "cv")
    x, ck2, cv2 = _attn_port(a, H, None, ck, cv)
    assert ck2 is ck and cv2 is cv
    assert _rel(x.float().numpy(), want_x) <= 2e-2
    _check_caches(a, ck, cv, want_k, want_v)


def test_fully_masked_row_is_finite_and_uniform():
    """A row that sees no key (every mask entry -1e9) stays finite: its
    context is the mean of its values, as in the JAX kernel."""
    a = _inputs(4, 64, 16, 256, seed=3)
    a["mask"][:, 2] = -1e9
    x, _, cv = _attn_port(a, 2)
    assert torch.isfinite(x.float()).all()
    want, _, _ = _attn_numpy(a, 2)
    assert _rel(x.float().numpy(), want) <= 2e-2


def test_wrappers_check_shapes_on_cpu(inputs):
    a, H = inputs, SHAPES["H"]
    with pytest.raises(ValueError, match="not divisible by heads"):
        _attn_port(a, 3)
    bad = dict(a)
    bad["mask"] = a["mask"][:, :, 0]
    with pytest.raises(ValueError, match="mask_bias must be"):
        _attn_port(bad, H)
    with pytest.raises(ValueError, match="w2 must be"):
        PF.fused_mlp_step(_t(a, "x"), _t(a, "lns"), _t(a, "lnb"), _t(a, "w1"), _t(a, "b1"),
                          _t(a, "w1"), _t(a, "b2"))
