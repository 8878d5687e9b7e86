"""The port's W8A16 op (pytorch_zappa_serverless_tpu_torch/ops/int8_matmul.py)
held against the JAX package's, on the same numpy inputs.

- The plain version (what the wrapper computes for CPU tensors) against the
  JAX ``int8_matmul`` Pallas kernel in interpret mode, as
  tests/test_int8_matmul.py runs it.  Both accumulate in f32 over the exact
  int8 values; bf16 results differ only by summation order and one rounding
  of the output, hence ``rtol = atol = 2e-2`` there.  f32 inputs compute in
  f32 on both sides (no bf16 anywhere), so they agree to summation order.
- The host-side quantizer, pad and tree rewrite give the same bytes.
- CPU tensors never launch the kernel; the kernel itself is held against
  the plain version in tests/test_torch_kernels_cuda.py, on a GPU only.
- The launch planner's tiles cover the output once and its K splits
  partition the K tiles, at every main-path shape and the ragged ones; the
  wrapper's padded copies (operands TMA cannot describe) give the plain
  version's result; every variant of tools/int8_ablation still applies to
  the kernel source.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.ops import int8_matmul as J
from pytorch_zappa_serverless_tpu_torch.ops import _build
from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as P
from pytorch_zappa_serverless_tpu_torch.tools import int8_ablation as ablation

SHAPES = [
    (8, 768, 768),      # tests/test_int8_matmul.py's shapes
    (16, 768, 3072),
    (8, 3072, 768),
    (128, 768, 1024),
    (3, 100, 50),
    (4, 768, 768),      # BERT-base projections at a small M
    (4, 768, 3072),
    (4, 3072, 768),
    (8, 768, 2304),     # GPT-2 small decode: the fused q|k|v projection
    (1, 3072, 768),     # GPT-2 small decode: fc2 at one row
]


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32) * 0.5
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    w_q, scale = P.quantize_per_channel(w, axis=0)
    return x, w_q, scale


def _jax(x, w_q, scale, dtype, out_dtype=None):
    return np.asarray(J.int8_matmul(jnp.asarray(x, dtype), jnp.asarray(w_q),
                                    jnp.asarray(scale), out_dtype=out_dtype),
                      np.float32)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_jax_bf16(m, k, n):
    x, w_q, scale = _operands(m, k, n)
    got = P.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(w_q),
                        torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), _jax(x, w_q, scale, jnp.bfloat16),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("m,k,n", [(8, 768, 768), (3, 100, 50), (4, 3072, 768)])
def test_plain_matches_jax_f32_out(m, k, n):
    x, w_q, scale = _operands(m, k, n, seed=1)
    got = P.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(w_q),
                        torch.from_numpy(scale), out_dtype=torch.float32)
    want = _jax(x, w_q, scale, jnp.bfloat16, out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    # f32 out of an f32 accumulator: only the summation order differs.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(8, 768, 768), (3, 100, 50)])
def test_plain_matches_jax_f32_in(m, k, n):
    x, w_q, scale = _operands(m, k, n, seed=2)
    got = P.int8_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                        torch.from_numpy(scale))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax(x, w_q, scale, jnp.float32),
                               rtol=1e-5, atol=1e-5)


def test_quantize_per_channel_same_bytes():
    rng = np.random.default_rng(3)
    for shape in [(768, 768), (100, 50), (3072, 768)]:
        w = rng.standard_normal(shape).astype(np.float32) * 0.02
        w[:, 0] = 0.0  # an all-zero column takes scale 1.0 on both sides
        pq, ps = P.quantize_per_channel(w, axis=0)
        jq, js = J.quantize_per_channel(w, axis=0)
        assert pq.dtype == jq.dtype == np.int8
        assert pq.tobytes() == jq.tobytes() and ps.tobytes() == js.tobytes()


def test_pad_weights_same_bytes():
    _, w_q, scale = _operands(3, 100, 50)
    pw, ps = P.pad_weights(w_q, scale)
    jw, js = J.pad_weights(w_q, scale)
    assert pw.shape == (128, 128) and ps.shape == (128,)
    assert pw.tobytes() == jw.tobytes() and ps.tobytes() == js.tobytes()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("min_size", [1, 1024])
def test_quantize_tree_same_bytes(min_size):
    rng = np.random.default_rng(4)
    params = {
        "wte": {"embedding": rng.standard_normal((64, 32)).astype(np.float32)},
        "layer0": {
            "q": {"kernel": rng.standard_normal((64, 64)).astype(np.float32),
                  "bias": np.zeros(64, np.float32)},
            "small": {"kernel": rng.standard_normal((8, 8)).astype(np.float32)},
            "ln": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)},
        },
    }
    got = dict(_leaves(P.quantize_tree(params, min_size=min_size)))
    want = dict(_leaves(J.quantize_tree(params, min_size=min_size)))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_dense_maybe_int8_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32) * 0.05
    b = rng.standard_normal((128,)).astype(np.float32)
    w_q, scale = P.quantize_per_channel(w, axis=0)
    for quantized in (True, False):
        node = ({"kernel_q": w_q, "scale": scale, "bias": b} if quantized
                else {"kernel": w, "bias": b})
        got = P.dense_maybe_int8({k: torch.from_numpy(v) for k, v in node.items()},
                                 torch.from_numpy(x).bfloat16())
        want = J.dense_maybe_int8({k: jnp.asarray(v) for k, v in node.items()},
                                  jnp.asarray(x, jnp.bfloat16))
        assert got.dtype == torch.bfloat16 and got.shape == (2, 5, 128)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_cpu_tensors_do_not_launch():
    x, w_q, scale = _operands(4, 64, 32)
    before = P.int8_matmul.launches
    P.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(w_q),
                  torch.from_numpy(scale))
    P.dense_maybe_int8({"kernel_q": torch.from_numpy(w_q),
                        "scale": torch.from_numpy(scale)},
                       torch.from_numpy(x)[None])
    assert P.int8_matmul.launches == before == 0


@pytest.mark.parametrize("bad,exc", [
    ({"x": torch.zeros(4, 64, dtype=torch.float16)}, TypeError),
    ({"w_q": torch.zeros(64, 32)}, TypeError),
    ({"scale": torch.ones(32, dtype=torch.float64)}, TypeError),
    ({"w_q": torch.zeros(63, 32, dtype=torch.int8)}, ValueError),
    ({"scale": torch.ones(31)}, ValueError),
    ({"x": torch.zeros(2, 4, 64)}, ValueError),
])
def test_wrapper_rejects_bad_operands(bad, exc):
    ops = {"x": torch.zeros(4, 64), "w_q": torch.zeros(64, 32, dtype=torch.int8),
           "scale": torch.ones(32)}
    ops.update(bad)
    with pytest.raises(exc):
        P.int8_matmul(ops["x"], ops["w_q"], ops["scale"])


# (K, N) of every int8 product on the served paths: GPT-2 small's four layer
# projections and its padded lm head, BERT-base's (K, N) are among them.
LAYER_KN = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
HEAD_KN = (768, 50304)
PLAN_SHAPES = ([(m, k, n) for m in (1, 8, 16, 64, 128, 512, 1024)
                for k, n in LAYER_KN + [HEAD_KN]]
               + [(3, 100, 50), (200, 136, 272), (1, 8, 16), (65, 64, 4096), (129, 4096, 40)])


def _grid(p, m, n):
    """The kernel's grid for plan ``p``: (column tiles, row tiles, splits)."""
    return -(-n // p.bn), -(-m // p.bm), p.splits


def _k_slices(k, splits):
    """The K tiles [t0, t1) of each split, as the kernel cuts them
    (csrc/int8_matmul.cu: kt0 = split * k_tiles / splits)."""
    k_tiles = -(-k // P.BK)
    return [(s * k_tiles // splits, (s + 1) * k_tiles // splits) for s in range(splits)]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_tiles_cover_the_output_once(m, k, n):
    p = P.plan(m, k, n)
    assert (p.bm, p.bn) in P.TILES
    gx, gy, gz = _grid(p, m, n)
    # Tile i covers [i·b, (i+1)·b) ∩ [0, extent): the last one starts inside.
    for tiles, b, extent in ((gx, p.bn, n), (gy, p.bm, m)):
        assert (tiles - 1) * b < extent <= tiles * b
    if m * n <= 1 << 22:  # and explicitly, cell by cell
        count = np.zeros((m, n), np.int32)
        for bx in range(gx):
            for by in range(gy):
                count[by * p.bm:(by + 1) * p.bm, bx * p.bn:(bx + 1) * p.bn] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_splits_partition_the_k_tiles(m, k, n):
    p = P.plan(m, k, n)
    slices = _k_slices(k, p.splits)
    assert len(slices) == p.splits
    assert all(t1 > t0 for t0, t1 in slices)  # no split is empty
    assert [t for t0, t1 in slices for t in range(t0, t1)] == list(range(-(-k // P.BK)))


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_cluster_divides_the_grid(m, k, n):
    p = P.plan(m, k, n)
    assert p.cluster == p.splits and 1 <= p.cluster <= P.MAX_CLUSTER
    assert _grid(p, m, n)[2] % p.cluster == 0


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k,n", LAYER_KN)
def test_plan_fills_the_card_at_decode(m, k, n):
    gx, gy, gz = _grid(P.plan(m, k, n), m, n)
    assert gx * gy * gz >= P.SMS


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros(8, 768, dtype=torch.bfloat16), True),
    (lambda: torch.zeros(3, 100, dtype=torch.bfloat16), False),   # 200-byte rows
    (lambda: torch.zeros(768, 768, dtype=torch.int8), True),
    (lambda: torch.zeros(100, 50, dtype=torch.int8), False),      # 50-byte rows
    (lambda: torch.zeros(1 + 8 * 768, dtype=torch.bfloat16)[1:].view(8, 768), False),  # base
])
def test_tma_describable_says_which_operands_need_a_copy(make, want):
    assert P.tma_describable(make()) is want


@pytest.mark.parametrize("shape,dtype", [((3, 100), torch.bfloat16), ((100, 50), torch.int8),
                                         ((5, 33), torch.float32), ((8, 768), torch.bfloat16)])
def test_padded_copy_is_describable_and_keeps_the_values(shape, dtype):
    t = (torch.arange(shape[0] * shape[1]) % 251 - 125).reshape(shape).to(dtype)
    c = P.padded_copy(t)
    assert P.tma_describable(c) and c.shape == t.shape and c.stride(1) == 1
    assert c.stride(0) * c.element_size() % 16 == 0 and c.stride(0) - shape[1] < 16
    assert torch.equal(c, t)


@pytest.mark.parametrize("m,k,n", [(3, 100, 50), (5, 36, 200), (1, 8, 24)])
def test_padded_operands_give_the_plain_result(m, k, n):
    x, w_q, scale = _operands(m, k, n, seed=9)
    x, w_q, scale = torch.from_numpy(x).bfloat16(), torch.from_numpy(w_q), torch.from_numpy(scale)
    xp = x if P.tma_describable(x) else P.padded_copy(x)
    wp = w_q if P.tma_describable(w_q) else P.padded_copy(w_q)
    assert (xp is not x) or (wp is not w_q)
    for out_dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(P.int8_matmul_reference(xp, wp, scale, out_dtype),
                           P.int8_matmul_reference(x, w_q, scale, out_dtype))


@pytest.mark.parametrize("name", sorted({**ablation.VARIANTS, **ablation.PROBES}))
def test_ablation_variants_apply_to_the_kernel_source(name):
    """Each variant of tools/int8_ablation takes out one part of the kernel
    (each probe changes one constant); its substitutions must still match
    the source once each."""
    source = (_build.CSRC / ablation.SOURCE).read_text()
    assert (ablation.apply_variant(source, name) == source) == (name == "kernel")
