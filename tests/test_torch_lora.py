"""The port's LoRA functions (``ops/lora.py``, the adapter half of
``engine/weights.py``) held against the JAX package's on the same
numpy-seeded inputs.

- ``lora_delta`` and ``lora_apply`` at fp32, 2-D and 3-D: within 1e-6 of
  the JAX package's (two small products, summed in different orders);
- slot 0 returns the base output bitwise (a select, not ``y + 0``), and a
  co-batched dispatch equals each row run alone, bitwise;
- the host-side pool (``zero_stacks``, ``install_adapter``, ``clear_slot``,
  ``adapter_nbytes``), ``validate_adapter``'s refusals, ``convert_lora``,
  ``init_lora`` and the staged save/import: byte-identical to the JAX
  package's;
- ``merge_adapter`` equals the runtime delta (within 1e-5 at fp32);
- ``write_slot`` writes one slot in place, cast to the stack's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.engine import weights as JW
from pytorch_zappa_serverless_tpu.ops import lora as JL
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.ops import lora as PL

DIMS = {"q": (16, 16), "v": (16, 16), "fc1": (16, 48)}


def _stacks(S=4, r=4, seed=0):
    g = np.random.default_rng(seed)
    a = (g.standard_normal((S, 16, r)) * 0.3).astype(np.float32)
    b = (g.standard_normal((S, r, 48)) * 0.3).astype(np.float32)
    a[0], b[0] = 0.0, 0.0
    return a, b


@pytest.mark.parametrize("shape", [(5, 16), (5, 7, 16)], ids=["2d", "3d"])
def test_delta_and_apply_match_jax(shape):
    g = np.random.default_rng(1)
    x = g.standard_normal(shape).astype(np.float32)
    y = g.standard_normal(shape[:-1] + (48,)).astype(np.float32)
    a, b = _stacks()
    idx = np.array([0, 1, 2, 3, 1], np.int32)
    want = np.asarray(JL.lora_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(idx)))
    got = PL.lora_delta(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(idx)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    node_j = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    node_p = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    want = np.asarray(JL.lora_apply(jnp.asarray(y), jnp.asarray(x), node_j, jnp.asarray(idx)))
    got = PL.lora_apply(torch.from_numpy(y), torch.from_numpy(x), node_p,
                        torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_zero_is_the_base_bitwise(dtype):
    """Rows at slot 0 get ``y`` back selected: the same bits even where a
    stale non-zero stack sits in slot 0's place of another pool."""
    g = np.random.default_rng(2)
    x = torch.from_numpy(g.standard_normal((4, 6, 16)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(g.standard_normal((4, 6, 48)).astype(np.float32)).to(dtype)
    a, b = _stacks()
    node = {"a": torch.from_numpy(a).to(dtype), "b": torch.from_numpy(b).to(dtype)}
    out = PL.lora_apply(y, x, node, torch.tensor([0, 2, 0, 1]))
    assert torch.equal(out[0], y[0]) and torch.equal(out[2], y[2])
    assert not torch.equal(out[1], y[1]) and not torch.equal(out[3], y[3])
    assert torch.equal(PL.lora_apply(y, x, node, torch.zeros(4, dtype=torch.int64)), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_equals_sequential_bitwise(dtype):
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal((5, 3, 16)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(g.standard_normal((5, 3, 48)).astype(np.float32)).to(dtype)
    a, b = _stacks()
    node = {"a": torch.from_numpy(a).to(dtype), "b": torch.from_numpy(b).to(dtype)}
    idx = torch.tensor([3, 1, 0, 2, 1])
    batched = PL.lora_apply(y, x, node, idx)
    for i in range(5):
        assert torch.equal(batched[i:i + 1], PL.lora_apply(y[i:i + 1], x[i:i + 1], node,
                                                            idx[i:i + 1]))


def _tree(seed=0, layers=2, rank=4):
    return JW.init_lora(layers, DIMS, rank, seed=seed)


def test_host_pool_matches_jax():
    jst = {f"layer{i}": JL.zero_stacks(4, 8, DIMS) for i in range(2)}
    pst = {f"layer{i}": PL.zero_stacks(4, 8, DIMS) for i in range(2)}
    for slot, seed, scaling in ((1, 5, 2.0), (3, 6, 0.5)):
        tree = _tree(seed)
        JL.install_adapter(jst, slot, tree, scaling=scaling)
        PL.install_adapter(pst, slot, tree, scaling=scaling)
    JL.clear_slot(jst, 3)
    PL.clear_slot(pst, 3)
    for lname in jst:
        for t in DIMS:
            for h in "ab":
                assert np.asarray(pst[lname][t][h]).tobytes() == jst[lname][t][h].tobytes()
    assert PL.adapter_nbytes(_tree(5)) == JL.adapter_nbytes(_tree(5))


@pytest.mark.parametrize("case,match", [
    ("target", "not in the configured adapter_targets"),
    ("shape", "do not match the base projection"),
    ("rank_mismatch", "rank mismatch"),
    ("empty", "carries no factors"),
    ("rank", "exceeds the configured adapter_rank"),
    ("layers", "missing layer1"),
])
def test_validate_adapter_refuses_as_jax(case, match):
    tree = _tree(rank=4)
    kw = {}
    rank = 8
    if case == "target":
        tree["layer0"]["k"] = tree["layer0"]["q"]
    elif case == "shape":
        tree["layer0"]["q"] = {"a": np.zeros((15, 4), np.float32),
                               "b": np.zeros((4, 16), np.float32)}
    elif case == "rank_mismatch":
        tree["layer0"]["q"] = {"a": np.zeros((16, 4), np.float32),
                               "b": np.zeros((3, 16), np.float32)}
    elif case == "empty":
        tree = {"layer0": {}}
    elif case == "rank":
        rank = 2
    else:
        del tree["layer1"]
        kw["layers"] = 2
    for fn in (JL.validate_adapter, PL.validate_adapter):
        with pytest.raises(ValueError, match=match):
            fn(tree, DIMS, rank, name="m:a", **kw)
    assert PL.validate_adapter(_tree(rank=4), DIMS, 8, layers=2) == 4


def _peft_sd(seed=0, fused=True, prefix="base_model.model.transformer.h"):
    """A synthetic PEFT state dict for a 2-layer GPT-2: the fused c_attn
    (B [3D, r]) or split q/v projections, and the MLP's c_fc."""
    g = np.random.default_rng(seed)
    sd = {}
    for i in range(2):
        if fused:
            sd[f"{prefix}.{i}.attn.c_attn.lora_A.weight"] = g.standard_normal((4, 16))
            sd[f"{prefix}.{i}.attn.c_attn.lora_B.weight"] = g.standard_normal((48, 4))
        else:
            for proj in ("q_proj", "v_proj"):
                sd[f"{prefix}.{i}.attn.{proj}.lora_A.default.weight"] = g.standard_normal((4, 16))
                sd[f"{prefix}.{i}.attn.{proj}.lora_B.default.weight"] = g.standard_normal((16, 4))
        sd[f"{prefix}.{i}.mlp.c_fc.lora_A.weight"] = g.standard_normal((4, 16))
        sd[f"{prefix}.{i}.mlp.c_fc.lora_B.weight"] = g.standard_normal((48, 4))
        sd[f"{prefix}.{i}.attn.c_attn.weight"] = g.standard_normal((16, 48))  # not lora
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("fused,prefix", [(True, "base_model.model.transformer.h"),
                                          (False, "base_model.model.transformer.h"),
                                          (True, "h")], ids=["peft-fused", "peft-split", "bare"])
def test_convert_lora_matches_jax(fused, prefix):
    sd = _peft_sd(fused=fused, prefix=prefix)
    got, want = PW.convert_lora(sd), JW.convert_lora(sd)
    _same_tree(got, want)
    if fused:
        # A shared, B in thirds: q|k|v.
        b = sd[f"{prefix}.0.attn.c_attn.lora_B.weight"].T
        np.testing.assert_array_equal(got["layer0"]["k"]["b"], b[:, 16:32])
        assert got["layer0"]["q"]["a"].tobytes() == got["layer0"]["v"]["a"].tobytes()


@pytest.mark.parametrize("sd,match", [({"h.0.attn.q_proj.lora_A.weight": np.zeros((2, 4))},
                                       "incomplete"),
                                      ({"x.lora_A.weight": np.zeros((2, 4))}, "unrecognized"),
                                      ({"w": np.zeros(2)}, "no lora_A/lora_B")])
def test_convert_lora_refuses_as_jax(sd, match):
    for fn in (JW.convert_lora, PW.convert_lora):
        with pytest.raises((KeyError, ValueError), match=match):
            fn(sd)


def test_init_lora_save_and_import_byte_identical(tmp_path):
    got, want = PW.init_lora(2, DIMS, 4, seed=7), JW.init_lora(2, DIMS, 4, seed=7)
    _same_tree(got, want)
    PW.save_adapter(got, tmp_path / "p.tpu.safetensors")
    JW.save_adapter(want, tmp_path / "j.tpu.safetensors")
    assert ((tmp_path / "p.tpu.safetensors").read_bytes()
            == (tmp_path / "j.tpu.safetensors").read_bytes())
    _same_tree(PW.import_adapter(tmp_path / "j.tpu.safetensors"), want)
    sd = _peft_sd(seed=3)
    from safetensors.numpy import save_file

    save_file(sd, str(tmp_path / "a.safetensors"))
    _same_tree(PW.import_adapter(tmp_path / "a.safetensors"),
               JW.import_adapter(tmp_path / "a.safetensors"))


def test_merge_adapter_equals_runtime_delta():
    """W + A B s as one matmul equals the base projection plus the slot's
    delta at run time, and the merge matches the JAX package's bytes."""
    g = np.random.default_rng(4)
    base = {f"layer{i}": {t: {"kernel": (g.standard_normal((k, n)) * 0.1).astype(np.float32),
                              "bias": np.zeros(n, np.float32)} for t, (k, n) in DIMS.items()}
            for i in range(2)}
    tree = _tree(9)
    merged = PW.merge_adapter(base, tree, scaling=1.5)
    _same_tree(merged, JW.merge_adapter(base, tree, scaling=1.5))
    assert base["layer0"]["q"]["kernel"] is not merged["layer0"]["q"]["kernel"]
    pool = {f"layer{i}": PL.zero_stacks(2, 4, DIMS) for i in range(2)}
    PL.install_adapter(pool, 1, tree, scaling=1.5)
    x = torch.from_numpy(g.standard_normal((3, 16)).astype(np.float32))
    for lname in base:
        for t in DIMS:
            w = torch.from_numpy(base[lname][t]["kernel"])
            node = {h: torch.from_numpy(pool[lname][t][h]) for h in "ab"}
            runtime = PL.lora_apply(x @ w, x, node, torch.ones(3, dtype=torch.int64))
            folded = x @ torch.from_numpy(merged[lname][t]["kernel"])
            torch.testing.assert_close(runtime, folded, atol=1e-5, rtol=0)


def test_write_slot_in_place_and_cast():
    pool = {"layer0": PL.zero_stacks(3, 4, DIMS)}
    PL.install_adapter(pool, 2, {"layer0": _tree(1)["layer0"]}, scaling=2.0)
    dev = {"layer0": {t: {h: torch.zeros(pool["layer0"][t][h].shape, dtype=torch.bfloat16)
                          for h in "ab"} for t in DIMS}}
    ptrs = {(t, h): dev["layer0"][t][h].data_ptr() for t in DIMS for h in "ab"}
    PL.write_slot(dev, pool, 2)
    for t in DIMS:
        for h in "ab":
            d = dev["layer0"][t][h]
            assert d.data_ptr() == ptrs[(t, h)]
            assert torch.equal(d[2], torch.from_numpy(pool["layer0"][t][h][2]).to(torch.bfloat16))
            assert not d[:2].any()
    with pytest.raises(IndexError, match="outside the pool"):
        PL.write_slot(dev, pool, 3)
