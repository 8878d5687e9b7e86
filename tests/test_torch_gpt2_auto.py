"""GPT-2's regime-routed lane in the port (``extra.params_dtype: "auto"``),
the twin of the JAX package's ``tests/test_gpt2_auto.py`` at its tiny
arch (width 128, 2 layers, bf16, ``int8_crossover_batch`` 2), on the CPU.

One servable holds both trees and routes each program by its static row
count: prefill always on the bf16 tree, decode on the int8 tree at up to
the crossover, on the bf16 tree above.

- The dual tree: the int8 tree holds only what it quantized, and the
  embeddings and LayerNorms are held once, in the bf16 tree; the engine's
  at-rest cast leaves both trees alone, and the model's bytes are the int8
  lane's plus the bf16 layer weights and biases, exactly.
- Below the crossover the tokens are bf16 prefill followed by int8 decode,
  composed by hand, and zeroing the int8 tree's ``lm_scale`` changes them;
  above it they are the bf16 lane's and the poison does not reach them.
- The int8 product runs 4 x layers + 1 times a decode position below the
  crossover, and never at prefill nor above it.
- The port's tokens are the JAX package's ``auto`` servable's on the same
  seeded weights and inputs, both bucket sizes.
- The slot and paged ``:generate`` lanes on ``auto`` give the fixed route's
  tokens; ``auto`` on a family without the lane fails at boot.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as j_builder
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.compiled import CompiledModel
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import gpt2 as PG
from pytorch_zappa_serverless_tpu_torch.ops.int8_matmul import int8_matmul
from pytorch_zappa_serverless_tpu_torch.serving.generation import (GenerationScheduler,
                                                                   PagedGenerationScheduler)
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder as p_builder

TINY_ARCH = {"vocab_size": 512, "d_model": 128, "layers": 2, "heads": 2, "ffn_dim": 256,
             "max_positions": 64, "eos_id": 511}
WAIT_S = 60


def _mc(cls=ModelConfig, **extra):
    return cls(name="gpt2", dtype="bfloat16", seq_buckets=(16,), batch_buckets=(1, 4),
               extra={"max_new_tokens": 8, "arch": TINY_ARCH, "quantize_min_size": 1024,
                      **extra})


def _build(**extra):
    return p_builder("gpt2")(_mc(**extra))


@pytest.fixture(scope="module")
def sv_auto():
    return _build(params_dtype="auto", int8_crossover_batch=2)


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, 500, (batch, 16)).astype(np.int32),
            "length": np.full((batch,), 16, np.int32),
            "temperature": np.zeros((batch,), np.float32),
            "seed": np.zeros((batch,), np.int32),
            "top_k": np.zeros((batch,), np.int32),
            "top_p": np.ones((batch,), np.float32),
            "repetition_penalty": np.ones((batch,), np.float32)}


def _apply(sv, inputs, tree=None):
    class M:  # apply_fn reads the tree through module.tree()
        def tree(self):
            return tree if tree is not None else sv.module.tree()

    with torch.inference_mode():
        return sv.apply_fn(M(), {k: torch.from_numpy(v) for k, v in inputs.items()})[
            "tokens"].numpy()


def _poisoned(sv):
    tree = sv.module.tree()
    return {**tree, "int8": {**tree["int8"], "lm_scale": torch.zeros_like(
        tree["int8"]["lm_scale"])}}


def test_dual_tree_holds_each_shared_leaf_once(sv_auto):
    tree = sv_auto.module.tree()
    assert set(tree) == {"bf16", "int8"}
    assert tree["int8"]["layer0"]["qkv"]["kernel_q"].dtype == torch.int8
    assert "qkv" not in tree["bf16"]["layer0"]
    for leaf in ("wte", "wpe", "ln_f"):
        assert leaf not in tree["int8"]
    assert "ln1" not in tree["int8"]["layer0"] and "ln2" not in tree["int8"]["layer1"]
    dec = PG.int8_view(tree, 2)
    assert dec["wte"] is tree["bf16"]["wte"] and dec["wpe"] is tree["bf16"]["wpe"]
    assert dec["layer1"]["ln2"]["scale"] is tree["bf16"]["layer1"]["ln2"]["scale"]
    assert dec["layer0"]["qkv"] is tree["int8"]["layer0"]["qkv"]
    ids = [id(t) for t in sv_auto.module.buffers()]
    assert len(ids) == len(set(ids))


def test_engine_bytes_are_int8_plus_the_bf16_layers():
    """Through the engine: no at-rest cast of the trees, and the model's
    bytes are the int8 lane's plus the bf16 layer weights and biases."""
    def nbytes(**extra):
        mc = _mc(**extra)
        cm = CompiledModel(p_builder("gpt2")(mc), mc, torch.device("cpu"))
        return cm, cm.param_nbytes()

    cm, auto = nbytes(params_dtype="auto", int8_crossover_batch=2)
    _, int8 = nbytes(params_dtype="int8")
    tree = cm.servable.module.tree()
    assert tree["bf16"]["layer0"]["q"]["kernel"].dtype == torch.bfloat16
    assert tree["bf16"]["layer0"]["q"]["bias"].dtype == torch.float32
    layers = sum(t.numel() * t.element_size() for i in range(2)
                 for p in ("q", "k", "v", "out", "fc1", "fc2")
                 for t in tree["bf16"][f"layer{i}"][p].values())
    D, F = TINY_ARCH["d_model"], TINY_ARCH["ffn_dim"]
    assert layers == 2 * ((4 * D * D + 2 * D * F) * 2 + (4 * D + F + D) * 4)
    assert auto - int8 == layers


def test_small_batch_routes_int8_decode(sv_auto):
    """b1 <= crossover: bf16 prefill + int8 decode composed by hand, and
    poisoning the int8 tree's lm head changes the output: the b1 program
    reads the int8 tree (greedy chains alone can coincide across lanes)."""
    cfg, dtype = sv_auto.meta["config"], sv_auto.meta["dtype"]
    inputs = _inputs(1)
    got = _apply(sv_auto, inputs)
    tree = sv_auto.module.tree()
    T = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.inference_mode():
        want = PG.generate(tree["bf16"], T["input_ids"], T["length"], T["temperature"],
                           T["seed"], 8, cfg, dtype, decode_params=PG.int8_view(tree, 2)).numpy()
    np.testing.assert_array_equal(got, want)
    pois = _apply(sv_auto, inputs, _poisoned(sv_auto))
    assert not np.array_equal(got, pois)
    assert (pois[0, 1:] == 0).all()  # all-zero logits argmax to id 0


def test_large_batch_routes_bf16(sv_auto):
    """b4 > crossover: the bf16 lane's tokens, and the int8 poison does not
    reach the b4 program."""
    inputs = _inputs(4)
    got = _apply(sv_auto, inputs)
    plain = _build(params_dtype="bfloat16")
    mc = _mc(params_dtype="bfloat16")
    cm = CompiledModel(plain, mc, torch.device("cpu"))  # the engine's at-rest cast
    np.testing.assert_array_equal(got, _apply(cm.servable, inputs))
    np.testing.assert_array_equal(got, _apply(sv_auto, inputs, _poisoned(sv_auto)))


def test_int8_launches_per_decode_position(sv_auto, monkeypatch):
    """4 x layers + 1 int8 products a decode position at b1 (each layer's
    fused q|k|v, out, fc1 and fc2, and the f32 lm head), none at prefill
    and none at b4."""
    calls = []

    def counting(x, w_q, scale, **kw):
        calls.append(int(x.shape[0]))
        return int8_matmul(x, w_q, scale, **kw)

    monkeypatch.setattr(PG, "int8_mm", counting)
    _apply(sv_auto, _inputs(1))
    assert len(calls) == 8 * (4 * TINY_ARCH["layers"] + 1) and set(calls) == {1}
    calls.clear()
    _apply(sv_auto, _inputs(4))
    assert calls == []


@pytest.mark.parametrize("batch", [1, 4])
def test_tokens_match_the_jax_auto_servable(sv_auto, batch):
    """The port's routed lane against the JAX package's on the same seeded
    weights and inputs (its int8 product the Pallas kernel in interpret
    mode): the same tokens at each side of the crossover."""
    mc = _mc(JModelConfig, params_dtype="auto", int8_crossover_batch=2)
    jsv = j_builder("gpt2")(mc)
    inputs = _inputs(batch)
    want = np.asarray(jax.jit(jsv.apply_fn)(jsv.params, inputs)["tokens"])
    np.testing.assert_array_equal(_apply(sv_auto, inputs), want)


def test_generation_lanes_match_the_fixed_route():
    """The slot and paged lanes on ``auto`` (2 slots: the int8 decode tree)
    stream the fixed route's tokens at b1 (also the int8 decode tree)."""
    models = [ModelConfig(name="gpt2", dtype="bfloat16", batch_buckets=(1,), seq_buckets=(16,),
                          coalesce_ms=1.0, kv_cache=kv, kv_block_size=4,
                          extra={"max_new_tokens": 8, "arch": TINY_ARCH,
                                 "quantize_min_size": 1024, "params_dtype": "auto",
                                 "int8_crossover_batch": 2, "gen_slots": 2,
                                 "segment_tokens": 3})
              for kv in ("slot", "paged")]
    for mc in models:
        eng = build_engine(ServeConfig(warmup_at_boot=False, models=[mc]), device="cpu")
        try:
            cm = eng.model("gpt2")
            samples = [cm.servable.preprocess({"input_ids": list(range(1, n))}) for n in (9, 5)]
            want = [eng.runner.run_fn_sync(cm.run_batch, [s])[0][0]["tokens"] for s in samples]
            lane = PagedGenerationScheduler if mc.kv_cache == "paged" else GenerationScheduler

            async def scenario():
                sched = lane(cm, eng.runner, cm.cfg).start()
                try:
                    return [await asyncio.wait_for(sched.submit(s).done, WAIT_S)
                            for s in samples]
                finally:
                    await sched.stop()

            assert asyncio.run(scenario()) == want, mc.kv_cache
        finally:
            eng.shutdown()


def test_auto_rejected_without_the_lane():
    mc = ModelConfig(name="resnet18", batch_buckets=(1,),
                     extra={"image_size": 32, "resize_to": 40, "params_dtype": "auto"})
    sv = p_builder("resnet18")(mc)
    with pytest.raises(ValueError, match="auto"):
        CompiledModel(sv, mc, torch.device("cpu"))
