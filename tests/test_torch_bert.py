"""The port's BERT (pytorch_zappa_serverless_tpu_torch/models/bert.py) held
against the JAX package's on the same weights and inputs.

The JAX servable's param tree crosses to the port through
``engine.weights.params_from_jax``, so both packages compute on the same
bytes.  Inputs come from a numpy seed.  Tolerances:

- f32: probabilities within 1e-5, the difference of summation orders
  between XLA on the CPU and PyTorch on the CPU;
- bf16: ``rtol=0.05, atol=0.02`` on probabilities, as tests/test_bert_int8.py
  holds the int8 lane, because the two frameworks round bf16 at other
  places.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.models import bert as JB
from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as j_builder
from pytorch_zappa_serverless_tpu_torch import models as _port_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig as PModelConfig
from pytorch_zappa_serverless_tpu_torch.engine.weights import params_from_jax
from pytorch_zappa_serverless_tpu_torch.models import bert as PB
from pytorch_zappa_serverless_tpu_torch.ops.int8_matmul import int8_matmul
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder as p_builder

TINY_ARCH = {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
             "vocab_size": 512, "max_position": 64}


def _cfgs(dtype: str, int8: bool, **extra):
    kw = dict(name="bert_base", dtype=dtype, seq_buckets=(8,), batch_buckets=(2,),
              extra={"arch": TINY_ARCH, **({"params_dtype": "int8"} if int8 else {}),
                     **extra})
    return JModelConfig(**kw), PModelConfig(**kw)


def _pair(dtype: str, int8: bool, **extra):
    """(JAX servable, port servable) holding the same weights."""
    jc, pc = _cfgs(dtype, int8, **extra)
    jsv = j_builder("bert_base")(jc)
    psv = p_builder("bert_base")(pc)
    psv.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jsv.params)))
    return jsv, psv


_PAIRS: dict = {}


@pytest.fixture(scope="module")
def pair():
    def get(dtype, int8):
        if (dtype, int8) not in _PAIRS:
            _PAIRS[dtype, int8] = _pair(dtype, int8)
        return _PAIRS[dtype, int8]
    yield get
    _PAIRS.clear()


def _inputs(batch=2, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 500, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[1, 5:] = 0  # a padded row: its tail must not reach the real tokens
    ids[1, 5:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": np.zeros((batch, seq), np.int32)}


def _probs_jax(jsv, inputs):
    return np.asarray(jax.jit(jsv.apply_fn)(jsv.params, inputs)["probs"], np.float32)


def _probs_port(psv, inputs):
    with torch.inference_mode():
        out = psv.apply_fn(psv.module, {k: torch.from_numpy(v) for k, v in inputs.items()})
    return out["probs"].float().numpy()


@pytest.mark.parametrize("dtype,int8,tol", [
    ("float32", False, {"rtol": 0, "atol": 1e-5}),
    ("float32", True, {"rtol": 0, "atol": 1e-5}),
    ("bfloat16", False, {"rtol": 0.05, "atol": 0.02}),
    ("bfloat16", True, {"rtol": 0.05, "atol": 0.02}),
])
def test_classifier_matches_jax(pair, dtype, int8, tol):
    jsv, psv = pair(dtype, int8)
    inputs = _inputs()
    got, want = _probs_port(psv, inputs), _probs_jax(jsv, inputs)
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_int8_tree_layout(pair):
    _, psv = pair("bfloat16", True)
    sd = psv.module.state_dict()
    assert sd["layer0.attention.query.kernel_q"].dtype == torch.int8
    assert sd["layer0.intermediate.kernel_q"].shape == (32, 64)  # [K, N]
    assert sd["layer0.output.scale"].shape == (32,)
    assert "layer0.output.weight" not in sd
    # Embeddings, norms, pooler and classifier stay float.
    assert sd["pooler.weight"].dtype == torch.float32
    assert sd["embeddings_ln.weight"].dtype == torch.float32
    assert isinstance(psv.module.layer1.output, PB.Int8Dense)
    assert psv.module.layer1.output.matmul is int8_matmul


def test_params_from_jax_layout(pair):
    jsv, psv = pair("float32", False)
    sd = psv.module.state_dict()
    jp = jax.tree.map(np.asarray, jsv.params)
    np.testing.assert_array_equal(sd["layer0.attention.query.weight"].numpy(),
                                  jp["layer0"]["attention"]["query"]["kernel"].T)
    np.testing.assert_array_equal(sd["layer1.output_ln.weight"].numpy(),
                                  jp["layer1"]["output_ln"]["scale"])
    np.testing.assert_array_equal(sd["word_embeddings.weight"].numpy(),
                                  jp["word_embeddings"]["embedding"])
    assert len(sd) == len(jax.tree.leaves(jp))


@pytest.mark.parametrize("dtype,int8,atol", [("float32", False, 1e-5),
                                              ("float32", True, 1e-5),
                                              ("bfloat16", True, 2e-2)])
def test_padded_matches_unpadded(pair, dtype, int8, atol):
    """A 37-token input in the 64 bucket gives the logits of an unpadded
    run: the -1e9 bias zeroes the padded keys exactly, and only the
    products' blocking changes with the shape."""
    _, psv = pair(dtype, int8)
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 500, (1, 37)).astype(np.int32)
    short = {"input_ids": ids, "attention_mask": np.ones_like(ids),
             "token_type_ids": np.zeros_like(ids)}
    padded = {k: np.pad(v, ((0, 0), (0, 64 - 37))) for k, v in short.items()}
    np.testing.assert_allclose(_probs_port(psv, padded), _probs_port(psv, short),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("vocab", [512, 1500, 30522])
def test_fallback_tokenize_matches_jax(vocab):
    for text in ["", "hello world", "The quick brown fox, jumped!", "a " * 300,
                 "Ünïcode wörds ok"]:
        assert PB._fallback_tokenize(text, vocab) == JB._fallback_tokenize(text, vocab)


def test_preprocess_matches_jax(pair):
    jsv, psv = pair("float32", False)
    payloads = [{"text": "hello there world"}, {"input_ids": [101, 7, 8, 102]},
                "plain string body", {"text": "long " * 20}]  # 22 ids → truncated to 8
    for p in payloads:
        got, want = psv.preprocess(p), jsv.preprocess(p)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    assert psv.meta["seq_len_of"](psv.preprocess(payloads[0])) == 5


def test_overlength_error_matches_jax():
    jc, pc = _cfgs("float32", False, overlength="error")
    jsv, psv = j_builder("bert_base")(jc), p_builder("bert_base")(pc)
    for sv in (jsv, psv):
        with pytest.raises(ValueError, match="longest configured seq bucket is 8"):
            sv.preprocess({"input_ids": list(range(9))})


def test_postprocess_json_matches_jax():
    jc, pc = _cfgs("float32", False, labels=["neg", "pos"])
    jsv, psv = j_builder("bert_base")(jc), p_builder("bert_base")(pc)
    probs = np.array([[0.25, 0.75], [0.9, 0.1]], np.float32)
    for i in range(2):
        got = json.dumps(psv.postprocess({"probs": probs}, i))
        assert got == json.dumps(jsv.postprocess({"probs": probs}, i))
    assert psv.postprocess({"probs": probs}, 0)["scores"][0]["label"] == "pos"


def _hf_state_dict(seed: int = 8) -> dict[str, torch.Tensor]:
    """A seed-filled state dict under Hugging Face BertForSequenceClassification
    key names, at the tiny arch."""
    g = torch.Generator().manual_seed(seed)
    d, f, v = 32, 64, TINY_ARCH["vocab_size"]

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    sd = {"bert.embeddings.word_embeddings.weight": t(v, d),
          "bert.embeddings.position_embeddings.weight": t(64, d),
          "bert.embeddings.token_type_embeddings.weight": t(2, d),
          "bert.embeddings.LayerNorm.weight": 1 + t(d),
          "bert.embeddings.LayerNorm.bias": t(d),
          "bert.embeddings.position_ids": torch.arange(64)[None],
          "bert.pooler.dense.weight": t(d, d), "bert.pooler.dense.bias": t(d),
          "classifier.weight": t(2, d), "classifier.bias": t(2)}
    for i in range(TINY_ARCH["num_layers"]):
        p = f"bert.encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (d, d), "attention.self.key": (d, d),
                             "attention.self.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (f, d), "output.dense": (d, f)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = t(o, n), t(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = 1 + t(d), t(d)
    return sd


@pytest.mark.parametrize("int8", [False, True])
def test_checkpoint_import_matches_jax(tmp_path, int8):
    from pytorch_zappa_serverless_tpu.engine import weights as JW
    from pytorch_zappa_serverless_tpu_torch.engine import weights as PW

    path = tmp_path / "bert.pt"
    torch.save(_hf_state_dict(), path)
    got = PW.import_params(path, PW.convert_bert)
    want = JW.import_params(path, JW.convert_bert)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    jc, pc = _cfgs("float32", int8)
    jc.checkpoint = pc.checkpoint = str(path)
    jsv, psv = j_builder("bert_base")(jc), p_builder("bert_base")(pc)
    inputs = _inputs(seed=9)
    np.testing.assert_allclose(_probs_port(psv, inputs), _probs_jax(jsv, inputs),
                               rtol=0, atol=1e-5)


# -- bert_embed: mean-pooled, L2-normalised sentence embeddings ----------------

def _embed_pair(dtype: str, int8: bool = False):
    """(JAX servable, port servable) of ``bert_embed`` holding the same
    weights."""
    kw = dict(name="bert_embed", dtype=dtype, seq_buckets=(16,), batch_buckets=(2,),
              extra={"arch": TINY_ARCH, **({"params_dtype": "int8"} if int8 else {})})
    jsv = j_builder("bert_embed")(JModelConfig(**kw))
    psv = p_builder("bert_embed")(PModelConfig(**kw))
    psv.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jsv.params)))
    return jsv, psv


def _embed_port(psv, inputs):
    with torch.inference_mode():
        out = psv.apply_fn(psv.module, {k: torch.from_numpy(v) for k, v in inputs.items()})
    return out["embedding"].numpy()


@pytest.mark.parametrize("dtype,int8,atol", [("float32", False, 1e-5), ("float32", True, 1e-5),
                                              ("bfloat16", False, 2e-2)])
def test_bert_embed_matches_jax(dtype, int8, atol):
    """Mask-aware mean pool of the last hidden states, in f32, L2-normalised:
    fp32 within 1e-5 per element, bf16 within 2e-2 (the bf16 roundings of
    two frameworks, as the classifier's bf16 case)."""
    jsv, psv = _embed_pair(dtype, int8)
    inputs = _inputs(seq=16, seed=3)
    want = np.asarray(jax.jit(jsv.apply_fn)(jsv.params, inputs)["embedding"])
    got = _embed_port(psv, inputs)
    assert got.shape == want.shape == (2, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert json.dumps(psv.postprocess({"embedding": got}, 1)) == json.dumps(
        jsv.postprocess({"embedding": got}, 1))


def test_bert_embed_padded_matches_unpadded():
    """A 9-token input padded to 16 embeds as the same 9 tokens alone: the
    -1e9 bias keeps the pad keys out, the mask keeps the pad rows out of
    the mean."""
    _, psv = _embed_pair("float32")
    ids = np.random.default_rng(11).integers(1, 500, (1, 9)).astype(np.int32)
    short = {"input_ids": ids, "attention_mask": np.ones_like(ids),
             "token_type_ids": np.zeros_like(ids)}
    padded = {k: np.pad(v, ((0, 0), (0, 7))) for k, v in short.items()}
    np.testing.assert_allclose(_embed_port(psv, padded), _embed_port(psv, short), rtol=0,
                               atol=1e-6)


def test_bert_embed_leaves_the_callers_config_alone():
    cfg = PModelConfig(name="bert_embed", dtype="float32", seq_buckets=(8,), batch_buckets=(1,),
                       extra={"arch": TINY_ARCH})
    sv = p_builder("bert_embed")(cfg)
    assert cfg.extra == {"arch": TINY_ARCH} and sv.name == "bert_embed"
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_latency_class

    assert get_latency_class("bert_embed") == "latency"
    out = sv.postprocess({"embedding": np.full((1, 32), 32 ** -0.5, np.float32)}, 0)
    assert len(out["embedding"]) == 32 and isinstance(out["embedding"][0], float)
