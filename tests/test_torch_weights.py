"""Staged checkpoints (``*.tpu.safetensors``) through the port.

The JAX package's ``save_native`` stages a converted param tree (what its
``tpuserve stage`` writes); the port's ``import_params`` must load that file
to the same tree, byte for byte, without running a converter, and the port's
servable built from it must answer as the JAX servable built from the same
file.  Tolerances are the parity tests' own: BERT f32 probabilities within
1e-5 (tests/test_torch_bert.py), GPT-2 f32 greedy tokens identical
(tests/test_torch_gpt2.py).
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.engine import weights as JW
from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as j_builder
from pytorch_zappa_serverless_tpu_torch import models as _port_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder as p_builder
from test_torch_bert import _cfgs as _bert_cfgs
from test_torch_bert import _hf_state_dict as _bert_hf
from test_torch_bert import _inputs as _bert_inputs
from test_torch_bert import _probs_jax, _probs_port
from test_torch_gpt2 import JModelConfig, PModelConfig, _build, _cfg, _tokens_jax, _tokens_port
from test_torch_gpt2 import _hf_state_dict as _gpt2_hf


def _assert_same_tree(got, want):
    got, want = PW.flatten_tree(got), JW.flatten_tree(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def _np_state(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.mark.parametrize("int8", [False, True])
def test_bert_staged_by_jax_loads_in_the_port(tmp_path, int8):
    tree = JW.convert_bert(_np_state(_bert_hf()))
    path = tmp_path / "params.tpu.safetensors"
    JW.save_native(tree, path)
    _assert_same_tree(PW.import_params(path, PW.convert_bert), tree)
    jc, pc = _bert_cfgs("float32", int8)
    jc.checkpoint = pc.checkpoint = str(path)
    jsv, psv = j_builder("bert_base")(jc), p_builder("bert_base")(pc)
    inputs = _bert_inputs(seed=4)
    np.testing.assert_allclose(_probs_port(psv, inputs), _probs_jax(jsv, inputs),
                               rtol=0, atol=1e-5)


def test_gpt2_staged_by_jax_loads_in_the_port(tmp_path):
    cfg = _cfg()
    tree = JW.convert_gpt2(_np_state(_gpt2_hf(cfg)))
    path = tmp_path / "gpt2.tpu.safetensors"
    JW.save_native(tree, path)
    _assert_same_tree(PW.import_params(path, PW.convert_gpt2), tree)
    arch = {"heads": cfg.heads}
    _, jmc = _build(j_builder, JModelConfig, arch)
    _, pmc = _build(p_builder, PModelConfig, arch)
    jmc.checkpoint = pmc.checkpoint = str(path)
    jsv, psv = j_builder("gpt2")(jmc), p_builder("gpt2")(pmc)
    assert psv.meta["config"].d_model == cfg.d_model
    samples = [jsv.preprocess({"input_ids": [5, 6, 7, 8, 9]}),
               jsv.preprocess({"input_ids": [40, 41]})]
    np.testing.assert_array_equal(_tokens_port(psv, samples), _tokens_jax(jsv, samples))


def test_port_save_native_round_trips(tmp_path):
    tree = JW.convert_gpt2(_np_state(_gpt2_hf(_cfg())))
    tree["layer0"]["q"]["kernel_q"] = np.arange(-8, 8, dtype=np.int8).reshape(4, 4)
    path = tmp_path / "rt.tpu.safetensors"
    PW.save_native(tree, path)
    back = PW.load_native(path)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    _assert_same_tree(back, tree)
    # the JAX package reads what the port stages
    _assert_same_tree(JW.load_native(path), tree)


def test_save_native_refuses_other_names_and_slashed_keys(tmp_path):
    with pytest.raises(ValueError, match=r"\.tpu\.safetensors"):
        PW.save_native({"w": np.zeros(2, np.float32)}, tmp_path / "params.safetensors")
    with pytest.raises(ValueError, match="separator"):
        PW.save_native({"a/b": np.zeros(2, np.float32)}, tmp_path / "p.tpu.safetensors")


def test_import_params_converts_other_files(tmp_path):
    """A plain .safetensors state dict still goes through the converter."""
    from safetensors.torch import save_file

    sd = {k: v.contiguous() for k, v in _bert_hf().items()}
    path = tmp_path / "bert.safetensors"
    save_file(sd, str(path))
    _assert_same_tree(PW.import_params(path, PW.convert_bert),
                      JW.convert_bert(_np_state(sd)))
    assert torch.equal(torch.from_numpy(PW.load_state_dict(path)["classifier.bias"]),
                       sd["classifier.bias"])
