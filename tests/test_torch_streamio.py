"""The port's stream checkpoint format (pytorch_zappa_serverless_tpu_torch/
engine/streamio.py, ``weights.save_stream``/``open_stream``), on the CPU.

- Every converter family of the port round-trips through ``save_stream`` /
  ``open_stream`` byte-identically (as the JAX package's
  ``tests/test_weights_native.py`` holds its own), on the trees the
  converters make from tiny torch models, at a chunk size small enough that
  tensors span chunks and chunks span tensors.
- The two packages share the format: a ``.tpu.ckpt`` the JAX package writes
  opens in the port to the same tree (bfloat16 and int8 leaves included),
  and the reverse.
- bfloat16 round-trips with ``ml_dtypes`` blocked from import (the card's
  machine has none).
- A consumer failure with a full staging ring raises within 15 s.
"""

import builtins
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu_torch.engine import streamio
from pytorch_zappa_serverless_tpu_torch.engine import weights as W

ROOT = Path(__file__).resolve().parents[1]


def _sd(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _tree_resnet():
    from torch_refs import randomize_bn_stats, torch_resnet18

    tm = torch_resnet18()
    randomize_bn_stats(tm)
    return W.convert_resnet(_sd(tm))


def _tree_efficientnet():
    from torch_refs import randomize_bn_stats
    from transformers import EfficientNetConfig
    from transformers.models.efficientnet.modeling_efficientnet import (
        EfficientNetForImageClassification)

    torch.manual_seed(0)
    hf = EfficientNetForImageClassification(EfficientNetConfig(
        width_coefficient=0.25, depth_coefficient=0.5, hidden_dim=320, num_labels=20))
    randomize_bn_stats(hf)
    return W.convert_efficientnet(_sd(hf))


def _tree_bert():
    from transformers import BertConfig, BertForSequenceClassification

    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=300, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=64, num_labels=3)
    return W.convert_bert(_sd(BertForSequenceClassification(cfg)))


def _tree_gpt2():
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    cfg = GPT2Config(vocab_size=500, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    return W.convert_gpt2(_sd(GPT2LMHeadModel(cfg)))


def _tree_vit():
    from transformers import ViTConfig, ViTForImageClassification

    torch.manual_seed(0)
    cfg = ViTConfig(image_size=32, patch_size=8, num_hidden_layers=2, num_attention_heads=2,
                    hidden_size=32, intermediate_size=64, num_labels=5)
    return W.convert_vit(_sd(ViTForImageClassification(cfg)))


def _tree_whisper():
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    torch.manual_seed(0)
    cfg = WhisperConfig(d_model=64, encoder_layers=2, decoder_layers=2,
                        encoder_attention_heads=2, decoder_attention_heads=2,
                        encoder_ffn_dim=128, decoder_ffn_dim=128)
    return W.convert_whisper(_sd(WhisperForConditionalGeneration(cfg)))


FAMILIES = {"resnet": _tree_resnet, "efficientnet": _tree_efficientnet, "bert": _tree_bert,
            "gpt2": _tree_gpt2, "vit": _tree_vit, "whisper": _tree_whisper}


def _bytes(x) -> tuple:
    dtype, shape, data = streamio.leaf_bytes(x)
    return dtype, shape, bytes(data)


def _assert_identical(expected, got):
    """Same key set, and per leaf: dtype name, shape, payload bytes."""
    eflat, gflat = W.flatten_tree(expected), W.flatten_tree(got)
    assert set(eflat) == set(gflat)
    for name, e in eflat.items():
        assert _bytes(gflat[name]) == _bytes(e), name


def _no_converter(sd):
    raise AssertionError("the stream fast path must not invoke the converter")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converter_family_stream_round_trip(family, tmp_path):
    tree = FAMILIES[family]()
    path = tmp_path / f"{family}{W.STREAM_SUFFIX}"
    W.save_stream(tree, path, chunk_bytes=1 << 14)
    _assert_identical(tree, W.import_params(path, _no_converter))
    got, stats = W.open_stream(path)
    _assert_identical(tree, got)
    assert all(isinstance(v, torch.Tensor) for v in W.flatten_tree(got).values())
    assert stats.chunks_streamed > 1 and stats.bytes_read > 0
    assert stats.tensors == len(W.flatten_tree(tree))


def _mixed_tree_np():
    """The dtypes the quantized and half-precision zoo stages (numpy, with
    ml_dtypes' bfloat16 for the JAX side)."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    return {
        "wte": rng.standard_normal((37, 16)).astype(ml_dtypes.bfloat16),
        "h0": {"w": rng.standard_normal((16, 16)).astype(np.float16),
               "scale": rng.standard_normal((16,)).astype(np.float32),
               "empty": np.zeros((0, 4), np.float32)},
        "q": {"w_int8": rng.integers(-128, 127, (16, 48)).astype(np.int8),
              "idx": np.arange(48, dtype=np.int32)},
    }


def test_jax_written_stream_opens_in_the_port(tmp_path):
    from pytorch_zappa_serverless_tpu.engine import weights as JW

    tree = _mixed_tree_np()
    path = tmp_path / f"m{W.STREAM_SUFFIX}"
    JW.save_stream(tree, path, chunk_bytes=1 << 9)
    got, stats = W.open_stream(path)
    _assert_identical(tree, got)
    assert W.flatten_tree(got)["wte"].dtype == torch.bfloat16
    assert stats.chunks_streamed > 1


def test_port_written_stream_opens_in_the_jax_package(tmp_path):
    from pytorch_zappa_serverless_tpu.engine import weights as JW

    want = _mixed_tree_np()
    # The port writes torch tensors (bf16 as torch's own dtype).
    tree = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else
                torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16))
            for k, v in want.items()}
    path = tmp_path / f"m{W.STREAM_SUFFIX}"
    W.save_stream(tree, path, chunk_bytes=1 << 9)
    got, stats = JW.open_stream(path)
    _assert_identical(want, got)
    assert got["wte"].dtype.name == "bfloat16" and stats.chunks_streamed > 1
    # And one file's bytes from either writer are the same file.
    jpath = tmp_path / f"j{W.STREAM_SUFFIX}"
    JW.save_stream(want, jpath, chunk_bytes=1 << 9)
    assert jpath.read_bytes() == path.read_bytes()


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """In a fresh interpreter where importing ``ml_dtypes`` raises: a bf16
    tree the port writes opens back byte-identical."""
    code = (
        "import builtins, sys\n"
        "real = builtins.__import__\n"
        "def guard(name, *a, **k):\n"
        "    if name.split('.')[0] == 'ml_dtypes':\n"
        "        raise ImportError('ml_dtypes is blocked')\n"
        "    return real(name, *a, **k)\n"
        "builtins.__import__ = guard\n"
        "sys.modules.pop('ml_dtypes', None)\n"
        "import torch\n"
        "from pytorch_zappa_serverless_tpu_torch.engine import weights as W\n"
        "g = torch.Generator().manual_seed(0)\n"
        "tree = {'a': torch.randn(33, 17, generator=g).to(torch.bfloat16),\n"
        "        'b': {'c': torch.randn(5, generator=g).to(torch.bfloat16)}}\n"
        f"path = {str(tmp_path / ('bf16' + W.STREAM_SUFFIX))!r}\n"
        "W.save_stream(tree, path, chunk_bytes=64)\n"
        "got, stats = W.open_stream(path)\n"
        "assert got['a'].dtype == torch.bfloat16 and got['b']['c'].dtype == torch.bfloat16\n"
        "assert torch.equal(got['a'].view(torch.int16), tree['a'].view(torch.int16))\n"
        "assert torch.equal(got['b']['c'].view(torch.int16), tree['b']['c'].view(torch.int16))\n"
        "assert 'ml_dtypes' not in sys.modules and stats.chunks_streamed > 1\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_bf16_loads_in_process_with_ml_dtypes_import_blocked(tmp_path, monkeypatch):
    """The same in this process: the loader never reaches for ml_dtypes."""
    real = builtins.__import__

    def guard(name, *a, **k):
        if name.split(".")[0] == "ml_dtypes":
            raise ImportError("ml_dtypes is blocked")
        return real(name, *a, **k)

    tree = {"w": torch.arange(100, dtype=torch.float32).to(torch.bfloat16).reshape(10, 10)}
    path = tmp_path / f"w{W.STREAM_SUFFIX}"
    W.save_stream(tree, path, chunk_bytes=32)
    monkeypatch.setattr(builtins, "__import__", guard)
    got, _ = W.open_stream(path)
    assert torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))


def test_consumer_failure_with_a_full_ring_raises_in_time(tmp_path):
    """place_fn failing while the reader has the ring full: the error comes
    back within 15 s, no deadlock."""
    rng = np.random.default_rng(1)
    tree = {f"h{i}": rng.standard_normal(4096).astype(np.float32) for i in range(16)}
    path = tmp_path / f"m{W.STREAM_SUFFIX}"
    W.save_stream(tree, path, chunk_bytes=1024)  # 256 chunks, a ring of 4
    calls = []

    def boom(t):
        calls.append(1)
        raise RuntimeError("device out of memory")

    out = []

    def run():
        try:
            W.open_stream(path, place_fn=boom)
        except RuntimeError as e:
            out.append(str(e))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=15.0)
    assert out == ["device out of memory"], "stream_load deadlocked on a consumer failure"
    assert calls == [1]


def test_layers_ready_in_execution_order(tmp_path):
    tree = {"wte": np.ones(8, np.float32), "h1": {"w": np.ones(8, np.float32)},
            "h0": {"w": np.ones(8, np.float32)}, "ln_f": {"scale": np.ones(8, np.float32)}}
    path = tmp_path / f"m{W.STREAM_SUFFIX}"
    index = W.save_stream(tree, path, chunk_bytes=16)
    assert [t.name for t in index.tensors] == ["wte", "h0/w", "h1/w", "ln_f/scale"]
    seen = []
    _, stats = W.open_stream(path, on_layer=seen.append)
    assert seen == stats.layers_ready == ["wte", "h0", "h1", "ln_f"]
