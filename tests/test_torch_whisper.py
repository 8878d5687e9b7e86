"""The port's Whisper-tiny (pytorch_zappa_serverless_tpu_torch/models/whisper.py,
ops/logmel.py, ops/audio.py) held against the JAX package's, on the CPU.

Weights are the JAX package's seed tree (``init_whisper_params``, which the
port must reproduce byte for byte), for the greedy checks with every bias
and LayerNorm made non-trivial so that the chains do not collapse onto one
token; inputs come from numpy seeds.  The arch is
tests/test_whisper_int8.py's ``TINY_ARCH`` (128 wide, 2 + 2 layers, the
real 80 x 3000 log-mel and 1500 encoder positions).  Tolerances:

- host front end: the mel filter bank within 1e-6 of ``transformers``'
  slaney bank (it is bit-equal today); log-mel, resample (native and numpy)
  and the WAV decode byte-identical to the JAX package's (the same numpy
  and C++ arithmetic);
- f32 on both sides: encoder states and teacher-forced logits within 1e-4
  of the largest magnitude (XLA's and PyTorch's summation orders on the
  CPU); greedy tokens equal at every step whose top-2 margin exceeds twice
  the logits' error, up to a row's first EOT;
- the int8 lane in bf16, the JAX package's Pallas kernel in interpret mode
  against the port's plain int8 product: logits within 2e-2 of the largest
  (the bf16 roundings of two frameworks' unfused products, as the GPT-2
  int8 lane is held);
- the int8 rewrite and the converter: byte-identical trees.
"""

import base64
import dataclasses
import io
import json
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.engine import weights as JWT
from pytorch_zappa_serverless_tpu.models import whisper as JW
from pytorch_zappa_serverless_tpu.ops import audio as JA
from pytorch_zappa_serverless_tpu.ops import hostops as jhostops
from pytorch_zappa_serverless_tpu.ops import logmel as JL
from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as j_builder
from pytorch_zappa_serverless_tpu_torch import models as _port_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import weights as PWT
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import whisper as PW
from pytorch_zappa_serverless_tpu_torch.ops import audio as PA
from pytorch_zappa_serverless_tpu_torch.ops import hostops as phostops
from pytorch_zappa_serverless_tpu_torch.ops import logmel as PL
from pytorch_zappa_serverless_tpu_torch.ops.int8_matmul import int8_matmul_reference
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_latency_class
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder as p_builder

# tests/test_whisper_int8.py's TINY_ARCH.
TINY_ARCH = {"d_model": 128, "encoder_layers": 2, "decoder_layers": 2, "heads": 2,
             "ffn_dim": 256, "vocab_size": 512, "source_positions": 1500,
             "target_positions": 96}
F32_TOL = 1e-4     # x the largest magnitude
INT8_RTOL = 2e-2   # x the largest logit


def _jcfg():
    cfg = dataclasses.replace(JW.TINY, **TINY_ARCH)
    return dataclasses.replace(cfg, eot_id=cfg.vocab_size - 2, sot_id=cfg.vocab_size - 1)


def _pcfg(jcfg=None):
    return PW.WhisperConfig(**dataclasses.asdict(jcfg or _jcfg()))


def _randomize(tree, seed):
    """Every bias and LayerNorm of a numpy tree made non-trivial, and the
    decoder's kernels (x10) and embeddings (x5) scaled up, so that greedy
    chains move from token to token (at the seed's scale one token repeats)."""
    rng = np.random.default_rng(seed)

    def walk(node, decoder):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, decoder)
            elif k == "bias":
                out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif decoder and k in ("kernel", "embed_tokens", "pos_embed"):
                out[k] = (v * (10.0 if k == "kernel" else 5.0)).astype(np.float32)
            else:
                out[k] = v
        return out

    return {"encoder": walk(tree["encoder"], False), "decoder": walk(tree["decoder"], True)}


def _trees(seed=0, randomize=False):
    tree = JW.init_whisper_params(seed, _jcfg())
    if randomize:
        tree = _randomize(tree, seed + 100)
    return (jax.tree.map(jnp.asarray, tree),
            PWT.ParamTree(PW.state_from_jax(tree, torch.float32)).tree(), tree)


def _mel(batch, seed):
    return np.random.default_rng(seed).standard_normal((batch, 80, 3000)).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
                 / np.abs(np.asarray(want, np.float64)).max())


def _wav(x: np.ndarray, rate: int, width: int = 2, channels: int = 1) -> bytes:
    """A WAV of ``x`` [n] or [n, channels] in [-1, 1] at ``width`` bytes."""
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    x = np.repeat(x, channels, axis=1) if x.shape[1] == 1 else x
    if width == 1:
        pcm = np.clip(x * 127 + 128, 0, 255).astype(np.uint8)
    else:
        top = 2 ** (8 * width - 1) - 1
        pcm = np.clip(x * top, -top, top).astype({2: np.int16, 4: np.int32}[width])
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _tone(seconds, rate, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape)).astype(
        np.float32)


# -- host front end ------------------------------------------------------------

def test_mel_filters_match_transformers():
    from transformers.audio_utils import mel_filter_bank

    want = mel_filter_bank(num_frequency_bins=201, num_mel_filters=80, min_frequency=0.0,
                           max_frequency=8000.0, sampling_rate=16000, norm="slaney",
                           mel_scale="slaney").astype(np.float32)
    got = PL.mel_filters()
    assert got.shape == (201, 80) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6
    assert got.tobytes() == JL.mel_filters().tobytes()


@pytest.mark.parametrize("seconds,pad", [(0.5, True), (30.0, True), (41.3, True), (2.0, False)])
def test_log_mel_matches_jax(seconds, pad):
    audio = _tone(seconds, 16000, seed=int(seconds * 10))
    got = PL.log_mel_spectrogram(audio, pad_to_chunk=pad)
    want = JL.log_mel_spectrogram(audio, pad_to_chunk=pad)
    assert got.shape == want.shape and got.dtype == np.float32
    if pad:
        assert got.shape == (80, PL.N_FRAMES)
    assert got.tobytes() == want.tobytes()


@pytest.fixture(params=["native", "numpy"])
def resampler(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(phostops, "get_lib", lambda: None)
        monkeypatch.setattr(jhostops, "get_lib", lambda: None)
    else:
        assert phostops.native_available() and jhostops.native_available()
    return request.param


@pytest.mark.parametrize("src", [44100, 48000, 22050, 8000])
def test_resample_matches_jax(resampler, src):
    x = _tone(1.7, src, seed=src)
    got, want = PA.resample(x, src), JA.resample(x, src)
    assert got.shape == want.shape == (int(x.shape[0] * 16000 / src),)
    assert got.tobytes() == want.tobytes()


def test_resample_native_equals_numpy():
    x = _tone(1.3, 44100, seed=5)
    ratio = 16000 / 44100
    native = PA.resample(x, 44100)
    assert native.tobytes() == PA._resample_numpy(x, ratio, native.shape[0]).tobytes()
    assert PA.resample(x, 16000).tobytes() == x.tobytes()  # at the target rate: as it is


@pytest.mark.parametrize("samples", [0, 100, PL.CHUNK_SAMPLES, 2 * PL.CHUNK_SAMPLES + 1,
                                     65 * 16000])
def test_chunk_waveform_matches_jax(samples):
    audio = np.arange(samples, dtype=np.float32) / max(samples, 1)
    got, want = PL.chunk_waveform(audio), JL.chunk_waveform(audio)
    assert [w.tobytes() for w in got] == [w.tobytes() for w in want]
    assert len(got) == max(1, -(-samples // PL.CHUNK_SAMPLES))


@pytest.mark.parametrize("rate,width,channels", [(16000, 2, 1), (44100, 2, 2), (8000, 1, 1),
                                                 (48000, 4, 3), (22050, 2, 1)])
def test_wav_decode_matches_jax(rate, width, channels):
    data = _wav(_tone(0.8, rate, seed=rate), rate, width, channels)
    got, want = PW.decode_audio_payload(data), JW._decode_audio_payload(data)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("payload", [{"array": [0.1, -0.2, 0.3] * 400},
                                     {"array": [0.5, -0.25] * 2205, "rate": 44100}])
def test_array_payload_matches_jax(payload):
    got, want = PW.decode_audio_payload(payload), JW._decode_audio_payload(payload)
    assert got.tobytes() == want.tobytes()


# -- the model -------------------------------------------------------------------

@pytest.mark.parametrize("arch,seed", [(TINY_ARCH, 0), (TINY_ARCH, 3),
                                       ({"vocab_size": 640, "d_model": 64, "heads": 1,
                                         "encoder_layers": 1, "decoder_layers": 1,
                                         "ffn_dim": 128, "target_positions": 32}, 1)])
def test_init_params_byte_identical(arch, seed):
    jcfg = dataclasses.replace(JW.TINY, **arch)
    want = JW.init_whisper_params(seed, jcfg)
    got = PW.init_whisper_params(seed, _pcfg(jcfg))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert PW.config_from_params(got) == PW.WhisperConfig(
        **dataclasses.asdict(JW.config_from_params(want)))


@pytest.mark.parametrize("stride", [1, 2])
def test_stem_conv_bridge_matches_jax(stride):
    """The stem's WIO kernel [3, C_in, D] as a Conv1d weight [D, C_in, 3]: a
    permute, no flip, padding 1 each side, at fp32."""
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 50, 12)).astype(np.float32)  # NWC
    kernel = rng.standard_normal((3, 12, 8)).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, kernel, window_strides=(stride,), padding=[(1, 1)],
        dimension_numbers=("NWC", "WIO", "NWC")) + bias)
    conv2 = {"kernel": np.zeros((3, 8, 8), np.float32), "bias": np.zeros(8, np.float32)}
    sd = PW.state_from_jax({"encoder": {"conv1": {"kernel": kernel, "bias": bias},
                                        "conv2": conv2}, "decoder": {}}, torch.float32)
    p = {"weight": sd["encoder.conv1.weight"], "bias": sd["encoder.conv1.bias"]}
    assert tuple(p["weight"].shape) == (8, 12, 3)
    got = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2), p["weight"], p["bias"],
                                     stride, 1).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # _conv_gelu is that conv and an exact GELU.
    y = PW._conv_gelu(p, torch.from_numpy(x).transpose(1, 2), stride, torch.float32)
    np.testing.assert_allclose(y.transpose(1, 2).numpy(), np.asarray(jax.nn.gelu(
        want, approximate=False)), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def encoded():
    """(jax tree, port tree, encoder states from JAX) on a randomized tree."""
    jp, pp, _ = _trees(0, randomize=True)
    mel = _mel(2, 0)
    jcfg = _jcfg()
    je = np.asarray(jax.jit(lambda p, m: JW.encode(p, m, jcfg, jnp.float32))(jp, mel))
    return jp, pp, mel, je


def test_encode_matches_jax(encoded):
    _, pp, mel, want = encoded
    got = PW.encode(pp, torch.from_numpy(mel), _pcfg(), torch.float32)
    assert got.shape == (2, 1500, 128) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= F32_TOL


def _forced(jp, pp, enc, tokens):
    jcfg = _jcfg()
    want = np.asarray(jax.jit(lambda p, e, t: JW.decode_forced(p, e, t, jcfg, jnp.float32))(
        jp, jnp.asarray(enc), jnp.asarray(tokens)))
    got = PW.decode_forced(pp, torch.from_numpy(enc.copy()), torch.from_numpy(tokens), _pcfg(),
                           torch.float32).numpy()
    return got, want


def test_decode_forced_matches_jax(encoded):
    jp, pp, _, enc = encoded
    tokens = np.random.default_rng(1).integers(0, 512, (2, 7)).astype(np.int32)
    got, want = _forced(jp, pp, enc, tokens)
    assert got.shape == want.shape == (2, 7, 512) and got.dtype == np.float32
    assert _rel(got, want) <= F32_TOL


def test_greedy_matches_jax_where_decided(encoded):
    """Greedy tokens equal wherever each step's top-2 margin exceeds twice
    the logits' error, up to a row's first EOT."""
    jp, pp, _, enc = encoded
    jcfg, max_new = _jcfg(), 10
    prompt = np.full((2, 1), jcfg.sot_id, np.int32)
    want = np.asarray(jax.jit(lambda p, e: JW.decode_greedy(
        p, e, jnp.asarray(prompt), max_new, jcfg, jnp.float32))(jp, jnp.asarray(enc)))
    got = PW.decode_greedy(pp, torch.from_numpy(enc.copy()), torch.from_numpy(prompt), max_new,
                           _pcfg(), torch.float32).numpy()
    assert got.shape == want.shape == (2, max_new) and got.dtype == np.int32
    # The logits that decided each token: teacher-forced on the JAX chain.
    fed = np.concatenate([prompt, want[:, :-1]], axis=1)
    lg, lw = _forced(jp, pp, enc, fed)
    err = np.abs(lg - lw).max()
    checked = 0
    for row in range(2):
        for t in range(max_new):
            top2 = np.sort(lw[row, t])[-2:]
            if top2[1] - top2[0] <= 2 * err:
                break
            assert got[row, t] == want[row, t], (row, t)
            checked += 1
            if want[row, t] == jcfg.eot_id:
                break
    assert checked >= max_new and len(set(want.ravel())) > 2


def test_eot_pins_the_rest_of_a_row(monkeypatch):
    """After a row's first EOT every emit is EOT, while the fed tokens go on;
    the same scripted step logits through both packages."""
    jcfg = _jcfg()
    script = np.array([[5, jcfg.eot_id, 7, 9, 11, 13], [3, 4, 6, 8, 10, jcfg.eot_id]])
    V, P = jcfg.vocab_size, 1

    def j_step(params, cfg, dtype, cross, tok, pos, cache_k, cache_v, mask):
        onehot = jax.nn.one_hot(jnp.asarray(script)[:, pos - P], V) * 10.0
        return onehot, cache_k, cache_v

    def p_step(params, cfg, dtype, cross, tok, pos, cache_k, cache_v, mask):
        return torch.nn.functional.one_hot(torch.from_numpy(script[:, pos - P]), V).float() * 10

    monkeypatch.setattr(JW, "_decoder_step", j_step)
    monkeypatch.setattr(PW, "_decoder_step", p_step)
    jp, pp, _ = _trees(0)
    enc = np.zeros((2, 1500, 128), np.float32)
    prompt = np.full((2, P), jcfg.sot_id, np.int32)
    want = np.asarray(JW.decode_greedy(jp, jnp.asarray(enc), jnp.asarray(prompt), 6, jcfg,
                                       jnp.float32))
    got = PW.decode_greedy(pp, torch.from_numpy(enc), torch.from_numpy(prompt), 6, _pcfg(),
                           torch.float32).numpy()
    eot = jcfg.eot_id
    assert (got == want).all()
    assert list(got[0, 1:]) == [5, eot, eot, eot, eot]
    assert list(got[1, 1:]) == [3, 4, 6, 8, 10]


# -- the int8 lane ---------------------------------------------------------------

def _servables(**extra):
    kw = dict(name="whisper_tiny", dtype="bfloat16", batch_buckets=(1,),
              extra={"max_new_tokens": 6, "arch": TINY_ARCH, "quantize_min_size": 1024,
                     **extra})
    return j_builder("whisper_tiny")(JModelConfig(**kw)), p_builder("whisper_tiny")(
        ModelConfig(**kw))


@pytest.fixture(scope="module")
def int8_pair():
    return _servables(params_dtype="int8")


def test_int8_rewrite_byte_identical(int8_pair):
    """The port's rewrite gives the JAX servable's bytes: int8 kernels,
    scales and the padded lm head, and every >= 2-D float leaf in bf16."""
    jsv, psv = int8_pair
    want = jax.tree.map(np.asarray, jsv.params)
    got = PW.quantize_whisper(PW.init_whisper_params(0, _pcfg()), 2, 1024)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    sd = psv.module.state_dict()
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        names = [k.key for k in path]
        if w.dtype == ml_dtypes.bfloat16:
            g = g.astype(ml_dtypes.bfloat16)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), names
        key = ".".join(names)
        if names[-2:] == ["conv1", "kernel"] or names[-2:] == ["conv2", "kernel"]:
            t = sd[key[: -len("kernel")] + "weight"].permute(2, 1, 0).contiguous()
        else:
            t = sd[key]
        t = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 \
            else t.numpy()
        assert t.tobytes() == w.tobytes(), key
    dec = want["decoder"]
    for n in PW.INT8_PROJECTIONS:
        assert dec["layer0"][n]["kernel_q"].dtype == np.int8
    assert "kernel" in dec["layer0"]["ck"] and "kernel" in want["encoder"]["layer0"]["q"]


def test_int8_lane_logits_match_jax(int8_pair):
    """Teacher-forced bf16 logits of the int8 lane: the JAX package's Pallas
    kernel (interpret mode) against the port's plain int8 product."""
    jsv, psv = int8_pair
    jcfg, pcfg = _jcfg(), psv.meta["config"]
    mel = _mel(1, 2)
    tokens = np.asarray([[jcfg.sot_id, 17, 300, 42, 99]], np.int32)

    def jax_logits(p):
        enc = JW.encode(p, mel, jcfg, jnp.bfloat16)
        return JW.decode_forced(p, enc, jnp.asarray(tokens), jcfg, jnp.bfloat16)

    want = np.asarray(jax.jit(jax_logits)(jsv.params), np.float32)
    tree = psv.module.tree()
    with torch.inference_mode():
        enc = PW.encode(tree, torch.from_numpy(mel), pcfg, torch.bfloat16)
        got = PW.decode_forced(tree, enc, torch.from_numpy(tokens), pcfg, torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == (1, 5, 512)
    assert _rel(got.numpy(), want) <= INT8_RTOL


def test_int8_launches_per_generate_call(int8_pair, monkeypatch):
    """(8 projections x layers + the lm head) x (the prefill + max_new
    steps) int8 products a call: 2145 at Whisper-tiny's 4 layers and 64
    tokens; here 17 x 7."""
    _, psv = int8_pair
    calls = []

    def counting(x, w_q, scale, out_dtype=None):
        calls.append((tuple(x.shape), tuple(w_q.shape)))
        return int8_matmul_reference(x, w_q, scale, out_dtype)

    monkeypatch.setattr(PW, "int8_mm", counting)
    mel = torch.from_numpy(_mel(1, 3))
    with torch.inference_mode():
        out = psv.apply_fn(psv.module, {"mel": mel})
    assert out["tokens"].shape == (1, 6) and out["tokens"].dtype == torch.int32
    assert len(calls) == (8 * 2 + 1) * (1 + 6)
    assert sum(w == (128, 512) for _, w in calls) == 7  # the lm head, once a position
    assert (8 * 4 + 1) * (1 + 64) == 2145


def test_servable_end_to_end_matches_jax_bf16():
    """The bf16 lane's servable (seed weights, f32 at rest) against the JAX
    servable: the same log-mel of a WAV, and the same tokens."""
    jsv, psv = _servables()
    data = _wav(_tone(3.0, 44100, seed=9), 44100, 2, 2)
    js, ps = jsv.preprocess(data), psv.preprocess(data)
    assert ps["mel"].tobytes() == js["mel"].tobytes()
    assert psv.module.encoder.layer0.q.kernel.dtype == torch.float32
    want = np.asarray(jax.jit(jsv.apply_fn)(jsv.params, {"mel": js["mel"][None]})["tokens"])
    with torch.inference_mode():
        got = psv.apply_fn(psv.module, {"mel": torch.from_numpy(ps["mel"][None])})["tokens"]
    assert (got.numpy() == want).all()
    assert psv.postprocess({"tokens": got.numpy()}, 0) == jsv.postprocess({"tokens": want}, 0)


def test_convert_whisper_synthetic_byte_identical():
    rng = np.random.default_rng(4)
    D, F_, mels, V = 16, 32, 8, 40
    sd = {"model.encoder.conv1.weight": (D, mels, 3), "model.encoder.conv1.bias": (D,),
          "model.encoder.conv2.weight": (D, D, 3), "model.encoder.conv2.bias": (D,),
          "model.encoder.embed_positions.weight": (30, D),
          "model.encoder.layer_norm.weight": (D,), "model.encoder.layer_norm.bias": (D,),
          "model.decoder.embed_tokens.weight": (V, D),
          "model.decoder.embed_positions.weight": (12, D),
          "model.decoder.layer_norm.weight": (D,), "model.decoder.layer_norm.bias": (D,),
          "proj_out.weight": (V, D)}
    for side in ("encoder", "decoder"):
        pre = f"model.{side}.layers.0."
        attns = ["self_attn"] + (["encoder_attn"] if side == "decoder" else [])
        for attn in attns:
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{pre}{attn}.{proj}.weight"] = (D, D)
                if proj != "k_proj":
                    sd[f"{pre}{attn}.{proj}.bias"] = (D,)
            for leaf in ("weight", "bias"):
                sd[f"{pre}{attn}_layer_norm.{leaf}"] = (D,)
        for leaf in ("weight", "bias"):
            sd[f"{pre}final_layer_norm.{leaf}"] = (D,)
        sd[f"{pre}fc1.weight"], sd[f"{pre}fc1.bias"] = (F_, D), (F_,)
        sd[f"{pre}fc2.weight"], sd[f"{pre}fc2.bias"] = (D, F_), (D,)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in sd.items()}
    want, got = JWT.convert_whisper(sd), PWT.convert_whisper(sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    cfg = PW.config_from_params(got)
    assert (cfg.d_model, cfg.n_mels, cfg.ffn_dim, cfg.decoder_layers) == (D, mels, F_, 1)
    with pytest.raises(KeyError, match="unrecognized whisper key"):
        PWT.convert_whisper({"model.encoder.bogus.weight": np.zeros(2, np.float32)})


# -- serving -------------------------------------------------------------------------

def _serve_cfg(**extra):
    return ServeConfig(models=[ModelConfig(
        name="whisper_tiny", dtype="float32", batch_buckets=(1, 2),
        extra={"max_new_tokens": 4, "arch": TINY_ARCH, **extra})])


def _post(port, path, data: bytes, ctype="application/json"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served():
    cfg = _serve_cfg()
    engine = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, engine) as srv:
            yield srv.port, engine
    finally:
        engine.shutdown()


PATH = "/v1/models/whisper_tiny:predict"


def test_long_audio_answers_merged_chunks(served):
    """A 65 s WAV: three 30 s windows, co-batched, merged in order; its
    tokens are the three windows' own answers joined."""
    port, engine = served
    audio = _tone(65.0, 16000, seed=1)
    status, out = _post(port, PATH, _wav(audio, 16000), "audio/wav")
    assert status == 200, out
    pred = out["predictions"]
    assert pred["chunks"] == 3 and out["timing"]["samples"] == 3
    windows = PL.chunk_waveform(audio)
    alone = []
    for w in windows:
        status, one = _post(port, PATH, json.dumps({"array": w.tolist()}).encode())
        assert status == 200 and "chunks" not in one["predictions"]
        alone += one["predictions"]["tokens"]
    assert pred["tokens"] == alone


def test_instances_mix_short_and_long_audio(served):
    port, _ = served
    short = _wav(_tone(2.0, 44100, seed=2), 44100, 2, 2)
    long_ = _wav(_tone(35.0, 16000, seed=3), 16000)
    body = {"instances": [{"b64": base64.b64encode(short).decode()},
                          {"b64": base64.b64encode(long_).decode()},
                          {"array": _tone(1.0, 8000).tolist(), "rate": 8000}]}
    status, out = _post(port, PATH, json.dumps(body).encode())
    assert status == 200, out
    preds = out["predictions"]
    assert len(preds) == 3 and out["timing"]["samples"] == 4
    assert "chunks" not in preds[0] and preds[1]["chunks"] == 2 and "chunks" not in preds[2]
    status, single = _post(port, PATH, json.dumps({"b64": base64.b64encode(short).decode()})
                           .encode())
    assert status == 200 and single["predictions"] == preds[0]


@pytest.mark.parametrize("body", [{"array": [0.0] * 1600, "temperature": 0.7},
                                  {"instances": [{"array": [0.0] * 1600},
                                                 {"array": [0.0] * 1600, "top_k": 5}]}])
def test_sampling_knobs_answer_400(served, body):
    port, _ = served
    status, out = _post(port, PATH, json.dumps(body).encode())
    assert status == 400 and "sampling knobs" in out["error"]


def test_bad_audio_answers_400(served):
    port, _ = served
    status, out = _post(port, PATH, b"RIFF not a wav at all", "audio/wav")
    assert status == 400 and "preprocess failed" in out["error"]


def test_whisper_registration_and_refusals():
    assert get_latency_class("whisper_tiny") == "latency"
    lane = p_builder("whisper_tiny")(ModelConfig(name="whisper_tiny", extra={
        "arch": TINY_ARCH, "gen_slots": 4})).meta["continuous"]
    assert lane["slots"] == 4 and lane["prompt_buckets"] == (1,)
    with pytest.raises(ValueError, match="positions"):
        p_builder("whisper_tiny")(ModelConfig(name="whisper_tiny", extra={
            "arch": TINY_ARCH, "max_new_tokens": 96}))
    sv = p_builder("whisper_tiny")(ModelConfig(name="whisper_tiny", extra={
        "arch": {**TINY_ARCH, "vocab_size": 51865}, "max_new_tokens": 2}))
    assert sv.meta["prompt_ids"] == (50258, 50259, 50359, 50363)
    assert sv.input_spec((4,)) == {"mel": ((4, 80, 3000), torch.float32)}

