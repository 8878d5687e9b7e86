"""Whisper on the port's continuous lane, against the JAX package's and its
own fixed-batch route: tests/test_whisper_stream.py's cases at its tiny arch
(fp32, ``gen_slots`` 2, ``segment_tokens`` 3) on the CPU.

Admission carries audio (one log-mel window and the fixed task prompt), the
pool packs cross and self K/V into one (k, v) pair, and segments stream the
tokens:

- ``prefill_continuous`` and segment slices give the one-shot
  ``decode_greedy`` chain, and the JAX package's ``decode_segment`` on the
  same weights and mel gives the same tokens (the packed rows within 1e-4);
- a frozen slot leaves its neighbour's chain as it is;
- the scheduler against the fixed-batch :predict route, a second stream
  admitted mid-flight, SSE over the port's server, and long audio refused
  with a pointer to :predict.
"""

import asyncio
import dataclasses
import io
import json
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.models import whisper as JW
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import whisper as PWh
from pytorch_zappa_serverless_tpu_torch.serving.generation import GenerationScheduler
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

TINY_ARCH = {"d_model": 32, "encoder_layers": 2, "decoder_layers": 2, "heads": 2,
             "ffn_dim": 64, "vocab_size": 64, "source_positions": 1500,
             "target_positions": 96}
MAX_NEW = 10
WAIT_S = 120


def _tiny_cfg():
    cfg = dataclasses.replace(JW.TINY, **TINY_ARCH)
    return dataclasses.replace(cfg, eot_id=cfg.vocab_size - 2, sot_id=cfg.vocab_size - 1)


def _model_cfg(**extra):
    return ModelConfig(name="whisper_tiny", dtype="float32", batch_buckets=(1, 2),
                       coalesce_ms=1.0,
                       extra={"max_new_tokens": MAX_NEW, "arch": TINY_ARCH, "gen_slots": 2,
                              "segment_tokens": 3, **extra})


def _wav_payload(seed, seconds=1.0):
    rate = 16000
    t = np.arange(int(rate * seconds)) / rate
    x = (0.4 * np.sin(2 * np.pi * (300 + 50 * seed) * t)).astype(np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _trees(cfg, seed=3):
    np_params = JW.init_whisper_params(seed, cfg)
    return (jax.tree.map(jnp.asarray, np_params),
            PW.ParamTree(PWh.state_from_jax(np_params, torch.float32)).tree())


def _pcfg(cfg):
    return PWh.WhisperConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# The segment functions
# ---------------------------------------------------------------------------

def test_segment_chain_matches_decode_greedy_and_jax():
    cfg = _tiny_cfg()
    pcfg = _pcfg(cfg)
    jp, pp = _trees(cfg)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, cfg.n_mels, 3000)).astype(np.float32)
    prompt_ids = (cfg.sot_id,)
    P, max_new = 1, 9
    prompt = torch.tensor([prompt_ids] * 2, dtype=torch.int32)
    enc = PWh.encode(pp, torch.from_numpy(mel), pcfg, torch.float32)
    want = PWh.decode_greedy(pp, enc, prompt, max_new, pcfg, torch.float32).numpy()

    total_self = P + max_new
    first, ck, cv = PWh.prefill_continuous(pp, torch.from_numpy(mel), prompt, total_self, pcfg,
                                           torch.float32)
    jfirst, jck, jcv = JW.prefill_continuous(jp, jnp.asarray(mel), prompt_ids, total_self, cfg,
                                             jnp.float32)
    assert first.tolist() == np.asarray(jfirst).tolist()
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), rtol=0, atol=1e-4)
    tok, pos = first, torch.full((2,), P, dtype=torch.int32)
    step, fin = torch.zeros((2,), dtype=torch.int32), torch.zeros((2,), dtype=torch.bool)
    jstate = (jfirst, jnp.full((2,), P, jnp.int32), jnp.zeros((2,), jnp.int32),
              jnp.zeros((2,), bool))
    got, jgot = [], []
    for _ in range(3):  # 3 segments x 3 tokens = max_new
        emits, ck, cv, tok, pos, step, fin = PWh.decode_segment(
            pp, ck, cv, tok, pos, step, fin, 3, pcfg, torch.float32)
        got.append(emits.numpy())
        jemits, jck, jcv, *jstate = JW.decode_segment(jp, jck, jcv, *jstate, 3, cfg,
                                                      jnp.float32)
        jgot.append(np.asarray(jemits))
    np.testing.assert_array_equal(np.concatenate(got, axis=1), want)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), np.concatenate(jgot, axis=1))


def test_segment_frozen_rows_do_not_disturb_neighbors():
    cfg = _tiny_cfg()
    pcfg = _pcfg(cfg)
    _, pp = _trees(cfg)
    rng = np.random.default_rng(1)
    mel = torch.from_numpy(rng.standard_normal((1, cfg.n_mels, 3000)).astype(np.float32))
    P = 1
    prompt = torch.tensor([[cfg.sot_id]], dtype=torch.int32)
    first, ck, cv = PWh.prefill_continuous(pp, mel, prompt, P + 6, pcfg, torch.float32)
    one = torch.ones((1,), dtype=torch.int32)
    solo, *_ = PWh.decode_segment(pp, ck.clone(), cv.clone(), first, one * P, one * 0,
                                  torch.zeros((1,), dtype=torch.bool), 6, pcfg, torch.float32)
    L, T_all = cfg.decoder_layers, ck.shape[2]
    ck2 = torch.zeros((L, 2, T_all, cfg.d_model))
    cv2 = torch.zeros_like(ck2)
    ck2[:, :1], cv2[:, :1] = ck, cv
    pooled, *_ = PWh.decode_segment(
        pp, ck2, cv2, torch.tensor([int(first[0]), cfg.eot_id], dtype=torch.int32),
        torch.tensor([P, 0], dtype=torch.int32), torch.zeros((2,), dtype=torch.int32),
        torch.tensor([False, True]), 6, pcfg, torch.float32)
    assert pooled[0].tolist() == solo[0].tolist()
    assert (pooled[1] == cfg.eot_id).all()


# ---------------------------------------------------------------------------
# The scheduler and the HTTP surface
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    eng = build_engine(ServeConfig(warmup_at_boot=False, models=[_model_cfg()]), device="cpu")
    yield eng
    eng.shutdown()


def _drive(eng, body):
    cm = eng.model("whisper_tiny")

    async def run():
        sched = GenerationScheduler(cm, eng.runner, cm.cfg).start()
        try:
            return await body(sched, cm)
        finally:
            await sched.stop()

    return asyncio.run(run())


def test_scheduler_matches_fixed_batch(engine):
    cm = engine.model("whisper_tiny")
    sample = cm.servable.preprocess(_wav_payload(0))
    assert not isinstance(sample, list)  # 1 s of audio: one window

    async def body(sched, cm):
        return await asyncio.wait_for(sched.submit(sample).done, WAIT_S)

    got = _drive(engine, body)
    want = engine.runner.run_fn_sync(cm.run_batch, [sample])[0][0]["tokens"]
    assert got == want


def test_second_stream_admits_mid_flight(engine):
    async def body(sched, cm):
        a = sched.submit(cm.servable.preprocess(_wav_payload(1)), max_new=MAX_NEW)
        first_a = await asyncio.wait_for(a.events.get(), WAIT_S)
        assert first_a is not None and not a.done.done()
        b = sched.submit(cm.servable.preprocess(_wav_payload(2)), max_new=3)
        toks_b = await asyncio.wait_for(b.done, WAIT_S)
        assert len(toks_b) <= 3
        assert b.slot is not None and a.slot is not None and b.slot != a.slot
        await asyncio.wait_for(a.done, WAIT_S)

    _drive(engine, body)


def test_sse_streams_whisper_tokens():
    cfg = ServeConfig(warmup_at_boot=False, models=[_model_cfg()])
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            url = f"http://127.0.0.1:{srv.port}/v1/models/whisper_tiny:generate"
            req = urllib.request.Request(url, data=_wav_payload(3),
                                         headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                assert r.status == 200
                assert r.headers["Content-Type"] == "text/event-stream"
                events = [json.loads(line[6:]) for line in r if line.startswith(b"data: ")]
            final = events[-1]
            assert final.get("done") is True
            streamed = [e["token"] for e in events[:-1]]
            assert streamed == final["tokens"] and 1 <= len(streamed) <= MAX_NEW
            # The same WAV on :predict gives the same tokens.
            req = urllib.request.Request(url.replace(":generate", ":predict"),
                                         data=_wav_payload(3))
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                assert json.loads(r.read())["predictions"]["tokens"] == final["tokens"]
            # Long audio fans out to several windows: :predict's work.
            req = urllib.request.Request(url, data=_wav_payload(4, seconds=35.0))
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=WAIT_S)
            assert ei.value.code == 400
            assert ":predict" in json.loads(ei.value.read())["error"]
    finally:
        eng.shutdown()
