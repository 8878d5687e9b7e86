"""The port's engine and serving path on the CPU (``device="cpu"``).

A tiny int8 BERT engine serves the JAX servable's weights, carried across
with ``params_from_jax``, so the whole slice (HTTP body → batcher → bucket
→ int8 forward → JSON) is held against the JAX package's forward on the same
bytes: f32 probabilities within 1e-5, the summation-order difference of the
two frameworks on the CPU.  The rest pins the engine's and server's
contracts: buckets, padding, the int8 gate, lane priority, coalescing, and
the JAX server's response shapes (serving/server.py:1526-1644, :2307-2329).
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as j_builder
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig, load_config
from pytorch_zappa_serverless_tpu_torch.engine.compiled import CompiledModel, default_collate
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.engine.runner import (
    LANE_LATENCY, LANE_THROUGHPUT, _DaemonDispatchPool)
from pytorch_zappa_serverless_tpu_torch.engine.weights import params_from_jax
from pytorch_zappa_serverless_tpu_torch.serving.batcher import DynamicBatcher, Overloaded
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder

TINY_ARCH = {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
             "vocab_size": 512, "max_position": 64}
MODEL = dict(name="bert_base", dtype="float32", seq_buckets=(8, 16),
             batch_buckets=(1, 4), extra={"arch": TINY_ARCH, "params_dtype": "int8"})


@pytest.fixture(scope="module")
def jax_servable():
    return j_builder("bert_base")(JModelConfig(**MODEL))


@pytest.fixture(scope="module")
def engine(jax_servable):
    cfg = ServeConfig(models=[ModelConfig(**MODEL)])
    eng = build_engine(cfg, device="cpu")
    eng.model("bert_base").servable.module.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jax_servable.params)))
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def server(engine):
    cfg = ServeConfig(models=[ModelConfig(**MODEL)])
    with BackgroundServer(cfg, engine) as s:
        yield s


def _http(port, path, body=None, method=None):
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method or ("GET" if data is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _sample(cm, n_tokens, seed):
    ids = np.random.default_rng(seed).integers(1, 500, n_tokens).tolist()
    return cm.servable.preprocess({"input_ids": ids})


# -- engine -----------------------------------------------------------------

def test_warmup_covers_every_bucket(engine):
    cm = engine.model("bert_base")
    assert cm.buckets == [(1, 8), (1, 16), (4, 8), (4, 16)]
    assert cm.warmed_buckets == set(cm.buckets)
    assert len(engine.clock.entries) == 4 and engine.cold_start_seconds > 0
    assert engine.device == torch.device("cpu")


def test_bucket_for(engine):
    cm = engine.model("bert_base")
    assert cm.bucket_for(1, 5) == (1, 8)
    assert cm.bucket_for(2, 8) == (4, 8)
    assert cm.bucket_for(3, 9) == (4, 16)
    for batch, seq in [(5, 4), (1, 17)]:
        with pytest.raises(ValueError, match="no bucket fits"):
            cm.bucket_for(batch, seq)


def test_default_collate_zero_pads():
    spec = {"input_ids": ((4, 8), torch.int32)}
    out = default_collate([{"input_ids": np.array([5, 6, 7])},
                           {"input_ids": np.array([1])}], (4, 8), spec)["input_ids"]
    assert out.dtype == np.int32 and out.shape == (4, 8)
    np.testing.assert_array_equal(out[0], [5, 6, 7, 0, 0, 0, 0, 0])
    assert not out[1, 1:].any() and not out[2:].any()


def test_pad_rows_never_change_real_rows(engine):
    cm = engine.model("bert_base")
    s = [_sample(cm, n, seed) for n, seed in [(5, 0), (8, 1), (3, 2)]]
    spec = cm.servable.input_spec((4, 8))
    alone = cm.forward(default_collate(s[:1], (4, 8), spec))["probs"]
    together = cm.forward(default_collate(s, (4, 8), spec))["probs"]
    np.testing.assert_allclose(alone[0], together[0], rtol=0, atol=1e-6)
    solo = engine.runner.run_sync(cm, s[:1])
    [first, *_] = engine.runner.run_sync(cm, s)
    assert [e["label"] for e in solo[0]["scores"]] == [e["label"] for e in first["scores"]]
    np.testing.assert_allclose([e["prob"] for e in solo[0]["scores"]],
                               [e["prob"] for e in first["scores"]], atol=1e-6)


def test_slice_matches_jax_forward(engine, jax_servable):
    """Engine path (collate → place → int8 forward → fetch) vs the JAX
    servable's jitted forward on the same weights and bucket batch."""
    cm = engine.model("bert_base")
    s = [_sample(cm, n, seed) for n, seed in [(6, 3), (16, 4)]]
    batch = default_collate(s, (4, 16), cm.servable.input_spec((4, 16)))
    want = np.asarray(jax.jit(jax_servable.apply_fn)(jax_servable.params, batch)["probs"])
    np.testing.assert_allclose(cm.forward(batch)["probs"], want, rtol=0, atol=1e-5)


def test_int8_gate_refuses_unquantized_tree():
    cfg = ModelConfig(**{**MODEL, "extra": {"arch": TINY_ARCH}})
    servable = get_model_builder("bert_base")(cfg)  # float tree: no kernel_q
    gated = ModelConfig(**MODEL)
    with pytest.raises(ValueError, match="no int8 lane"):
        CompiledModel(servable, gated, torch.device("cpu"))


def test_int8_weights_stay_int8_on_the_device(engine):
    m = engine.model("bert_base").servable.module
    assert m.layer0.attention.query.kernel_q.dtype == torch.int8
    assert m.layer1.output.scale.dtype == torch.float32
    assert engine.runner.resident_bytes()["bert_base"] == engine.model(
        "bert_base").param_nbytes() > 0


def test_priority_lane_order():
    pool = _DaemonDispatchPool("test-dispatch")
    gate, order = threading.Event(), []
    try:
        blocker = pool.submit(gate.wait)
        futs = [pool.submit_lane(lane, order.append, tag) for lane, tag in
                [(LANE_THROUGHPUT, "t1"), (LANE_THROUGHPUT, "t2"),
                 (LANE_LATENCY, "l1"), (LANE_LATENCY, "l2")]]
        gate.set()
        for f in [blocker, *futs]:
            f.result(10)
        assert order == ["l1", "l2", "t1", "t2"]
        stats = pool.stats_snapshot()
        assert stats[LANE_LATENCY]["dispatches"] == 3
        assert stats[LANE_THROUGHPUT]["dispatches"] == 2
        # Priority off: one FIFO across the lanes.
        pool.set_priority(False)
        gate.clear()
        order.clear()
        blocker = pool.submit(gate.wait)
        futs = [pool.submit_lane(lane, order.append, tag) for lane, tag in
                [(LANE_THROUGHPUT, "t1"), (LANE_LATENCY, "l1"), (LANE_THROUGHPUT, "t2")]]
        gate.set()
        for f in [blocker, *futs]:
            f.result(10)
        assert order == ["t1", "l1", "t2"]
    finally:
        pool.shutdown()


def test_batcher_coalesces_and_caps(engine):
    cm = engine.model("bert_base")
    cfg = ModelConfig(**{**MODEL, "coalesce_ms": 200.0, "max_concurrency": 4})

    async def drive():
        b = DynamicBatcher(cm, engine.runner, cfg).start()
        try:
            short = [_sample(cm, 4, i) for i in range(3)]
            got = await asyncio.gather(*[b.submit(s, 4) for s in short])
            sizes = [t["batch_size"] for _, t in got]
            # A 12-token request after a 4-token head waits for its own
            # batch instead of dragging the head into the 16 bucket.
            mixed = await asyncio.gather(b.submit(_sample(cm, 4, 7), 4),
                                         b.submit(_sample(cm, 12, 8), 12))
            with pytest.raises(Overloaded) as exc:
                b.submit_many([short[0]] * 5, [4] * 5)
            return sizes, [t["batch_size"] for _, t in mixed], exc.value
        finally:
            await b.stop()

    sizes, mixed, over = asyncio.run(drive())
    assert sizes == [3, 3, 3]
    assert mixed == [1, 1]
    assert over.retry_after_s >= 1.0


# -- server -----------------------------------------------------------------

def test_root_healthz_models(server):
    status, body, _ = _http(server.port, "/")
    assert status == 200
    assert set(body) == {"status", "framework", "profile", "models"}
    assert body["models"] == ["bert_base"]
    status, body, _ = _http(server.port, "/healthz")
    assert status == 200 and body["device_ok"] is True
    assert {"device_ok", "models", "queue_depths"} <= set(body)
    assert body["models"]["bert_base"] == {"buckets_compiled": 4, "buckets_total": 4}
    status, body, _ = _http(server.port, "/v1/models")
    assert status == 200
    entry = body["models"]["bert_base"]
    assert {"buckets", "buckets_compiled", "dtype", "async_only", "endpoint",
            "checkpoint"} <= set(entry)
    assert entry["endpoint"] == "/v1/models/bert_base:predict"
    assert entry["checkpoint"] == "random-init"


def test_predict_single_matches_jax(server, jax_servable):
    ids = [101, 17, 230, 44, 102]
    status, body, headers = _http(server.port, "/v1/models/bert_base:predict",
                                  {"input_ids": ids})
    assert status == 200
    assert set(body) == {"model", "timing", "predictions"}
    assert body["model"] == "bert_base"
    assert {"queue_ms", "device_ms", "total_ms", "batch_size"} <= set(body["timing"])
    assert "X-Queue-Ms" in headers and "X-Device-Ms" in headers
    scores = body["predictions"]["scores"]
    assert [set(s) for s in scores] == [{"label", "prob"}] * 2
    sample = jax_servable.preprocess({"input_ids": ids})
    batch = {k: np.pad(v, (0, 3))[None] for k, v in sample.items()}
    want = np.asarray(jax.jit(jax_servable.apply_fn)(jax_servable.params, batch)["probs"])[0]
    got = {s["label"]: s["prob"] for s in scores}
    np.testing.assert_allclose([got["label_0"], got["label_1"]], want, rtol=0, atol=1e-5)


def test_predict_instances_and_default_routes(server):
    body = {"instances": [{"text": "first input"}, {"input_ids": [101, 5, 102]},
                          {"text": "a third, longer input of words"}]}
    status, out, _ = _http(server.port, "/v1/models/bert_base:predict", body)
    assert status == 200 and len(out["predictions"]) == 3
    assert out["timing"]["samples"] == 3
    for pred in out["predictions"]:
        assert abs(sum(s["prob"] for s in pred["scores"]) - 1.0) < 1e-5
    for path in ("/predict", "/classify"):
        status, out, _ = _http(server.port, path, {"text": "hello world"})
        assert status == 200 and out["model"] == "bert_base"
        assert len(out["predictions"]["scores"]) == 2


def test_errors(server):
    status, body, _ = _http(server.port, "/v1/models/nope:predict", {"text": "x"})
    assert status == 404 and "not served" in body["error"]
    assert body["models"] == {"bert_base": "active"}
    assert _http(server.port, "/v1/models/bert_base:predict", method="GET")[0] == 405
    assert _http(server.port, "/no/such/route")[0] == 404
    assert _http(server.port, "/v1/models/bert_base:predict", b"{not json")[0] == 400
    status, body, _ = _http(server.port, "/v1/models/bert_base:predict",
                            {"instances": []})
    assert status == 400 and "instances" in body["error"]
    # Out-of-vocabulary ids are refused on the host, before any gather.
    status, body, _ = _http(server.port, "/v1/models/bert_base:predict",
                            {"input_ids": [101, 512, 102]})
    assert status == 400 and "[0, 512)" in body["error"]


def test_metrics(server):
    _http(server.port, "/classify", {"text": "metrics please"})
    status, body, _ = _http(server.port, "/metrics")
    assert status == 200
    ring = body["models"]["bert_base"]
    assert ring["requests"] >= 1 and {"p50", "p99", "mean"} <= set(ring["total_ms"])
    assert 0 < body["runner"]["bert_base"]["batch_occupancy"] <= 1
    assert body["cold_start"]["compile_by_model"]["bert_base"]["entries"] == 4
    assert body["hbm"]["total_bytes"] > 0
    assert set(body["dispatch"]["lanes"]) == {"latency", "throughput"}


def test_load_config_json(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"profiles": {"dev": {"port": 9001, "models": [
        {"name": "bert_base", "seq_buckets": [128], "batch_buckets": [1, 8],
         "extra": {"params_dtype": "int8"}}]}}}))
    cfg = load_config(path)
    assert cfg.profile == "dev" and cfg.port == 9001
    assert cfg.model("bert_base").batch_buckets == (1, 8)
    assert cfg.model("bert_base").seq_buckets == (128,)


GPT2_TINY = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128, "vocab_size": 500,
             "max_positions": 64}


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 0.0, 1e-4),
                                              ("bfloat16", 0.0, 2e-2)])
def test_gpt2_params_dtype_bfloat16_at_rest(dtype, rtol, atol):
    """``extra.params_dtype: bfloat16`` (the JAX dev profile sets it for
    gpt2) builds on the CPU: matrices held in bf16, norm scales and biases
    in f32, and prefill logits match the JAX servable after the reference's
    own at-rest cast.  f32 compute: both sides multiply the same bf16-rounded
    weights in f32 and the tied lm head returns its f32 accumulator on both,
    so 1e-4 of the largest logit, the summation orders; bf16 compute:
    2e-2 of the largest logit, the two frameworks' bf16 roundings
    (tests/test_torch_gpt2.py)."""
    import dataclasses

    import jax.numpy as jnp

    from pytorch_zappa_serverless_tpu.models import gpt2 as JG
    from pytorch_zappa_serverless_tpu.models.vision_common import cast_params_at_rest
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as PG

    kw = dict(name="gpt2", dtype=dtype, seq_buckets=(16,), batch_buckets=(1,),
              extra={"max_new_tokens": 8, "arch": GPT2_TINY, "params_dtype": "bfloat16"})
    eng = build_engine(ServeConfig(models=[ModelConfig(**kw)]), device="cpu")
    try:
        sd = eng.model("gpt2").servable.module.state_dict()
        tree = eng.model("gpt2").servable.module.tree()
        pcfg = eng.model("gpt2").servable.meta["config"]
    finally:
        eng.shutdown()
    assert sd["layer0.q.kernel"].dtype == sd["wte"].dtype == torch.bfloat16
    assert sd["layer0.ln1.scale"].dtype == sd["layer0.q.bias"].dtype == torch.float32
    assert all(t.dtype == (torch.bfloat16 if t.ndim >= 2 else torch.float32)
               for t in sd.values())
    jsv = j_builder("gpt2")(JModelConfig(**kw))
    jparams = cast_params_at_rest(jsv.params, jnp.bfloat16)
    jcfg = JG.GPT2Config(**dataclasses.asdict(pcfg))
    rng = np.random.default_rng(5)
    toks = rng.integers(1, 499, (2, 8)).astype(np.int32)
    lengths = np.array([8, 5], np.int32)
    toks[1, 5:] = 0
    cdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    want, _, _ = jax.jit(lambda p: JG.prefill(p, toks, lengths, 12, jcfg, cdt[dtype][0]))(
        jparams)
    with torch.inference_mode():
        got, _, _ = PG.prefill(tree, torch.from_numpy(toks), torch.from_numpy(lengths), 12,
                               pcfg, cdt[dtype][1])
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def test_dev_profile_gpt2_entry_boots():
    """``load_config()`` with no file: the dev profile's gpt2 entry, with
    ``params_dtype: bfloat16``, builds and answers (narrowed to a tiny arch)."""
    cfg = load_config()
    mc = cfg.model("gpt2")
    assert mc.extra["params_dtype"] == "bfloat16"
    mc.extra["arch"] = GPT2_TINY
    mc.extra["max_new_tokens"] = 4
    mc.seq_buckets, mc.batch_buckets = (16,), (1,)
    eng = build_engine(ServeConfig(models=[mc]), device="cpu")
    try:
        cm = eng.model("gpt2")
        sample = cm.servable.preprocess({"input_ids": [3, 1, 4, 1, 5]})
        batch = cm.servable.meta["collate"]([sample], (1, 16), cm.servable.input_spec((1, 16)))
        out = cm.forward(batch)
    finally:
        eng.shutdown()
    assert out["tokens"].shape == (1, 4)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 500)).all()
