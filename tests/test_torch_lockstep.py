"""The port's lockstep world (``parallel/lockstep.py``): rank 0 serves HTTP
and leads, the other ranks mirror it.

Fast cases hold the protocol on its own (no process group): the contract
check raises ``LockstepContractError`` before anything is broadcast, the
leader's broadcasts come header first and payload in sorted key order, and
the follower loop mirrors each op, skips heartbeats, stops at the shutdown
and leaves on a failed header (a dead leader).

The counterparts of the JAX package's ``tests/test_multihost.py`` keep that
file's ``slow`` mark: a two-process world serving one batch identically
(ranks driving ``run_batch`` themselves), a follower mirroring the leader's
buckets, two ``cli serve`` worlds over HTTP (a leader that serves
``:predict`` and both slot-pool ``:generate`` lanes while its follower
mirrors them, with heartbeats and the shutdown), and a leader killed with
``-9`` whose follower exits.  Answers are held to the port's single-device
engine: probabilities ``atol 1e-5`` (f32), tokens equal.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.parallel import lockstep as PL
from pytorch_zappa_serverless_tpu_torch.parallel.mesh import free_port
from torch_worlds import engine_world, run_world

ROOT = Path(__file__).resolve().parents[1]
TINY_BERT = {"num_layers": 1, "num_heads": 2, "head_dim": 8, "mlp_dim": 32,
             "vocab_size": 512, "max_position": 64}
TINY_GPT2 = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 64, "vocab_size": 512,
             "max_positions": 32}
TINY_WHISPER = {"d_model": 32, "encoder_layers": 2, "decoder_layers": 2, "heads": 2,
                "ffn_dim": 64, "vocab_size": 64, "target_positions": 96}


# -- the protocol, without a process group ---------------------------------------

def _spec(b, s):
    return {"input_ids": ((b, s), torch.int32), "mask": ((b, s), torch.bool),
            "scale": ((b,), torch.float32)}


class _Servable(SimpleNamespace):
    def input_spec(self, bucket):
        return _spec(*bucket)


def _leader():
    cm = SimpleNamespace(servable=_Servable(
        name="m", meta={"continuous": {"admit_spec": lambda b: {
            "input_ids": ((1, b), torch.int32), "length": ((1,), torch.int32)}, "slots": 2}}))
    engine = SimpleNamespace(models={"m": cm, "a": cm}, device=torch.device("cpu"))
    d = PL.LockstepDriver(engine)
    d.sent = []
    d._send = lambda arr: d.sent.append(np.asarray(arr).copy())
    return d, cm


def _batch(b=2, s=4):
    return {"scale": np.ones((b,), np.float32), "input_ids": np.arange(b * s, dtype=np.int32)
            .reshape(b, s), "mask": np.ones((b, s), bool)}


@pytest.mark.parametrize("mutate,msg", [
    (lambda b: b.pop("mask"), "m: collate keys ['input_ids', 'scale'] != spec keys "
                              "['input_ids', 'mask', 'scale'] for bucket (2, 4)"),
    (lambda b: b.update(scale=np.ones((3,), np.float32)),
     "m.scale: collate produced float32[3] but the spec for bucket (2, 4) declares "
     "float32[2]"),
    (lambda b: b.update(input_ids=b["input_ids"].astype(np.int64)),
     "m.input_ids: collate produced int64[2, 4] but the spec for bucket (2, 4) declares "
     "int32[2, 4]"),
    (lambda b: b.update(extra=np.zeros(2)), "m: collate keys"),
])
def test_contract_error_raises_before_any_broadcast(mutate, msg):
    d, cm = _leader()
    batch = _batch()
    mutate(batch)
    with pytest.raises(PL.LockstepContractError) as e:
        d.lead(cm, (2, 4), batch)
    assert str(e.value).startswith(msg)
    assert isinstance(e.value, ValueError)
    assert d.sent == [] and d.leads == {}


def test_admission_contract_error_raises_before_any_broadcast():
    d, _ = _leader()
    with pytest.raises(PL.LockstepContractError, match="m.length: collate_admit produced"):
        d.lead_gen_admit("m", 1, 8, {"input_ids": np.zeros((1, 8), np.int32),
                                     "length": np.zeros((2,), np.int32)})
    assert d.sent == []


def test_lead_sends_the_header_then_the_payload_in_sorted_key_order():
    d, cm = _leader()
    batch = _batch()
    d.lead(cm, (2, 4), batch)
    assert d.sent[0].tolist() == [PL.OP_RUN, d.model_names.index("m"), 2, 4]
    assert [a.tolist() for a in d.sent[1:]] == [batch[k].tolist() for k in sorted(batch)]
    d.lead_gen_admit("m", 1, 8, {"length": np.asarray([3], np.int32),
                                 "input_ids": np.zeros((1, 8), np.int32)})
    assert d.sent[4].tolist() == [PL.OP_GEN_ADMIT, 1, 8, 1]
    assert d.sent[5].shape == (1, 8) and d.sent[6].tolist() == [3]
    d.lead_heartbeat()
    d.lead_shutdown()
    d.lead_shutdown()  # once, never twice
    assert [a.tolist() for a in d.sent[-2:]] == [[PL.OP_HEARTBEAT, 0, 0, 0],
                                                 [PL.OP_SHUTDOWN, 0, 0, 0]]
    assert d.leads == {"run": 1, "gen_admit": 1, "heartbeat": 1, "shutdown": 1}
    with pytest.raises(RuntimeError, match="shut down"):
        d.lead_heartbeat()


def test_segment_lead_sends_the_eight_carries():
    d, _ = _leader()
    S = 2
    carries = {"tok": np.arange(S), "pos": np.arange(S), "step": np.zeros(S),
               "fin": np.array([True, False]), "temp": np.zeros(S), "seed": np.zeros(S),
               "topk": np.zeros(S), "topp": np.ones(S)}
    d.lead_gen_segment("m", carries)
    assert d.sent[0].tolist() == [PL.OP_GEN_SEGMENT, 1, 0, 0]
    assert [a.dtype for a in d.sent[1:]] == [np.dtype(PL.SEGMENT_SPEC[k])
                                             for k in sorted(PL.SEGMENT_SPEC)]
    assert d.sent[1 + sorted(PL.SEGMENT_SPEC).index("fin")].tolist() == [True, False]


def _follower(headers, payloads):
    """A follower whose receives are scripted: ``headers`` (a failure
    raises), each header's payload from ``payloads``."""
    d, cm = _leader()
    ran = []
    cm.forward = lambda batch: ran.append(("run", {k: v.shape for k, v in batch.items()}))
    cm._warmed = set()
    script = list(headers)

    def recv(shape, dtype):
        if tuple(shape) == (4,) and np.dtype(PL._np_dtype(dtype)) == np.int32 and script:
            h = script.pop(0)
            if isinstance(h, Exception):
                raise h
            return np.asarray(h, np.int32)
        return np.zeros(shape, PL._np_dtype(dtype))

    d._recv = recv
    d._follow_gen_admit = lambda name, slot, p: ran.append(("admit", name, slot, sorted(p)))
    d._follow_gen_segment = lambda name, c: ran.append(("segment", name, sorted(c)))
    return d, ran


def test_follower_mirrors_each_op_and_stops_at_the_shutdown():
    d, ran = _follower([[PL.OP_HEARTBEAT, 0, 0, 0], [PL.OP_RUN, 1, 2, 4],
                        [PL.OP_GEN_ADMIT, 1, 8, 1], [PL.OP_GEN_SEGMENT, 1, 0, 0],
                        [PL.OP_HEARTBEAT, 0, 0, 0], [PL.OP_SHUTDOWN, 0, 0, 0],
                        [PL.OP_RUN, 1, 2, 4]], None)
    d.follow()
    assert ran == [("run", {"input_ids": (2, 4), "mask": (2, 4), "scale": (2,)}),
                   ("admit", "m", 1, ["input_ids", "length"]),
                   ("segment", "m", sorted(PL.SEGMENT_SPEC))]


def test_follower_leaves_when_the_header_broadcast_fails():
    d, ran = _follower([[PL.OP_RUN, 1, 2, 4], RuntimeError("Connection closed by peer")],
                       None)
    d.follow()  # returns: the leader is lost
    assert len(ran) == 1


def test_follower_leaves_when_a_mirrored_dispatch_fails():
    d, ran = _follower([[PL.OP_RUN, 1, 2, 4], [PL.OP_RUN, 1, 2, 4]], None)
    d.engine.models["m"].forward = lambda batch: (_ for _ in ()).throw(RuntimeError("oom"))
    d.follow()  # one failure, and the loop is left for a world restart


def test_world_snapshot_and_lead_only_on_rank_zero(monkeypatch):
    from pytorch_zappa_serverless_tpu_torch.engine.loader import Engine

    engine = Engine(models={}, runner=None, clock=None, device=torch.device("cpu"))
    with pytest.raises(RuntimeError, match="rank 0 of a world only"):
        engine.enable_lockstep_lead()
    assert engine.mesh_rank() == 0


# -- multi-process worlds (slow, as the JAX package's test_multihost.py) --------

def _bert_cfg(buckets=(1, 2)):
    return ModelConfig(name="bert_base", dtype="float32", batch_buckets=buckets,
                       seq_buckets=(8,), extra={"arch": TINY_BERT})


def _two_hosts(rank, n, addr, requests):
    """Rank ``rank`` as process ``rank`` of a two-host world (one rank a
    host); every rank drives run_batch itself, as the library pattern does."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    cfg = ServeConfig(mesh={"data": 2}, coordinator_address=addr, num_processes=2,
                      process_id=rank, models=[_bert_cfg((2,))])
    engine = build_engine(cfg, device="cpu")
    try:
        cm = engine.model("bert_base")
        results, bucket = engine.runner.run_fn_sync(cm.run_batch, requests)
        return {"bucket": list(bucket), "world": engine.world_snapshot(),
                "scores": [[s["prob"] for s in r["scores"]] for r in results]}
    finally:
        engine.shutdown()


def _bert_samples(payloads):
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_servable

    sv = build_servable(_bert_cfg())
    return [sv.preprocess(p) for p in payloads]


def _single_scores(batches):
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    engine = build_engine(ServeConfig(models=[_bert_cfg()]), device="cpu")
    try:
        cm = engine.model("bert_base")
        return [[[s["prob"] for s in r["scores"]] for r in engine.runner.run_sync(cm, b)]
                for b in batches]
    finally:
        engine.shutdown()


@pytest.mark.slow
def test_two_process_world_serves_identically():
    samples = _bert_samples([{"input_ids": [5, 6, 7, 8]}, {"input_ids": [9, 10]}])
    out = run_world(2, _two_hosts, samples)
    assert out["bucket"] == [2, 8]
    assert out["world"]["world_size"] == 2 and out["world"]["mesh"] == {"data": 2}
    np.testing.assert_allclose(out["scores"], _single_scores([samples])[0], rtol=0, atol=1e-5)


@pytest.mark.slow
def test_follower_driver_mirrors_leader_dispatches():
    batches = [_bert_samples([{"input_ids": [5, 6, 7, 8]}, {"input_ids": [9, 10]}]),
               _bert_samples([{"input_ids": [1, 2, 3]}])]
    cfg = ServeConfig(mesh={"data": 1, "model": 2}, models=[_bert_cfg()])
    out = run_world(2, engine_world, cfg, {"bert_base": batches}, {})
    assert out["world"]["leads"] == {"run": 2}
    got = [[[s["prob"] for s in r["scores"]] for r in b] for b in out["answers"]["bert_base"]]
    for g, w in zip(got, _single_scores(batches)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _world_cfg(tmp_path: Path, port: int) -> Path:
    path = tmp_path / "world.json"
    path.write_text(json.dumps({
        "port": port, "mesh": {"model": 2}, "heartbeat_interval_s": 0.3,
        "supervise_interval_s": 0.5, "models": [
            {"name": "bert_base", "dtype": "float32", "batch_buckets": [1, 2],
             "seq_buckets": [8], "extra": {"arch": TINY_BERT}},
            {"name": "gpt2", "dtype": "float32", "batch_buckets": [1], "seq_buckets": [8],
             "kv_cache": "paged",
             "extra": {"arch": TINY_GPT2, "max_new_tokens": 6, "gen_slots": 2}},
            {"name": "whisper_tiny", "dtype": "float32", "batch_buckets": [1],
             "extra": {"arch": TINY_WHISPER, "max_new_tokens": 4, "gen_slots": 2}}]}))
    return path


def _http(port, method, path, body=None, timeout=60.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _children(pid: int) -> list[int]:
    kids = Path(f"/proc/{pid}/task/{pid}/children")
    return [int(x) for x in kids.read_text().split()] if kids.exists() else []


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return Path(f"/proc/{pid}").exists() and "Z" not in Path(
        f"/proc/{pid}/stat").read_text().split()[2]


def _serve(cfg_path: Path, port: int) -> tuple[subprocess.Popen, list[int]]:
    """``cli serve`` on the CPU with a mesh: the leader, and the follower it
    spawned, once /healthz answers 200."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli", "serve", "--config",
         str(cfg_path), "--platform", "cpu"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"cli serve exited {proc.returncode}"
        try:
            if _http(port, "GET", "/healthz", timeout=5)[0] == 200:
                return proc, _children(proc.pid)
        except OSError:
            pass
        time.sleep(0.3)
    proc.kill()
    raise AssertionError("the world did not come up")


@pytest.fixture(scope="module")
def served_world(tmp_path_factory):
    port = free_port()
    cfg_path = _world_cfg(tmp_path_factory.mktemp("world"), port)
    proc, ranks = _serve(cfg_path, port)
    try:
        yield SimpleNamespace(port=port, proc=proc, ranks=ranks, cfg=cfg_path)
    finally:
        for pid in [proc.pid, *ranks]:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
        proc.wait(30)


def _single_engine(cfg_path):
    from pytorch_zappa_serverless_tpu_torch.config import load_config
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    cfg = load_config(cfg_path)
    cfg.mesh, cfg.heartbeat_interval_s = {}, 0.0
    return build_engine(cfg, device="cpu")


@pytest.mark.slow
def test_streaming_generation_mirrors_on_a_world(served_world):
    w = served_world
    assert len(w.ranks) == 1 and _alive(w.ranks[0])
    st, bert = _http(w.port, "POST", "/v1/models/bert_base:predict",
                     {"input_ids": [5, 6, 7, 8]})
    assert st == 200, bert
    streams = [{"input_ids": [5, 6, 7]}, {"input_ids": [9, 10, 11, 12]}, {"input_ids": [42]}]
    got = []
    for body in streams:
        st, out = _http(w.port, "POST", "/v1/models/gpt2:generate", {**body, "stream": False})
        assert st == 200, out
        got.append(out["predictions"]["tokens"])
    engine = _single_engine(w.cfg)
    try:
        cm = engine.model("gpt2")
        want = [engine.runner.run_sync(cm, [cm.servable.preprocess(b)])[0]["tokens"]
                for b in streams]
        bcm = engine.model("bert_base")
        bwant = engine.runner.run_sync(bcm, [bcm.servable.preprocess({"input_ids": [5, 6, 7,
                                                                                    8]})])
    finally:
        engine.shutdown()
    assert got == want
    np.testing.assert_allclose([s["prob"] for s in bert["predictions"]["scores"]],
                               [s["prob"] for s in bwant[0]["scores"]], rtol=0, atol=1e-5)


@pytest.mark.slow
def test_whisper_streaming_mirrors_on_a_world(served_world):
    w = served_world
    rng = np.random.default_rng(3)
    body = {"array": (rng.standard_normal(16000) * 0.1).tolist(), "rate": 16000}
    st, out = _http(w.port, "POST", "/v1/models/whisper_tiny:generate", {**body,
                                                                          "stream": False})
    assert st == 200, out
    engine = _single_engine(w.cfg)
    try:
        cm = engine.model("whisper_tiny")
        want = engine.runner.run_sync(cm, [cm.servable.preprocess(body)])[0]["tokens"]
    finally:
        engine.shutdown()
    assert out["predictions"]["tokens"] == want
    time.sleep(0.8)  # a few heartbeats
    st, health = _http(w.port, "GET", "/healthz")
    assert st == 200 and health["generation_ok"]
    world = health["world"]
    assert world["backend"] == "gloo" and world["world_size"] == 2 and world["lead"]
    assert world["mesh"] == {"model": 2}
    assert world["leads"]["heartbeat"] >= 2 and world["leads"]["gen_admit"] >= 4
    assert world["leads"]["gen_segment"] >= 2 and world["leads"]["run"] >= 1
    assert health["supervisor"]["failures"] == 0
    # The shutdown: SIGINT stops the leader, which leads OP_SHUTDOWN; the
    # follower leaves its loop and exits, and the leader reaps it.
    os.kill(w.proc.pid, signal.SIGINT)
    assert w.proc.wait(60) == 0
    assert not any(_alive(pid) for pid in w.ranks)


@pytest.mark.slow
def test_leader_death_releases_the_follower_then_the_world_restarts(tmp_path):
    port = free_port()
    cfg_path = _world_cfg(tmp_path, port)
    proc, ranks = _serve(cfg_path, port)
    try:
        assert len(ranks) == 1
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(30)
        deadline = time.monotonic() + 30
        while _alive(ranks[0]) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not _alive(ranks[0]), "the follower outlived its leader"
        # The world restarts whole: a new leader and follower serve.
        proc, ranks = _serve(cfg_path, port)
        st, out = _http(port, "POST", "/v1/models/bert_base:predict", {"input_ids": [1, 2]})
        assert st == 200, out
    finally:
        for pid in [proc.pid, *ranks]:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
        proc.wait(30)
