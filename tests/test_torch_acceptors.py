"""The port's acceptor fast lane (``serving/acceptors.py``) against the JAX
package's, on the CPU.

- The rings, the message and batch framing, the fan-out and the fair drain:
  the cases of ``tests/test_tensorlane.py``, each run on both packages'
  modules with the same inputs; a ring the JAX ``ShmRing`` creates is
  attached by name in the port, and the reverse.
- The acceptor cases of ``tests/test_serverpath_http.py`` on a tiny BERT-base
  int8 (f32, seq 16) behind two spawned workers: fast-lane answers byte-equal
  to the main port's binary lane and, on the JAX package's weights, within
  1e-5 of its probabilities (``tests/test_torch_bert.py``'s f32 tolerance);
  the error surface (413, 400, 415, 504), trace continuity and the
  flight recorder, accounting parity with the JSON lane, the telemetry
  families, a ``kill -9`` of a worker, a worker whose parent's
  ``__main__`` imports torch, and the choices the port makes where the
  reference does not decide: a demoted model on the fast lane, and the
  hosts whose memory order the rings cannot trust.

Every test runs under its own time limit (``_time_limit``).
"""

import asyncio
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.serving import acceptors as JA
from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as j_builder
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.engine.weights import params_from_jax
from pytorch_zappa_serverless_tpu_torch.serving import acceptor_telemetry as PT
from pytorch_zappa_serverless_tpu_torch.serving import acceptors as PA
from pytorch_zappa_serverless_tpu_torch.serving import wire
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

ROOT = Path(__file__).resolve().parents[1]
BOTH = pytest.mark.parametrize("A", [JA, PA], ids=["jax", "port"])
TENSOR = {"Content-Type": wire.TENSOR_CONTENT_TYPE}
ARCH = {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64, "vocab_size": 512,
        "max_position": 64}
SEQ = 16
TENSOR_CAP = 1 << 16
# Seconds each test may run (60 unless named here).
LIMITS = {"test_kill_9_of_a_worker_fails_its_inflight_and_respawns": 120.0}
needs_reuseport = pytest.mark.skipif(not PA.HAVE_REUSEPORT, reason="SO_REUSEPORT unavailable")


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Fail a test that runs past its limit instead of hanging the run."""
    limit = LIMITS.get(request.node.originalname, 60.0)

    def expire(*_):
        raise TimeoutError(f"{request.node.name} ran past its {limit:g} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


# -- rings and framing ---------------------------------------------------------

@BOTH
def test_shm_ring_push_pop_wraparound_and_backpressure(A):
    ring = A.ShmRing(slots=4, slot_bytes=128, create=True)
    try:
        assert ring.try_pop() is None and ring.depth() == 0
        for round_ in range(3):
            msgs = [bytes([round_, i]) * 8 for i in range(4)]
            for m in msgs:
                assert ring.try_push(m)
            assert not ring.try_push(b"full")
            assert ring.depth() == 4
            assert [ring.try_pop() for _ in range(4)] == msgs
        with pytest.raises(ValueError):
            ring.try_push(b"z" * 200)
    finally:
        ring.close()
        ring.unlink()


@BOTH
def test_shm_ring_cross_attach_by_name(A):
    ring = A.ShmRing(slots=2, slot_bytes=64, create=True)
    try:
        other = A.ShmRing(ring.name, slots=2, slot_bytes=64)
        assert ring.try_push(b"over there")
        assert other.try_pop() == b"over there"
        other.close()
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("maker,user", [(JA, PA), (PA, JA)], ids=["jax-makes", "port-makes"])
def test_a_ring_made_by_one_package_serves_the_other(maker, user):
    """The ring is one ABI: the producer in one package, the consumer in the
    other, through wrap-around, back-pressure and the header bytes."""
    ring = maker.ShmRing(slots=3, slot_bytes=96, create=True)
    try:
        peer = user.ShmRing(ring.name, slots=3, slot_bytes=96)
        rng = np.random.default_rng(5)
        for round_ in range(4):
            msgs = [rng.bytes(int(rng.integers(1, 92))) for _ in range(3)]
            for m in msgs:
                assert ring.try_push(m)
            assert not ring.try_push(b"x") and peer.depth() == 3
            assert [peer.try_pop() for _ in range(3)] == msgs
            assert peer.try_push(msgs[0]) and ring.try_pop() == msgs[0]
        assert bytes(ring.shm.buf[:16]) == bytes(peer.shm.buf[:16])
        peer.close()
    finally:
        ring.close()
        ring.unlink()


@BOTH
def test_batch_framing_roundtrip_and_truncation(A):
    msgs = [A.pack_msg(1, 200, "resnet18", b"\x00\x01"),
            A.pack_msg(2, 429, "resnet18", b'{"error":"shed"}'),
            A.pack_msg(3, 0, "m|250", b"")]
    assert A.unpack_batch(A.pack_batch(msgs)) == [(1, 200, "resnet18", b"", b"\x00\x01"),
                                                  (2, 429, "resnet18", b"",
                                                   b'{"error":"shed"}'),
                                                  (3, 0, "m|250", b"", b"")]
    frame = A.pack_batch(msgs)
    with pytest.raises(ValueError):
        A.unpack_batch(frame[:-1])
    with pytest.raises(ValueError):
        A.unpack_batch(frame + b"x")


def test_message_framing_is_byte_identical_across_packages():
    telem = PT.pack_telem("rid", 1.0, 2.0, 3.0, 4.0, "")
    for args in [(7, 0, "bert_base|250", b"\x01" * 33, telem), (9, 503, "m", b"{}", b""),
                 (2 ** 32 - 1, 200, "x" * 40, bytes(range(256)), telem)]:
        assert PA.pack_msg(*args) == JA.pack_msg(*args)
        assert PA.unpack_msg(JA.pack_msg(*args)) == JA.unpack_msg(PA.pack_msg(*args))
    batch = [JA.pack_msg(i, 200, "m", bytes([i]) * i) for i in range(5)]
    assert PA.pack_batch(batch) == JA.pack_batch(batch)
    assert PA.unpack_batch(JA.pack_batch(batch)) == JA.unpack_batch(PA.pack_batch(batch))


def _mini_supervisor(A, slots=4, slot_bytes=256, workers=1):
    cfg = SimpleNamespace(host="127.0.0.1", port=0, ingest_port=1, ingest_workers=workers,
                          shm_ring_slots=slots, shm_ring_slot_bytes=slot_bytes,
                          tensor_max_bytes=0)
    sup = A.AcceptorSupervisor(cfg)
    sup.resp_rings = [A.ShmRing(slots=slots, slot_bytes=slot_bytes, create=True)
                      for _ in range(workers)]
    sup._resp_backlog = [deque(maxlen=4 * slots) for _ in range(workers)]
    return sup


def _drain_ring(A, ring):
    out = []
    while (raw := ring.try_pop()) is not None:
        out.extend(A.unpack_batch(raw))
    return out


@BOTH
def test_fan_out_chunks_and_replaces_oversize_response(A):
    sup = _mini_supervisor(A, slots=4, slot_bytes=256)
    ring = sup.resp_rings[0]
    try:
        big = A.pack_msg(7, 200, "m", b"x" * 1024)
        small = [A.pack_msg(10 + i, 200, "m", b"ok" * 30) for i in range(4)]
        asyncio.run(sup._fan_out(0, [big] + small))
        by_id = {m[0]: m for m in _drain_ring(A, ring)}
        assert sup.resp_oversize == 1 and sup.resp_drops == 0
        assert by_id[7][1] == 500 and b"ring slot" in by_id[7][4]
        body = json.loads(by_id[7][4])
        assert body["request_id"] and body["trace_id"]
        for i in range(4):
            assert by_id[10 + i][1] == 200 and by_id[10 + i][4] == b"ok" * 30
    finally:
        ring.close()
        ring.unlink()


@BOTH
def test_fan_out_full_ring_degrades_to_backlogged_503(A, monkeypatch):
    monkeypatch.setattr(A, "_RESP_RETRY_TICKS", 2)
    sup = _mini_supervisor(A, slots=2, slot_bytes=256)
    ring = sup.resp_rings[0]
    try:
        while ring.try_push(b"wedge"):
            pass
        asyncio.run(sup._fan_out(0, [A.pack_msg(5, 200, "m", b"r")]))
        assert sup.resp_drops == 1 and len(sup._resp_backlog[0]) == 1
        ring.try_pop()
        sup._flush_backlog()
        assert not sup._resp_backlog[0]
        ring.try_pop()
        req_id, status, _name, _telem, body = _drain_ring(A, ring)[0]
        payload = json.loads(body)
        assert (req_id, status) == (5, 503) and payload["retry_after_s"] == 1.0
        assert payload["request_id"] and payload["trace_id"]
    finally:
        ring.close()
        ring.unlink()


@BOTH
def test_drain_requests_is_fair_across_rings(A):
    sup = _mini_supervisor(A, workers=2)
    sup.req_rings = [A.ShmRing(slots=64, slot_bytes=64, create=True) for _ in range(2)]
    try:
        for _ in range(48):
            assert sup.req_rings[0].try_push(b"a")
        for _ in range(8):
            assert sup.req_rings[1].try_push(b"b")
        taken = {0: 0, 1: 0}
        for widx, _raw in sup._drain_requests():
            taken[widx] += 1
        assert taken == {0: 32, 1: 8} and sup._rr == 1
    finally:
        for ring in sup.req_rings + sup.resp_rings:
            ring.close()
            ring.unlink()


# -- the fast lane on a served tiny BERT-base int8 -----------------------------

def _cfg(**kw):
    base = dict(warmup_at_boot=True, ingest_workers=2, shm_ring_slots=16,
                shm_ring_slot_bytes=1 << 18, tensor_max_bytes=TENSOR_CAP,
                perf_loop_lag_interval_s=0.05,
                models=[ModelConfig(name="bert_base", dtype="float32", seq_buckets=(SEQ,),
                                    batch_buckets=(1, 4),
                                    extra={"arch": ARCH, "params_dtype": "int8"})])
    base.update(kw)
    return ServeConfig(**base)


@pytest.fixture(scope="module")
def jsv():
    return j_builder("bert_base")(JModelConfig(name="bert_base", dtype="float32",
                                               seq_buckets=(SEQ,), batch_buckets=(1,),
                                               extra={"arch": ARCH, "params_dtype": "int8"}))


@pytest.fixture(scope="module")
def engine(jsv):
    eng = build_engine(_cfg(), device="cpu")
    eng.model("bert_base").servable.module.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jsv.params)))
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def srv(engine):
    if not PA.HAVE_REUSEPORT:
        pytest.skip("SO_REUSEPORT unavailable")
    with BackgroundServer(_cfg(), engine) as s:
        yield s


def _post(port, body, headers=None, path="/v1/models/bert_base:predict", timeout=30.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def _ids(seed, n=1):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 500, int(rng.integers(3, SEQ)))] for _ in range(n)]


def _frame(ids_rows):
    return bytes(wire.pack([{"input_ids": r} for r in ids_rows],
                           flags=wire.FLAG_LIST if len(ids_rows) > 1 else 0))


def _preds(raw):
    return wire.unpack_response(raw)[1]


def _jax_probs(jsv, rows):
    ids = np.zeros((len(rows), SEQ), np.int32)
    mask = np.zeros((len(rows), SEQ), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = r, 1
    out = jax.jit(jsv.apply_fn)(jsv.params, {"input_ids": ids, "attention_mask": mask,
                                             "token_type_ids": np.zeros_like(ids)})
    return np.asarray(out["probs"], np.float32)


@pytest.mark.parametrize("n", [1, 4])
def test_fast_lane_equals_the_main_binary_lane_and_the_jax_package(srv, jsv, n):
    sup = srv.server.acceptors
    for seed in range(3):
        rows = _ids(100 * n + seed, n)
        status, heads, fast = _post(sup.ingest_port, _frame(rows), TENSOR)
        assert status == 200, fast
        assert heads["Content-Type"] == wire.TENSOR_CONTENT_TYPE
        assert heads["X-Request-Id"] and heads["X-Trace-Id"]
        status, _, main = _post(srv.port, _frame(rows), TENSOR)
        assert status == 200, main
        assert _preds(fast) == _preds(main)
        want = _jax_probs(jsv, rows)
        for i, pred in enumerate(_preds(fast)):
            got = {s["label"]: s["prob"] for s in pred["scores"]}
            ref = {s["label"]: s["prob"]
                   for s in jsv.postprocess({"probs": want}, i)["scores"]}
            assert got.keys() == ref.keys()
            np.testing.assert_allclose([got[k] for k in ref], list(ref.values()),
                                       rtol=0, atol=1e-5)


def test_worker_errors_carry_ids(srv):
    sup = srv.server.acceptors
    hdr = wire._HDR.pack(wire.MAGIC, wire.VERSION, 0, 1)
    oversize = hdr + wire._BLK.pack(9, 2, 0) + wire._DIM.pack(60000) + wire._DIM.pack(60000)
    good = _frame(_ids(1))
    for body, heads, want in [(oversize, TENSOR, 413), (good[:-3], TENSOR, 400),
                              (b"XXXXgarbage", TENSOR, 400),
                              (b'{"input_ids": [1]}', {"Content-Type": "application/json"}, 415),
                              (bytes(wire.pack([{"m": 1}], flags=wire.FLAG_META)), TENSOR, 400)]:
        status, h, raw = _post(sup.ingest_port, body, {**heads, "X-Request-Id": "rid-err"})
        assert status == want, raw
        err = json.loads(raw)
        assert err["request_id"] == "rid-err" == h["X-Request-Id"]
        assert err["trace_id"] == h["X-Trace-Id"] and len(err["trace_id"]) == 32
    status, _, raw = _post(sup.ingest_port, good, TENSOR, path="/v1/models/nope:predict")
    assert status == 404 and json.loads(raw)["request_id"]
    health = _get(sup.ingest_port, "/healthz")
    assert health["ok"] and health["torch_loaded"] is False


def test_workers_split_the_accepts_and_load_no_torch(srv):
    sup = srv.server.acceptors
    assert sup.alive_workers() == 2
    for seed in range(24):
        assert _post(sup.ingest_port, _frame(_ids(seed)), TENSOR)[0] == 200
    accepts = [blk.snapshot()["accepts"] for blk in sup.stats_blocks]
    assert all(a > 0 for a in accepts), accepts
    for p in sup.workers:
        maps = Path(f"/proc/{p.pid}/maps")
        if maps.exists():
            assert "libtorch" not in maps.read_text()
    pump = srv.server._serverpath_snapshot()["pump"]
    assert pump["served"] >= 24 and pump["resp_drops"] == pump["resp_oversize"] == 0
    assert all(s is not None and s < 30 for s in pump["spawn_seconds"])


def test_trace_continuity_through_the_rings(srv):
    sup = srv.server.acceptors
    client_tid = "ab" * 16
    status, heads, raw = _post(sup.ingest_port, _frame(_ids(77)),
                               {**TENSOR, "traceparent": f"00-{client_tid}-{'cd' * 8}-01",
                                "X-Request-Id": "rid-fastlane-021"})
    assert status == 200, raw
    assert heads["X-Trace-Id"] == client_tid and heads["X-Request-Id"] == "rid-fastlane-021"
    tree = _get(srv.port, f"/admin/trace/{client_tid}")["trace"]["tree"]
    assert tree["attrs"]["request_id"] == "rid-fastlane-021"
    assert tree["attrs"]["lane"] == "binary"
    names = [c["name"] for c in tree["children"]]
    order = ["sock_read", "frame_validate", "ring_wait", "binary_decode", "admission", "queue",
             "batch_form", "device", "respond"]
    assert [n for n in names if n in order] == sorted(
        [n for n in names if n in order], key=lambda n: min(
            c["start_ms"] for c in tree["children"] if c["name"] == n))
    assert set(order) <= set(names)
    device = next(c for c in tree["children"] if c["name"] == "device")
    assert [c["name"] for c in device.get("children", [])] == ["exec"]
    import importlib.util

    spec = importlib.util.spec_from_file_location("tracedump", ROOT / "tools" / "tracedump.py")
    dump = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dump)
    att = dump.stage_attribution({"trace": _get(srv.port, f"/admin/trace/{client_tid}")
                                  ["trace"]})
    for sub in ("sock_read", "frame_validate", "ring_wait", "binary_decode"):
        assert sub in att["substages"] and sub not in att["stages"]
    assert att["coverage_pct"] >= 95.0, att


def test_pump_errors_carry_ids_and_join_the_flight_recorder(srv):
    sup = srv.server.acceptors
    client_tid = "ef" * 16
    raw = PA.pack_msg(5, 0, "bert_base|", b"XXXX not a frame",
                      PT.pack_telem("rid-fastlane-005", *([time.perf_counter()] * 4),
                                    f"00-{client_tid}-{'12' * 8}-01"))
    _, status, _, telem, body, _ = PA.unpack_msg(srv.call(sup._serve_one, srv.server, raw))
    assert status == 400
    body = json.loads(body)
    assert body["request_id"] == "rid-fastlane-005" and body["trace_id"] == client_tid
    assert PT.unpack_telem(telem)["request_id"] == "rid-fastlane-005"
    trace = srv.server.tracer.get(client_tid)
    assert trace is not None and trace.status == "error"
    assert srv.server.tracer.pinned()["errored"].get("bert_base", 0) >= 1
    raw = PA.pack_msg(8, 0, "nope|", _frame(_ids(3)))
    _, status, _, _, body, _ = PA.unpack_msg(srv.call(sup._serve_one, srv.server, raw))
    body = json.loads(body)
    assert status == 404 and "unknown model" in body["error"]
    assert body["request_id"] and body["trace_id"]
    srv.server.resilience.quarantined.add("bert_base")
    try:
        raw = PA.pack_msg(9, 0, "bert_base|", _frame(_ids(3)))
        _, status, _, _, body, _ = PA.unpack_msg(srv.call(sup._serve_one, srv.server, raw))
        body = json.loads(body)
        assert status == 503 and body["retry_after_s"] > 0 and body["quarantined"]
    finally:
        srv.server.resilience.quarantined.discard("bert_base")


def test_fast_lane_accounting_parity_with_the_json_lane(srv):
    server, sup, n = srv.server, srv.server.acceptors, 3

    def books():
        def read():
            tr = server.slo.tracker("bert_base", "predict")
            usage = server.slo.usage.snapshot().get("bert_base") or {}
            dm = server.autoscale._models.get("bert_base")
            return (sum(tr.outcomes.values()), usage.get("requests", 0),
                    dm.arrivals if dm is not None else 0)
        return srv.call(read)

    base = books()
    for seed in range(n):
        assert _post(sup.ingest_port, _frame(_ids(200 + seed)), TENSOR)[0] == 200
    after_fast = books()
    for seed in range(n):
        body = json.dumps({"input_ids": _ids(300 + seed)[0]}).encode()
        assert _post(srv.port, body, {"Content-Type": "application/json"})[0] == 200
    after_json = books()
    fast = tuple(b - a for a, b in zip(base, after_fast))
    slow = tuple(b - a for a, b in zip(after_fast, after_json))
    assert fast == slow == (n, n, n), (fast, slow)


def test_telemetry_families_and_the_ingest_stages(srv):
    sup = srv.server.acceptors
    before = _get(srv.port, "/admin/perf")["ingest"]["bert_base"]
    for seed in range(4):
        assert _post(sup.ingest_port, _frame(_ids(400 + seed)), TENSOR)[0] == 200
    after = _get(srv.port, "/admin/perf")["ingest"]["bert_base"]
    for stage in ("sock_read", "frame_validate", "ring_wait", "binary_decode", "validate",
                  "batch_form", "serialize", "respond"):
        assert after[stage]["count"] - before.get(stage, {"count": 0})["count"] == 4, stage
    prom = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics?format=prometheus",
                                  timeout=30).read().decode()
    for fam in ("tpuserve_ingest_workers 2", "tpuserve_acceptor_accepts_total{worker=\"0\"}",
                "tpuserve_acceptor_worker_up{worker=\"1\"} 1",
                "# TYPE tpuserve_acceptor_inworker_ms histogram",
                "# TYPE tpuserve_acceptor_ring_wait_ms histogram",
                "# TYPE tpuserve_shm_ring_occupancy_pct histogram",
                'tpuserve_shm_ring_depth{ring="req:0"}'):
        assert fam in prom, fam
    import importlib.util

    spec = importlib.util.spec_from_file_location("check_metrics",
                                                  ROOT / "tools" / "check_metrics.py")
    cm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cm)
    assert cm.check(prom, cm.load_manifest()) == []


def test_a_deadline_behind_a_slow_dispatch_is_504(srv):
    sup = srv.server.acceptors
    assert _post(srv.port, json.dumps({"model": "bert_base", "latency_ms": 300}).encode(),
                 {"Content-Type": "application/json"}, path="/admin/faults")[0] == 200
    try:
        slow = threading.Thread(target=_post, args=(sup.ingest_port, _frame(_ids(5)), TENSOR))
        slow.start()
        time.sleep(0.05)
        status, heads, raw = _post(sup.ingest_port, _frame(_ids(6)),
                                   {**TENSOR, "X-Deadline-MS": "1"})
        slow.join(30)
        assert status == 504, raw
        body = json.loads(raw)
        assert body["request_id"] == heads["X-Request-Id"] and body["trace_id"]
    finally:
        _post(srv.port, json.dumps({"clear": True}).encode(),
              {"Content-Type": "application/json"}, path="/admin/faults")


def test_a_demoted_model_answers_cold_start_and_never_dispatches(srv):
    """The port's choice (the reference answers 404): a configured model
    that is not resident answers 503 ``cold_start`` with Retry-After on
    the fast lane and its activation starts; once restored it serves the
    same bytes.  No request reaches the demoted model's released graphs."""
    sup = srv.server.acceptors
    frame = _frame(_ids(9))
    status, _, want = _post(sup.ingest_port, frame, TENSOR)
    assert status == 200
    assert _post(srv.port, json.dumps({"action": "demote", "to": "host"}).encode(),
                 {"Content-Type": "application/json"},
                 path="/admin/models/bert_base")[0] == 200
    batches = srv.call(lambda: srv.server.engine.runner.stats["bert_base"].batches)
    status, heads, raw = _post(sup.ingest_port, frame, TENSOR)
    assert status == 503, raw
    body = json.loads(raw)
    assert body["cold_start"] is True and int(heads["Retry-After"]) >= 1
    assert body["request_id"] and body["trace_id"]
    for _ in range(200):
        if srv.call(lambda: srv.server.lifecycle.state_of("bert_base")) == "active":
            break
        time.sleep(0.05)
    status, _, got = _post(sup.ingest_port, frame, TENSOR)
    assert status == 200 and _preds(got) == _preds(want)
    assert srv.call(lambda: srv.server.engine.runner.stats["bert_base"].batches) == batches + 1


def _wait_serving(srv, timeout_s=30.0):
    """Until both workers are up and a respawn has stamped its heartbeat
    (a respawn's is cleared until it listens)."""
    sup = srv.server.acceptors
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rows = srv.call(sup.telemetry_snapshot)["workers"]
        if sup.alive_workers() == 2 and all(r["up"] and r["heartbeat_age_s"] is not None
                                            for r in rows):
            return
        time.sleep(0.02)
    raise AssertionError(f"workers not serving: {rows}")


def test_kill_9_of_a_worker_fails_its_inflight_and_respawns(srv):
    """SIGKILL a worker: every in-flight request ends (200 through the
    survivor, an error where its connection died), the liveness gauge
    flips and the restart counts; a message the dead worker had queued is
    answered 503 with its ids through the response path; after the respawn
    the lane serves the same bytes."""
    server, sup = srv.server, srv.server.acceptors
    frames = [_frame(_ids(500 + i)) for i in range(8)]
    want = [_preds(_post(sup.ingest_port, f, TENSOR)[2]) for f in frames]
    restarts = sup.restarts
    assert _post(srv.port, json.dumps({"model": "bert_base", "latency_ms": 400}).encode(),
                 {"Content-Type": "application/json"}, path="/admin/faults")[0] == 200
    results = [None] * 4

    def send(i):
        try:
            results[i] = _post(sup.ingest_port, frames[i], TENSOR)[0]
        except Exception as e:  # noqa: BLE001 — the connection died with its worker
            results[i] = type(e).__name__

    threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        victim = sup.workers[0]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(10)
        for t in threads:
            t.join(30)
        assert all(r is not None for r in results), results
        assert all(r == 200 or isinstance(r, str) or r >= 500 for r in results), results
        for _ in range(100):
            rows = srv.call(sup.telemetry_snapshot)["workers"]
            if not rows[0]["up"] or sup.restarts > restarts:
                break
            time.sleep(0.02)
        assert sup.restarts == restarts + 1
    finally:
        _post(srv.port, json.dumps({"clear": True}).encode(),
              {"Content-Type": "application/json"}, path="/admin/faults")
    # A queued message of a dead worker: the pump out of the way, the
    # worker killed with the message in its ring.
    _wait_serving(srv)

    async def queued_death():
        sup._pump_task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await sup._pump_task
        telem = PT.pack_telem("rid-sigkill-0077", *([time.perf_counter()] * 4), "")
        assert sup.req_rings[1].try_push(PA.pack_msg(77, 0, "bert_base|", frames[0], telem))
        os.kill(sup.workers[1].pid, signal.SIGKILL)
        await asyncio.get_running_loop().run_in_executor(None, sup.workers[1].join, 10)
        sup._next_reap = 0.0
        sup._reap_dead_workers(server)
        assert sup.worker_up[1] is False
        msgs = PA.unpack_batch(sup.resp_rings[1].try_pop())
        sup._next_reap = 0.0
        sup._reap_dead_workers(server)
        sup._pump_task = asyncio.get_running_loop().create_task(sup._pump(server))
        return msgs

    msgs = srv.call(queued_death)
    by_id = {m[0]: m for m in msgs}
    body = json.loads(by_id[77][4])
    assert by_id[77][1] == 503 and body["request_id"] == "rid-sigkill-0077"
    assert body["trace_id"] and body["retry_after_s"] > 0 and "worker died" in body["error"]
    _wait_serving(srv)
    assert sup.restarts == restarts + 2
    for _ in range(3):
        got = [_preds(_post(sup.ingest_port, f, TENSOR)[2]) for f in frames]
        assert got == want
    prom = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics?format=prometheus",
                                  timeout=30).read().decode()
    assert f"tpuserve_acceptor_restarts_total {restarts + 2}" in prom


# -- boot: what the port refuses -------------------------------------------------

def _refused_boot(engine, **kw):
    with pytest.raises(RuntimeError) as e:
        with BackgroundServer(_cfg(**kw), engine):
            pass
    return str(e.value)


@needs_reuseport
def test_a_host_without_total_store_order_is_refused(engine, monkeypatch):
    """The rings publish a cursor after the payload with no fence: the port
    refuses the workers on a host that is not x86-64, with the reason,
    rather than serve on a ring that can tear."""
    monkeypatch.setattr(PA.platform, "machine", lambda: "aarch64")
    why = _refused_boot(engine)
    assert "aarch64" in why and "total-store-order" in why


@needs_reuseport
def test_rings_that_do_not_fit_dev_shm_are_refused(engine, monkeypatch):
    monkeypatch.setattr(PA, "shm_free_bytes", lambda path="/dev/shm": 1 << 20)
    why = _refused_boot(engine, shm_ring_slots=256, shm_ring_slot_bytes=1 << 20)
    assert "/dev/shm" in why and str(1 << 20) in why


@needs_reuseport
def test_an_ingest_port_in_use_is_refused(engine):
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        why = _refused_boot(engine, ingest_port=taken.getsockname()[1])
    assert "cannot be bound" in why


@needs_reuseport
def test_a_worker_started_under_a_torch_main_loads_no_torch(tmp_path):
    """Whatever the parent's ``__main__`` imports (here torch), a worker's
    modules are the acceptors module's closure: no torch, no JAX."""
    script = tmp_path / "main_with_torch.py"
    script.write_text(
        "import asyncio, json, sys, urllib.request\n"
        "import torch  # noqa: F401\n"
        "from types import SimpleNamespace\n"
        "from pytorch_zappa_serverless_tpu_torch.serving.acceptors import AcceptorSupervisor\n"
        "cfg = SimpleNamespace(host='127.0.0.1', port=0, ingest_port=0, ingest_workers=1,\n"
        "                      shm_ring_slots=4, shm_ring_slot_bytes=4096,\n"
        "                      tensor_max_bytes=0)\n"
        "async def main():\n"
        "    sup = AcceptorSupervisor(cfg)\n"
        "    await sup.start(None)\n"
        "    try:\n"
        "        loop = asyncio.get_running_loop()\n"
        "        url = f'http://127.0.0.1:{sup.ingest_port}/healthz'\n"
        "        body = await loop.run_in_executor(None, lambda: urllib.request.urlopen(\n"
        "            url, timeout=10).read())\n"
        "        pid = json.loads(body)['pid']\n"
        "        maps = open(f'/proc/{pid}/maps').read()\n"
        "        mods = open(f'/proc/{pid}/cmdline').read()\n"
        "        print(json.dumps({'health': json.loads(body), 'libtorch': 'libtorch' in maps,\n"
        "                          'cmd': mods, 'parent_torch': 'torch' in sys.modules}))\n"
        "    finally:\n"
        "        await sup.stop()\n"
        "asyncio.run(main())\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["parent_torch"] is True
    assert out["health"]["torch_loaded"] is False and out["libtorch"] is False
    assert "serving.acceptors" in out["cmd"]
