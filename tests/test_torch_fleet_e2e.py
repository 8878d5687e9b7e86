"""The port's fleet router in front of real port replicas, on the CPU.

- **Routed work**: two in-process replicas (``BackgroundServer``, a tiny
  seeded BERT on the int8 lane) behind the router: a routed predict equals
  the same request sent to a replica directly, the replica's trace of it
  parents under the router's span (one trace id, the router's span id as
  the replica root's parent), and a partitioned replica fails over within
  one retry.
- **Disaggregated ``:generate``**: three replicas with a tiny seeded GPT-2
  on the paged lane, the first tagged prefill.  A stream through the router
  prefills there, moves to a decode replica at its first token and equals
  the same greedy stream on one replica undisturbed; then the decode
  replica of a second stream is stopped mid-stream and the stream resumes
  on the third, no token lost or repeated (``kv_failover``).
- **A replica busy warming stays routable.**  A restore, build or capture
  holds the dispatch thread for seconds (a cold GPT-2 small int8
  activation takes 13-18 s on the H100).  A device probe queued behind it
  would time the router's polls out and quarantine the replica the router
  had just asked to activate a model; ``/healthz`` answers at once with the
  hold named instead, and the replica stays healthy.  An unmarked wedge
  still quarantines.
- **Refused config fields say why**, each by name.
"""

import http.client
import json
import threading
import time

import pytest

from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

from fleet_harness import RouterHarness

BERT = {"arch": {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
                 "vocab_size": 512}, "params_dtype": "int8", "quantize_min_size": 1024}
GPT2 = {"arch": {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128, "vocab_size": 500,
                 "max_positions": 96}, "max_new_tokens": 16, "gen_slots": 2,
        "segment_tokens": 2}


def _bert_cfg(**kw):
    return PC.ServeConfig(models=[PC.ModelConfig(name="bert_base", seq_buckets=(16,),
                                                 batch_buckets=(1, 4), coalesce_ms=0.0,
                                                 extra=BERT)], **kw)


def _gpt2_cfg():
    return PC.ServeConfig(models=[PC.ModelConfig(
        name="gpt2", dtype="float32", batch_buckets=(1,), seq_buckets=(16,), coalesce_ms=0.0,
        kv_cache="paged", kv_block_size=4, extra=GPT2)])


def _req(port, method, path, body=None, headers=None, timeout=60.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=json.dumps(body).encode() if body is not None else None,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


def _harness(urls, **cfg):
    """The harness's router in front of running servers (not fakes)."""
    fakes = [type("R", (), {"url": u})() for u in urls]
    return RouterHarness("port", fakes, **cfg)


@pytest.fixture(scope="module")
def bert_engine():
    eng = build_engine(_bert_cfg(), device="cpu")
    yield eng
    eng.shutdown()


def test_routed_predict_equals_direct_fails_over_and_joins_the_trace(bert_engine):
    with BackgroundServer(_bert_cfg(), bert_engine) as a, \
            BackgroundServer(_bert_cfg(), bert_engine) as b:
        with _harness([f"http://127.0.0.1:{s.port}" for s in (a, b)]) as h:
            snap = h.router.registry.snapshot()
            assert all(r["residency"]["bert_base"]["state"] == "active" for r in snap.values())
            assert all("bert_base" in r["forecast"] for r in snap.values())
            body = {"input_ids": [5, 17, 42, 99]}
            tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
            r = h.req("POST", "/v1/models/bert_base:predict", json_body=body,
                      headers={"traceparent": tp})
            assert r.status == 200 and r.header("X-Fleet-Attempts") == "1"
            rid = r.header("X-Fleet-Replica")
            direct = _req((a if rid == "r0" else b).port, "POST",
                          "/v1/models/bert_base:predict", body)
            assert direct[0] == 200
            assert r.json()["predictions"] == json.loads(direct[2])["predictions"]
            # One trace id through the hop: the replica's root parents under
            # the router's span, which parents under the caller's.
            tid = r.header("X-Trace-Id")
            assert tid == "ab" * 16
            rtrace = h.router.tracer.get(tid)
            assert rtrace is not None and rtrace.root.parent_id == "cd" * 8
            st, _, raw = _req((a if rid == "r0" else b).port, "GET", f"/admin/trace/{tid}")
            assert st == 200
            tree = json.loads(raw)["trace"]
            assert tree["remote_parent"] == rtrace.root.span_id
            assert tree["tree"]["name"] == "predict" and tree["spans"] >= 4
            # A partition of the replica that answered: the peer answers.
            h.run(lambda: h.router.faults.configure(replica=rid, kind="partition"))
            r2 = h.req("POST", "/v1/models/bert_base:predict", json_body=body)
            assert r2.status == 200 and r2.header("X-Fleet-Attempts") == "2"
            assert r2.header("X-Fleet-Replica") != rid
            assert r2.json()["predictions"] == r.json()["predictions"]
            assert h.router.metrics.failovers_total.get("connect", 0) >= 1


def _stream(port, body, until=None):
    """(headers, tokens, last event) of one SSE request; with ``until``, the
    first ``until`` tokens and the open response."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/models/gpt2:generate", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.read()
    tokens, last = [], None

    def read(n=None):
        nonlocal last
        while n is None or len(tokens) < n:
            line = resp.readline()
            if not line:
                return
            if line.startswith(b"data: "):
                ev = json.loads(line[6:])
                if "token" in ev:
                    tokens.append(ev["token"])
                else:
                    last = ev
                    return

    read(until)
    if until is not None:
        return resp, tokens, read, conn
    conn.close()
    return resp.headers, tokens, last


def test_disaggregated_generate_moves_at_the_first_token_and_survives_the_decode_replica():
    cfg = _gpt2_cfg()
    engines = [build_engine(cfg, device="cpu") for _ in range(3)]
    servers = [BackgroundServer(_gpt2_cfg(), e).__enter__() for e in engines]
    stopped = set()
    try:
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        body = {"input_ids": list(range(5, 15)), "max_new_tokens": 16}
        _, ref, ref_end = _stream(servers[1].port, body)
        assert len(ref) == 16 and ref_end["tokens"] == ref
        with _harness(urls, disagg=True, prefill_replicas=[urls[0]]) as h:
            headers, tokens, end = _stream(h.port, body)
            assert headers["X-Fleet-Disagg"] == "1" and headers["X-Fleet-Replica"] == "r0"
            assert tokens == ref and end["done"] and end["tokens"] == ref
            assert h.router.metrics.migrations_total.get("prefill") == 1
            # A slow decode, so the stop lands mid-stream.
            for e in engines:
                e.runner.faults.configure(model="gpt2", latency_ms=150.0)
            resp, tokens, read, conn = _stream(h.port, body, until=4)
            sid = resp.headers["X-Stream-Id"]
            fleet = h.req("GET", "/admin/fleet").json()
            decode = fleet["streams"][sid]["replica"]
            assert decode != "r0"
            victim = servers[int(decode[1:])]
            victim.__exit__(None, None, None)
            stopped.add(victim)
            read()
            conn.close()
            assert tokens == ref, (tokens, ref)  # nothing lost, nothing repeated
            fleet = h.req("GET", "/admin/fleet").json()
            assert fleet["streams"][sid]["replica"] not in (decode, "r0")
            assert fleet["metrics"]["migrations"] == {"prefill": 2, "failover": 1}
            assert fleet["metrics"]["failovers"].get("kv_failover") == 1
    finally:
        for s in servers:
            if s not in stopped:
                s.__exit__(None, None, None)
        for e in engines:
            e.shutdown()


def _hold(runner, fn_name: str, seconds: float) -> threading.Thread:
    import functools

    call = getattr(runner, fn_name)
    fn = (functools.partial(call, "restore m", time.sleep, seconds) if fn_name == "run_held"
          else functools.partial(call, time.sleep, seconds))
    th = threading.Thread(target=fn, daemon=True)
    th.start()
    time.sleep(0.1)  # the thread is inside
    return th


@pytest.mark.parametrize("held", [True, False], ids=["held_by_a_restore", "unmarked_wedge"])
def test_a_replica_whose_dispatch_thread_is_held_stays_routable(bert_engine, held):
    """The router polls with a 2 s budget and quarantines after 2 missed
    polls.  A hold of 5 s marked as a restore (what an activation's restore,
    build and captures now are) leaves the replica healthy, and /healthz
    names the hold; the same 5 s unmarked (a wedge) still quarantines."""
    runner = bert_engine.runner
    with BackgroundServer(_bert_cfg(), bert_engine) as a:
        with _harness([f"http://127.0.0.1:{a.port}"], poll_interval_s=0.4,
                      quarantine_after=2) as h:
            assert h.router.registry.get("r0").state == "healthy"
            with runner._probe_lock:
                runner._probe_deadline = 0.0  # the cached verdict has expired
            th = _hold(runner, "run_held" if held else "run_fn_sync", 5.0)
            states, took = [], []
            for _ in range(2):
                t0 = time.monotonic()
                h.poll()
                took.append(time.monotonic() - t0)
                states.append(h.router.registry.get("r0").state)
            if held:
                assert states == ["healthy", "healthy"] and max(took) < 1.0, (states, took)
                st, _, raw = _req(a.port, "GET", "/healthz")
                health = json.loads(raw)
                assert st == 200 and health["device_ok"] is True
                assert health["dispatch_held"]["by"] == "restore m"
                assert 0 < health["dispatch_held"]["s"] < 5.0
                assert h.router.registry.get("r0").routable("bert_base")
            else:
                assert states == ["healthy", "quarantined"] and min(took) >= 1.9, (states, took)
            th.join(10)
            h.poll()
            assert h.router.registry.get("r0").state == "healthy"


def test_activation_builds_and_restores_hold_the_dispatch_thread(bert_engine):
    """The lifecycle's device work goes through ``run_held``: a lazy model's
    activation and a host-tier restore mark the thread with their model."""
    cfg = _bert_cfg(lazy_load=True)
    with BackgroundServer(cfg, device="cpu") as a:
        runner = a.server.engine.runner
        labels = []
        orig = runner.run_held

        def spy(label, fn, *args, **kw):
            labels.append((label, runner.held()))
            return orig(label, fn, *args, **kw)

        runner.run_held = spy
        st, _, _ = _req(a.port, "POST", "/admin/models/bert_base", {"action": "activate"})
        assert st == 200
        st, _, _ = _req(a.port, "POST", "/admin/models/bert_base",
                        {"action": "demote", "to": "host"})
        assert st == 200
        st, _, _ = _req(a.port, "POST", "/admin/models/bert_base", {"action": "activate"})
        assert st == 200
        assert [lb for lb, _ in labels][:1] == ["build bert_base"]
        assert "restore bert_base" in [lb for lb, _ in labels]
        assert runner.held() is None  # released after each


@pytest.mark.parametrize("field", sorted(set(PC.REFUSED_FIELDS)))
def test_each_refused_field_is_refused_by_name_with_its_reason(tmp_path, field):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({field: 1, "models": []}))
    with pytest.raises(ValueError) as e:
        PC.load_config(path)
    msg = str(e.value)
    assert repr(field) in msg and PC.REFUSED_FIELDS[field] in msg
    # Both are stated differences of the port (ROADMAP Queue 3).
    assert "Queue 3" in PC.REFUSED_FIELDS[field]
    # parallel/ serves the mesh and multi-host fields: none is refused for it.
    assert "parallel/" not in PC.REFUSED_FIELDS[field]
    assert field in ("profiler_port", "compile_cache_dir")


def test_refused_fields_and_the_fleet_block_cover_the_reference_config(tmp_path):
    """Every field of the JAX package's ServeConfig is served or refused by
    name: 83 of its 85 served, the two others refused."""
    import dataclasses

    from pytorch_zappa_serverless_tpu import config as JC

    ref = {f.name for f in dataclasses.fields(JC.ServeConfig)}
    port = {f.name for f in dataclasses.fields(PC.ServeConfig)}
    assert len(ref) == 85 and len(ref & port) == 83
    assert ref - port == set(PC.REFUSED_FIELDS)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"fleet": {"poll_interval_s": 0.4, "spawn": 2,
                                          "prefill_replicas": ["http://x"]},
                                "models": []}))
    cfg = PC.load_config(path)
    assert isinstance(cfg.fleet, PC.FleetConfig)
    assert (cfg.fleet.poll_interval_s, cfg.fleet.spawn, cfg.fleet.prefill_replicas) == (
        0.4, 2, ["http://x"])
    assert cfg.fleet.quarantine_after == JC.FleetConfig().quarantine_after
    with pytest.raises(TypeError):
        path.write_text(json.dumps({"fleet": {"bogus": 1}}))
        PC.load_config(path)


def test_cli_fleet_runs_the_router_over_running_replicas(bert_engine, tmp_path):
    """``cli fleet --replicas`` serves the router in front of replicas that
    run already (no spawn, so no device is asked for)."""
    import subprocess
    import sys

    from pytorch_zappa_serverless_tpu_torch.tools.crashtest import _free_port

    with BackgroundServer(_bert_cfg(), bert_engine) as a:
        port = _free_port()
        cfg = tmp_path / "fleet.json"
        cfg.write_text(json.dumps({"fleet": {"poll_interval_s": 0.2}, "models": []}))
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli", "fleet",
             "--config", str(cfg), "--port", str(port),
             "--replicas", f"http://127.0.0.1:{a.port}"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 60
            state = None
            while time.monotonic() < deadline:
                try:
                    st, _, raw = _req(port, "GET", "/admin/fleet", timeout=2)
                    state = json.loads(raw)["replicas"]["r0"]["state"]
                    if state == "healthy":
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            assert state == "healthy"
            st, hdrs, raw = _req(port, "POST", "/v1/models/bert_base:predict",
                                 {"input_ids": [1, 2, 3]})
            assert st == 200 and hdrs["X-Fleet-Replica"] == "r0"
        finally:
            proc.terminate()
            assert proc.wait(timeout=30) == 0
