"""Fault injection and recovery over the port's HTTP server, on the CPU
(the JAX package's ``tests/test_fault_injection.py``, case for case, with a
tiny int8 BERT as ``tests/test_torch_engine.py`` drives it).

``DeviceRunner.poison`` wedges the runner: every waiting request resolves
with 500, ``/healthz`` flips 503, and the engine is rebuilt by the operator
route and by the watchdog.  ``FaultInjector`` rules drive transient retries,
the breaker's open/half-open/close cycle, deadline shedding under latency,
drain and the admin surface, and the watchdog's give-up and re-arm seen
through the residency surface (``serving/lifecycle.py``).  The last case runs
one script of faults, deadlines, a breaker trip and a drain against both
packages' servers and holds their answers and counters equal.
"""

import asyncio
import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref
from concurrent.futures import ThreadPoolExecutor

import pytest

import pytorch_zappa_serverless_tpu_torch.serving.server as server_mod
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

TINY_ARCH = {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
             "vocab_size": 512, "max_position": 64}
MODEL = dict(name="bert_base", dtype="float32", seq_buckets=(8, 16), batch_buckets=(1, 4),
             coalesce_ms=5.0, extra={"arch": TINY_ARCH, "params_dtype": "int8"})
GPT2_ARCH = {"d_model": 32, "layers": 1, "heads": 2, "ffn_dim": 64, "vocab_size": 512,
             "max_positions": 64}
GPT2 = dict(name="gpt2", dtype="float32", batch_buckets=(1, 2), seq_buckets=(8,),
            coalesce_ms=5.0, extra={"max_new_tokens": 4, "arch": GPT2_ARCH})
BODY = {"input_ids": [5, 6, 7, 8]}
PREDICT = "/v1/models/bert_base:predict"
SUBMIT = "/v1/models/bert_base:submit"


def _cfg(*models, **kw):
    return ServeConfig(models=[ModelConfig(**m) for m in (models or (MODEL,))], **kw)


@pytest.fixture(scope="module")
def engine():
    eng = build_engine(_cfg(), device="cpu")
    yield eng
    eng.shutdown()


@pytest.fixture
def faults(engine):
    """The module engine's injector, clean before and after each test."""
    inj = engine.runner.faults
    inj.clear()
    inj.poison_exc = None
    yield inj
    inj.clear()
    inj.poison_exc = None


def _http(port, path, body=None, headers=None, method=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})},
                                 method=method or ("GET" if data is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read(), e.code, dict(e.headers)
    if hdrs.get("Content-Type", "").startswith("application/json"):
        return status, json.loads(raw), hdrs
    return status, raw.decode(), hdrs


def _predict(port, **headers):
    return _http(port, PREDICT, BODY, headers)


def _prometheus(port):
    status, text, hdrs = _http(port, "/metrics?format=prometheus")
    assert status == 200 and hdrs["Content-Type"].startswith("text/plain; version=0.0.4")
    return text


def _lane_held(inj, before=0.0):
    """Until the dispatch thread sleeps in an injected latency (the
    injector books it first): the lane is then held."""
    assert _wait_for(lambda: inj.snapshot()["injected"]["latency_ms"] > before, 30, 0.001)


def _wait_for(predicate, timeout_s=60.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def test_poisoned_runner_fails_all_waiters_and_flips_healthz(engine, faults):
    with BackgroundServer(_cfg(), engine) as srv:
        engine.runner.poison(RuntimeError("injected fatal CUDA error"))
        try:
            # Every concurrently waiting request resolves with 500.
            with ThreadPoolExecutor(6) as ex:
                statuses = [r[0] for r in ex.map(lambda _: _predict(srv.port), range(6))]
            assert statuses == [500] * 6
            status, body, _ = _http(srv.port, "/healthz")
            assert status == 503 and not body["device_ok"]
        finally:
            engine.runner.poison(None)
        assert _http(srv.port, "/healthz")[0] == 200
        assert _predict(srv.port)[0] == 200


def test_reload_does_not_shut_down_external_engine(engine, faults):
    """An engine handed in survives /admin/reload: the server swaps to its
    own fresh engine and leaves the shared one alone."""
    with BackgroundServer(_cfg(), engine) as srv:
        status, body, _ = _http(srv.port, "/admin/reload", {})
        assert status == 200 and body["status"] == "reloaded"
        server = srv.server
        assert server.engine is not engine and server._owns_engine
        assert server.engine.device == engine.device  # a rebuild never moves
        assert engine.runner.probe()
        assert _predict(srv.port)[0] == 200


def test_admin_reload_and_watchdog_rebuild():
    """Rebuilds by the operator route, then by the watchdog after the live
    runner is poisoned (the port's counterpart of the reference's
    supervisor, which the watchdog supersedes)."""
    eng = build_engine(_cfg(), device="cpu")
    try:
        with BackgroundServer(_cfg(watchdog_interval_s=0.05, recover_backoff_s=0.05),
                              eng) as srv:
            status, body, _ = _http(srv.port, "/admin/reload", {})
            assert status == 200 and body["status"] == "reloaded"
            assert _predict(srv.port)[0] == 200
            poisoned = srv.server.engine.runner
            poisoned.poison(RuntimeError("injected"))
            assert _wait_for(lambda: srv.server.engine.runner is not poisoned), \
                "the watchdog never rebuilt"
            assert poisoned.closed  # the replaced engine, the server's own, is shut down
            assert _wait_for(lambda: _http(srv.port, "/healthz")[0] == 200)
            assert _predict(srv.port)[0] == 200
    finally:
        eng.shutdown()


def test_reload_under_the_watchdog_is_not_taken_for_a_fault():
    """While a reload swaps the engine, the old runner refuses work (it is
    poisoned for the rebuild): the watchdog must not read that as a fault
    and rebuild again."""
    eng = build_engine(_cfg(), device="cpu")
    try:
        with BackgroundServer(_cfg(watchdog_interval_s=0.01, recover_backoff_s=0.01),
                              eng) as srv:
            assert _http(srv.port, "/admin/reload", {})[0] == 200
            reloaded = srv.server.engine
            time.sleep(0.3)  # thirty ticks
            assert srv.server.engine is reloaded and not eng.runner.faults.poison_exc
            snap = srv.server.watchdog.snapshot()
            assert snap["recoveries_total"] == 0 and snap["attempts"] == 0
            assert snap["state"] == "healthy" and _predict(srv.port)[0] == 200
    finally:
        eng.shutdown()


def test_transient_fault_retried_request_succeeds(engine, faults):
    cfg = _cfg(retry_max_attempts=2, retry_base_ms=1.0)
    with BackgroundServer(cfg, engine) as srv:
        runner_before = engine.runner
        faults.configure(model="bert_base", fail_every_n=1, count=1, kind="transient")
        status, body, _ = _predict(srv.port)
        assert status == 200, body
        assert engine.runner is runner_before and engine.runner.probe()
        m = _http(srv.port, "/metrics")[1]
        res = m["resilience"]["models"]["bert_base"]
        assert res["retries"] == 1 and res["retry_successes"] == 1
        assert m["faults"]["injected"]["dispatch"] == 1


def test_breaker_open_fast_fails_while_other_model_serves():
    """Persistent fatal faults on BERT trip its breaker: requests then fail
    fast with 503 (no dispatch) while GPT-2 keeps serving on the same
    engine; after the cooldown a half-open probe closes it."""
    cfg = _cfg(MODEL, GPT2, breaker_threshold=0.5, breaker_min_samples=4, breaker_window=8,
               breaker_open_s=0.4)
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            eng.runner.faults.configure(model="bert_base", fail_every_n=1, kind="fatal")
            for _ in range(4):
                assert _predict(srv.port)[0] == 500
            st = eng.runner.stats.get("bert_base")
            batches_before = st.batches if st else 0
            t0 = time.perf_counter()
            status, body, hdrs = _predict(srv.port)
            fast_fail_ms = (time.perf_counter() - t0) * 1000
            assert status == 503 and body["breaker"] == "open" and "Retry-After" in hdrs
            assert fast_fail_ms < 250
            st = eng.runner.stats.get("bert_base")
            assert (st.batches if st else 0) == batches_before
            # The sick model cannot poison its neighbour.
            status, body, _ = _http(srv.port, "/v1/models/gpt2:predict", {"input_ids": [3, 4]})
            assert status == 200, body
            assert _http(srv.port, SUBMIT, BODY)[0] == 503  # submits share the breaker
            res = _http(srv.port, "/metrics")[1]["resilience"]["models"]["bert_base"]
            assert res["breaker"]["state"] == "open" and res["breaker_fast_fails"] >= 2
            eng.runner.faults.clear()
            time.sleep(0.45)
            assert _predict(srv.port)[0] == 200
            res = _http(srv.port, "/metrics")[1]["resilience"]["models"]["bert_base"]
            assert res["breaker"]["state"] == "closed"
            text = _prometheus(srv.port)
            assert 'tpuserve_breaker_state{model="bert_base"} 0' in text
            assert "# TYPE tpuserve_breaker_opens_total counter" in text
    finally:
        eng.shutdown()


def test_deadline_shed_before_dispatch_under_latency(engine, faults):
    """With device latency injected on the lane, a request whose deadline
    cannot be met is 504'd and never dispatched."""
    with BackgroundServer(_cfg(), engine) as srv:
        assert _predict(srv.port)[0] == 200
        samples_before = engine.runner.stats["bert_base"].samples
        p50 = _http(srv.port, "/metrics")[1]["models"]["bert_base"]["device_ms"]["p50"]
        deadline_ms = 2 * p50 + 150
        slept = faults.snapshot()["injected"]["latency_ms"]
        faults.configure(model="bert_base", latency_ms=deadline_ms + 400)
        with ThreadPoolExecutor(1) as ex:
            slow = ex.submit(_predict, srv.port)
            _lane_held(faults, slept)  # the slow batch now holds the lane
            status, body, _ = _predict(srv.port, **{"X-Deadline-Ms": str(round(deadline_ms, 1))})
            assert status == 504, body
            assert body["stage"] in ("queue", "await")
            assert slow.result()[0] == 200
        assert engine.runner.stats["bert_base"].samples == samples_before + 1
        m = _http(srv.port, "/metrics")[1]
        assert m["resilience"]["models"]["bert_base"]["deadline_exceeded"]["total"] >= 1
        assert "tpuserve_deadline_exceeded_total" in _prometheus(srv.port)


def test_admission_rejects_spent_or_hopeless_deadlines(engine, faults):
    with BackgroundServer(_cfg(), engine) as srv:
        assert _predict(srv.port)[0] == 200  # warms the p50 signal
        samples_before = engine.runner.stats["bert_base"].samples
        status, body, _ = _predict(srv.port, **{"X-Deadline-Ms": "0"})
        assert status == 504 and body["stage"] == "admission"
        status, body, hdrs = _predict(srv.port, **{"X-Deadline-Ms": "0.01"})
        assert status == 429, body
        assert "Retry-After" in hdrs and body["estimated_wait_ms"] > 0
        # The body's top-level deadline_ms counts too, popped before preprocess.
        status, body, _ = _http(srv.port, PREDICT, {**BODY, "deadline_ms": 0})
        assert status == 504 and body["stage"] == "admission"
        assert _http(srv.port, PREDICT, BODY, {"X-Deadline-Ms": "soon"})[0] == 400
        assert engine.runner.stats["bert_base"].samples == samples_before
        res = _http(srv.port, "/metrics")[1]["resilience"]["models"]["bert_base"]
        assert res["deadline_exceeded"]["admission"] == 2 and res["shed"] == 1


def test_preprocess_fault_fails_one_request_only(engine, faults):
    with BackgroundServer(_cfg(), engine) as srv:
        faults.configure(model="bert_base", fail_every_n=1, count=1, preprocess=True)
        status, body, _ = _predict(srv.port)
        assert status == 400 and "preprocess failed" in body["error"]
        assert _predict(srv.port)[0] == 200


def test_admin_faults_endpoint(engine, faults):
    with BackgroundServer(_cfg(), engine) as srv:
        status, body, _ = _http(srv.port, "/admin/faults",
                                {"model": "bert_base", "fail_every_n": 2, "kind": "transient",
                                 "latency_ms": 5})
        assert status == 200
        assert body["faults"]["rules"][0]["model"] == "bert_base"
        assert _http(srv.port, "/admin/faults")[1]["faults"]["rules"]
        status, body, _ = _http(srv.port, "/admin/faults", {"frequency": 3})
        assert status == 400 and "unknown fault fields" in body["error"]
        assert _http(srv.port, "/admin/faults", {"kind": "nonsense", "fail_every_n": 1})[0] == 400
        status, body, _ = _http(srv.port, "/admin/faults", {"clear": True})
        assert body["faults"]["rules"] == []


def test_admin_faults_refuses_kinds_the_port_lacks(engine, faults):
    """A kind whose plane the port has not ported (the autoscaler's
    ``demand``) is a 400 naming the module, where the reference would accept
    it; the residency plane's kinds (activation, ckpt with its modes), and
    since live migration and speculation came, migration (with its modes)
    and spec_mismatch, and since the adapters came, adapter, are
    accepted."""
    with BackgroundServer(_cfg(), engine) as srv:
        for kind, module in (("demand", "autoscale.py"),):
            status, body, _ = _http(srv.port, "/admin/faults",
                                    {"model": "bert_base", "fail_every_n": 1, "kind": kind})
            assert status == 400 and module in body["error"]
        assert faults.snapshot()["rules"] == []
        for rule in ({"kind": "activation"}, {"kind": "ckpt", "mode": "torn"},
                     {"kind": "ckpt", "mode": "slow", "latency_ms": 5},
                     {"kind": "migration", "mode": "corrupt"}, {"kind": "spec_mismatch"},
                     {"kind": "adapter"}):
            status, body, _ = _http(srv.port, "/admin/faults",
                                    {"model": "bert_base", "fail_every_n": 1, **rule})
            assert status == 200, body
        for rule, match in (({"kind": "ckpt", "mode": "cow"}, "ckpt mode"),
                            ({"kind": "migration", "mode": "cow"}, "migration mode")):
            status, body, _ = _http(srv.port, "/admin/faults", {"model": "bert_base", **rule})
            assert status == 400 and match in body["error"]
        assert sorted(r["kind"] for r in faults.snapshot()["rules"]) == [
            "activation", "adapter", "ckpt", "migration", "spec_mismatch"]
    with pytest.raises(ValueError, match="autoscale"):
        asyncio.run(server_mod.Server(
            _cfg(faults={"bert_base": {"kind": "demand", "fail_every_n": 1}}), engine).start())


def test_graceful_drain_finishes_inflight_jobs(engine, faults):
    """Drain: health 503 + draining, new work 503 + Retry-After, job polls
    still answered, and the running job finishes within the budget."""
    with BackgroundServer(_cfg(drain_timeout_s=10.0), engine) as srv:
        slept = faults.snapshot()["injected"]["latency_ms"]
        faults.configure(model="bert_base", latency_ms=300)
        status, body, _ = _http(srv.port, SUBMIT, BODY)
        assert status == 202
        job_id = body["job"]["id"]
        _lane_held(faults, slept)  # the job runs on the lane
        srv.call(srv.server.begin_drain)
        status, body, _ = _http(srv.port, "/healthz")
        assert status == 503 and body["draining"] is True
        status, body, hdrs = _predict(srv.port)
        assert status == 503 and "Retry-After" in hdrs and body["draining"] is True
        assert _http(srv.port, f"/v1/jobs/{job_id}")[0] in (200, 410)
        assert srv.call(srv.server.wait_drained, 10.0)
        assert _http(srv.port, f"/v1/jobs/{job_id}")[1]["job"]["status"] == "done"
        assert _http(srv.port, "/admin/drain", {"timeout_s": 1})[1]["drained"] is True
        assert "tpuserve_draining 1" in _prometheus(srv.port)


def test_expired_job_poll_returns_410(engine, faults):
    with BackgroundServer(_cfg(), engine) as srv:
        job_id = _http(srv.port, SUBMIT, BODY)[1]["job"]["id"]
        job = srv.server.jobs.get(job_id)
        assert _wait_for(lambda: job.status == "done")
        job.result, job.status = None, "expired"  # what the TTL sweep does
        status, body, _ = _http(srv.port, f"/v1/jobs/{job_id}")
        assert status == 410, body
        assert body["expired"]["result_ttl_s"] == srv.server.jobs.result_ttl_s
        assert "resubmit" in body["job"]["error"]


# -- self-healing recovery ---------------------------------------------------

def test_fatal_poison_fault_auto_recovers_without_restart():
    """A poison rule wedges the runner mid-flight; the watchdog detects the
    dead probe, quarantines, rebuilds and swaps, and the same request
    succeeds with no restart."""
    cfg = _cfg(watchdog_interval_s=0.05, recover_max_attempts=3, recover_backoff_s=0.05)
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            server = srv.server
            assert _predict(srv.port)[0] == 200
            poisoned = server.engine.runner
            status, body, _ = _http(srv.port, "/admin/faults",
                                    {"model": "bert_base", "fail_every_n": 1, "count": 1,
                                     "kind": "poison"})
            assert status == 200, body
            assert _predict(srv.port)[0] == 500
            assert not poisoned.probe()
            assert _wait_for(lambda: (server.engine.runner is not poisoned
                                      and server.watchdog.state == "healthy")), \
                server.watchdog.snapshot()
            assert server.watchdog.recoveries_total == 1
            assert srv.call(lambda: set(server.resilience.quarantined)) == set()
            assert _predict(srv.port)[0] == 200
            status, body, _ = _http(srv.port, "/healthz")
            assert status == 200 and body["recovery"]["state"] == "healthy"
            assert _http(srv.port, "/metrics")[1]["recovery"]["recoveries_total"] == 1
            text = _prometheus(srv.port)
            assert "tpuserve_recoveries_total 1" in text and "tpuserve_recovery_state 0" in text
    finally:
        eng.shutdown()


def test_breaker_open_with_fatal_cause_triggers_rebuild_and_reset():
    cfg = _cfg(breaker_threshold=0.5, breaker_min_samples=3, breaker_window=4,
               breaker_open_s=60.0, watchdog_interval_s=0.05, recover_max_attempts=3,
               recover_backoff_s=0.05)
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            server = srv.server
            assert _predict(srv.port)[0] == 200
            runner_before = server.engine.runner
            runner_before.faults.configure(model="bert_base", fail_every_n=1, kind="fatal")
            for _ in range(2):
                assert _predict(srv.port)[0] == 500
            mr = server.resilience.model("bert_base")
            assert _wait_for(lambda: (server.engine.runner is not runner_before
                                      and server.watchdog.state == "healthy")), \
                server.watchdog.snapshot()
            # Reset, not a half-open cooldown: closed now, the fatal flag gone.
            assert mr.breaker.state == "closed" and not mr.last_error_fatal
            assert mr.breaker.opens == 1
            assert server.watchdog.recoveries_total == 1
            assert _predict(srv.port)[0] == 200  # the fresh injector has no rules
    finally:
        eng.shutdown()


def test_transient_breaker_open_does_not_trigger_rebuild():
    cfg = _cfg(breaker_threshold=0.5, breaker_min_samples=3, breaker_window=4,
               breaker_open_s=0.3, watchdog_interval_s=0.05, recover_backoff_s=0.05)
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            server = srv.server
            assert _predict(srv.port)[0] == 200
            eng.runner.faults.configure(model="bert_base", fail_every_n=1, count=2,
                                        kind="transient")
            for _ in range(2):
                assert _predict(srv.port)[0] == 500
            mr = server.resilience.model("bert_base")
            assert mr.breaker.state == "open" and not mr.last_error_fatal
            time.sleep(0.4)
            assert _predict(srv.port)[0] == 200  # the half-open probe
            assert server.engine is eng and server.watchdog.recoveries_total == 0
    finally:
        eng.shutdown()


def _doomed_build(seen, msg):
    def build(cfg, device=None, **kw):  # noqa: ARG001
        seen.append(device)
        raise RuntimeError(msg)
    return build


def test_recovery_attempts_bounded_then_manual_recover(monkeypatch):
    """A device that stays dead converges to gave_up (quarantined 503s),
    never a rebuild loop; POST /admin/recover re-arms and heals."""
    cfg = _cfg(watchdog_interval_s=0.05, recover_max_attempts=2, recover_backoff_s=0.01)
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            server = srv.server
            assert _predict(srv.port)[0] == 200
            real_build, seen = server_mod.build_engine, []
            monkeypatch.setattr(server_mod, "build_engine",
                                _doomed_build(seen, "device still wedged"))
            eng.runner.poison(RuntimeError("injected fatal CUDA error"))
            assert _wait_for(lambda: server.watchdog.state == "gave_up")
            assert server.watchdog.attempts == 2 and server.watchdog.recoveries_total == 0
            time.sleep(0.3)  # more ticks: the budget holds
            assert server.watchdog.attempts == 2 and len(seen) == 2
            status, body, hdrs = _predict(srv.port)
            assert status == 503 and "Retry-After" in hdrs and body["quarantined"] is True
            status, _, hdrs = _http(srv.port, SUBMIT, BODY)
            assert status == 503 and "Retry-After" in hdrs
            text = _prometheus(srv.port)
            assert "tpuserve_recovery_state 2" in text
            assert 'tpuserve_quarantined{model="bert_base"} 1' in text
            monkeypatch.setattr(server_mod, "build_engine", real_build)
            status, body, _ = _http(srv.port, "/admin/recover", {})
            assert status == 200, body
            assert body["recovery"]["state"] == "healthy"
            assert body["recovery"]["recoveries_total"] == 1
            assert _predict(srv.port)[0] == 200
    finally:
        eng.shutdown()


def test_gave_up_rearm_interacts_with_lifecycle_quarantine(monkeypatch):
    """The gave_up → /admin/recover re-arm seen through the residency
    surface: while the watchdog has given up, /admin/models/{name} reports
    the quarantine without corrupting residency; the manual re-arm records
    the swap as a cause="recovery" activation and lifts the quarantine
    everywhere (watchdog, resilience hub, residency snapshot)."""
    cfg = _cfg(watchdog_interval_s=0.05, recover_max_attempts=1, recover_backoff_s=0.01)
    with BackgroundServer(cfg, device="cpu") as srv:
        server = srv.server
        assert _predict(srv.port)[0] == 200
        before = server.lifecycle.activations_by_cause.get("bert_base", {}).get("recovery", 0)
        real_build, seen = server_mod.build_engine, []
        monkeypatch.setattr(server_mod, "build_engine", _doomed_build(seen, "device still wedged"))
        server.engine.runner.poison(RuntimeError("injected fatal CUDA error"))
        assert _wait_for(lambda: server.watchdog.state == "gave_up")
        model = _http(srv.port, "/admin/models/bert_base")[1]["model"]
        assert model["quarantined"] is True
        assert server.lifecycle.knows("bert_base")
        # The model is resident, so "activate" answers at once, and predicts
        # still 503: nothing reaches the poisoned engine past the quarantine.
        status, body, _ = _http(srv.port, "/admin/models/bert_base", {"action": "activate"})
        assert status == 200 and body["model"]["state"] == "active"
        status, body, _ = _predict(srv.port)
        assert status == 503 and body["quarantined"] is True
        monkeypatch.setattr(server_mod, "build_engine", real_build)

        status, body, _ = _http(srv.port, "/admin/recover", {})
        assert status == 200, body
        assert body["recovery"]["state"] == "healthy"
        model = _http(srv.port, "/admin/models/bert_base")[1]["model"]
        assert model["quarantined"] is False
        assert model["state"] == "active"
        assert model["activations_by_cause"].get("recovery", 0) == before + 1
        assert ('tpuserve_activations_total{cause="recovery",model="bert_base"}'
                in _prometheus(srv.port))
        assert _predict(srv.port)[0] == 200


def test_sticky_cuda_error_converges_to_gave_up(monkeypatch):
    """A sticky CUDA error (a device-side assert) leaves the context
    unusable, so every rebuild in the process fails: the watchdog must end at
    gave_up within its budget with /healthz at 503, never spin, and never
    rebuild on another device."""
    cfg = _cfg(watchdog_interval_s=0.05, recover_max_attempts=3, recover_backoff_s=0.01)
    eng = build_engine(cfg, device="cpu")
    sticky = "CUDA error: device-side assert triggered"
    try:
        with BackgroundServer(cfg, eng) as srv:
            server, seen = srv.server, []
            monkeypatch.setattr(server_mod, "build_engine", _doomed_build(seen, sticky))
            eng.runner.poison(RuntimeError(sticky))
            assert _predict(srv.port)[0] == 500
            assert _wait_for(lambda: server.watchdog.state == "gave_up")
            time.sleep(0.5)  # ten more ticks
            assert server.watchdog.attempts == 3 and len(seen) == 3
            assert seen == [eng.device] * 3
            assert server.engine is eng  # the old engine stays in place
            status, body, _ = _http(srv.port, "/healthz")
            assert status == 503 and body["recovery"]["state"] == "gave_up"
            assert not body["device_ok"] and body["quarantined"] == ["bert_base"]
    finally:
        eng.shutdown()


def test_submit_idempotency_key_concurrent_http(engine, faults):
    """Eight concurrent same-key submits collapse to one job; the body field
    twin dedupes to it too."""
    with BackgroundServer(_cfg(), engine) as srv:
        def submit(_):
            return _http(srv.port, SUBMIT, BODY, {"Idempotency-Key": "conc-1"})

        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(submit, range(8)))
        assert sorted(s for s, _, _ in results) == [200] * 7 + [202]
        ids = {b["job"]["id"] for _, b, _ in results}
        assert len(ids) == 1
        assert all(b.get("deduped") for s, b, _ in results if s == 200)
        status, body, _ = _http(srv.port, SUBMIT, {**BODY, "idempotency_key": "conc-1"})
        assert status == 200 and body["deduped"] and body["job"]["id"] in ids


def test_admin_faults_clear_rejects_unknown_fields(engine, faults):
    with BackgroundServer(_cfg(), engine) as srv:
        assert _http(srv.port, "/admin/faults", {"model": "bert_base", "fail_every_n": 2})[0] \
            == 200
        status, body, _ = _http(srv.port, "/admin/faults", {"clear": True, "modle": "x"})
        assert status == 400 and "unknown fault fields" in body["error"]
        assert faults.snapshot()["rules"]
        status, body, _ = _http(srv.port, "/admin/faults", {"clear": True})
        assert status == 200 and body["faults"]["rules"] == []


def test_job_backlog_full_429_carries_retry_after_and_depth(engine, faults):
    with BackgroundServer(_cfg(job_max_backlog=1), engine) as srv:
        slept = faults.snapshot()["injected"]["latency_ms"]
        faults.configure(model="bert_base", latency_ms=300)
        assert _http(srv.port, SUBMIT, BODY)[0] == 202  # picked up by the worker
        _lane_held(faults, slept)
        assert _http(srv.port, SUBMIT, BODY)[0] == 202  # fills the 1-deep backlog
        status, body, hdrs = _http(srv.port, SUBMIT, BODY)
        assert status == 429, body
        assert "Retry-After" in hdrs and body["backlog"] == 1 and body["max_backlog"] == 1


# -- drain with a stream, and SIGTERM ------------------------------------------

def _sse(port, model, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{model}:generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        events = [json.loads(line[6:]) for line in r if line.startswith(b"data: ")]
    return events


def test_drain_lets_an_inflight_stream_finish_whole():
    """A :generate stream in flight when the drain begins runs to its last
    event; meanwhile new work and /healthz answer 503."""
    gpt2 = {**GPT2, "extra": {**GPT2["extra"], "gen_slots": 2, "segment_tokens": 2,
                              "max_new_tokens": 8}}
    cfg = _cfg(gpt2, drain_timeout_s=10.0)
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            body = {"input_ids": [3, 4, 5], "max_new_tokens": 8}
            want = _sse(srv.port, "gpt2", body)[-1]["tokens"]
            # Slow segments (latency on the lane), so the drain overlaps.
            eng.runner.faults.configure(model="gpt2", latency_ms=100)
            with ThreadPoolExecutor(2) as ex:
                stream = ex.submit(_sse, srv.port, "gpt2", body)
                assert _wait_for(lambda: srv.server.schedulers["gpt2"].active, 10, 0.005)
                drain = ex.submit(_http, srv.port, "/admin/drain", {"timeout_s": 10})
                assert _wait_for(lambda: srv.server.draining, 10, 0.005)
                status, out, hdrs = _http(srv.port, "/v1/models/gpt2:predict", {"input_ids": [3]})
                assert status == 503 and out["draining"] is True and "Retry-After" in hdrs
                assert _http(srv.port, "/healthz")[0] == 503
                events = stream.result()
                assert drain.result()[1]["drained"] is True
            assert events[-1]["done"] is True and events[-1]["tokens"] == want
            assert [e["token"] for e in events[:-1]] == want
    finally:
        eng.shutdown()


def test_sigterm_drains_and_a_second_one_stops_at_once(engine, faults):
    with BackgroundServer(_cfg(drain_timeout_s=10.0), engine) as srv:
        slept = faults.snapshot()["injected"]["latency_ms"]
        faults.configure(model="bert_base", latency_ms=300)
        stop = srv.call(asyncio.Event)
        with ThreadPoolExecutor(1) as ex:
            slow = ex.submit(_predict, srv.port)
            _lane_held(faults, slept)
            srv.call(srv.server.on_sigterm, stop)
            assert srv.server.draining and not stop.is_set()
            assert slow.result()[0] == 200  # in-flight work finishes
        assert _wait_for(stop.is_set, 10)
        stop2 = srv.call(asyncio.Event)
        srv.call(srv.server.on_sigterm, stop2)  # draining already: at once
        assert stop2.is_set()
    with BackgroundServer(_cfg(), engine) as srv:  # no budget: at once
        stop = srv.call(asyncio.Event)
        srv.call(srv.server.on_sigterm, stop)
        assert stop.is_set() and not srv.server.draining


def test_concurrent_healthz_share_one_probe():
    """Concurrent /healthz calls during a wedge (a slow dispatch holding
    the lane) share one no-op on the dispatch thread and one timeout; a
    poisoned runner is dead with no dispatch at all.  (A fresh engine: no
    earlier verdict is cached.)"""
    with BackgroundServer(_cfg(dispatch_probe_timeout_s=0.3), device="cpu") as srv:
        runner = srv.server.engine.runner
        runner.faults.configure(model="bert_base", latency_ms=1500)
        with ThreadPoolExecutor(9) as ex:
            slow = ex.submit(_predict, srv.port)
            _lane_held(runner.faults)
            barrier = threading.Barrier(8)

            def hit(_):
                barrier.wait()
                return _http(srv.port, "/healthz")[0]

            assert list(ex.map(hit, range(8))) == [503] * 8
            assert runner.probe_dispatches == 1
            assert slow.result()[0] == 200
        runner.faults.clear()
        # The cached verdict lapses and the kept no-op has resolved.
        assert _wait_for(lambda: _http(srv.port, "/healthz")[0] == 200, 15)
        runner.poison(RuntimeError("wedged"))
        before = runner.probe_dispatches
        assert _http(srv.port, "/healthz")[0] == 503
        assert runner.probe_dispatches == before
        runner.poison(None)
        assert _wait_for(lambda: _http(srv.port, "/healthz")[0] == 200, 15)


def test_server_frees_the_engine_it_built_on_reload():
    """A server given no engine builds and owns one (as ``serve`` runs it):
    a reload shuts the old one down and drops it, and stopping the server
    shuts down the live one."""
    with BackgroundServer(_cfg(), device="cpu") as srv:
        first = srv.server.engine
        old_runner, old_ref = first.runner, weakref.ref(first)
        del first
        assert srv.server._owns_engine and srv.server.engine.device.type == "cpu"
        assert _http(srv.port, "/admin/reload", {})[0] == 200
        assert old_runner.closed
        gc.collect()
        assert old_ref() is None, "the replaced engine is still reachable"
        assert _predict(srv.port)[0] == 200
        live = srv.server.engine.runner
    assert live.closed


# -- the same script against both packages -----------------------------------

SCENARIO = [
    ("POST", PREDICT, BODY, {}),
    ("POST", "/admin/faults", {"model": "bert_base", "fail_every_n": 1, "count": 1,
                               "kind": "transient"}, {}),
    ("POST", PREDICT, BODY, {}),  # retried → 200
    ("POST", PREDICT, BODY, {"X-Deadline-Ms": "0"}),  # 504 at admission
    ("POST", PREDICT, BODY, {"X-Deadline-Ms": "0.01"}),  # hopeless → 429
    ("POST", "/admin/faults", {"model": "bert_base", "fail_every_n": 1, "count": 1,
                               "preprocess": True}, {}),
    ("POST", PREDICT, BODY, {}),  # 400
    ("POST", PREDICT, BODY, {}),
    ("POST", "/admin/faults", {"model": "bert_base", "fail_every_n": 1, "kind": "fatal"}, {}),
    ("POST", PREDICT, BODY, {}),
    ("POST", PREDICT, BODY, {}),  # the breaker trips here
    ("POST", PREDICT, BODY, {}),
    ("POST", PREDICT, BODY, {}),
    ("POST", "/admin/faults", {"clear": True, "modle": "x"}, {}),
    ("POST", "/admin/faults", {"clear": True}, {}),
    ("POST", SUBMIT, BODY, {}),  # the breaker covers :submit
    ("POST", "/admin/drain", {"timeout_s": 1}, {}),
    ("POST", PREDICT, BODY, {}),  # draining
    ("GET", "/healthz", None, {}),
]
SCENARIO_CFG = dict(retry_max_attempts=2, retry_base_ms=1.0, breaker_threshold=0.5,
                    breaker_min_samples=4, breaker_window=8, breaker_open_s=60.0)


def _counters(metrics):
    res = metrics["resilience"]["models"]["bert_base"]
    return {**{k: res[k] for k in ("deadline_exceeded", "shed", "retries", "retry_successes",
                                   "breaker_fast_fails")},
            "breaker": {k: res["breaker"][k] for k in ("state", "opens", "fatal_cause")},
            "injected": {k: metrics["faults"]["injected"][k] for k in ("dispatch", "preprocess")},
            "draining": metrics["resilience"]["draining"]}


def _jax_scenario(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
    from pytorch_zappa_serverless_tpu.config import ServeConfig as JServeConfig
    from pytorch_zappa_serverless_tpu.engine.loader import build_engine as jbuild
    from pytorch_zappa_serverless_tpu.serving.server import Server as JServer

    cfg = JServeConfig(compile_cache_dir=str(tmp_path), models=[JModelConfig(**MODEL)],
                       **SCENARIO_CFG)
    eng = jbuild(cfg)

    async def drive():
        client = TestClient(TestServer(JServer(cfg, engine=eng).app))
        await client.start_server()
        try:
            out = []
            for method, path, body, headers in SCENARIO:
                r = await client.request(method, path, json=body, headers=headers)
                out.append((r.status, "Retry-After" in r.headers))
            metrics = await (await client.get("/metrics")).json()
            return out, _counters(metrics)
        finally:
            await client.close()

    try:
        return asyncio.run(drive())
    finally:
        eng.shutdown()


def _port_scenario():
    cfg = _cfg(**SCENARIO_CFG)
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            out = []
            for method, path, body, headers in SCENARIO:
                status, _, hdrs = _http(srv.port, path, body, headers, method=method)
                out.append((status, "Retry-After" in hdrs))
            return out, _counters(_http(srv.port, "/metrics")[1])
    finally:
        eng.shutdown()


def test_scenario_matches_the_jax_server(tmp_path):
    port, ref = _port_scenario(), _jax_scenario(tmp_path)
    assert port == ref
    statuses = [s for s, _ in port[0]]
    assert statuses[2:5] == [200, 504, 429] and statuses[9:13] == [500, 500, 503, 503]
    assert statuses[-3:] == [200, 503, 503] and port[1]["breaker"]["state"] == "open"
