"""The fleet router of the port (``serving/fleet.py``) against the JAX
package's, on the CPU.

- **Pure parts, exact.**  Seeded replica states (``/healthz`` and
  ``/admin/models`` payloads drawn with numpy from a seed) and one fake
  clock go through both packages' ``Replica.poll_ok`` and the other outcome
  hooks, and both ``ReplicaRegistry.pick``; the pick sequences, snapshots,
  quarantine and breaker edges are equal.  So are ``FleetFaultInjector``'s
  snapshots and validation errors, and ``FleetMetrics``' Prometheus text for
  the same events (the same values observed, so the histogram lines too).
- **The whole router.**  Each case of the JAX package's
  ``tests/test_fleet.py`` (routing and trace, failover, the cold spill and
  its single-flight activation, the 500 failover, every shed path's
  Retry-After, idempotency and job affinity, quarantine and readmission,
  drain, membership, the fault admin, health, the scale actuator, the
  metrics lint, the mid-stream error event) runs as a script against both
  routers, each in front of fresh stdlib fake replicas
  (``tests/fleet_harness.py``).  The script holds the reference's
  assertions for both, and what it observes (statuses, bodies, Retry-After,
  replica headers, the failover counters, ``/admin/fleet``'s states) is
  equal; request and trace ids, URLs, ``last_error`` wording (aiohttp's
  exception names against the stdlib client's) and poll ages are left out.
"""

import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from fleet_harness import FakeReplica, RouterHarness
from pytorch_zappa_serverless_tpu import config as JC
from pytorch_zappa_serverless_tpu import faults as JF
from pytorch_zappa_serverless_tpu.serving import fleet as JFL
from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch import faults as PF
from pytorch_zappa_serverless_tpu_torch.serving import fleet as PFL

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("m", "full", "lite", "other")
STATES = ("active", "pinned", "draining_idle", "warming", "cold", "weird", None)


def _fcfg(mod, **kw):
    base = dict(poll_interval_s=0.0, failover_backoff_ms=0.0, connect_timeout_s=1.0,
                quarantine_after=2, breaker_threshold=0.5, breaker_min_samples=4)
    base.update(kw)
    return mod.FleetConfig(**base)


def test_fleet_config_fields_and_defaults_are_the_reference():
    import dataclasses

    jf = {f.name: f for f in dataclasses.fields(JC.FleetConfig)}
    pf = {f.name: f for f in dataclasses.fields(PC.FleetConfig)}
    assert list(jf) == list(pf)
    assert dataclasses.asdict(JC.FleetConfig()) == dataclasses.asdict(PC.FleetConfig())
    assert isinstance(PC.ServeConfig().fleet, PC.FleetConfig)


# -- pure parts: seeded replica states ----------------------------------------

def _payloads(rng):
    health = {"device_ok": bool(rng.random() > 0.15), "draining": bool(rng.random() < 0.1),
              "quarantined": [m for m in MODELS if rng.random() < 0.1],
              "forecast": {m: round(float(rng.uniform(0, 300)), 3)
                           for m in MODELS if rng.random() < 0.8}}
    if rng.random() < 0.3:
        health["slo"] = {"fast_alarms": ["m|predict"], "worst_fast_burn": float(rng.uniform(0, 30))}
    models = {}
    for m in MODELS:
        if rng.random() < 0.2:
            continue
        row = {"state": STATES[int(rng.integers(len(STATES)))], "pinned": bool(rng.random() < 0.1),
               "estimated_warm_ms": (None if rng.random() < 0.2
                                     else round(float(rng.uniform(10, 9000)), 1))}
        if m in ("full", "lite") and rng.random() < 0.7:
            row["family"] = "fam"
        if rng.random() < 0.3:
            row["adapters"] = {"t1": ("active", "attaching", "cold")[int(rng.integers(3))]}
        models[m] = row
    return health, {"models": models}


def _drive(mod, seed: int) -> list:
    """A seeded sequence of outcomes on a 4-replica registry; the trace of
    picks, states and snapshots after each step."""
    rng = np.random.default_rng(seed)
    now = [0.0]
    reg = mod.ReplicaRegistry(_fcfg(JC if mod is JFL else PC, quarantine_after=2,
                                    breaker_min_samples=3),
                              clock=lambda: now[0])
    for i in range(4):
        reg.add(f"http://r{i}")
    trace = []
    for step in range(60):
        r = reg.get(f"r{int(rng.integers(4))}")
        op = int(rng.integers(9))
        if op <= 2:
            r.poll_ok(*_payloads(rng))
        elif op == 3:
            r.poll_failed(ConnectionError("refused"))
        elif op == 4:
            r.note_failure("replica answered 500")
        elif op == 5:
            r.note_failure(TimeoutError("slow"), connect=True)
        elif op == 6:
            r.note_success()
        elif op == 7:
            r.forced_quarantine = bool(rng.random() < 0.3)
            r.draining = bool(rng.random() < 0.2)
            r.inflight = int(rng.integers(3))
        else:
            now[0] += float(rng.uniform(0, 4))
        model = (None, "m", "fam", "full", "other")[int(rng.integers(5))]
        adapter = "t1" if rng.random() < 0.4 else None
        exclude = {f"r{i}" for i in range(4) if rng.random() < 0.2}
        pick = reg.pick(model, exclude=exclude, adapter=adapter)
        snap = reg.snapshot()
        for s in snap.values():
            s.pop("url")
        trace.append({"step": step, "pick": pick.id if pick else None, "states": reg.states(),
                      "min_warm": reg.min_estimated_warm_ms(model), "snap": snap,
                      "routable": {x.id: x.routable(model) for x in reg.replicas.values()},
                      "ranks": {x.id: (x.model_rank(model), x.adapter_rank(model, adapter),
                                       x.forecast_ms(model or "m"),
                                       x.estimated_warm_ms(model))
                                for x in reg.replicas.values()}})
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_registry_picks_snapshots_and_edges_match_the_reference(seed):
    assert _drive(PFL, seed) == _drive(JFL, seed)


def _faults_script(mod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    inj = mod.FleetFaultInjector()
    out = []
    for _ in range(40):
        op = int(rng.integers(6))
        rid = ("r0", "r1", "*")[int(rng.integers(3))]
        try:
            if op == 0:
                kind = ("partition", "slow_replica", "replica_kill", "meteor")[int(rng.integers(4))]
                count = (None, 0, 1, 2)[int(rng.integers(4))]
                lat = float(rng.choice([-1.0, 0.0, 250.0]))
                out.append(("configure", inj.configure(replica=rid, kind=kind, latency_ms=lat,
                                                       count=count).public()))
            elif op in (1, 2):
                out.append(("check", inj.check(rid if rid != "*" else "r2", poll=op == 2)))
            elif op == 3:
                out.append(("kill", inj.should_kill(rid if rid != "*" else "r1")))
            elif op == 4 and rng.random() < 0.3:
                inj.clear(None if rng.random() < 0.5 else rid)
                out.append(("clear",))
            out.append(("snap", inj.snapshot()))
        except ValueError as e:
            out.append(("ValueError", str(e)))
        except ConnectionError as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fleet_fault_injector_matches_the_reference(seed):
    assert _faults_script(PF, seed) == _faults_script(JF, seed)


def _metrics_text(mod, fmod, seed: int) -> str:
    rng = np.random.default_rng(seed)
    reg = mod.ReplicaRegistry(_fcfg(JC if mod is JFL else PC))
    for i in range(3):
        r = reg.add(f"http://r{i}")
        r.poll_ok({"device_ok": True, "forecast": {"m": 1.0}}, {"models": {}})
        r.routed, r.failures, r.inflight = (int(x) for x in rng.integers(0, 9, 3))
    reg.get("r1").forced_quarantine = True
    reg.get("r1")._track_quarantine_edge()
    m = mod.FleetMetrics()
    for _ in range(30):
        m._bump(m.requests_total, ("predict", "submit", "generate")[int(rng.integers(3))])
        m._bump(m.failovers_total, ("connect", "timeout", "cold_start")[int(rng.integers(3))])
        m._bump(m.spills_total, "m")
        m._bump(m.shed_total, ("no_replica", "all_cold")[int(rng.integers(2))])
        m._bump(m.scale_events_total, ("out", "in")[int(rng.integers(2))])
        m.observe(("m", None)[int(rng.integers(2))], float(rng.uniform(0, 400)))
    m.retries_total, m.polls_total = 5, 7
    m._bump(m.poll_failures_total, "r2", 3)
    m._bump(m.activations_triggered, "m")
    m._bump(m.degraded_total, "fam")
    inj = fmod.FleetFaultInjector()
    inj.configure(replica="r0", kind="slow_replica", latency_ms=5.0)
    inj.check("r0")
    return m.render_prometheus(reg, inj)


def _check_metrics_mod():
    spec = importlib.util.spec_from_file_location("tpuserve_check_metrics",
                                                  ROOT / "tools" / "check_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(2))
def test_fleet_metrics_prometheus_text_matches_the_reference(seed):
    text = _metrics_text(PFL, PF, seed)
    assert text == _metrics_text(JFL, JF, seed)
    mod = _check_metrics_mod()
    assert mod.check(text, mod.load_manifest()) == []
    families = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
    manifest = {k for k in mod.load_manifest() if k.startswith("tpuserve_fleet_")}
    assert manifest <= families  # every fleet family of the manifest, exercised
    assert "tpuserve_autoscale_scale_events_total" in families


# -- the whole router: one script, both packages -------------------------------

_DROP = ("request_id", "trace_id", "last_error", "last_poll_s_ago", "url")


def _clean(obj):
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items() if k not in _DROP}
    if isinstance(obj, list):
        return [_clean(v) for v in obj]
    return obj


def _seen(rep, *headers) -> dict:
    try:
        body = _clean(rep.json())
    except ValueError:
        body = rep.body.decode()
    return {"status": rep.status, "body": body,
            **{h: rep.header(h) for h in headers}}


def _fleet_view(h) -> dict:
    snap = _clean(h.req("GET", "/admin/fleet").json())
    m = h.router.metrics
    return {"fleet": snap, "failovers": dict(m.failovers_total), "retries": m.retries_total,
            "spills": dict(m.spills_total), "shed": dict(m.shed_total),
            "requests": dict(m.requests_total)}


def _wait(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def scn_routes_and_propagates_trace(kind):
    a, b = FakeReplica(forecast_ms=50.0), FakeReplica(forecast_ms=1.0)
    with RouterHarness(kind, [a, b]) as h:
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        r = h.req("POST", "/v1/models/m:predict", b"{}", headers={"traceparent": tp})
        assert r.status == 200
        assert b.predicts == 1 and a.predicts == 0  # least forecast wait
        assert r.header("X-Fleet-Attempts") == "1"
        assert r.header("X-Fleet-Replica") == h.rid_of(b)
        assert r.header("X-Trace-Id") == "ab" * 16  # one trace id across the hop
        return {"r": _seen(r, "X-Fleet-Replica", "X-Fleet-Attempts", "X-Trace-Id"),
                "view": _fleet_view(h)}


def scn_fails_over_on_partition_within_one_retry(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        h.run(lambda: h.router.faults.configure(replica="*", kind="partition", count=1))
        r = h.req("POST", "/v1/models/m:predict", b"{}")
        assert r.status == 200 and r.header("X-Fleet-Attempts") == "2"
        assert a.predicts + b.predicts == 1
        assert h.router.metrics.failovers_total.get("connect") == 1
        assert h.router.metrics.retries_total == 1
        return {"r": _seen(r, "X-Fleet-Replica", "X-Fleet-Attempts"), "view": _fleet_view(h)}


def scn_spills_cold_start_and_triggers_background_activation(kind):
    cold = FakeReplica(mode="cold", state="active", warm_ms=9000.0, forecast_ms=0.0)
    warm = FakeReplica(forecast_ms=40.0)
    with RouterHarness(kind, [cold, warm]) as h:
        r = h.req("POST", "/v1/models/m:predict", b"{}")
        assert r.status == 200 and warm.predicts == 1
        assert r.header("X-Fleet-Attempts") == "2"
        assert h.router.metrics.spills_total == {"m": 1}
        assert _wait(lambda: cold.activations == ["m"])
        assert h.router.metrics.activations_triggered == {"m": 1}
        return {"r": _seen(r, "X-Fleet-Replica", "X-Fleet-Attempts"), "view": _fleet_view(h),
                "activations": cold.activations}


def scn_cold_spill_background_activation_is_single_flight(kind):
    # The activation stays open until the three spills have landed (no
    # sleep to outrun): the second and third find it in flight.
    gate = threading.Event()
    cold = FakeReplica(mode="cold", state="active", warm_ms=9000.0, forecast_ms=0.0,
                       activate_gate=gate)
    warm = FakeReplica(forecast_ms=40.0)
    with RouterHarness(kind, [cold, warm]) as h:
        for _ in range(3):
            assert h.req("POST", "/v1/models/m:predict", b"{}").status == 200
        gate.set()
        assert h.router.metrics.spills_total == {"m": 3}
        assert _wait(lambda: not h.router._activation_flight.running(f"{h.rid_of(cold)}:m"))
        assert cold.activations == ["m"]  # one request, not three
        assert h.router.metrics.activations_triggered == {"m": 1}
        assert h.router.metrics.activations_deduped == {"m": 2}
        j = h.req("GET", "/metrics").json()
        assert j["fleet"]["activations_deduped"] == {"m": 2}
        assert h.req("POST", "/v1/models/m:predict", b"{}").status == 200
        assert _wait(lambda: len(cold.activations) == 2)
        assert h.router.metrics.activations_triggered == {"m": 2}
        return {"deduped": j["fleet"]["activations_deduped"], "view": _fleet_view(h),
                "activations": cold.activations}


def scn_fails_over_replica_500_for_idempotent_predict(kind):
    sick, ok = FakeReplica(mode="error", forecast_ms=0.0), FakeReplica(forecast_ms=40.0)
    with RouterHarness(kind, [sick, ok]) as h:
        r = h.req("POST", "/v1/models/m:predict", b"{}")
        assert r.status == 200 and ok.predicts == 1
        assert h.router.metrics.failovers_total.get("error") == 1
        return {"r": _seen(r, "X-Fleet-Replica", "X-Fleet-Attempts"), "view": _fleet_view(h)}


def _shed(h, path="/v1/models/m:predict", **kw):
    r = h.req("POST", path, b"{}", **kw)
    body = r.json()
    assert r.status in (429, 503), body
    assert r.header("Retry-After") is not None, f"shed {body.get('fleet_shed')} lost Retry-After"
    assert int(r.header("Retry-After")) >= 1
    assert body.get("request_id") and body.get("trace_id")
    return r, body


def scn_shed_no_replica_carries_retry_after(kind):
    a = FakeReplica()
    with RouterHarness(kind, [a]) as h:
        h.router.registry.get(h.rid_of(a)).forced_quarantine = True
        r, body = _shed(h)
        assert body["fleet_shed"] == "no_replica"
        return {"r": _seen(r, "Retry-After"), "view": _fleet_view(h)}


def scn_shed_all_failed_carries_retry_after(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        h.run(lambda: h.router.faults.configure(replica="*", kind="partition"))
        r, body = _shed(h)
        assert body["fleet_shed"] == "all_failed" and len(body["replicas_tried"]) == 2
        return {"r": _seen(r, "Retry-After"), "view": _fleet_view(h)}


def scn_shed_all_overloaded_recomputes_fleet_minimum(kind):
    a = FakeReplica(mode="overloaded", retry_after="30", wait_ms=30000.0)
    b = FakeReplica(mode="overloaded", retry_after="7", wait_ms=7000.0)
    with RouterHarness(kind, [a, b]) as h:
        r, body = _shed(h)
        assert r.status == 429 and body["fleet_shed"] == "all_overloaded"
        assert body["estimated_wait_ms"] == 7000.0 and int(r.header("Retry-After")) == 7
        return {"r": _seen(r, "Retry-After"), "view": _fleet_view(h)}


def scn_shed_all_cold_recomputes_estimated_warm_ms(kind):
    a = FakeReplica(mode="cold", warm_ms=60000.0, retry_after="60")
    b = FakeReplica(mode="cold", warm_ms=4000.0, retry_after="4")
    with RouterHarness(kind, [a, b]) as h:
        r, body = _shed(h)
        assert r.status == 503 and body["fleet_shed"] == "all_cold"
        assert body["estimated_warm_ms"] == 4000.0 and int(r.header("Retry-After")) <= 4
        _wait(lambda: len(a.activations) + len(b.activations) == 2)
        return {"r": _seen(r, "Retry-After"), "view": _fleet_view(h)}


def scn_shed_submit_owner_recovering_carries_retry_after(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        r = h.req("POST", "/v1/models/m:submit", b"{}", headers={"Idempotency-Key": "k1"})
        assert r.status == 202
        h.router.registry.get(r.header("X-Fleet-Replica")).forced_quarantine = True
        r2 = h.req("POST", "/v1/models/m:submit", b"{}", headers={"Idempotency-Key": "k1"})
        assert r2.status == 503 and r2.json()["fleet_shed"] == "owner_recovering"
        assert r2.header("Retry-After") is not None
        return {"r": _seen(r, "X-Fleet-Replica"), "r2": _seen(r2, "Retry-After"),
                "view": _fleet_view(h)}


def scn_submit_cut_after_the_replica_read_it_is_shed_not_failed_over(kind):
    dying = FakeReplica(forecast_ms=0.0, submit="die")
    peer = FakeReplica(forecast_ms=40.0)
    with RouterHarness(kind, [dying, peer]) as h:
        # The poll left a keep-alive connection to each replica in the pool:
        # the submit goes out on it, the replica reads it, then dies.
        tid = "ef" * 16
        r = h.req("POST", "/v1/models/m:submit", b"{}",
                  headers={"Idempotency-Key": "kd", "traceparent": f"00-{tid}-{'12' * 8}-01"})
        assert r.status == 503 and r.json()["fleet_shed"] == "all_failed"
        assert dying.submits == ["kd"] and peer.submits == []  # it ran at most once
        assert "connect" not in h.router.metrics.failovers_total
        assert h.router.metrics.retries_total == 0
        points = [sp.name for sp in h.router.tracer.get(tid).spans]
        assert "ambiguous_submit" in points and "failover" not in points
        return {"r": _seen(r, "X-Fleet-Attempts"), "points": points,
                "failovers": dict(h.router.metrics.failovers_total)}


def scn_submit_key_affinity_dedupes_on_owner(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        r = h.req("POST", "/v1/models/m:submit", b"{}", headers={"Idempotency-Key": "kx"})
        assert r.status == 202
        jid = r.json()["job"]["id"]
        owner = a if a.submits else b
        other = b if owner is a else a
        h.router.registry.get(h.rid_of(other)).forecast = {"m": 0.0}
        h.router.registry.get(h.rid_of(owner)).forecast = {"m": 500.0}
        r2 = h.req("POST", "/v1/models/m:submit", b"{}", headers={"Idempotency-Key": "kx"})
        body2 = r2.json()
        assert r2.status == 200 and body2["deduped"] is True and body2["job"]["id"] == jid
        assert owner.submits == ["kx", "kx"] and not other.submits
        return {"owner": h.rid_of(owner), "r2": r2.status, "view": _fleet_view(h)}


def scn_submit_body_field_key_gets_affinity_too(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        r = h.req("POST", "/v1/models/m:submit", json_body={"b64": "x", "idempotency_key": "kb"})
        assert r.status == 202
        owner_rid = r.header("X-Fleet-Replica")
        assert h.router._key_affinity.get("kb") == owner_rid
        for rid, rec in h.router.registry.replicas.items():
            rec.forecast = {"m": 0.0 if rid != owner_rid else 500.0}
        r2 = h.req("POST", "/v1/models/m:submit", json_body={"b64": "x", "idempotency_key": "kb"})
        assert r2.header("X-Fleet-Replica") == owner_rid
        return {"owner": owner_rid, "r2": r2.status, "view": _fleet_view(h)}


def scn_job_poll_routes_home_and_falls_back_to_fanout(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        r = h.req("POST", "/v1/models/m:submit", b"{}", headers={"Idempotency-Key": "kj"})
        jid = r.json()["job"]["id"]
        r2 = h.req("GET", f"/v1/jobs/{jid}")
        assert r2.status == 200 and r2.json()["job"]["status"] == "done"
        h.run(h.router._job_affinity.clear)
        r3 = h.req("GET", f"/v1/jobs/{jid}")
        assert r3.status == 200
        r4 = h.req("GET", "/v1/jobs/nope")
        assert r4.status == 404
        return {"r2": _seen(r2, "X-Fleet-Replica"), "r3": _seen(r3, "X-Fleet-Replica"),
                "r4": _seen(r4)}


def scn_job_poll_unreachable_owner_is_503_not_404(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        r = h.req("POST", "/v1/models/m:submit", b"{}", headers={"Idempotency-Key": "kz"})
        jid = r.json()["job"]["id"]
        owner_rid = r.header("X-Fleet-Replica")
        h.run(lambda: h.router.faults.configure(replica=owner_rid, kind="partition"))
        for f in (a, b):
            f.jobs.clear()
        r2 = h.req("GET", f"/v1/jobs/{jid}")
        assert r2.status == 503 and r2.json()["fleet_shed"] == "owner_recovering"
        assert r2.header("Retry-After") is not None
        return {"r2": _seen(r2, "Retry-After"), "view": _fleet_view(h)}


def scn_poll_quarantines_partitioned_replica_and_readmits(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        rid = h.rid_of(a)
        h.run(lambda: h.router.faults.configure(replica=rid, kind="partition"))
        h.poll()
        h.poll()
        rec = h.router.registry.get(rid)
        assert rec.state == "quarantined"
        r = h.req("POST", "/v1/models/m:predict", b"{}")
        assert r.status == 200 and r.header("X-Fleet-Attempts") == "1"
        assert r.header("X-Fleet-Replica") == h.rid_of(b)
        h.run(h.router.faults.clear)
        h.poll()
        assert rec.state == "healthy" and rec.readmits >= 1
        snap = h.req("GET", "/admin/fleet").json()
        assert snap["replicas"][rid]["quarantines"] >= 1
        return {"r": _seen(r, "X-Fleet-Replica", "X-Fleet-Attempts"), "view": _fleet_view(h)}


def scn_drain_action_stops_routing_and_undrain_restores(kind):
    a, b = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a, b]) as h:
        rid_a = h.rid_of(a)
        r = h.req("POST", "/admin/fleet", json_body={"action": "drain", "replica": rid_a,
                                                     "timeout_s": 1.0})
        assert r.status == 200 and a.drains == 1
        for _ in range(3):
            rr = h.req("POST", "/v1/models/m:predict", b"{}")
            assert rr.status == 200 and rr.header("X-Fleet-Replica") == h.rid_of(b)
        assert a.predicts == 0
        r2 = h.req("POST", "/admin/fleet", json_body={"action": "undrain", "replica": rid_a})
        assert r2.status == 200 and h.router.registry.get(rid_a).routable()
        return {"r": _seen(r), "r2": _seen(r2), "view": _fleet_view(h)}


def scn_register_deregister_and_unknown_replica_404(kind):
    a, extra = FakeReplica(), FakeReplica()
    with RouterHarness(kind, [a]) as h:
        r = h.req("POST", "/admin/fleet", json_body={"action": "register", "url": extra.url})
        body = r.json()
        assert r.status == 200 and len(body["fleet"]) == 2
        rid = body["replica"]
        r2 = h.req("POST", "/admin/fleet", json_body={"action": "deregister", "replica": rid})
        r3 = h.req("POST", "/admin/fleet", json_body={"action": "drain", "replica": "bogus"})
        r4 = h.req("POST", "/admin/fleet", json_body={"action": "explode",
                                                      "replica": h.rid_of(a)})
        r5 = h.req("POST", "/admin/fleet", b"[1]")
        assert (r2.status, r3.status, r4.status, r5.status) == (200, 404, 400, 400)
        return {k: _seen(v) for k, v in (("r", r), ("r2", r2), ("r3", r3), ("r4", r4),
                                         ("r5", r5))}


def scn_fleet_faults_admin_validates_and_clears(kind):
    a = FakeReplica()
    with RouterHarness(kind, [a]) as h:
        out = []
        for body in ({"kind": "partition", "replica": "r0", "bogus": 1},
                     {"kind": "partition", "replica": "r0"},
                     {"clear": True, "modle": "x"},
                     {"kind": "meteor"}, {"kind": "slow_replica", "latency_ms": -1},
                     {"kind": "partition", "count": 0}):
            out.append(_seen(h.req("POST", "/admin/fleet/faults", json_body=body)))
        assert [o["status"] for o in out] == [400, 200, 400, 400, 400, 400]
        assert h.router.faults.snapshot()["rules"]
        r = h.req("POST", "/admin/fleet/faults", json_body={"clear": True})
        assert r.status == 200 and h.router.faults.snapshot()["rules"] == []
        out.append(_seen(r))
        out.append(_seen(h.req("GET", "/admin/fleet/faults")))
        return {"out": out}


def scn_router_healthz_flips_with_no_routable_replicas(kind):
    a = FakeReplica()
    with RouterHarness(kind, [a]) as h:
        r = h.req("GET", "/healthz")
        assert r.status == 200 and r.json()["fleet_ok"]
        h.router.registry.get(h.rid_of(a)).forced_quarantine = True
        r2 = h.req("GET", "/healthz")
        assert r2.status == 503 and not r2.json()["fleet_ok"]
        root = h.req("GET", "/").json()
        root.pop("framework")
        return {"r": _seen(r), "r2": _seen(r2), "root": root}


def scn_fleet_scale_actuator_out_in_auto_and_floor(kind):
    busy, spare = FakeReplica(forecast_ms=900.0), FakeReplica(forecast_ms=1.0)
    spawned = []

    def spawn():
        spawned.append(spare.url)
        return spare.url

    with RouterHarness(kind, [busy], router_kw={"spawn_hook": spawn}) as h:
        g = h.req("GET", "/admin/fleet/scale").json()
        assert g["current"] == 1 and g["desired"] == 2
        assert g["fleet_wait_ms"] == 900.0 and g["can_spawn"]
        r = h.req("POST", "/admin/fleet/scale", json_body={"action": "auto"})
        j = r.json()
        assert r.status == 200 and j["applied"][0]["direction"] == "out" and spawned
        assert h.router.metrics.scale_events_total == {"out": 1}
        h.poll()
        rp = h.req("POST", "/v1/models/m:predict", b"{}")
        assert rp.status == 200 and spare.predicts == 1
        r2 = h.req("POST", "/admin/fleet/scale", json_body={"action": "in"})
        assert r2.status == 200 and r2.json()["applied"][0]["direction"] == "in"
        assert len(h.router.registry.replicas) == 1
        assert h.router.metrics.scale_events_total == {"out": 1, "in": 1}
        r3 = h.req("POST", "/admin/fleet/scale", json_body={"action": "in"})
        assert r3.status == 503 and "floor" in r3.json()["applied"][0]["error"]
        r4 = h.req("POST", "/admin/fleet/scale", json_body={"action": "nope"})
        r5 = h.req("POST", "/admin/fleet/scale", json_body={"action": "set", "count": 0})
        assert (r4.status, r5.status) == (400, 400)
        text = h.req("GET", "/metrics?format=prometheus").body.decode()
        assert 'tpuserve_autoscale_scale_events_total{direction="out"} 1' in text
        mod = _check_metrics_mod()
        assert mod.check(text, mod.load_manifest()) == []
        return {"g": g, "j": _clean(j), **{k: _seen(v) for k, v in
                                           (("r2", r2), ("r3", r3), ("r4", r4), ("r5", r5))}}


def scn_desired_replicas_no_spawn_hook_errors_cleanly(kind):
    a = FakeReplica(forecast_ms=900.0)
    with RouterHarness(kind, [a]) as h:
        r = h.req("POST", "/admin/fleet/scale", json_body={"action": "out"})
        assert r.status == 503 and "spawn hook" in r.json()["applied"][0]["error"]
        assert h.router.metrics.scale_events_total == {}
        return {"r": _seen(r)}


def scn_fleet_metrics_exposition_matches_manifest(kind):
    cold, warm = FakeReplica(mode="cold"), FakeReplica(forecast_ms=40.0)
    with RouterHarness(kind, [cold, warm]) as h:
        h.req("POST", "/v1/models/m:predict", b"{}")
        h.req("POST", "/v1/models/m:submit", b"{}", headers={"Idempotency-Key": "k"})
        h.run(lambda: h.router.faults.configure(replica="*", kind="partition"))
        h.req("POST", "/v1/models/m:predict", b"{}")
        h.run(h.router.faults.clear)
        _wait(lambda: not h.router._activation_flight.running(f"{h.rid_of(cold)}:m"))
        text = h.req("GET", "/metrics?format=prometheus").body.decode()
        for fam in ("tpuserve_fleet_replica_state", "tpuserve_fleet_failovers_total",
                    "tpuserve_fleet_router_ms_bucket"):
            assert fam in text
        mod = _check_metrics_mod()
        assert mod.check(text, mod.load_manifest()) == []
        j = h.req("GET", "/metrics").json()
        assert j["fleet"]["spills"] == {"m": 1}
        # The router's own time is not compared; the families and every
        # counter sample are.
        lines = sorted(ln for ln in text.splitlines() if "router_ms" not in ln)
        fleet = _clean(j["fleet"])
        fleet.pop("router_ms")
        return {"lines": lines, "json": fleet}


def scn_generate_midstream_death_emits_structured_error_event(kind):
    a = FakeReplica(forecast_ms=2000.0, stream="die")
    with RouterHarness(kind, [a]) as h:
        r = h.req("POST", "/v1/models/m:generate", json_body={"input_ids": [1, 2, 3]})
        assert r.status == 200
        assert r.header("Content-Type").startswith("text/event-stream")
        events = [json.loads(line[6:]) for line in r.body.split(b"\n\n")
                  if line.startswith(b"data: ")]
        assert [ev.get("token") for ev in events[:2]] == [7, 9]
        term = events[-1]
        assert term.get("midstream") is True
        assert "error" in term and term["request_id"] and term["trace_id"]
        assert term["retry_after_s"] >= 1.0
        assert h.router.metrics.failovers_total.get("midstream", 0) == 1
        term = {k: v for k, v in term.items() if k not in ("error", "request_id", "trace_id")}
        return {"tokens": events[:2], "term": term, "view": _fleet_view(h)}


def scn_generate_streams_through_and_fails_over_before_the_first_byte(kind):
    full, ok = FakeReplica(mode="overloaded", retry_after="2"), FakeReplica(forecast_ms=9.0)
    with RouterHarness(kind, [full, ok]) as h:
        r = h.req("POST", "/v1/models/m:generate", json_body={"input_ids": [1, 2]})
        assert r.status == 200 and r.header("X-Fleet-Replica") == h.rid_of(ok)
        events = [json.loads(line[6:]) for line in r.body.split(b"\n\n")
                  if line.startswith(b"data: ")]
        assert [e["token"] for e in events[:-1]] == [7, 9, 11] and events[-1]["done"]
        assert full.generates == 1 and ok.generates == 1
        ok.mode = "overloaded"
        r2, body = _shed(h, "/v1/models/m:generate")
        assert body["fleet_shed"] == "all_overloaded"
        return {"events": events, "r2": _seen(r2, "Retry-After"), "view": _fleet_view(h)}


# -- the router cases of the JAX package's tests/test_slo.py -------------------

def _slo_fake(outcomes, **kw):
    """A fake whose /healthz, /metrics and SLO snapshot come from a real
    SLO hub of the port fed ``outcomes`` ((status, ms) of predicts on m)."""
    from pytorch_zappa_serverless_tpu_torch.serving.slo import SLOHub

    hub = SLOHub(PC.ServeConfig(slo={"m": {"latency_objective_ms": 100.0,
                                           "availability_target": 0.99}}))
    for status, ms in outcomes:
        hub.observe("m", "predict", status, ms)
    return FakeReplica(slo=hub, forecast_ms=1.0, warm_ms=500.0,
                       metrics_models={"m": {"requests": 2, "errors": 0,
                                             "req_per_s_lifetime": 1.0}}, **kw)


def scn_router_admin_slo_aggregates_two_replicas(kind):
    a = _slo_fake([(200, 1.0)] * 4)
    b = _slo_fake([(200, 1.0)] + [(503, 0.0)] * 5)
    with RouterHarness(kind, [a, b]) as h:
        r = h.req("GET", "/admin/slo")
        assert r.status == 200
        snap = r.json()
        assert snap["replicas_merged"] == 2 and snap["fleet"] is True
        lane = snap["models"]["m"]["predict"]
        assert lane["outcomes"]["good"] == 5 and lane["outcomes"]["shed"] == 5
        assert lane["goodput_ratio"] == 0.5
        assert lane["windows"]["fast"]["burn_rate"] > 14.0
        assert lane["windows"]["fast"]["alarm"] is True
        assert len(snap["replicas"]) == 2
        assert any(rep["slo"]["fast_alarms"] for rep in snap["replicas"].values())
        return {"snap": _clean(snap)}


def scn_router_healthz_and_fleet_carry_burn_summary(kind):
    a, b = _slo_fake([(200, 1.0)] * 3), _slo_fake([(503, 0.0)] * 3)
    with RouterHarness(kind, [a, b]) as h:
        r = h.req("GET", "/healthz")
        assert r.status == 200
        body = r.json()
        assert body["slo"]["worst_fast_burn"] > 14.0
        assert any(x.endswith("m|predict") for x in body["slo"]["fast_alarms"])
        fleet = h.req("GET", "/admin/fleet").json()
        assert fleet["slo"]["fast_alarms"] == body["slo"]["fast_alarms"]
        assert fleet["quarantined"] == {"replicas": [], "models": {}}
        roll = h.req("GET", "/metrics").json()["fleet"]["rollup"]
        assert roll["replicas_merged"] == 2
        assert roll["models"]["m"]["requests"] == 4
        assert roll["slo"]["models"]["m"]["predict"]["requests"] == 6
        return {"health": _clean(body), "roll": _clean(roll)}


def scn_router_shed_under_budget_exhaustion_keeps_fleet_min_retry(kind):
    a = _slo_fake([(429, 0.0)] * 4, mode="overloaded", retry_after="7", wait_ms=7000.0)
    b = _slo_fake([(429, 0.0)] * 4, mode="overloaded", retry_after="3", wait_ms=3000.0)
    with RouterHarness(kind, [a, b]) as h:
        r = h.req("POST", "/v1/models/m:predict", b"{}")
        assert r.status == 429
        body = r.json()
        assert body["fleet_shed"] == "all_overloaded"
        assert int(r.header("Retry-After")) == 3 and len(body["replicas_tried"]) == 2
        assert h.req("GET", "/healthz").json()["slo"]["worst_fast_burn"] > 14.0
        return {"r": _seen(r, "Retry-After")}


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("scn_")]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[4:])
def test_router_matches_the_reference_on_a_fake_fleet(scenario):
    """The same request script against the JAX router and the port's, each
    in front of fresh fake replicas: both pass the reference's assertions,
    and what they answer is equal."""
    assert scenario("port") == scenario("jax")


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_client_retries_a_cut_pooled_connection_only_for_an_idempotent_method(method):
    """A server reads the second request on a keep-alive connection and
    resets it unanswered.  A GET is sent once more on a fresh connection and
    answered; a POST, which the server may have acted on, raises
    ``ServerDisconnected`` and is not sent again (aiohttp's rule)."""
    import asyncio
    import socket
    import struct

    from pytorch_zappa_serverless_tpu_torch.serving import httpclient as HC

    seen: list[str] = []

    async def serve(reader, writer):
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                while (await reader.readline()) not in (b"\r\n", b""):
                    pass
                seen.append(line.split()[0].decode())
                if len(seen) == 2:  # the second request: cut without an answer
                    writer.get_extra_info("socket").setsockopt(
                        socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
                    writer.transport.abort()
                    return
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
                await writer.drain()
        finally:
            writer.close()

    async def go():
        server = await asyncio.start_server(serve, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/x"
        pool = HC.ClientPool()
        timeout = HC.ClientTimeout(total=5.0, connect=1.0)
        try:
            async with await pool.request("GET", url, timeout=timeout) as r:
                assert await r.read() == b"ok"  # its connection goes back to the pool
            try:
                async with await pool.request(method, url, data=b"", timeout=timeout) as r:
                    return r.status, await r.read()
            except HC.ServerDisconnected as e:
                assert not isinstance(e, HC.ConnectFailed)
                return "disconnected"
        finally:
            await pool.close()
            server.close()
            await server.wait_closed()

    out = asyncio.run(asyncio.wait_for(go(), 20.0))
    if method == "GET":
        assert out == (200, b"ok") and seen == ["GET", "GET", "GET"]
    else:
        assert out == "disconnected" and seen == ["GET", "POST"]
