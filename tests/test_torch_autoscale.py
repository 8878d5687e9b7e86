"""The predictive autoscaler of the port (``serving/autoscale.py``, the
reapers' keep-warm hooks and the ``demand`` fault) against the JAX
package's, on the CPU.

- Pure logic, exact: the same seeded arrival journals on the same injected
  clock go through both packages' ``DemandModel`` (gap quantiles,
  forecasts, the next arrival) and ``AutoscalePlane`` (``plan`` action
  lists, keep-warm windows, snapshots, and ``tick_once`` with fake
  actuators through the misprediction ladder under ``starve``), and the
  same replica forecasts through ``desired_replicas``; every result is
  equal (floats to 1e-9 relative).
- Units of the port: single-flight pre-warm with its draft rung, the
  adapter pre-warm, the ``spike`` fault hiding arrivals, the lifecycle
  reaper honouring a learned window and falling back to the timer, the
  adapter reaper's window lookup.
- HTTP, the scenario of the JAX package's ``tests/test_autoscale.py``
  through the port's ``BackgroundServer`` with a tiny seeded GPT-2 and a
  lazy ``ghost`` deploy of it: demand on ``/admin/autoscale`` and the
  Prometheus families; ``starve`` chaos walks the plane to reactive with
  no request lost and at most one pre-warm activation of the ghost; the
  plane recovers after its hold; the ``autoscale`` table renders.  The
  plane runs on an injected clock and is ticked by the test.

No sleeps past a loop turn; every wait is bounded.
"""

import asyncio
import http.client
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu import config as JC
from pytorch_zappa_serverless_tpu import faults as JF
from pytorch_zappa_serverless_tpu.serving import autoscale as JA
from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch import faults as PF
from pytorch_zappa_serverless_tpu_torch.serving import autoscale as PA
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

WAIT_S = 60
ARCH = {"vocab_size": 512, "d_model": 128, "layers": 2, "heads": 2, "ffn_dim": 256,
        "max_positions": 64, "eos_id": 511}


def same(a, b, path="") -> None:
    """Equal structures; floats to 1e-9 relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0), (path, a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


class FakeClock:
    def __init__(self, now: float = 0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float):
        self.now += s


def _planes(**cfg_kw):
    cp, cj = FakeClock(), FakeClock()
    return (PA.AutoscalePlane(PC.ServeConfig(**cfg_kw), clock=cp), cp,
            JA.AutoscalePlane(JC.ServeConfig(**cfg_kw), clock=cj), cj)


# ---------------------------------------------------------------------------
# Pure logic against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_demand_model_quantiles_and_forecasts_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    cp, cj = FakeClock(), FakeClock()
    got = PA.DemandModel(clock=cp, fast_s=10.0, slow_s=100.0)
    want = JA.DemandModel(clock=cj, fast_s=10.0, slow_s=100.0)
    base = float(rng.choice([0.05, 0.3, 1.0, 4.0, 40.0]))
    for i in range(150):
        gap = float(rng.exponential(base)) if rng.random() < 0.9 else float(rng.uniform(0, 4000))
        cp.advance(gap)
        cj.advance(gap)
        got.note_arrival()
        want.note_arrival()
        if i % 10 == 9:
            for q in (0.0, 0.1, 0.5, 0.9, 0.95, 1.0):
                assert got.gap_quantile_s(q) == want.gap_quantile_s(q)
            assert got.forecast_rps() == want.forecast_rps()
            for ahead in (0.0, 0.2, 3.0):
                assert (got.next_expected_in_s(cp.now + ahead)
                        == want.next_expected_in_s(cj.now + ahead))
            same(got.snapshot(cp.now), want.snapshot(cj.now))
    assert got.gap_counts == want.gap_counts
    assert PA.GAP_BUCKETS_S == JA.GAP_BUCKETS_S


@pytest.mark.parametrize("seed", range(5))
def test_plan_matches_the_reference_on_the_same_journal(seed):
    """Seeded journals over keys and tenants, seeded residency and
    estimates, and a budget that comes and goes: the same actions, windows
    and snapshots at every checkpoint."""
    rng = np.random.default_rng(seed)
    kw = dict(autoscale_min_history=int(rng.integers(2, 6)),
              prewarm_margin_s=float(rng.choice([0.2, 1.0, 2.0])),
              keepwarm_min_s=0.5, keepwarm_max_s=120.0, keepwarm_quantile=0.9,
              hbm_budget_bytes=1000)
    pp, cp, jp, cj = _planes(**kw)
    keys = [("m", None), ("n", None), ("b", "t1"), ("b", "t2")]
    periods = {k: float(rng.choice([0.5, 1.0, 2.5, 7.0])) for k in keys}
    states = {}
    est = {f"{m}:{a}" if a else m: float(rng.uniform(50, 3000)) for m, a in keys}
    over = {"v": False}
    for plane in (pp, jp):
        plane.bind(residency_fn=lambda k: states.get(k, "cold"),
                   estimate_warm_ms_fn=est.get,
                   resident_bytes_fn=lambda: 2000 if over["v"] else 0)
    for i in range(200):
        step = float(rng.uniform(0.05, 1.5))
        cp.advance(step)
        cj.advance(step)
        for model, adapter in keys:
            k = f"{model}:{adapter}" if adapter else model
            if rng.random() < step / periods[(model, adapter)]:
                pp.note_arrival(model, adapter)
                jp.note_arrival(model, adapter)
            if rng.random() < 0.05:
                states[k] = ["active", "cold", "warming", "attaching", None][
                    int(rng.integers(0, 5))]
        over["v"] = bool(rng.random() < 0.1)
        a, b = pp.plan(cp.now), jp.plan(cj.now)
        assert a == b, i
        for model, adapter in keys:
            k = f"{model}:{adapter}" if adapter else model
            assert pp.keepwarm_window_s(k) == jp.keepwarm_window_s(k)
    assert pp.prewarm_shed_budget == jp.prewarm_shed_budget
    same(pp.snapshot(), jp.snapshot())


def test_ticks_through_the_misprediction_ladder_match_the_reference():
    """``tick_once`` with fake actuators and a ``starve`` rule on a ghost,
    on the same journal and clock: the same activations in the same order,
    the same counters, the degradation and the recovery."""
    async def drive(mod, fmod, cfg_mod):
        clock = FakeClock()
        plane = mod.AutoscalePlane(cfg_mod.ServeConfig(
            autoscale_min_history=4, autoscale_mispredict_limit=3,
            autoscale_reactive_hold_s=30.0, prewarm_margin_s=0.5), clock=clock)
        inj = fmod.FaultInjector()
        inj.configure(model="ghost", kind="demand", mode="starve", fail_every_n=1)
        calls = []

        async def activate(name, cause):
            calls.append((name, cause, clock.now))

        plane.bind(activate_fn=activate, faults=inj, model_names=["ghost", "real"],
                   draft_of=lambda m: "real_int8" if m == "real" else None,
                   residency_fn=lambda k: "cold", estimate_warm_ms_fn=lambda k: 100.0,
                   resident_bytes_fn=lambda: 0)
        trail = []
        for i in range(40):
            clock.advance(0.4)
            plane.note_arrival("real")
            clock.advance(0.6)  # the next arrival is due within the lead
            plane.tick_once(clock.now)
            for _ in range(3):
                await asyncio.sleep(0)
            if i % 3 == 0:
                clock.advance(4.0)
            trail.append((plane.degraded(clock.now), plane.mispredict_streak,
                          plane.prewarm_hits, plane.prewarm_misses, plane.degradations,
                          plane.keepwarm_window_s("real")))
        snap = plane.snapshot()
        snap.pop("in_flight")
        return calls, trail, snap

    got = asyncio.run(drive(PA, PF, PC))
    want = asyncio.run(drive(JA, JF, JC))
    same(list(got), list(want))
    calls, trail, snap = got
    assert ("ghost", "prewarm", calls[0][2]) == calls[0]
    assert any(t[0] for t in trail) and snap["counters"]["degradations"] >= 1
    assert any(c[:2] == ("real_int8", "prewarm_draft") for c in calls)


@pytest.mark.parametrize("seed", range(4))
def test_desired_replicas_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        forecasts = [{f"m{j}": float(rng.uniform(0, 1500))
                      for j in range(int(rng.integers(0, 3)))}
                     for _ in range(int(rng.integers(0, 5)))]
        current = int(rng.integers(0, 9))
        kw = dict(target_wait_ms=float(rng.uniform(50, 800)),
                  min_replicas=int(rng.integers(0, 3)), max_replicas=int(rng.integers(1, 8)),
                  scale_in_factor=float(rng.choice([0.1, 0.25, 0.5])))
        assert (PA.desired_replicas(forecasts, current, **kw)
                == JA.desired_replicas(forecasts, current, **kw))
        assert PA.fleet_wait_ms(forecasts) == JA.fleet_wait_ms(forecasts)


# ---------------------------------------------------------------------------
# Units of the port
# ---------------------------------------------------------------------------

def _feed(plane, clock, key="m", n=10, gap=1.0):
    base, _, adapter = key.partition(":")
    for _ in range(n):
        clock.advance(gap)
        plane.note_arrival(base, adapter=adapter or None)


def test_prewarm_is_single_flight_and_warms_the_draft_rung():
    async def go():
        clock = FakeClock()
        plane = PA.AutoscalePlane(PC.ServeConfig(autoscale_min_history=4,
                                                 prewarm_margin_s=2.0), clock=clock)
        release = asyncio.Event()
        calls = []

        async def activate(name, cause):
            calls.append((name, cause))
            if name == "m":
                await release.wait()

        plane.bind(activate_fn=activate, draft_of=lambda m: "m_int8" if m == "m" else None,
                   residency_fn=lambda k: "cold", estimate_warm_ms_fn=lambda k: 100.0,
                   resident_bytes_fn=lambda: 0)
        _feed(plane, clock)
        plane.tick_once(clock.now)
        plane.tick_once(clock.now)
        await asyncio.sleep(0)
        assert calls == [("m", "prewarm")]
        assert plane.snapshot()["counters"]["prewarms"] == 1
        release.set()
        for _ in range(5):
            await asyncio.sleep(0)
        assert calls == [("m", "prewarm"), ("m_int8", "prewarm_draft")]
        plane.note_arrival("m")
        assert plane.prewarm_hits == 1 and plane.mispredict_streak == 0

        attached = []

        async def attach(base, adapter, cause):
            attached.append((base, adapter, cause))

        plane.bind(attach_fn=attach, residency_fn=lambda k: "cold",
                   estimate_warm_ms_fn=lambda k: 50.0, resident_bytes_fn=lambda: 0)
        _feed(plane, clock, "b:t1")
        plane.tick_once(clock.now)
        for _ in range(3):
            await asyncio.sleep(0)
        assert attached == [("b", "t1", "prewarm")]

    asyncio.run(go())


def test_spike_hides_a_burst_from_the_forecaster():
    clock = FakeClock()
    plane = PA.AutoscalePlane(PC.ServeConfig(autoscale_min_history=2), clock=clock)
    inj = PF.FaultInjector()
    inj.configure(model="m", kind="demand", mode="spike", fail_every_n=1)
    plane.bind(faults=inj, model_names=["m"])
    for _ in range(6):
        clock.advance(0.1)
        plane.note_arrival("m")
    assert "m" not in plane._models
    assert inj.snapshot()["injected"]["demand"] == 6
    plane.note_arrival("m", adapter="t1")  # tenant keys never consult the rule
    assert "m:t1" in plane._models


def test_lifecycle_reaper_honours_the_learned_window():
    from pytorch_zappa_serverless_tpu_torch.serving.lifecycle import (ACTIVE, COLD,
                                                                      LifecycleManager)

    cfg = PC.ServeConfig(idle_unload_s=1.0, host_idle_drop_s=100.0,
                         models=[PC.ModelConfig(name="m")])
    runner = SimpleNamespace(faults=PF.FaultInjector(), _r={})
    runner.track_model = lambda n, b: runner._r.__setitem__(n, int(b))
    runner.untrack_model = lambda n: runner._r.pop(n, None)
    runner.resident_bytes = lambda: dict(runner._r)

    async def run_fn(fn, *args, model=None):
        return fn(*args)

    runner.run_fn = run_fn
    engine = SimpleNamespace(models={}, runner=runner, build_seconds={},
                             clock=SimpleNamespace(per_model=lambda: {}),
                             device=SimpleNamespace(type="cpu"))
    engine.attach = lambda n, cm, nbytes=None: (engine.models.__setitem__(n, cm),
                                                runner.track_model(n, 100))
    engine.detach = lambda n: (runner.untrack_model(n), engine.models.pop(n, None))[1]
    engine.model = lambda n: engine.models[n]
    server = SimpleNamespace(cfg=cfg, engine=engine, batchers={}, schedulers={}, jobs=None,
                             resilience=SimpleNamespace(quarantined=set()),
                             _start_model_lanes=lambda n: None)

    async def stop_lanes(name):
        return None

    server._stop_model_lanes = stop_lanes

    class CM:
        def param_nbytes(self):
            return 100

        def resident_nbytes(self):
            return 100

        def host_offload(self):
            pass

        def device_restore(self):
            pass

        def release(self):
            pass

    def build(name, from_tier, host_cm):
        return host_cm if host_cm is not None else CM()

    async def go():
        clock = FakeClock()
        mgr = LifecycleManager(server, cfg, build_fn=build, clock=clock)
        await mgr.ensure_active("m")
        windows = {"m": 10.0}
        mgr.keepwarm_fn = windows.get
        assert mgr.idle_window_s("m") == 10.0
        clock.advance(2.0)  # past the fixed timer, inside the learned window
        await mgr.tick_once()
        assert mgr.state_of("m") == ACTIVE
        clock.advance(9.0)  # past the learned window
        await mgr.tick_once()
        assert mgr.state_of("m") == COLD
        await mgr.ensure_active("m")
        windows.clear()  # no opinion: the fixed timer rules again
        assert mgr.idle_window_s("m") == 1.0
        clock.advance(1.5)
        await mgr.tick_once()
        assert mgr.state_of("m") == COLD

    asyncio.run(go())


def test_adapter_reaper_window_lookup():
    """The learned window replaces the fixed timer; thin history falls back
    to it; with no timer (never), a learned window creates none (the
    lifecycle's reaper has the same gate)."""
    from pytorch_zappa_serverless_tpu_torch.serving.adapters import (AdapterManager,
                                                                     AdapterResidency)

    mgr = AdapterManager(SimpleNamespace(engine=None),
                         PC.ServeConfig(adapter_idle_unload_s=5.0, models=[]))
    rec = AdapterResidency(base="b", name="t", spec={})
    assert mgr.idle_window_s(rec) == 5.0
    mgr.keepwarm_fn = lambda key: 42.0 if key == "b:t" else None
    assert mgr.idle_window_s(rec) == 42.0
    mgr.keepwarm_fn = lambda key: None
    assert mgr.idle_window_s(rec) == 5.0
    # No timer set (never): a learned window does not create one.
    never = AdapterManager(SimpleNamespace(engine=None),
                           PC.ServeConfig(adapter_idle_unload_s=-1.0, models=[]))
    never.keepwarm_fn = lambda key: 42.0
    assert never.idle_window_s(rec) == float("inf")


# ---------------------------------------------------------------------------
# HTTP through the port's server
# ---------------------------------------------------------------------------

def _gpt2(name: str, **over) -> PC.ModelConfig:
    return PC.ModelConfig(name=name, builder="gpt2", dtype="float32", batch_buckets=(1, 2),
                          seq_buckets=(16,), coalesce_ms=1.0,
                          extra={"max_new_tokens": 4, "arch": ARCH}, **over)


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request(method, path, body=json.dumps(body).encode() if body is not None else None,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"null")
    finally:
        conn.close()


def test_http_demand_chaos_degrades_to_reactive_and_recovers():
    """Demand shows on /admin/autoscale and the Prometheus families;
    ``starve`` chaos on the trafficless lazy ghost walks the plane down to
    reactive while every predict is served, with at most one pre-warm
    activation of the ghost; after the hold the plane recovers; the table
    renders."""
    from pytorch_zappa_serverless_tpu import cli as jcli
    from pytorch_zappa_serverless_tpu_torch import cli as pcli

    cfg = PC.ServeConfig(warmup_at_boot=False, autoscale="predictive",
                         autoscale_tick_s=3600.0, autoscale_min_history=3,
                         autoscale_mispredict_limit=2, autoscale_reactive_hold_s=2.0,
                         prewarm_margin_s=0.5,
                         models=[_gpt2("lm"), _gpt2("ghost", lazy_load=True)])
    with BackgroundServer(cfg, device="cpu") as srv:
        plane = srv.server.autoscale
        clock = FakeClock(1000.0)
        plane.clock = clock
        for i in range(4):
            clock.advance(0.5)
            assert _http(srv.port, "POST", "/v1/models/lm:predict",
                         {"input_ids": [5 + i, 6, 7]})[0] == 200
        _, snap = _http(srv.port, "GET", "/admin/autoscale")
        assert snap["mode"] == "predictive" and not snap["degraded"]
        m = snap["models"]["lm"]
        assert m["arrivals"] == 4 and m["forecast_rps"] > 0
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=WAIT_S)
        conn.request("GET", "/metrics?format=prometheus")
        text = conn.getresponse().read().decode()
        conn.close()
        assert 'tpuserve_autoscale_forecast_rps{model="lm"}' in text
        status, _ = _http(srv.port, "POST", "/admin/faults",
                          {"model": "ghost", "kind": "demand", "mode": "starve",
                           "fail_every_n": 1})
        assert status == 200
        ok = n = 0
        for n in range(1, 11):
            ok += _http(srv.port, "POST", "/v1/models/lm:predict",
                        {"input_ids": [9, 9, n]})[0] == 200
            srv.call(plane.tick_once)
            srv.call(lambda: asyncio.sleep(0.2))  # the pre-warm's flight runs
            clock.advance(5.0)  # every phantom watch expires unmatched
            srv.call(plane.tick_once)
            _, snap = _http(srv.port, "GET", "/admin/autoscale")
            if snap["degraded"]:
                break
        assert ok == n
        assert snap["degraded"] and snap["effective_mode"] == "reactive"
        assert snap["counters"]["degradations"] == 1
        assert snap["counters"]["prewarm_misses"] >= 2
        _, models = _http(srv.port, "GET", "/admin/models")
        assert models["models"]["ghost"]["activations_by_cause"].get("prewarm", 0) == 1
        assert len(snap["in_flight"]) <= 1
        _, faults = _http(srv.port, "GET", "/admin/faults")
        assert faults["faults"]["injected"]["demand"] >= 1
        assert _http(srv.port, "POST", "/admin/faults", {"clear": True})[0] == 200
        clock.advance(2.5)  # the hold expires
        _, snap = _http(srv.port, "GET", "/admin/autoscale")
        assert not snap["degraded"]
        assert _http(srv.port, "POST", "/v1/models/lm:predict",
                     {"input_ids": [1, 2, 3]})[0] == 200
        table = pcli.format_autoscale_table(snap)
        assert table == jcli.format_autoscale_table(snap)
        assert "lm" in table and "mode: predictive" in table and "KEEPWARM_S" in table
