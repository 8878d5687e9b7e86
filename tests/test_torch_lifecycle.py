"""Serverless residency in the port (pytorch_zappa_serverless_tpu_torch/
serving/lifecycle.py), on the CPU: the JAX package's ``tests/test_lifecycle.py``
case for case, under the same names, then demote → restore cycles of small
BERT, GPT-2 (``:predict`` and both ``:generate`` lanes) and ResNet against the
JAX package.

Unit half: the state machine against a fake engine and builder (an injected
``build_fn`` and clock, as the reference injects them): single-flight
activation, deadline-aware cold admission, idle scale-to-zero through the
tiers, LRU eviction under the budget, PIN, the busy gate, activation chaos,
rebind.  HTTP half: the port's server over a lazy 48 px ResNet-18, driven
with urllib through ``BackgroundServer``.  The port's server mints no request
or trace ids, so the reference's asserts on them are left out.

Cases of the reference this slice leaves out, with what they wait for:
``test_models_cli_table`` waits for the port's ``cli.py`` ``models``
command, and ``test_bench_lifecycle_section_wiring`` and
``test_bench_lifecycle_emits_activation_ladder`` wait for the port's bench.

Cycle half: each model's weights are the JAX package's seed tree, written
with the port's ``save_stream`` and loaded as the checkpoint by both
packages.  After each demotion (host, disk, none) the restored model answers
byte-equal to its first answer, and that answer agrees with the JAX
servable's on the same checkpoint within the tolerances the port's parity
tests state: BERT's probabilities within 1e-5 (tests/test_torch_engine.py),
GPT-2's f32 tokens identical (tests/test_torch_gpt2.py), ResNet's top-5
probabilities within rtol 2e-3, atol 1e-6 and its indices equal
(tests/test_torch_vision.py).
"""

import asyncio
import importlib.util
import json
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.cache import CompileClock
from pytorch_zappa_serverless_tpu_torch.faults import FaultInjector, TransientFault
from pytorch_zappa_serverless_tpu_torch.models.sd15 import png_bytes
from pytorch_zappa_serverless_tpu_torch.serving.lifecycle import (ACTIVE, COLD, ColdStart,
                                                                   LifecycleManager)
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

ROOT = Path(__file__).resolve().parents[1]


# -- fakes for the unit half --------------------------------------------------

class FakeRunner:
    def __init__(self):
        self.faults = FaultInjector()
        self._resident = {}

    def track_model(self, name, nbytes):
        self._resident[name] = int(nbytes)

    def untrack_model(self, name):
        self._resident.pop(name, None)

    def resident_bytes(self):
        return dict(self._resident)

    async def run_fn(self, fn, *args, model=None):
        return fn(*args)


class FakeCM:
    def __init__(self, nbytes=100):
        self.nbytes = nbytes
        self.offloads = 0
        self.restores = 0
        self.releases = 0

    def param_nbytes(self):
        return self.nbytes

    def resident_nbytes(self):
        return self.nbytes

    def host_offload(self):
        self.offloads += 1

    def device_restore(self):
        self.restores += 1

    def release(self):
        self.releases += 1


class FakeEngine:
    def __init__(self):
        self.models = {}
        self.runner = FakeRunner()
        self.clock = CompileClock()
        self.build_seconds = {}
        self.device = SimpleNamespace(type="cpu")

    def attach(self, name, cm, nbytes=None):
        self.models[name] = cm
        self.runner.track_model(name, cm.resident_nbytes() if nbytes is None else nbytes)

    def detach(self, name):
        self.runner.untrack_model(name)
        return self.models.pop(name, None)

    def model(self, name):
        return self.models[name]


class FakeServer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.engine = FakeEngine()
        self.batchers = {}
        self.schedulers = {}
        self.jobs = None
        self.resilience = SimpleNamespace(quarantined=set())
        self.lanes_started = []
        self.lanes_stopped = []

    def _start_model_lanes(self, name):
        self.lanes_started.append(name)

    async def _stop_model_lanes(self, name):
        self.lanes_stopped.append(name)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


def _unit_cfg(tmp_path, names=("m",), **kw):
    return ServeConfig(models=[ModelConfig(name=n) for n in names], **kw)


def _mgr(tmp_path, names=("m",), builds=None, delay=0.0, nbytes=100, fail_first=False,
         **cfg_kw):
    """(manager, server, clock, builds counter) against the fake stack."""
    cfg = _unit_cfg(tmp_path, names, **cfg_kw)
    server = FakeServer(cfg)
    clock = FakeClock()
    builds = builds if builds is not None else {}
    failed = {}

    def build(name, from_tier, host_cm):
        if delay:
            time.sleep(delay)
        builds[name] = builds.get(name, 0) + 1
        if fail_first and not failed.get(name):
            failed[name] = True
            raise RuntimeError("injected build failure")
        if from_tier == "host" and host_cm is not None:
            host_cm.device_restore()
            return host_cm
        return FakeCM(nbytes)

    mgr = LifecycleManager(server, cfg, build_fn=build, clock=clock)
    return mgr, server, clock, builds


# -- unit: the state machine ---------------------------------------------------

def test_idle_cycle_through_warm_tiers(tmp_path):
    """ACTIVE → (idle) host tier → (more idle) none, the re-activation cost
    tiered: a host restore reuses the SAME CompiledModel."""
    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path, idle_unload_s=10.0, host_idle_drop_s=30.0)
        cm1 = await mgr.ensure_active("m")
        res = mgr.residency("m")
        assert res.state == ACTIVE and res.tier == "device"
        assert server.lanes_started == ["m"] and builds["m"] == 1
        assert server.engine.runner.resident_bytes() == {"m": 100}

        clock.advance(11)
        await mgr.tick_once()
        assert res.state == COLD and res.tier == "host"
        assert cm1.offloads == 1 and server.lanes_stopped == ["m"]
        assert server.engine.runner.resident_bytes() == {}

        cm2 = await mgr.ensure_active("m")
        assert cm2 is cm1 and cm1.restores == 1  # host tier: restore, no build
        assert res.state == ACTIVE and builds["m"] == 2

        clock.advance(11)
        await mgr.tick_once()  # active → host again
        assert res.tier == "host"
        clock.advance(35)
        await mgr.tick_once()  # host → none
        assert res.tier == "none" and res.cm_host is None

        cm3 = await mgr.ensure_active("m")
        assert cm3 is not cm1  # a full rebuild from none
        assert res.state == ACTIVE
    asyncio.run(scenario())


def test_single_flight_activation(tmp_path):
    """N concurrent cold requests share ONE activation: one build, one lane
    start, the same CompiledModel back."""
    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path, delay=0.05)
        got = await asyncio.gather(*[mgr.ensure_active("m", cause="request")
                                     for _ in range(10)])
        assert builds == {"m": 1}
        assert all(g is got[0] for g in got)
        assert server.lanes_started == ["m"]
        assert mgr.activations_by_cause["m"] == {"request": 1}
    asyncio.run(scenario())


def test_deadline_aware_cold_admission(tmp_path):
    """A deadline below the estimate fast-fails ColdStart while the
    activation keeps warming; a caller without one then finds it active
    with ONE build in all."""
    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path, activation_estimate_ms=5000.0)
        est = mgr.estimate_warm_ms("m")
        assert est == 5000.0  # the prior: the port has no compile cache to quarter it
        with pytest.raises(ColdStart) as ei:
            await mgr.ensure_active("m", deadline_ms=10.0)
        assert ei.value.estimated_warm_ms == 5000.0
        assert ei.value.retry_after_s >= 1.0
        assert mgr.residency("m").cold_fast_fails == 1
        # The fast-fail started the activation anyway: demand is warm-up.
        await mgr.ensure_active("m")
        assert builds == {"m": 1}
        assert mgr.residency("m").state == ACTIVE
        # Warm, the same tight deadline is admitted at once.
        await mgr.ensure_active("m", deadline_ms=10.0)
    asyncio.run(scenario())


def test_lru_eviction_respects_budget_and_pinned(tmp_path):
    """hbm_budget_bytes evicts LRU first, never PINNED, never the model whose
    activation triggered it; all pinned stays over budget."""
    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path, names=("a", "b", "c"),
                                          hbm_budget_bytes=250)
        await mgr.ensure_active("a")
        await mgr.pin("a")
        clock.advance(1)
        await mgr.ensure_active("b")
        clock.advance(1)
        await mgr.ensure_active("c")  # 300 bytes resident > 250
        resident = server.engine.runner.resident_bytes()
        assert set(resident) == {"a", "c"}  # b: the LRU that is neither pinned nor new
        assert mgr.residency("b").state == COLD
        assert mgr.residency("b").tier == "host"
        assert mgr.residency("a").state == ACTIVE
        assert mgr.residency("c").state == ACTIVE

        await mgr.pin("c")
        clock.advance(1)
        await mgr.ensure_active("b")
        assert set(server.engine.runner.resident_bytes()) == {"a", "b", "c"}
        assert all(mgr.residency(n).state == ACTIVE for n in "abc")
    asyncio.run(scenario())


def test_pin_semantics(tmp_path):
    """pin activates a COLD model and exempts it from idle unload; unpin
    re-arms the reaper."""
    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path, idle_unload_s=5.0)
        await mgr.pin("m")
        res = mgr.residency("m")
        assert res.state == ACTIVE and res.pinned
        assert mgr.activations_by_cause["m"] == {"pin": 1}
        assert mgr.state_code("m") == 4
        clock.advance(60)
        await mgr.tick_once()
        assert res.state == ACTIVE
        mgr.unpin("m")
        await mgr.tick_once()
        assert res.state == COLD and res.tier == "host"
    asyncio.run(scenario())


def test_busy_model_never_demoted(tmp_path):
    """The in-flight guard (enter/exit) blocks idle demotion and unload until
    the handler's window closes."""
    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path, idle_unload_s=5.0)
        await mgr.ensure_active("m")
        mgr.enter("m")
        clock.advance(60)
        await mgr.tick_once()
        assert mgr.residency("m").state == ACTIVE
        assert not await mgr.unload("m")  # busy: refused, 409 upstream
        mgr.exit("m")
        clock.advance(60)
        await mgr.tick_once()
        assert mgr.residency("m").state == COLD
    asyncio.run(scenario())


def test_activation_failure_returns_to_cold_and_retries(tmp_path):
    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path, fail_first=True)
        with pytest.raises(RuntimeError, match="injected build failure"):
            await mgr.ensure_active("m")
        res = mgr.residency("m")
        assert res.state == COLD and res.activations == 0
        await mgr.ensure_active("m")  # the next demand retries the build
        assert res.state == ACTIVE and builds["m"] == 2
    asyncio.run(scenario())


def test_activation_fault_rule_targets_activation_only():
    """kind="activation" fires on on_activation, never on dispatch, and
    coexists with a dispatch rule for the same model."""
    inj = FaultInjector()
    inj.configure(model="m", fail_every_n=1, count=1, kind="activation")
    inj.configure(model="m", fail_every_n=1, count=1, kind="transient")
    assert len(inj.snapshot()["rules"]) == 2
    with pytest.raises(RuntimeError, match="activation"):
        inj.on_activation("m")
    assert inj.injected["activation"] == 1
    inj.on_activation("m")  # count=1 spent
    with pytest.raises(TransientFault):
        inj.on_dispatch("m")
    assert inj.injected["dispatch"] == 1 and inj.injected["activation"] == 1


def test_rebind_records_recovery_activations(tmp_path):
    """An engine swap re-syncs residency: swapped-in models count as
    cause="recovery" activations, missing ones go back to COLD."""
    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path, names=("a", "b"))
        await mgr.ensure_active("a")
        await mgr.ensure_active("b")
        server.engine = FakeEngine()  # a rebuild that brought back only "a"
        server.engine.attach("a", FakeCM())
        server.engine.build_seconds["a"] = 1.5
        mgr.rebind(cause="recovery")
        assert mgr.residency("a").state == ACTIVE
        assert mgr.activations_by_cause["a"]["recovery"] == 1
        assert mgr.residency("b").state == COLD
        assert mgr.residency("b").tier == "none"
    asyncio.run(scenario())


# -- HTTP: the port's serving stack -----------------------------------------------

def _http_cfg(**kw):
    base = dict(warmup_at_boot=True, lazy_load=True, activation_max_wait_s=120.0,
                models=[ModelConfig(name="resnet18", batch_buckets=(1, 2), dtype="float32",
                                    coalesce_ms=2.0,
                                    extra={"image_size": 48, "resize_to": 56})])
    base.update(kw)
    return ServeConfig(**base)


def _png(seed=0) -> bytes:
    return png_bytes(np.random.default_rng(seed).integers(0, 255, (60, 70, 3)).astype(np.uint8))


def _http(port, path, body=None, headers=None, raw=None, timeout=120):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    ctype = "image/png" if raw is not None else "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST",
                                 headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw_out, status, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw_out, status, hdrs = e.read(), e.code, dict(e.headers)
    if hdrs.get("Content-Type", "").startswith("application/json"):
        return status, json.loads(raw_out), hdrs
    return status, raw_out.decode(), hdrs


def _predict(port, seed=0, headers=None):
    return _http(port, "/v1/models/resnet18:predict", raw=_png(seed), headers=headers)


def _model(port, name="resnet18"):
    return _http(port, f"/admin/models/{name}")[1]["model"]


def _check_metrics_tool():
    spec = importlib.util.spec_from_file_location("tpuserve_cm",
                                                  ROOT / "tools" / "check_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wait_for(pred, timeout_s=60.0, every=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def test_lazy_boot_first_request_activates():
    with BackgroundServer(_http_cfg(), device="cpu") as srv:
        port = srv.port
        status, snap, _ = _http(port, "/admin/models")
        assert status == 200
        assert snap["models"]["resnet18"]["state"] == "cold"
        assert snap["models"]["resnet18"]["tier"] == "none"
        assert snap["hbm_bytes_total"] == 0
        # Discovery and health list the COLD model and stay healthy.
        assert _http(port, "/v1/models")[1]["models"]["resnet18"]["residency"] == "cold"
        status, body, _ = _http(port, "/healthz")
        assert status == 200 and body["residency"]["resnet18"] == "cold"

        status, body, _ = _predict(port)
        assert status == 200, body
        m = _model(port)
        assert m["state"] == "active" and m["tier"] == "device"
        assert m["hbm_bytes"] > 0
        assert m["activations_by_cause"].get("request") == 1
        assert m["last_activation_ms"] > 0

        # Unload to zero, then N concurrent cold requests → ONE activation.
        assert _http(port, "/admin/models/resnet18", {"action": "unload"})[0] == 200
        with ThreadPoolExecutor(6) as ex:
            statuses = [r[0] for r in ex.map(lambda i: _predict(port, i), range(6))]
        assert statuses == [200] * 6
        assert _model(port)["activations_by_cause"]["request"] == 2  # +1, not +6

        mjson = _http(port, "/metrics")[1]
        assert mjson["lifecycle"]["models"]["resnet18"]["state"] == "active"
        assert mjson["hbm"]["total_bytes"] > 0
        assert "resnet18" in mjson["cold_start"]["compile_by_model"]
        text = _http(port, "/metrics?format=prometheus")[1]
        assert 'tpuserve_residency_state{model="resnet18"} 2' in text
        assert 'tpuserve_activations_total{cause="request",model="resnet18"}' in text
        assert 'tpuserve_hbm_bytes{model="resnet18"}' in text
        assert 'tpuserve_compile_entries{model="resnet18"}' in text
        assert "tpuserve_activation_ms_bucket" in text
        tool = _check_metrics_tool()
        problems = tool.check(text, tool.load_manifest())
        assert not problems, problems


def test_cold_fast_fail_503_with_retry_after():
    # A huge prior: the estimate always dwarfs the deadline.
    with BackgroundServer(_http_cfg(activation_estimate_ms=600000.0), device="cpu") as srv:
        status, body, hdrs = _predict(srv.port, headers={"X-Deadline-Ms": "40"})
        assert status == 503, body
        assert body["cold_start"] is True
        assert body["estimated_warm_ms"] > 40
        assert int(hdrs["Retry-After"]) >= 1
        # Demand started the activation in the background: wait for ACTIVE,
        # then a request is admitted.
        assert _wait_for(lambda: _model(srv.port)["state"] == "active", 60, 0.1), \
            "background activation never finished"
        assert _predict(srv.port, 1)[0] == 200


def test_unload_reactivate_zero_acked_loss():
    """Burst → unload raced against live work (409 while busy) → drained
    unload → reactivation: every acknowledged request answered 200."""
    with BackgroundServer(_http_cfg(), device="cpu") as srv:
        port = srv.port

        def unload():
            time.sleep(0.001)  # land inside the burst
            return _http(port, "/admin/models/resnet18", {"action": "unload"})[0]

        with ThreadPoolExecutor(9) as ex:
            futs = [ex.submit(_predict, port, i) for i in range(8)]
            unload_status = ex.submit(unload).result()
            statuses = [f.result()[0] for f in futs]
        assert statuses == [200] * 8
        assert unload_status in (200, 409)
        for _ in range(100):
            status = _http(port, "/admin/models/resnet18", {"action": "unload"})[0]
            if status == 200:
                break
            time.sleep(0.05)
        assert status == 200
        assert _model(port)["state"] == "cold"
        assert _predict(port, 99)[0] == 200
        assert _model(port)["state"] == "active"


def test_pin_blocks_unload_and_budget():
    with BackgroundServer(_http_cfg(), device="cpu") as srv:
        port = srv.port
        status, body, _ = _http(port, "/admin/models/resnet18", {"action": "pin"})
        m = body["model"]
        assert status == 200 and m["state"] == "active" and m["pinned"]
        assert _http(port, "/admin/models/resnet18", {"action": "unload"})[0] == 409
        assert _http(port, "/admin/models/resnet18", {"action": "demote"})[0] == 409
        assert _http(port, "/admin/models/resnet18", {"action": "unpin"})[0] == 200
        assert _http(port, "/admin/models/resnet18", {"action": "unload"})[0] == 200
        assert _http(port, "/admin/models/resnet18", {"action": "nope"})[0] == 400
        assert _http(port, "/admin/models/ghost", {"action": "pin"})[0] == 404


def test_submit_acks_cold_model_job_activates():
    """:submit never blocks on activation: an instant 202 while COLD, the
    job activates the model (cause="job") and finishes."""
    with BackgroundServer(_http_cfg(), device="cpu") as srv:
        port = srv.port
        assert _model(port)["state"] == "cold"
        status, body, _ = _http(port, "/v1/models/resnet18:submit",
                                [[[int(v) for v in px] for px in row]
                                 for row in np.zeros((48, 48, 3), np.uint8)])
        assert status == 202, body
        job_id = body["job"]["id"]
        for _ in range(600):
            job = _http(port, f"/v1/jobs/{job_id}")[1]["job"]
            if job["status"] in ("done", "error"):
                break
            time.sleep(0.05)
        assert job["status"] == "done", job
        m = _model(port)
        assert m["state"] == "active"
        assert m["activations_by_cause"].get("job") == 1


def test_unknown_model_404_lists_residency():
    with BackgroundServer(_http_cfg(), device="cpu") as srv:
        for route in ("/v1/models/nope:predict", "/v1/models/nope:submit",
                      "/v1/models/nope:generate"):
            status, body, _ = _http(srv.port, route, {"x": 1})
            assert status == 404, body
            assert "available" in body["error"]
            assert body["models"] == {"resnet18": "cold"}


def test_activation_chaos_fault():
    """kind="activation": the first cold request fails 503 with the
    injected error, the model goes back to COLD, and the next demand (the
    rule spent) activates."""
    with BackgroundServer(_http_cfg(), device="cpu") as srv:
        port = srv.port
        status, body, _ = _http(port, "/admin/faults",
                                {"model": "resnet18", "fail_every_n": 1, "count": 1,
                                 "kind": "activation"})
        assert status == 200, body
        status, body, hdrs = _predict(port, 3)
        assert status == 503 and body.get("activation_failed"), body
        assert "Retry-After" in hdrs
        assert _model(port)["state"] == "cold"
        assert _predict(port, 4)[0] == 200


# -- cycles: demote → restore against the JAX package --------------------------

BERT_ARCH = {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
             "vocab_size": 512, "max_position": 64}
GPT2_ARCH = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128, "vocab_size": 500,
             "max_positions": 64, "eos_id": 499}
CYCLE_MODELS = {
    "bert_base": [dict(name="bert_base", seq_buckets=(16,), batch_buckets=(1, 2),
                       extra={"arch": BERT_ARCH})],
    "gpt2": [dict(name="gpt2", seq_buckets=(16,), batch_buckets=(1,),
                  extra={"arch": GPT2_ARCH, "max_new_tokens": 6, "gen_slots": 2}),
             dict(name="gpt2_paged", builder="gpt2", kv_cache="paged", seq_buckets=(16,),
                  batch_buckets=(1,), extra={"arch": GPT2_ARCH, "max_new_tokens": 6,
                                             "gen_slots": 2})],
    "resnet18": [dict(name="resnet18", batch_buckets=(1, 2),
                      extra={"image_size": 32, "resize_to": 40})],
}
CYCLE_BODIES = {"bert_base": {"input_ids": [5, 17, 33, 2, 9, 120, 7]},
                "gpt2": {"input_ids": [3, 1, 4, 1, 5, 9, 2, 6]}}


def _jax_servable(mc: dict, ckpt: str | None):
    from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
    from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
    from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder

    jmc = JModelConfig(**{k: v for k, v in mc.items() if k != "kv_cache"}, dtype="float32",
                       checkpoint=ckpt)
    return get_model_builder(jmc.builder or jmc.name)(jmc)


def _jax_answer(js, body):
    """The JAX servable's answer to one request body (bucket 1)."""
    import jax

    sample = js.preprocess(body)
    bucket = (1, 16) if js.bucket_axes == ("batch", "seq") else (1,)
    collate = js.meta.get("collate")
    if collate is None:
        from pytorch_zappa_serverless_tpu.engine.compiled import default_collate

        collate = default_collate
    batch = collate([sample], bucket, js.input_spec(bucket))
    out = jax.tree.map(np.asarray, jax.jit(js.apply_fn)(js.params, batch))
    return js.postprocess(out, 0)


@pytest.mark.parametrize("family", sorted(CYCLE_MODELS))
def test_demote_restore_cycle_matches_jax(family, tmp_path):
    """Each tier's restore answers byte-equal to the first answer (both
    ``:generate`` lanes for GPT-2), and the first answer agrees with the JAX
    package's on the same checkpoint."""
    import jax

    from pytorch_zappa_serverless_tpu_torch.engine import weights as W

    specs = CYCLE_MODELS[family]
    seeded = _jax_servable(specs[0], None)
    ckpt = tmp_path / f"{family}{W.STREAM_SUFFIX}"
    W.save_stream(jax.tree.map(np.asarray, seeded.params), ckpt)
    js = _jax_servable(specs[0], str(ckpt))
    cfg = ServeConfig(lazy_load=True, ckpt_store_dir=str(tmp_path / "store"),
                      models=[ModelConfig(**m, dtype="float32", checkpoint=str(ckpt))
                              for m in specs])
    body = CYCLE_BODIES.get(family)
    img = _png(5)

    def answers(port):
        out = []
        for m in specs:
            if body is None:
                status, got, _ = _http(port, f"/v1/models/{m['name']}:predict", raw=img)
            else:
                status, got, _ = _http(port, f"/v1/models/{m['name']}:predict", body)
            assert status == 200, got
            out.append(got["predictions"])
            if family == "gpt2":
                status, got, _ = _http(port, f"/v1/models/{m['name']}:generate",
                                       {**body, "stream": False})
                assert status == 200, got
                out.append(got["predictions"]["tokens"])
        return out

    with BackgroundServer(cfg, device="cpu") as srv:
        port = srv.port
        first = answers(port)
        want = _jax_answer(js, body if body is not None else img)
        got = first[0]
        if family == "bert_base":
            np.testing.assert_allclose([got[k] for k in sorted(got) if k.startswith("label")],
                                       [want[k] for k in sorted(want) if k.startswith("label")],
                                       rtol=0, atol=1e-5)
        elif family == "gpt2":
            assert got == want
            # Both lanes' streams agree with :predict's greedy tokens.
            assert first[1] == first[3] == got["tokens"]
        else:
            assert [e["index"] for e in got["top_k"]] == [e["index"] for e in want["top_k"]]
            np.testing.assert_allclose([e["prob"] for e in got["top_k"]],
                                       [e["prob"] for e in want["top_k"]], rtol=2e-3, atol=1e-6)
        for to in ("host", "disk", "none"):
            for m in specs:
                status, out, _ = _http(port, f"/admin/models/{m['name']}",
                                       {"action": "demote", "to": to})
                assert status == 200 and out["model"]["tier"] == to, out
            assert answers(port) == first, f"after a restore from {to}"
            for m in specs:
                phases = _model(port, m["name"])["last_activation_phases"]
                assert phases["tier"] == to
                # The disk restore and the rebuild from none both stream.
                assert phases.get("streamed", False) is (to != "host"), phases
        snap = _http(port, "/admin/models")[1]
        assert snap["ckpt_store"]["degraded_loads_total"] == 0
