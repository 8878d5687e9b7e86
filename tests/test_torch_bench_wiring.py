"""The bench's plane sections against the JAX package's, on the CPU.

- Wiring: ``mixed_path`` runs by default; each other plane section is
  added by the reference's knob (``BENCH_TRACE=1``, ... ``BENCH_RECOVERY=1``)
  and dispatched by ``run_section`` under the reference's name; the
  sections ``run_flagship_bench`` runs are the reference's, in its order,
  for every knob.
- The record: ``_COMPACT_KEYS`` is the reference's, entry for entry, less
  the keys ``DROPPED`` names; the compact line of a run with every section
  fits the tail; a false verdict is a reading, a raised section an error.
- The port's ``tools/replay.py`` and ``tools/tracedump.py`` against the
  root tools of the same names, loaded by path: the same traces for the
  same seeds, the same reports, verdicts, retries and waterfalls.
"""

import asyncio
import copy
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu_torch import benchmark as B
from pytorch_zappa_serverless_tpu_torch.tools import replay as R
from pytorch_zappa_serverless_tpu_torch.tools import tracedump as TD

ROOT = Path(__file__).resolve().parents[1]

PLANE = {"trace_path": "BENCH_TRACE", "serverpath": "BENCH_SERVERPATH",
         "lifecycle": "BENCH_LIFECYCLE", "generation_v2": "BENCH_GENERATION",
         "prefix": "BENCH_PREFIX", "disagg": "BENCH_DISAGG", "replay": "BENCH_REPLAY",
         "autoscale": "BENCH_AUTOSCALE", "variants": "BENCH_VARIANTS",
         "adapters": "BENCH_ADAPTERS", "fleet": "BENCH_FLEET", "recovery": "BENCH_RECOVERY"}


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def JB():
    from pytorch_zappa_serverless_tpu import benchmark

    return benchmark


@pytest.fixture(scope="module")
def RR():
    return _root_tool("replay")


@pytest.fixture(scope="module")
def RT():
    return _root_tool("tracedump")


@pytest.fixture
def no_knobs(monkeypatch):
    for knob in PLANE.values():
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.delenv("BENCH_SKIP", raising=False)


# -- wiring ------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mixed_path", *PLANE])
def test_section_wiring(no_knobs, monkeypatch, name):
    """``run_section(name)`` runs ``bench_<name>`` on the device asked; the
    section joins the run by default (``mixed_path``) or by its knob."""
    seen = []
    monkeypatch.setattr(B, f"bench_{name}", lambda device=None: seen.append(device)
                        or {"stub": True})
    assert B.run_section(name, "cpu") == {"stub": True} and seen == ["cpu"]
    if name == "mixed_path":
        assert name in B.SECTIONS and name in B.sections_to_run()
        return
    assert name not in B.sections_to_run()
    monkeypatch.setenv(PLANE[name], "0")
    assert name not in B.sections_to_run()
    monkeypatch.setenv(PLANE[name], "1")
    assert B.sections_to_run() == [*B.SECTIONS, name]


def _sections_run(JB, B_, monkeypatch) -> tuple[list[str], list[str]]:
    """The section names each package's ``run_flagship_bench`` runs (every
    section stubbed, the flagship faked)."""
    flag = {"p50_ms": 1.0, "e2e_p50_ms": 1.0, "req_s_chip": 8.0, "first_call_s": 1.0,
            "clock": "wall"}
    ran_jax, ran_port = [], []
    monkeypatch.setattr(JB, "_run_section_subprocess",
                        lambda name, timeout=1800: ran_jax.append(name) or {"x": 1})
    monkeypatch.setattr(JB, "bench_cold_start", lambda: ran_jax.append("cold_start") or {})
    monkeypatch.setattr(JB, "bench_recovery", lambda: ran_jax.append("recovery") or {})
    monkeypatch.setattr(JB, "_setup", lambda: None)
    monkeypatch.setattr(JB, "bench_image_model", lambda *a, **k: dict(flag))
    monkeypatch.setattr(B_, "_run_section_subprocess",
                        lambda name, device=None, timeout=1800: ran_port.append(name) or {"x": 1})
    monkeypatch.setattr(B_, "bench_image_model", lambda *a, **k: dict(flag))
    monkeypatch.setattr(B_, "_device_record", lambda device: {"backend": "cpu"})
    jax_full = JB.run_flagship_bench()
    port_full = B_.run_flagship_bench(device="cpu")
    assert set(port_full["extra"]) >= {"configs", "cold_start", "server_path",
                                       "generate_path", "mixed_path"}
    assert set(port_full["extra"]["configs"]) == set(jax_full["extra"]["configs"])
    return ran_jax, ran_port


@pytest.mark.parametrize("knob", [None, *PLANE.values(), "all"])
def test_the_sections_run_are_the_references(JB, no_knobs, monkeypatch, knob):
    if knob == "all":
        for k in PLANE.values():
            monkeypatch.setenv(k, "1")
    elif knob:
        monkeypatch.setenv(knob, "1")
    ran_jax, ran_port = _sections_run(JB, B, monkeypatch)
    assert ran_port == ran_jax
    assert ("mixed_path" in ran_port) and len(ran_port) == 13 + (
        12 if knob == "all" else bool(knob))


def test_bench_skip_skips_a_plane_section(JB, no_knobs, monkeypatch):
    monkeypatch.setenv("BENCH_FLEET", "1")
    monkeypatch.setenv("BENCH_SKIP", "fleet,mixed_path")
    ran_jax, ran_port = _sections_run(JB, B, monkeypatch)
    assert ran_port == ran_jax and "fleet" not in ran_port and "mixed_path" not in ran_port


# -- the record ----------------------------------------------------------------------

def test_compact_keys_are_the_references_less_dropped(JB):
    """Every section of the reference's compact line is the port's, entry
    for entry, less the keys ``DROPPED`` names with their reasons."""
    assert set(B._COMPACT_KEYS) == set(JB._COMPACT_KEYS)
    for name, keys in JB._COMPACT_KEYS.items():
        assert B._COMPACT_KEYS[name] == tuple(k for k in keys if k not in B.DROPPED), name
    assert {k for ks in JB._COMPACT_KEYS.values() for k in ks} - \
        {k for ks in B._COMPACT_KEYS.values() for k in ks} == {
            "meets_target", "warm_boot_s", "speedup", "ttft_est_tpu_vm_ms",
            "warm_cache_activation_p50_ms"}
    assert all(isinstance(why, str) and why for why in B.DROPPED.values())
    sections = set(B.SECTIONS) | {name for _, name in B.PLANE_SECTIONS}
    assert set(B._COMPACT_KEYS) <= sections
    assert sections - set(B._COMPACT_KEYS) == {"prefix", "variants", "adapters", "fleet",
                                                "recovery"}  # the reference lists none


def _plane_entry(name: str, i: int, pad: int = 0) -> dict:
    keys = sorted({k for ks in B._COMPACT_KEYS.values() for k in ks} | {"note", "phases"})
    out = {k: round((i + 1) * (j + 1.25), 3) for j, k in enumerate(keys)}
    out["predictive_beats_fixed"] = False
    if pad:
        out["p50_ms"] = "x" * pad
    return out


@pytest.mark.parametrize("pad", [0, 400])
def test_a_run_with_every_section_fits_the_tail_as_the_references(JB, tmp_path, monkeypatch,
                                                                  capsys, pad):
    """A record with every section's entry: the port's compact line is the
    reference's less the dropped keys, parses, and fits ``_TAIL_BYTES``
    (trimmed as the reference trims); a false verdict fails nothing."""
    names = [*B.SECTIONS, *(n for _, n in B.PLANE_SECTIONS)]
    configs = {n: _plane_entry(n, i, pad) for i, n in enumerate(names)
               if n not in ("cold_start", "server_path", "generate_path", "mixed_path")}
    full = {"metric": "resnet50_b8_p50_latency", "value": 1.5, "unit": "ms",
            "vs_baseline": None,
            "extra": {"step_p99_ms": 1.6, "req_s_chip": 5000.0, "configs": configs,
                      **{k: _plane_entry(k, 0) for k in ("cold_start", "server_path",
                                                         "generate_path", "mixed_path")}}}

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in B.DROPPED}
        return x

    path = str(tmp_path / "f.json")
    got = B.compact_summary(copy.deepcopy(full), path)
    assert got == strip(JB.compact_summary(copy.deepcopy(full), path))
    assert len(json.dumps(got)) <= B._TAIL_BYTES - 200
    monkeypatch.setenv("BENCH_FULL_PATH", path)
    monkeypatch.setattr(B, "run_flagship_bench", lambda emit, device: copy.deepcopy(full))
    assert B.main(device="cpu") == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line) + 1 <= B._TAIL_BYTES and json.loads(line) == got


def test_a_raised_plane_section_fails_the_run(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("BENCH_FULL_PATH", str(tmp_path / "f.json"))
    full = {"metric": "m", "value": 1.0, "unit": "ms", "vs_baseline": None,
            "extra": {"configs": {"autoscale": {"predictive_beats_fixed": False},
                                  "fleet": {"error": "RuntimeError: boom"}},
                      "mixed_path": {"isolated_wall_p99_ms": 3.0}}}
    monkeypatch.setattr(B, "run_flagship_bench", lambda emit, device: copy.deepcopy(full))
    assert B.main(device="cpu") == 1
    assert "sections with an error: fleet" in capsys.readouterr().err
    full["extra"]["mixed_path"] = {"error": "x"}
    del full["extra"]["configs"]["fleet"]
    assert B.main(device="cpu") == 1
    assert "sections with an error: mixed_path" in capsys.readouterr().err
    full["extra"]["mixed_path"] = {"isolated_wall_p99_ms": 3.0}
    assert B.main(device="cpu") == 0


# -- tools/replay.py against the root tool ----------------------------------------------

@pytest.mark.parametrize("shape", ["bursty", "diurnal", "uniform"])
@pytest.mark.parametrize("seed", [0, 7, 8, 123])
def test_synth_trace_is_the_root_tools(RR, shape, seed):
    for duration, rps, models in ((3.0, 8.0, ["rn_hot", "rn_cold"]), (20.0, 30.0, ["rn_burst"]),
                                  (30.0, 40.0, ["a", "b", "c"]), (6.0, 10.0, ["rn_burst"])):
        got = R.synth_trace(shape, duration, rps, models, seed=seed)
        assert got == RR.synth_trace(shape, duration, rps, models, seed=seed)
        assert got and all(0 <= it["t"] <= duration for it in got)
    assert R.synth_trace(shape, 5.0, 4.0, ["m"], seed=seed, period_s=2.0) == \
        RR.synth_trace(shape, 5.0, 4.0, ["m"], seed=seed, period_s=2.0)


def test_synth_trace_refuses_as_the_root_tool(RR):
    for args in (("sawtooth", 1.0, 1.0, ["m"]), ("bursty", 1.0, 1.0, [])):
        with pytest.raises(ValueError) as a:
            R.synth_trace(*args)
        with pytest.raises(ValueError) as b:
            RR.synth_trace(*args)
        assert str(a.value) == str(b.value)


def _outcomes(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    statuses = [200, 200, 200, 201, 429, 503, 504, 500, 599]
    return [{"status": int(rng.choice(statuses)), "latency_ms": float(rng.gamma(2.0, 200.0)),
             "cold": bool(rng.random() < 0.2), "degraded": bool(rng.random() < 0.3),
             "t": float(i), "model": "m"} for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_summarize_and_the_verdict_are_the_root_tools(RR, seed):
    outs = _outcomes(seed, [0, 1, 9, 60, 200, 17][seed])
    for objective in (None, 300.0, 1500.0):
        for duration in (3.0, 0.0, 20.0):
            assert R.summarize(outs, duration, objective) == RR.summarize(outs, duration,
                                                                          objective)
    rng = np.random.default_rng(100 + seed)
    per = {p: {k: (None if rng.random() < 0.15 else round(float(rng.random()) * 500, 2))
               for k in ("cold_hit_rate", "latency_p99_ms", "goodput_rps")}
           for p in R.POLICIES if rng.random() < 0.9}
    assert R.sweep_verdict(per) == RR.sweep_verdict(per)
    assert R.POLICIES == RR.POLICIES and R.POLICY_OVERRIDES == RR.POLICY_OVERRIDES


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    async def sleep(self, s):
        self.now += s
        await asyncio.sleep(0)


def _script(seed: int):
    """A ``send`` answering from a seeded script: statuses, Retry-After,
    colds, latencies (on the fake clock)."""
    rng = np.random.default_rng(seed)
    answers = [(int(rng.choice([200, 200, 429, 503, 504])), bool(rng.random() < 0.4),
                None if rng.random() < 0.5 else float(rng.random()), float(rng.random()))
               for _ in range(400)]

    def make(clock):
        it = iter(answers)

        async def send(item):
            status, cold, ra, lat = next(it)
            await clock.sleep(lat / 10)
            return {"status": status, "latency_ms": lat * 100, "cold": cold,
                    "degraded": status == 200 and cold, "retry_after_s": ra}
        return send
    return make


@pytest.mark.parametrize("seed", range(4))
def test_replay_and_the_retrying_sender_are_the_root_tools(RR, seed):
    trace = R.synth_trace("bursty", 4.0, 10.0, ["a", "b"], seed=seed)

    def run(mod):
        clock = _FakeClock()
        send = _script(seed)(clock)
        retry = mod.retrying_sender(send, max_attempts=5, wait_cap_s=0.25, clock=clock,
                                    sleep=clock.sleep)
        return asyncio.run(mod.replay_async(retry, trace, speedup=2.0, clock=clock,
                                            sleep=clock.sleep))

    got = run(R)
    assert got == run(RR) and len(got) == len(trace)
    assert all(1 <= o["attempts"] <= 5 for o in got)

    async def boom(item):
        raise ConnectionError("refused")

    errs = [asyncio.run(m.replay_async(boom, trace[:3])) for m in (R, RR)]
    for a, b in zip(*errs):
        assert a["status"] == b["status"] == 599 and a["error"] == b["error"]


def test_default_payload_is_the_root_tools_image(RR):
    import io

    from PIL import Image

    body, ctype = R.default_payload()
    ref_body, ref_ctype = RR._default_payload()
    assert ctype == ref_ctype == "image/png"
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))),
                                  np.asarray(Image.open(io.BytesIO(ref_body))))


# -- tools/tracedump.py against the root tool ---------------------------------------------

def _trace(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    names = ["admission", "queue", "device", "respond", "retry", *TD.SUBSTAGES[:8],
             "payload_read", "batch_form", "exec"]

    def node(depth, start):
        dur = float(rng.gamma(2.0, 3.0))
        kids, t = [], start
        for _ in range(int(rng.integers(0, 4)) if depth < 3 else 0):
            c = node(depth + 1, t)
            kids.append(c)
            t += c["duration_ms"] * 0.5
        attrs = {"batch_size": int(rng.integers(1, 9))} if rng.random() < 0.5 else {}
        if rng.random() < 0.2:
            attrs["lane"] = "latency"
        return {"name": str(rng.choice(names)), "start_ms": round(start, 3),
                "duration_ms": round(dur, 3), "status": "error" if rng.random() < 0.1 else "ok",
                "attrs": attrs, "children": kids}

    root = node(0, 0.0)
    root["name"] = "predict"
    root["children"] += [{"name": "device", "start_ms": 1.0, "duration_ms": 4.0,
                          "children": [{"name": "exec", "start_ms": 1.0, "duration_ms": 3.0}]}]
    return {"trace": {"trace_id": f"t{seed}", "name": "predict", "model": "resnet50",
                      "status": "ok", "tree": root}}


@pytest.mark.parametrize("seed", range(8))
def test_stage_attribution_and_render_are_the_root_tools(RT, seed):
    payload = _trace(seed)
    for p in (payload, payload["trace"], payload["trace"]["tree"]):
        assert TD.stage_attribution(p) == RT.stage_attribution(p)
        assert TD.render(p) == RT.render(p)
        assert TD.render(p, bar_width=12) == RT.render(p, bar_width=12)
    assert TD.SUBSTAGES == RT.SUBSTAGES
    assert TD.stage_attribution({"tree": {"name": "r", "duration_ms": 0.0}}) == \
        RT.stage_attribution({"tree": {"name": "r", "duration_ms": 0.0}})


# -- stated differences ----------------------------------------------------------------

def test_the_policy_sweep_boots_one_server_after_another(monkeypatch):
    """No compile cache to share: each policy's server is a full build of
    its own, booted only after the one before it stopped (and, on the
    card, freed its device bytes); the configs differ in the policy alone
    and name no ``compile_cache_dir``."""
    import types

    from pytorch_zappa_serverless_tpu_torch.serving import server as S

    events, cfgs = [], []

    class FakeServer:
        def __init__(self, cfg, engine=None, device=None):
            cfgs.append(cfg)
            self.port, self.policy = 0, cfg.autoscale

        def __enter__(self):
            events.append(("boot", self.policy))
            return self

        def __exit__(self, *exc):
            events.append(("stop", self.policy))

    def run(coro):
        coro.close()
        return {"cold_hit_rate": 0.1, "latency_p99_ms": 5.0, "goodput_rps": 1.0}

    monkeypatch.setattr(S, "BackgroundServer", FakeServer)
    monkeypatch.setattr(R, "asyncio", types.SimpleNamespace(run=run))
    out = R.policy_sweep(duration_s=1.0, rps=2.0, device="cpu")
    assert events == [(e, p) for p in ("off", "histogram", "predictive")
                      for e in ("boot", "stop")]
    assert list(out["policies"]) == list(R.POLICIES)
    assert not any(getattr(c, "compile_cache_dir", None) for c in cfgs)
    base = [{k: v for k, v in vars(c).items() if k != "autoscale"} for c in cfgs]
    assert base[0] == base[1] == base[2]


def test_the_crashtest_hooks_run_on_the_benchs_device(monkeypatch):
    """``recovery`` runs the port's ``tools/crashtest.run_crashtest`` on the
    section's device (the reference runs CPU subprocesses); asked for the
    card where there is none, it raises instead of carrying on."""
    import torch

    from pytorch_zappa_serverless_tpu_torch.tools import crashtest

    seen = []
    monkeypatch.setattr(crashtest, "run_crashtest", lambda td, n_jobs, platform: (
        seen.append((n_jobs, platform)) or {"lost": 0, "restart_ready_s": 1.0}))
    out = B.run_section("recovery", "cpu")
    assert seen == [(4, "cpu")] and out["zero_loss"] is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.run_section("recovery", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.run_section("autoscale", None)
