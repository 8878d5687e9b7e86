"""Variant families in the port (``serving/variants.py`` and the brownout
ladder of ``serving/resilience.py``) against the JAX package's, on the CPU.

- Pure logic, exact: the same family tables, objectives, frozen evidence
  views and brownout observation sequences (built from a numpy seed or
  fixed tables) go through both packages, and the results are equal (float
  fields to 1e-9 relative): ``FamilyRegistry`` ladders, ``Objective.parse``
  (the same value, or ``ValueError`` in both), ``select`` and
  ``BrownoutController`` state sequences on an injected clock.
- HTTP, the JAX package's ``tests/test_variants.py`` scenarios through the
  port's ``BackgroundServer``: a tiny seeded GPT-2 family of a bf16 rung and
  an int8 rung (width 128: the int8 lm head pads to 128 columns, so the
  narrower arch of the adapter tests has no int8 rung).  A family answer's
  predictions equal the addressed rung's byte for byte; that rung's tokens
  are held against the JAX package by ``test_torch_gpt2.py``.  Family
  ``:predict``, ``:generate`` and ``:submit`` answer ``X-Served-Variant``;
  a latency objective degrades, brownout holds and recovers with
  hysteresis; an open breaker degrades and a blocked family sheds with
  its minimum; an exact-variant shed reports the family's minimum wait;
  an objective on a deploy is 400; the 404 groups by family;
  ``spec_draft: "auto"`` drafts with the int8 rung; the variant families
  pass ``tools/check_metrics.py``.

Injected clocks; no sleep but a job poll's; every wait is bounded.
"""

import dataclasses
import http.client
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu import config as JC
from pytorch_zappa_serverless_tpu.serving import resilience as JR
from pytorch_zappa_serverless_tpu.serving import variants as JV
from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch.serving import resilience as PR
from pytorch_zappa_serverless_tpu_torch.serving import variants as PV
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

ROOT = Path(__file__).resolve().parents[1]
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


# ---------------------------------------------------------------------------
# Pure logic against the JAX package
# ---------------------------------------------------------------------------

def _family_table(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(int(rng.integers(3, 9))):
        fam = ["", "fa", "fb"][int(rng.integers(0, 3))]
        rows.append({"name": f"m{i}_{int(rng.integers(0, 50))}", "family": fam,
                     "quality_rank": int(rng.integers(0, 4)),
                     "cost_hint_ms": float(np.round(rng.uniform(0, 40), 3))})
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_family_registry_ladders_match_the_reference(seed):
    rows = _family_table(seed)
    got = PV.FamilyRegistry([PC.ModelConfig(**r) for r in rows])
    want = JV.FamilyRegistry([JC.ModelConfig(**r) for r in rows])
    assert got.families() == want.families()
    for fam in want.families():
        assert ([m.name for m in got.ladder(fam)] == [m.name for m in want.ladder(fam)])
        assert got.top_rank(fam) == want.top_rank(fam)
    for name in [r["name"] for r in rows] + ["fa", "fb", "nope"]:
        assert got.family_of(name) == want.family_of(name)
        assert (got.is_family(name), got.is_model(name)) == (want.is_family(name),
                                                            want.is_model(name))


OBJECTIVES = [
    ({}, None), ({}, {"max_latency_ms": 50, "min_quality": 1}),
    ({"X-Objective-Prefer-Cost": "true", "X-Objective-Max-Latency-Ms": "25"}, None),
    ({"X-Objective-Min-Quality": "2"}, {"min_quality": 0, "prefer_cost": True}),
    ({"X-Objective-Prefer-Cost": "off"}, {"prefer_cost": 1}),
    ({}, {"prefer_cost": 0}), ({}, {"max_latency_ms": "12.5"}),
    ({}, {"max_latency_ms": "soon"}), ({}, {"max_latency_ms": -1}),
    ({}, {"max_latency_ms": float("nan")}), ({}, {"max_latency_ms": 0}),
    ({}, {"min_quality": "best"}), ({}, {"min_quality": 1.7}), ({}, {"bogus": 1}),
    ({}, ["not", "a", "dict"]), ({"X-Objective-Max-Latency-Ms": "x"}, {"max_latency_ms": 5}),
    ({"X-Objective-Min-Quality": "1"}, {"min_quality": "nope"}),
]


@pytest.mark.parametrize("headers,body", OBJECTIVES)
def test_objective_parse_matches_the_reference(headers, body):
    def parse(mod):
        try:
            o = mod.Objective.parse(headers, body)
        except ValueError:
            return "ValueError"
        return (dataclasses.asdict(o), o.stated, o.public())

    assert parse(PV) == parse(JV)


def _views(mod, rng, n):
    views = []
    for i in range(n):
        resid = ["active", "active", "cold", "warming"][int(rng.integers(0, 4))]
        views.append(mod.VariantView(
            name=f"v{int(rng.integers(0, 4))}{i}", quality_rank=int(rng.integers(0, 3)),
            cost_hint_ms=float(rng.uniform(0, 30)), residency=resid,
            estimated_warm_ms=float(rng.uniform(0, 500)) if resid != "active" else 0.0,
            forecast_wait_ms=float(rng.choice([0.0, rng.uniform(0, 200)])),
            device_p50_ms=None if rng.random() < 0.3 else float(rng.uniform(1, 80)),
            queue_depth=int(rng.integers(0, 5)),
            breaker_state=["closed", "closed", "half_open", "open"][int(rng.integers(0, 4))],
            breaker_retry_after_s=float(rng.uniform(0, 3)),
            quarantined=bool(rng.random() < 0.15)))
    return views


@pytest.mark.parametrize("seed", range(8))
def test_select_matches_the_reference_on_frozen_views(seed):
    """Every (objective, brownout, bound, top rank) over the same seeded
    views picks the same variant with the same evidence in both packages."""
    for case in range(12):
        rng_p, rng_j = (np.random.default_rng((seed, case)) for _ in range(2))
        n = int(np.random.default_rng((seed, case, 9)).integers(0, 5))
        pv, jv = _views(PV, rng_p, n), _views(JV, rng_j, n)
        o = np.random.default_rng((seed, case, 7))
        kw = {"max_latency_ms": None if o.random() < 0.5 else float(o.uniform(5, 150)),
              "min_quality": None if o.random() < 0.6 else int(o.integers(0, 3)),
              "prefer_cost": bool(o.random() < 0.3)}
        bound = None if o.random() < 0.5 else float(o.uniform(5, 150))
        top = None if o.random() < 0.5 else int(o.integers(0, 4))
        for brownout in (False, True):
            got = PV.select("f", PV.Objective(**kw), pv, brownout, bound, top)
            want = JV.select("f", JV.Objective(**kw), jv, brownout, bound, top)
            same(dataclasses.asdict(got), dataclasses.asdict(want), f"case{case}")


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.mark.parametrize("mode,seed", [("auto", 0), ("auto", 1), ("auto", 2),
                                       ("forced", 3), ("off", 4)])
def test_brownout_sequences_match_the_reference(mode, seed):
    """The same pressure sequence on the same injected clock walks both
    controllers through the same states, transitions and snapshots."""
    rng = np.random.default_rng(seed)
    pc, jc = Clock(), Clock()
    got = PR.BrownoutController(mode, exit_ticks=3, min_hold_s=2.0, clock=pc)
    want = JR.BrownoutController(mode, exit_ticks=3, min_hold_s=2.0, clock=jc)
    trail = []
    for _ in range(120):
        fam = ["a", "b"][int(rng.integers(0, 2))]
        fits = bool(rng.random() < 0.7)
        step = float(rng.choice([0.0, 0.1, 0.7, 1.5]))
        pc.t += step
        jc.t += step
        a, b = got.observe(fam, fits), want.observe(fam, fits)
        assert a == b
        assert got.state_code(fam) == want.state_code(fam)
        trail.append(a)
    assert got.snapshot() == want.snapshot()
    assert got.transitions == want.transitions
    if mode == "auto":
        assert got.transitions["a"]["enter"] >= 1 and got.transitions["a"]["exit"] >= 1
    assert PR.BROWNOUT_STATE_CODE == JR.BROWNOUT_STATE_CODE
    with pytest.raises(ValueError):
        PR.BrownoutController("sometimes")


def test_brownout_hysteresis_needs_ticks_and_hold():
    clock = Clock(0.0)
    bc = PR.BrownoutController("auto", exit_ticks=3, min_hold_s=5.0, clock=clock)
    assert bc.observe("f", False) is True            # one shed-worthy verdict enters
    clock.t = 1.0
    assert [bc.observe("f", True) for _ in range(3)] == [True, True, True]  # held < 5 s
    clock.t = 6.0
    assert bc.observe("f", True) is False            # streak and hold both met
    assert bc.transitions["f"] == {"enter": 1, "exit": 1}
    bc.observe("f", False)
    clock.t = 12.0
    assert [bc.observe("f", x) for x in (True, True, False, True, True)] == [True] * 5
    assert bc.observe("f", True) is False            # the oscillation reset the streak


# ---------------------------------------------------------------------------
# HTTP: a bf16 and an int8 rung of one seeded GPT-2 through the port's server
# ---------------------------------------------------------------------------

def _rung(name: str, rank: int, params_dtype: str, **over) -> PC.ModelConfig:
    return PC.ModelConfig(
        name=name, builder="gpt2", family="g", quality_rank=rank, dtype="bfloat16",
        batch_buckets=(1, 4), seq_buckets=(16,), coalesce_ms=1.0, kv_cache="paged",
        kv_block_size=4,
        extra={"max_new_tokens": 6, "arch": ARCH, "quantize_min_size": 1024,
               "params_dtype": params_dtype, "gen_slots": 2, "segment_tokens": 3}, **over)


def _cfg(**over) -> PC.ServeConfig:
    kw = dict(warmup_at_boot=False, breaker_threshold=0.5, breaker_min_samples=2,
              breaker_open_s=60.0, brownout_exit_ticks=2, brownout_min_hold_s=5.0,
              models=[_rung("g_bf16", 2, "bfloat16", spec_draft="auto", spec_k=3),
                      _rung("g_int8", 1, "int8")])
    kw.update(over)
    return PC.ServeConfig(**kw)


@pytest.fixture(scope="module")
def served():
    with BackgroundServer(_cfg(), device="cpu") as srv:
        yield srv


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        raw = r.read()
        return r.status, dict(r.getheaders()), raw
    finally:
        conn.close()


def _post(srv, path, body, headers=None):
    status, heads, raw = _http(srv.port, "POST", path, body, headers)
    return status, heads, json.loads(raw) if raw.startswith(b"{") else raw


def _reset(srv):
    """Fresh evidence: the rungs' rings, breakers, quarantine and the
    family's brownout state."""
    server = srv.server
    for name in ("g_bf16", "g_int8"):
        server.metrics.ring(name)._samples.clear()  # the batcher's ring too
        mr = server.resilience.model(name)
        if mr.breaker is not None:
            mr.breaker.reset()
    server.resilience.quarantined.clear()
    bc = server.variants.brownout
    bc._active.clear()
    bc._ok_streak.clear()
    bc._clock = Clock()


PROMPT = {"input_ids": [5, 6, 7, 8, 9]}


def test_family_predict_serves_the_top_rung_and_cost_the_bottom(served):
    _reset(served)
    s, h, body = _post(served, "/v1/models/g:predict", PROMPT)
    assert s == 200, body
    assert h["X-Served-Variant"] == "g_bf16" and "X-Degraded" not in h
    assert (body["model"], body["family"], body["degraded"]) == ("g_bf16", "g", False)
    s, _, exact = _post(served, "/v1/models/g_bf16:predict", PROMPT)
    assert s == 200
    assert json.dumps(body["predictions"]) == json.dumps(exact["predictions"])
    s, h, cheap = _post(served, "/v1/models/g:predict",
                        {**PROMPT, "objective": {"prefer_cost": True}})
    assert s == 200 and h["X-Served-Variant"] == "g_int8" and h["X-Degraded"] == "1"
    s, _, exact8 = _post(served, "/v1/models/g_int8:predict", PROMPT)
    assert json.dumps(cheap["predictions"]) == json.dumps(exact8["predictions"])
    sel = served.server.variants.selections["g"]
    assert sel["g_bf16"] >= 1 and sel["g_int8"] >= 1
    s, h, body = _post(served, "/v1/models/g:predict", PROMPT,
                       {"X-Objective-Min-Quality": "3"})
    assert s == 429 and body["variant_shed"] == "no_variant_fits" and body["family"] == "g"
    assert int(h["Retry-After"]) >= 1 and served.server.variants.sheds["g"] >= 1


def test_family_degrades_under_a_latency_objective_then_recovers(served):
    """The top rung's evidence says 500 s a request: a 60 s objective
    serves the int8 rung, degraded, and enters brownout; with the evidence gone,
    the family leaves only after its exit ticks and its hold, and both
    transitions are counted."""
    _reset(served)
    server = served.server
    clock = server.variants.brownout._clock
    for _ in range(8):
        server.metrics.ring("g_bf16").record(0.0, 500000.0, 500000.0)
        server.metrics.ring("g_int8").record(0.0, 5.0, 5.0)
    obj = {"X-Objective-Max-Latency-Ms": "60000"}
    served_n = 0
    for _ in range(4):
        s, h, body = _post(served, "/v1/models/g:predict", PROMPT, obj)
        served_n += s == 200
        assert h.get("X-Served-Variant") == "g_int8" and h["X-Degraded"] == "1", body
    assert served_n == 4 and body["degraded"] is True
    assert server.variants.brownout.active("g")
    before = dict(server.variants.brownout.transitions["g"])
    server.metrics.ring("g_bf16")._samples.clear()   # the pressure clears
    s, h, _ = _post(served, "/v1/models/g:predict", PROMPT, obj)
    s, h, _ = _post(served, "/v1/models/g:predict", PROMPT, obj)
    assert h["X-Served-Variant"] == "g_int8"         # two clean ticks, held < 5 s
    clock.t += 6.0
    s, h, _ = _post(served, "/v1/models/g:predict", PROMPT, obj)
    assert s == 200 and h["X-Served-Variant"] == "g_bf16" and "X-Degraded" not in h
    after = server.variants.brownout.transitions["g"]
    assert after["exit"] == before["exit"] + 1 and after["enter"] == before["enter"]
    prom = _http(served.port, "GET", "/metrics?format=prometheus")[2].decode()
    assert 'tpuserve_variant_brownout_state{family="g"} 0' in prom
    assert 'tpuserve_variant_brownout_transitions_total{direction="exit",family="g"}' in prom


def test_family_degrades_around_an_open_breaker_then_sheds_when_all_blocked(served):
    _reset(served)
    server = served.server
    full = server.resilience.model("g_bf16")
    full.breaker.record(False)
    full.breaker.record(False)
    assert full.breaker.state == "open"
    s, h, body = _post(served, "/v1/models/g:predict", PROMPT)
    assert s == 200 and h["X-Served-Variant"] == "g_int8", body
    server.resilience.quarantined.add("g_int8")
    s, h, body = _post(served, "/v1/models/g:predict", PROMPT)
    assert s == 503, body
    assert body["variant_shed"] == "all_blocked" and body["family"] == "g"
    assert "Retry-After" in h
    # An exact request to the blocked top rung reports the family's minimum.
    s, h, body = _post(served, "/v1/models/g_bf16:predict", PROMPT)
    assert s == 503 and body["breaker"] == "open" and body["family"] == "g"
    _reset(served)


def test_exact_variant_shed_reports_the_family_minimum_wait(served):
    _reset(served)
    server = served.server
    for _ in range(8):
        server.metrics.ring("g_bf16").record(0.0, 5000.0, 5000.0)
        server.metrics.ring("g_int8").record(0.0, 5.0, 5.0)
    s, h, body = _post(served, "/v1/models/g_bf16:predict", PROMPT, {"X-Deadline-Ms": "100"})
    assert s == 429, body
    assert body["family"] == "g" and body["estimated_wait_ms"] <= 100
    assert int(h["Retry-After"]) <= 1
    _reset(served)


@pytest.mark.parametrize("verb", ["predict", "generate", "submit"])
def test_objective_on_an_exact_variant_declines_loudly(served, verb):
    _reset(served)
    s, _, body = _post(served, f"/v1/models/g_bf16:{verb}",
                       {**PROMPT, "objective": {"max_latency_ms": 50}})
    assert s == 400 and "family" in body["error"]


def test_unknown_model_404_groups_variants_by_family(served):
    s, _, body = _post(served, "/v1/models/nope:predict", PROMPT)
    assert s == 404
    ladder = body["families"]["g"]
    assert [v["variant"] for v in ladder] == ["g_bf16", "g_int8"]
    assert ladder[0]["quality_rank"] == 2 and all("residency" in v for v in ladder)


def test_family_generate_and_submit_answer_the_served_variant(served):
    _reset(served)
    s, h, body = _post(served, "/v1/models/g:generate", {**PROMPT, "stream": False})
    assert s == 200 and h["X-Served-Variant"] == "g_bf16", body
    assert body["family"] == "g" and body["degraded"] is False
    s, _, exact = _post(served, "/v1/models/g_bf16:generate", {**PROMPT, "stream": False})
    assert body["predictions"]["tokens"] == exact["predictions"]["tokens"]
    # The stream form carries the same headers.
    s, h, raw = _http(served.port, "POST", "/v1/models/g:generate",
                      {**PROMPT, "objective": {"prefer_cost": True}})
    assert s == 200 and h["X-Served-Variant"] == "g_int8" and h["X-Degraded"] == "1"
    assert json.loads(raw.decode().strip().splitlines()[-1][6:])["done"]
    s, h, body = _post(served, "/v1/models/g:submit",
                       {**PROMPT, "objective": {"prefer_cost": True}})
    assert s == 202 and h["X-Served-Variant"] == "g_int8", body
    assert body["family"] == "g" and body["degraded"] is True
    job = body["job"]["id"]
    for _ in range(600):
        _, _, polled = _http(served.port, "GET", f"/v1/jobs/{job}")
        polled = json.loads(polled)
        if polled["job"]["status"] in ("done", "failed"):
            break
        time.sleep(0.05)
    assert polled["job"]["model"] == "g_int8" and polled["job"]["status"] == "done"


def test_spec_draft_auto_drafts_with_the_lowest_rung(served):
    _reset(served)
    assert served.server._spec_draft_name("g_bf16") == "g_int8"
    assert served.server._spec_draft_name("g_int8") is None
    # A prompt no other test sent: a prefix hit would decode plain.
    s, h, raw = _http(served.port, "POST", "/v1/models/g_bf16:generate",
                      {"input_ids": [31, 32, 33, 34, 35, 36, 37], "stream": False})
    body = json.loads(raw)
    assert s == 200 and h.get("X-Spec-Draft") == "g_int8", body
    assert body["predictions"]["stats"]["spec_proposed"] > 0


def test_variant_metric_families_match_the_manifest(served):
    _post(served, "/v1/models/g:predict", PROMPT)
    text = _http(served.port, "GET", "/metrics?format=prometheus")[2].decode()
    assert "tpuserve_variant_selections_total" in text
    assert "tpuserve_variant_brownout_state" in text
    assert "tpuserve_variant_select_ms_bucket" in text
    js = json.loads(_http(served.port, "GET", "/metrics")[2])
    assert js["variants"]["families"]["g"]["ladder"][0]["variant"] == "g_bf16"
    spec = importlib.util.spec_from_file_location("check_metrics",
                                                  ROOT / "tools" / "check_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.check(text, mod.load_manifest()) == []
