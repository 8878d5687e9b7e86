"""The SLO and goodput plane of the port (``serving/slo.py``) against the
JAX package's, on the CPU.

- Pure logic, exact: the same seeded observation sequences on the same
  injected clock go through both packages' ``RollingWindow``, ``SLOHub``
  (classification, definition resolution, burn windows and alarms, the
  health summary) and ``UsageLedger``, and the three fleet merge functions
  fold the same snapshots; every result is equal (floats to 1e-9
  relative).
- HTTP, the JAX package's ``tests/test_slo.py`` scenarios through the
  port's ``BackgroundServer`` with a tiny seeded GPT-2 family (a bf16 and
  an int8 rung, the paged lane with the prefix cache): a good predict lands
  in ``/admin/slo`` and the usage ledger (its ``device_ms`` at least the
  answers' ``X-Device-Ms``); ``/admin/slo``'s outcome counts equal what the
  client saw, by status and by degraded; an unmeetable objective and an
  ``error`` fault burst flip the fast alarm on ``/healthz`` ``slo`` and
  leave health ``ok``; sheds count, client errors do not; a stream's bill
  carries KV page-seconds and the prefix tokens its final event reports;
  the families pass ``tools/check_metrics.py``.

Injected clocks and no sleeps; every wait is bounded.
"""

import http.client
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu import config as JC
from pytorch_zappa_serverless_tpu.serving import slo as JS
from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch.serving import metrics as PM
from pytorch_zappa_serverless_tpu_torch.serving import slo as PS
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


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


SLO_DEFS = {"m": {"latency_objective_ms": 10.0, "availability_target": 0.99},
            "m:t1": {"latency_objective_ms": 5.0},
            "fam": {"latency_objective_ms": 99.0, "availability_target": 0.9}}


def _hubs(clock_p, clock_j, **over):
    kw = dict(slo=SLO_DEFS, slo_fast_window_s=30.0, slo_slow_window_s=300.0,
              slo_latency_objective_ms=40.0, slo_availability_target=0.995, **over)
    pm = [PC.ModelConfig(name="fm", family="fam"), PC.ModelConfig(name="m")]
    jm = [JC.ModelConfig(name="fm", family="fam"), JC.ModelConfig(name="m")]
    return (PS.SLOHub(PC.ServeConfig(models=pm, **kw), clock=clock_p),
            JS.SLOHub(JC.ServeConfig(models=jm, **kw), clock=clock_j))


# ---------------------------------------------------------------------------
# Pure logic against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_rolling_window_counts_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    cp, cj = Clock(0.0), Clock(0.0)
    buckets = int(rng.integers(2, 12))
    got = PS.RollingWindow(60.0, buckets=buckets, clock=cp)
    want = JS.RollingWindow(60.0, buckets=buckets, clock=cj)
    for _ in range(300):
        step = float(rng.choice([0.0, 0.5, 3.0, 17.0, 70.0]))
        cp.t += step
        cj.t += step
        if rng.random() < 0.8:
            good = bool(rng.random() < 0.6)
            got.note(good)
            want.note(good)
        assert got.counts() == want.counts()


def test_classification_and_definitions_match_the_reference():
    hp, hj = _hubs(Clock(), Clock())
    for key in ("m", "m:t1", "m:t2", "fm", "fm:x", "unknown"):
        assert vars(hp.definition(key)) == vars(hj.definition(key)), key
        for status in (200, 202, 400, 404, 409, 429, 500, 503, 504):
            for ms in (0.0, 4.0, 7.5, 30.0, 1e6):
                for degraded in (False, True):
                    for errored in (False, True):
                        assert (hp.classify(key, status, ms, degraded, errored)
                                == hj.classify(key, status, ms, degraded, errored))


@pytest.mark.parametrize("seed", range(4))
def test_burn_windows_alarms_and_health_match_the_reference(seed):
    """A seeded mix of outcomes on several keys, lanes and tenants, the
    clock advancing through the windows: the same snapshots and health
    summaries at every checkpoint, and the fast alarm flips."""
    rng = np.random.default_rng(seed)
    cp, cj = Clock(), Clock()
    hp, hj = _hubs(cp, cj)
    flipped = False
    for i in range(400):
        model = ["m", "fm", "other"][int(rng.integers(0, 3))]
        lane = ["predict", "generate", "submit"][int(rng.integers(0, 3))]
        status = int(rng.choice([200, 200, 200, 200, 400, 429, 500, 503, 504]))
        ms = float(rng.uniform(0, 60))
        deg = bool(rng.random() < 0.2)
        err = bool(rng.random() < 0.05)
        adapter = None if rng.random() < 0.7 else ["t1", "t2"][int(rng.integers(0, 2))]
        assert (hp.observe(model, lane, status, ms, deg, adapter, err)
                == hj.observe(model, lane, status, ms, deg, adapter, err))
        step = float(rng.choice([0.0, 0.05, 0.4, 6.0]))
        cp.t += step
        cj.t += step
        if i % 50 == 49:
            same(hp.snapshot(), hj.snapshot(), f"step{i}")
            same(hp.health_summary(), hj.health_summary(), f"health{i}")
            flipped |= bool(hp.health_summary()["fast_alarms"])
    assert flipped


def test_usage_ledger_snapshots_match_the_reference():
    rng = np.random.default_rng(7)
    lp, lj = PS.UsageLedger(), JS.UsageLedger()
    for _ in range(200):
        model = ["m", "g"][int(rng.integers(0, 2))]
        adapter = [None, "t1", "t2"][int(rng.integers(0, 3))]
        kind = int(rng.integers(0, 3))
        if kind == 0:
            args = (model, adapter, float(rng.uniform(-1, 30)))
            lp.note_request(*args), lj.note_request(*args)
        elif kind == 1:
            args = (model, adapter, float(rng.uniform(0, 300)), float(rng.uniform(0, 9)),
                    int(rng.integers(0, 64)))
            lp.note_stream(*args), lj.note_stream(*args)
        elif adapter:
            args = (model, adapter, float(rng.uniform(0, 20)))
            lp.note_attach(*args), lj.note_attach(*args)
    same(lp.snapshot(), lj.snapshot())
    assert PS.UsageLedger.key("m", "t1") == JS.UsageLedger.key("m", "t1") == "m:t1"


def _hist_snapshots(seed: int, n: int = 4) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bounds = tuple(sorted(set(float(b) for b in rng.choice(
            [0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 100.0], size=int(rng.integers(1, 6))))))
        h = PM.Histogram(bounds)
        for v in rng.exponential(8.0, size=int(rng.integers(0, 40))):
            h.observe(float(v))
        out.append(h.snapshot())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fleet_merges_match_the_reference(seed):
    """The three pure folds a fleet router runs, on the same replica
    snapshots: histograms bucket-wise, SLO snapshots with burn recomputed
    from summed windows, and the /metrics rollup."""
    snaps = _hist_snapshots(seed)
    same(PS.merge_histogram_snapshots(snaps), JS.merge_histogram_snapshots(snaps))
    assert PS.merge_histogram_snapshots([]) is JS.merge_histogram_snapshots([]) is None
    rng = np.random.default_rng(seed)
    slo_snaps = []
    for r in range(3):
        cp, cj = Clock(), Clock()
        hp, _ = _hubs(cp, cj)
        for _ in range(60):
            hp.observe(["m", "fm"][int(rng.integers(0, 2))], "predict",
                       int(rng.choice([200, 200, 503, 500])), float(rng.uniform(0, 50)),
                       adapter=None if rng.random() < 0.5 else "t1")
            hp.usage.note_request("m", None, float(rng.uniform(0, 5)))
        slo_snaps.append(hp.snapshot())
    same(PS.merge_slo_snapshots(slo_snaps), JS.merge_slo_snapshots(slo_snaps))
    ring = {"requests": 4, "errors": 1, "req_per_s_lifetime": 2.5,
            "queue_hist": snaps[0], "device_hist": snaps[1]}
    metric_snaps = [{"models": {"m": ring, f"r{i}": ring},
                     "generation": {"g": {"kv": {"blocks_used": 3 + i, "blocks_total": 8,
                                                 "evictions": i}}},
                     "hbm": {"total_bytes": 100 * (i + 1)}, "slo": slo_snaps[i]}
                    for i in range(3)]
    same(PS.rollup_metrics(metric_snaps), JS.rollup_metrics(metric_snaps))


# ---------------------------------------------------------------------------
# HTTP through the port's server
# ---------------------------------------------------------------------------

def _rung(name: str, rank: int, params_dtype: str) -> PC.ModelConfig:
    return PC.ModelConfig(
        name=name, builder="gpt2", family="g", quality_rank=rank, dtype="bfloat16",
        batch_buckets=(1, 4), seq_buckets=(16,), coalesce_ms=1.0, kv_cache="paged",
        kv_block_size=4,
        extra={"max_new_tokens": 6, "arch": ARCH, "quantize_min_size": 1024,
               "params_dtype": params_dtype, "gen_slots": 2, "segment_tokens": 3})


@pytest.fixture(scope="module")
def served():
    cfg = PC.ServeConfig(warmup_at_boot=False, slo={"g": {"latency_objective_ms": 60000.0}},
                         slo_fast_window_s=60.0,
                         models=[_rung("g_bf16", 2, "bfloat16"), _rung("g_int8", 1, "int8")])
    with BackgroundServer(cfg, device="cpu") as srv:
        yield srv


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _get(srv, path):
    status, heads, raw = _http(srv.port, "GET", path)
    return status, json.loads(raw)


def _reset(srv):
    hub = srv.server.slo
    hub._trackers.clear()
    hub._defs["g"] = PS.SLODef(60000.0, 0.9)
    srv.server.engine.runner.faults.clear()


PROMPT = {"input_ids": [5, 6, 7, 8, 9]}


def test_good_predicts_land_in_slo_and_the_usage_ledger(served):
    _reset(served)
    before = served.server.slo.usage.snapshot().get("g_bf16", {"device_ms": 0.0})["device_ms"]
    device_ms = 0.0
    for _ in range(3):
        status, heads, _ = _http(served.port, "POST", "/v1/models/g_bf16:predict", PROMPT)
        assert status == 200
        device_ms += float(heads["X-Device-Ms"])
    _, snap = _get(served, "/admin/slo")
    lane = snap["models"]["g_bf16"]["predict"]
    assert lane["outcomes"]["good"] == 3 and lane["goodput_ratio"] == 1.0
    assert lane["objective"]["latency_objective_ms"] == 60000.0  # the family's
    assert lane["windows"]["fast"]["alarm"] is False
    assert snap["usage"]["g_bf16"]["device_ms"] - before >= device_ms - 1e-3 * 3


def test_outcome_counts_equal_what_the_client_saw(served):
    """Family requests served at the top rung and degraded, exact requests,
    a shed and a client error: /admin/slo counts each the client's way."""
    _reset(served)
    # ``prefer_cost`` picks the rung with the least measured cost, and on a
    # loaded CPU the two tiny rungs are a few ms apart: the top rung's
    # evidence starts afresh behind a 200 ms latency rule, so the int8 rung
    # is the cheaper one whatever the host's load (``_reset`` clears it).
    for name in ("g_bf16", "g_int8"):
        served.server.batchers[name].ring._samples.clear()
    served.server.engine.runner.faults.configure(model="g_bf16", latency_ms=200.0)
    seen = {"good": 0, "degraded": 0, "shed": 0}
    cases = [("/v1/models/g:predict", {}, PROMPT),
             ("/v1/models/g:predict", {"X-Objective-Prefer-Cost": "1"}, PROMPT),
             ("/v1/models/g_int8:predict", {}, PROMPT),
             ("/v1/models/g:predict", {"X-Objective-Prefer-Cost": "1"}, PROMPT),
             ("/v1/models/g_bf16:predict", {"X-Deadline-Ms": "0"}, PROMPT),
             ("/v1/models/g_bf16:predict", {}, {"input_ids": "junk"})]
    by_model: dict[str, dict[str, int]] = {}
    for path, heads, body in cases:
        status, h, raw = _http(served.port, "POST", path, body, heads)
        model = h.get("X-Served-Variant") or path.split("/")[-1].split(":")[0]
        if status == 200:
            kind = "degraded" if h.get("X-Degraded") == "1" else "good"
        elif status in (429, 503, 504):
            kind = "shed"
        else:
            assert status == 400
            continue
        seen[kind] += 1
        row = by_model.setdefault(model, {})
        row[kind] = row.get(kind, 0) + 1
    assert seen == {"good": 2, "degraded": 2, "shed": 1}
    _, snap = _get(served, "/admin/slo")
    for model, want in by_model.items():
        got = {k: v for k, v in snap["models"][model]["predict"]["outcomes"].items() if v}
        assert got == want, model


def test_missed_objective_and_an_error_burst_flip_the_fast_alarm(served):
    """An unmeetable objective burns the fast window past its alarm; so
    does an ``error`` fault burst.  Both show on /healthz ``slo`` while
    health stays ok."""
    _reset(served)
    served.server.slo._defs["g"] = PS.SLODef(0.0001, 0.99)
    for _ in range(2):
        assert _http(served.port, "POST", "/v1/models/g_int8:predict", PROMPT)[0] == 200
    _, slo = _get(served, "/admin/slo")
    lane = slo["models"]["g_int8"]["predict"]
    assert lane["outcomes"]["late"] == 2 and lane["windows"]["fast"]["alarm"] is True
    _reset(served)
    served.server.slo._defs["g"] = PS.SLODef(60000.0, 0.99)
    _, health = _get(served, "/healthz")
    assert "g_int8|predict" not in health["slo"]["fast_alarms"]
    status, _, _ = _http(served.port, "POST", "/admin/faults",
                         {"model": "g_int8", "fail_every_n": 1, "count": 3, "kind": "fatal"})
    assert status == 200
    for _ in range(3):
        assert _http(served.port, "POST", "/v1/models/g_int8:predict", PROMPT)[0] == 500
    served.server.engine.runner.faults.clear()
    status, health = _get(served, "/healthz")
    assert status == 200 and health["device_ok"] is True
    assert "g_int8|predict" in health["slo"]["fast_alarms"]
    assert health["slo"]["worst_fast_burn"] >= 14.0
    _, slo = _get(served, "/admin/slo")
    assert slo["models"]["g_int8"]["predict"]["outcomes"]["error"] == 3


def test_unknown_models_are_not_the_servers_budget(served):
    _reset(served)
    assert _http(served.port, "POST", "/v1/models/nope:predict", PROMPT)[0] == 404
    _, snap = _get(served, "/admin/slo")
    assert "nope" not in snap["models"]


def test_a_streams_bill_carries_pages_and_its_prefix_tokens(served):
    """Two streams of one prompt of several pages: the second's prefix
    tokens (its final event's stats) are the ledger's saved tokens, and the
    streams held pages for some seconds."""
    _reset(served)
    ledger = served.server.slo.usage
    before = ledger.snapshot().get("g_int8", {})
    ids = list(range(40, 52))
    cached = 0
    for _ in range(2):
        status, _, raw = _http(served.port, "POST", "/v1/models/g_int8:generate",
                               {"input_ids": ids, "max_new_tokens": 4})
        assert status == 200
        final = json.loads(raw.decode().strip().splitlines()[-1][6:])
        assert final["done"]
        cached += final.get("stats", {}).get("prefix_cached_tokens", 0)
    assert cached > 0
    after = ledger.snapshot()["g_int8"]
    assert after["prefix_saved_tokens"] - before.get("prefix_saved_tokens", 0) == cached
    assert after["kv_block_seconds"] > before.get("kv_block_seconds", 0.0)
    assert after["requests"] - before.get("requests", 0) == 2
    _, snap = _get(served, "/admin/slo")
    assert snap["models"]["g_int8"]["generate"]["outcomes"]["good"] == 2


def test_slo_and_usage_families_match_the_manifest(served):
    _reset(served)
    _http(served.port, "POST", "/v1/models/g_bf16:predict", PROMPT)
    text = _http(served.port, "GET", "/metrics?format=prometheus")[2].decode()
    for family in ("tpuserve_slo_requests_total", "tpuserve_slo_burn_rate",
                   "tpuserve_slo_burn_alarm", "tpuserve_slo_goodput_ratio",
                   "tpuserve_slo_budget_remaining", "tpuserve_usage_device_ms_total",
                   "tpuserve_usage_requests_total"):
        assert f"# TYPE {family} " in text, family
    assert 'tpuserve_slo_requests_total{lane="predict",model="g_bf16",outcome="good"}' in text
    _, js = _get(served, "/metrics")
    assert "g_bf16" in js["slo"]["models"]
    spec = importlib.util.spec_from_file_location("check_metrics",
                                                  ROOT / "tools" / "check_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.check(text, mod.load_manifest()) == []
