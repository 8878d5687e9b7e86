"""The port's perf plane (``serving/perfplane.py``) against the JAX
package's, and ``GET /admin/perf`` on the port's server, on the CPU.

The counterparts of ``tests/test_perfplane.py``'s unit and integration
cases: the loop-lag sampler and the stack sampler with injected clocks and
frames, the ingest registry, the rolling gauges and ``hist_quantile``, each
driven the same way in both packages and held to equal snapshots; then a
booted server (a 64 px ResNet-18 and a tiny GPT-2): every ingest stage of
the JSON, raw and binary lanes on ``/admin/perf``, ``?top``, the
Prometheus families against the unedited manifest, the ``perf`` CLI table,
``perfplane: false`` as a no-op, the split TTFT and inter-token histograms,
and the MFU gauge against the card's peak.
"""

import asyncio
import base64
import importlib.util
import io
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from pytorch_zappa_serverless_tpu.config import ServeConfig as JServeConfig
from pytorch_zappa_serverless_tpu.serving import perfplane as JP
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.ops.preprocessing import preprocess_image_bytes_uint8
from pytorch_zappa_serverless_tpu_torch.serving import perfplane as PP
from pytorch_zappa_serverless_tpu_torch.serving import wire
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

ROOT = Path(__file__).resolve().parents[1]
BOTH = pytest.mark.parametrize("P,C", [(JP, JServeConfig), (PP, ServeConfig)],
                               ids=["jax", "port"])
GPT2_ARCH = {"d_model": 32, "layers": 1, "heads": 2, "ffn_dim": 64, "vocab_size": 512,
             "max_positions": 32}


# -- the loop-lag sampler ------------------------------------------------------

def _drive_lag(P):
    now = [100.0]
    lag = P.LoopLagSampler(interval_s=0.25, clock=lambda: now[0])
    lag.arm()
    out = []
    for step in (0.25, 0.25 + 0.180, 0.25 + 0.030, 0.01):
        now[0] += step
        out.append(lag.note())
    return out, lag.snapshot()


@BOTH
def test_loop_lag_sampler_detects_injected_lag(P, C):
    lags, snap = _drive_lag(P)
    assert lags[:3] == [pytest.approx(0.0), pytest.approx(180.0), pytest.approx(30.0)]
    assert lags[3] == 0.0                      # an early tick is no negative lag
    assert snap["ticks"] == 4 and snap["max_ms"] == pytest.approx(180.0)
    assert 100.0 <= P.hist_quantile(snap["hist"], 0.99) <= 250.0


def test_loop_lag_snapshots_are_equal_in_both_packages():
    assert _drive_lag(PP) == _drive_lag(JP)


def test_loop_lag_sampler_ticks_on_a_real_loop():
    async def run():
        lag = PP.LoopLagSampler(interval_s=0.02)
        ticked = []
        lag.on_tick = lambda: ticked.append(1)
        lag.start(asyncio.get_running_loop())
        try:
            await asyncio.sleep(0.1)
        finally:
            lag.stop()
        return lag, ticked

    lag, ticked = asyncio.run(run())
    assert lag.ticks >= 2 and lag.hist.count == lag.ticks == len(ticked)


# -- the stack sampler ---------------------------------------------------------

def _fake_frame(stack):
    frame = None
    for fname, func in stack:
        frame = SimpleNamespace(f_code=SimpleNamespace(co_filename=fname, co_name=func),
                                f_back=frame)
    return frame


def _drive_stacks(P):
    frames = {"current": {}}
    sampler = P.StackSampler(topk=3, frames=lambda: frames["current"])
    hot = _fake_frame([("/srv/app.py", "loop"), ("/srv/app.py", "hot")])
    for _ in range(10):
        frames["current"] = {1: hot}
        sampler.sample_once(0.1)
    for i in range(9):
        frames["current"] = {1: _fake_frame([("/srv/app.py", f"cold{i}")])}
        sampler.sample_once(0.01)
    return sampler


@BOTH
def test_stack_sampler_aggregates_and_bounds_topk(P, C):
    sampler = _drive_stacks(P)
    snap = sampler.snapshot()
    assert snap["samples"] == 19 and len(snap["stacks"]) <= 3
    assert sampler.evictions > 0
    top = snap["stacks"][0]
    assert top["stack"].endswith("app.py:loop;app.py:hot")
    assert top["seconds"] == pytest.approx(1.0)
    total = sum(s["seconds"] for s in snap["stacks"]) + snap.get("other_s", 0)
    assert total == pytest.approx(19 * 0.1 - 9 * 0.09, abs=0.02)


@pytest.mark.parametrize("top", [None, 1, 2])
def test_stack_snapshots_are_equal_in_both_packages(top):
    assert _drive_stacks(PP).snapshot(top=top) == _drive_stacks(JP).snapshot(top=top)


@BOTH
def test_stack_sampler_skips_its_own_thread(P, C):
    frames = {1: _fake_frame([("a.py", "f")]), 2: _fake_frame([("b.py", "g")])}
    sampler = P.StackSampler(frames=lambda: frames)
    assert sampler.sample_once(0.1, skip_ident=2) == 1
    [row] = sampler.snapshot()["stacks"]
    assert "a.py:f" in row["stack"]


def test_stack_sampler_thread_runs_and_stops():
    sampler = PP.StackSampler(hz=50.0).start()
    time.sleep(0.1)
    sampler.stop()
    assert sampler.samples >= 2
    before = sampler.samples
    time.sleep(0.05)
    assert sampler.samples == before
    assert not any(t.name == "perf-stack-sampler" for t in threading.enumerate())


# -- the ingest registry, the gauges, the quantile -----------------------------

@BOTH
def test_note_stage_histograms_and_disabled_noop(P, C):
    perf = P.PerfPlane(C())
    for ms in (0.2, 0.4, 8.0):
        perf.note_stage("m", "json_decode", ms)
    perf.note_stage(None, "json_decode", 1.0)
    assert perf.ingest_snapshot()["m"]["json_decode"]["count"] == 3
    off = P.PerfPlane(C(perfplane=False))
    off.note_stage("m", "json_decode", 1.0)
    assert off.ingest_snapshot() == {}
    assert off.start(loop=None) is off


def test_ingest_snapshots_are_equal_in_both_packages():
    rng = np.random.default_rng(3)
    planes = [JP.PerfPlane(JServeConfig()), PP.PerfPlane(ServeConfig())]
    assert JP.INGEST_STAGES == PP.INGEST_STAGES
    for _ in range(200):
        model = ("bert_base", "resnet50")[int(rng.integers(2))]
        stage = PP.INGEST_STAGES[int(rng.integers(len(PP.INGEST_STAGES)))]
        ms = float(rng.lognormal(0.0, 2.0))
        for p in planes:
            p.note_stage(model, stage, ms)
    j, p = (pl.ingest_snapshot() for pl in planes)
    assert p == j
    assert list(p["bert_base"]) == [s for s in PP.INGEST_STAGES if s in p["bert_base"]]


def _drive_gauges(P, C, peak):
    perf = P.PerfPlane(C(perf_window_s=30.0))
    stats = {"resnet18": SimpleNamespace(samples=0, batches=0, device_seconds=0.0)}
    gens = {"gpt2": {"tokens_emitted": 0, "segment_rounds": 0}}
    perf.runner_stats = lambda: stats
    perf.gen_snapshots = lambda: gens
    perf.observe_models(now=0.0)
    stats["resnet18"] = SimpleNamespace(samples=500, batches=100, device_seconds=2.0)
    gens["gpt2"] = {"tokens_emitted": 1200, "segment_rounds": 300}
    perf.observe_models(now=10.0)
    first = perf.model_gauges()
    perf.flops_hint = lambda m: 1.0e9
    perf.peak_flops = peak
    return first, perf.model_gauges()


@BOTH
def test_rolling_gauges_difference_the_counters(P, C):
    first, hinted = _drive_gauges(P, C, 100e12)
    assert first["resnet18"]["samples_per_s"] == pytest.approx(50.0)
    assert first["resnet18"]["step_ms"] == pytest.approx(20.0)
    assert first["resnet18"]["device_util_pct"] == pytest.approx(20.0)
    assert first["gpt2:generate"]["tokens_per_s"] == pytest.approx(120.0)
    assert "mfu_pct" not in first["resnet18"]
    assert hinted["resnet18"]["mfu_pct"] == pytest.approx(0.05)


def test_gauges_are_equal_in_both_packages():
    assert _drive_gauges(PP, ServeConfig, 100e12) == _drive_gauges(JP, JServeConfig, 100e12)


def test_the_window_drops_old_samples_as_the_reference():
    planes = [(JP, JP.PerfPlane(JServeConfig(perf_window_s=5.0))),
              (PP, PP.PerfPlane(ServeConfig(perf_window_s=5.0)))]
    for t in range(20):
        st = {"m": SimpleNamespace(samples=t * t, batches=t, device_seconds=0.01 * t)}
        for _, p in planes:
            p.runner_stats = lambda st=st: st
            p.observe_models(now=float(t))
    (_, j), (_, p) = planes
    assert p.model_gauges() == j.model_gauges()
    assert p.model_gauges()["m"]["window_s"] == 5.0


SNAPS = [
    {"buckets": {}, "count": 0},
    {"buckets": {"1": 0, "2": 10, "4": 10, "+Inf": 10}, "count": 10},
    {"buckets": {"0.5": 3, "1": 3, "2.5": 7, "+Inf": 9}, "count": 9},
    {"buckets": {"0.5": 0, "1": 0, "+Inf": 4}, "count": 4},
]


@pytest.mark.parametrize("snap", SNAPS)
@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_hist_quantile_matches_the_reference(snap, q):
    assert PP.hist_quantile(snap, q) == JP.hist_quantile(snap, q)


def test_hist_quantile_interpolates():
    assert PP.hist_quantile(SNAPS[0], 0.5) is None
    assert 1.0 < PP.hist_quantile(SNAPS[1], 0.5) <= 2.0


def test_the_peak_table_is_the_cards_own():
    assert PP.CHIP_PEAK_FLOPS == {"NVIDIA H100 80GB HBM3": 989.4e12}
    perf = PP.PerfPlane(ServeConfig())
    perf.device_name = lambda: "NVIDIA H100 80GB HBM3"
    assert perf._peak() == 989.4e12
    perf = PP.PerfPlane(ServeConfig())
    perf.device_name = lambda: "an unknown card"
    assert perf._peak() is None
    perf = PP.PerfPlane(ServeConfig())          # off CUDA: no name, no gauge
    assert perf._peak() is None


# -- a booted server -----------------------------------------------------------

def _cfg(**kw):
    return ServeConfig(warmup_at_boot=True, perf_loop_lag_interval_s=0.02, perf_stack_hz=50.0,
                       models=[ModelConfig(name="resnet18", batch_buckets=(1, 4),
                                           dtype="float32", coalesce_ms=2.0,
                                           extra={"image_size": 64, "resize_to": 72,
                                                  "flops_per_sample": 2.0e9})], **kw)


@pytest.fixture(scope="module")
def engine():
    eng = build_engine(_cfg(), device="cpu")
    yield eng
    eng.shutdown()


def _png(seed=0) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 255, (64, 64, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _req(port, path, body=None, headers=None, method=None, timeout=60.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _perf(port, query=""):
    status, _, raw = _req(port, "/admin/perf" + query)
    return status, json.loads(raw)


def _tracedump():
    spec = importlib.util.spec_from_file_location("tpuserve_tracedump",
                                                  ROOT / "tools" / "tracedump.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_admin_perf_over_a_real_server(engine):
    route = "/v1/models/resnet18:predict"
    with BackgroundServer(_cfg(), engine) as s:
        for i in range(3):
            body = json.dumps({"b64": base64.b64encode(_png(i)).decode()}).encode()
            status, heads, raw = _req(s.port, route, body, {"Content-Type": "application/json"})
            assert status == 200, raw
        trace_id = heads["X-Trace-Id"]
        status, _, raw = _req(s.port, route, json.dumps(
            {"instances": [{"b64": base64.b64encode(_png(9)).decode()}]}).encode(),
            {"Content-Type": "application/json"})
        assert status == 200, raw
        status, _, raw = _req(s.port, route, _png(4), {"Content-Type": "image/png"})
        assert status == 200, raw
        crop = preprocess_image_bytes_uint8(_png(5), 72, 64)
        status, _, raw = _req(s.port, route, bytes(wire.pack([crop])),
                              {"Content-Type": wire.TENSOR_CONTENT_TYPE})
        assert status == 200, raw
        time.sleep(0.1)                          # lag ticks and stack samples
        status, perf = _perf(s.port)
        assert status == 200 and perf["enabled"] is True
        assert perf["loop_lag"]["ticks"] >= 1 and perf["stacks"]["samples"] >= 1
        stages = perf["ingest"]["resnet18"]
        counts = {k: v["count"] for k, v in stages.items()}
        # 6 requests: 3 JSON b64 bodies, one b64 instance, a raw PNG, a frame.
        assert counts == {"payload_read": 6, "json_decode": 4, "b64_decode": 4,
                          "binary_decode": 1, "validate": 6, "batch_form": 6,
                          "serialize": 6, "respond": 6}, counts
        assert list(stages) == [x for x in PP.INGEST_STAGES if x in stages]
        assert "resnet18" in perf["models"] and "mfu_pct" not in perf["models"]["resnet18"]
        assert len(_perf(s.port, "?top=1")[1]["stacks"]["stacks"]) <= 1
        assert _perf(s.port, "?top=x")[0] == 400
        assert any("http-loop" in r["stack"] for r in _perf(s.port, "?top=50")[1]
                   ["stacks"]["stacks"])

        # The substages ride the trace beside the stage chain.
        dump = _tracedump()
        status, _, raw = _req(s.port, f"/admin/trace/{trace_id}")
        att = dump.stage_attribution(json.loads(raw))
        assert att["coverage_pct"] >= 95.0, att
        assert {"payload_read", "json_decode", "b64_decode", "validate",
                "serialize"} <= set(att["substages"])
        assert "payload_read" not in att["stages"]

        status, _, raw = _req(s.port, "/metrics?format=prometheus")
        prom = raw.decode()
        for fam in ("tpuserve_ingest_ms_bucket", "tpuserve_loop_lag_ms_bucket",
                    "tpuserve_loop_lag_max_ms", "tpuserve_stack_samples_total",
                    "tpuserve_perf_samples_per_s", "tpuserve_perf_device_util_pct"):
            assert fam in prom, fam
        spec = importlib.util.spec_from_file_location("check_metrics",
                                                      ROOT / "tools" / "check_metrics.py")
        cm = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cm)
        assert cm.check(prom, cm.load_manifest()) == []

        from pytorch_zappa_serverless_tpu_torch.cli import format_perf_table

        table = format_perf_table(perf)
        assert "loop lag:" in table and "payload_read" in table and "top stacks" in table


def test_the_mfu_gauge_reads_the_cards_peak(engine):
    with BackgroundServer(_cfg(perf_window_s=30.0), engine) as s:
        s.server.perf.device_name = lambda: "NVIDIA H100 80GB HBM3"
        crop = preprocess_image_bytes_uint8(_png(5), 72, 64)
        for _ in range(4):
            status, _, raw = _req(s.port, "/v1/models/resnet18:predict",
                                  bytes(wire.pack([crop])),
                                  {"Content-Type": wire.TENSOR_CONTENT_TYPE})
            assert status == 200, raw
            time.sleep(0.03)
        time.sleep(0.1)
        row = _perf(s.port)[1]["models"]["resnet18"]
        assert row["samples_per_s"] > 0
        assert row["mfu_pct"] == pytest.approx(
            round(100.0 * 2.0e9 * row["samples_per_s"] / 989.4e12, 2), abs=0.011)


def test_perfplane_off_disables_the_plane(engine):
    before = {t.name for t in threading.enumerate()}
    with BackgroundServer(_cfg(perfplane=False), engine) as s:
        body = json.dumps({"b64": base64.b64encode(_png(9)).decode()}).encode()
        assert _req(s.port, "/v1/models/resnet18:predict", body,
                    {"Content-Type": "application/json"})[0] == 200
        time.sleep(0.06)
        perf = _perf(s.port)[1]
        assert perf["enabled"] is False and perf["ingest"] == {}
        assert perf["loop_lag"]["ticks"] == 0 and perf["stacks"]["samples"] == 0
        assert s.server.perf.loop_lag._handle is None
        assert "perf-stack-sampler" not in {t.name for t in threading.enumerate()} - before
        prom = _req(s.port, "/metrics?format=prometheus")[2].decode()
        assert "tpuserve_ingest_ms" not in prom and "tpuserve_loop_lag_max_ms" not in prom


def test_ttft_and_itl_split_histograms():
    cfg = ServeConfig(models=[ModelConfig(name="gpt2", batch_buckets=(1, 2), seq_buckets=(8,),
                                          dtype="float32",
                                          extra={"max_new_tokens": 6, "arch": GPT2_ARCH})])
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as s:
            status, _, raw = _req(s.port, "/v1/models/gpt2:generate",
                                  json.dumps({"text": "hello tpu", "stream": False}).encode(),
                                  {"Content-Type": "application/json"})
            assert status == 200, raw
            n_tokens = len(json.loads(raw)["predictions"]["tokens"])
            assert n_tokens >= 2
            gen = json.loads(_req(s.port, "/metrics")[2])["generation"]["gpt2"]
            assert gen["latency"]["ttft_ms"]["count"] == 1
            assert gen["latency"]["itl_ms"]["count"] == n_tokens - 1
            assert gen["tokens_emitted"] == n_tokens
            prom = _req(s.port, "/metrics?format=prometheus")[2].decode()
            assert 'tpuserve_ttft_ms_count{model="gpt2"} 1' in prom
            assert f'tpuserve_itl_ms_count{{model="gpt2"}} {n_tokens - 1}' in prom
            assert f'tpuserve_tokens_streamed_total{{model="gpt2"}} {n_tokens}' in prom
            row = _perf(s.port)[1]["models"]["gpt2:generate"]
            assert "ttft_p50_ms" in row and "itl_p50_ms" in row
            # A streamed :generate stamps serialize and respond per event.
            status, _, raw = _req(s.port, "/v1/models/gpt2:generate",
                                  json.dumps({"text": "hello"}).encode(),
                                  {"Content-Type": "application/json"})
            events = [ln for ln in raw.decode().split("\n") if ln.startswith("data:")]
            stages = _perf(s.port)[1]["ingest"]["gpt2"]
            assert stages["serialize"]["count"] == stages["respond"]["count"] == len(events)
    finally:
        eng.shutdown()
