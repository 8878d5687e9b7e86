"""The port's Prometheus exposition (the JAX package's
``tests/test_metrics_prometheus.py``, on the port's ``MetricsHub``).

Every line a hub loaded with each publishing subsystem the port has (rings,
runner stats, lanes, resilience, faults, recovery, the ``:generate`` lanes)
stays scrapeable, label values escape, the histograms are exact, and every
family and label set is declared in ``tools/metrics_manifest.json``
(``tools/check_metrics.py``, the manifest unedited).  Beside the JAX hub fed
the same traffic, each family both render has the same type and label keys;
and a served exposition after real traffic passes the manifest check.
"""

import importlib.util
import json
import re
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import torch

from pytorch_zappa_serverless_tpu.config import ServeConfig as JServeConfig
from pytorch_zappa_serverless_tpu.engine.runner import DeviceRunner as JDeviceRunner
from pytorch_zappa_serverless_tpu.faults import FaultInjector as JFaultInjector
from pytorch_zappa_serverless_tpu.serving.metrics import MetricsHub as JMetricsHub
from pytorch_zappa_serverless_tpu.serving.resilience import ResilienceHub as JResilienceHub
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.engine.runner import DeviceRunner
from pytorch_zappa_serverless_tpu_torch.faults import FaultInjector
from pytorch_zappa_serverless_tpu_torch.serving.metrics import (
    TOKEN_LATENCY_BUCKETS_MS, Histogram, MetricsHub)
from pytorch_zappa_serverless_tpu_torch.serving.resilience import ResilienceHub
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

# The exposition grammar (text format 0.0.4): name, optional label set, one
# float value; the port writes no exemplars yet.
_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL = rf'{_NAME}="(?:[^"\\\n]|\\.)*"'
_NUM = r"-?[0-9.e+-]+"
_LINE = re.compile(rf"^{_NAME}(?:\{{{_LABEL}(?:,{_LABEL})*\}})? {_NUM}$")
_HELP = re.compile(rf"^# HELP {_NAME} \S.*$")
_TYPE = re.compile(rf"^# TYPE {_NAME} (counter|gauge|summary|histogram)$")
_HIST_SUFFIX = re.compile(r"_(bucket|sum|count)$")
HOSTILE = ("bert_base", 'mo"del\\weird', "with\nnewline")


def _hist(values, bounds=TOKEN_LATENCY_BUCKETS_MS):
    h = Histogram(bounds)
    for v in values:
        h.observe(v)
    return h


def _generation():
    """A paged lane's and a slot lane's snapshots, as the schedulers publish."""
    lat = {"ttft_ms": _hist([12.0, 40.0]).snapshot(), "itl_ms": _hist([0.5, 1.5, 3.0]).snapshot()}
    paged = {"mode": "paged", "kv": {"blocks_used": 5, "blocks_total": 12, "evictions": 1},
             "prefill_chunks": 4, "tokens_emitted": 30, "latency": lat,
             "prefix": {"hits": 2, "misses": 1, "nodes_total": 3, "pages_total": 6,
                        "cow_copies": 2, "evictions": 0,
                        "cached_tokens": _hist([16, 96], (16, 64, 256)).snapshot()}}
    slot = {"mode": "slot", "tokens_emitted": 7, "latency": lat}
    return {'gpt2"paged': paged, "gpt2": slot}


def _loaded_hub():
    """A hub with each subsystem the port publishes, and hostile names."""
    hub = MetricsHub()
    for model in HOSTILE:
        ring = hub.ring(model)
        for i in range(4):
            ring.record(1.0 + i, 2.0 + i, 3.0 + i)
        ring.record_error()
    hub.resilience = ResilienceHub(ServeConfig(breaker_threshold=0.5, breaker_min_samples=1))
    mr = hub.resilience.model('mo"del\\weird')
    mr.stats.retries, mr.stats.deadline_queue, mr.stats.shed_predicted = 3, 2, 1
    mr.breaker.record(False)  # trips open
    hub.resilience.draining = True
    hub.resilience.quarantined.add('mo"del\\weird')
    hub.faults = FaultInjector()
    hub.faults.configure(model="*", fail_every_n=2, latency_ms=5)
    hub.watchdog = SimpleNamespace(snapshot=lambda: {
        "state": "recovering", "attempts": 1, "max_attempts": 3, "recoveries_total": 2,
        "requeued_jobs_total": 4, "last_reason": "device probe failed",
        "last_recovery_ts": None})
    hub.generation = _generation
    return hub


def _engine_render(hub, runner_cls=DeviceRunner, *args):
    """``hub.render_prometheus`` over a runner that served one batch."""
    runner = runner_cls(*args)
    try:
        cm = SimpleNamespace(servable=SimpleNamespace(name="bert_base"),
                             latency_class="latency",
                             run_batch=lambda samples, seq=None: (["r"] * len(samples), (4,)))
        runner.run_sync(cm, [{}, {}])
        engine = SimpleNamespace(
            runner=runner, cold_start_seconds=1.23, models={},
            clock=SimpleNamespace(entries=[], total_seconds=0.5,
                                  per_model=lambda: {"bert_base": {"entries": 2,
                                                                   "seconds": 0.25}}))
        return hub.render_prometheus(engine)
    finally:
        runner.shutdown()


def test_every_published_line_is_scrapeable():
    text = _engine_render(_loaded_hub(), DeviceRunner, torch.device("cpu"))
    assert text.endswith("\n")
    seen_types: dict[str, str] = {}
    families_in_help = set()
    for line in text.strip().splitlines():
        if line.startswith("# HELP "):
            assert _HELP.match(line), f"bad HELP line: {line!r}"
            families_in_help.add(line.split()[2])
        elif line.startswith("# TYPE "):
            assert _TYPE.match(line), f"bad TYPE line: {line!r}"
            name = line.split()[2]
            assert name not in seen_types, f"duplicate TYPE for {name}"
            seen_types[name] = line.split()[3]
        else:
            assert _LINE.match(line), f"unscrapeable sample line: {line!r}"
            float(line.rsplit(" ", 1)[1])
            name = re.match(_NAME, line).group(0)
            family = name
            if family not in seen_types and _HIST_SUFFIX.search(name):
                family = _HIST_SUFFIX.sub("", name)
            assert family in seen_types, f"sample before TYPE: {line!r}"
    assert families_in_help == set(seen_types)
    for family in ("tpuserve_requests_total", "tpuserve_deadline_exceeded_total",
                   "tpuserve_load_shed_total", "tpuserve_dispatch_retries_total",
                   "tpuserve_breaker_state", "tpuserve_draining",
                   "tpuserve_faults_injected_total", "tpuserve_batches_total",
                   "tpuserve_quarantined", "tpuserve_recovery_state",
                   "tpuserve_recoveries_total", "tpuserve_queue_ms", "tpuserve_device_ms",
                   "tpuserve_dispatch_total", "tpuserve_device_seconds_total",
                   "tpuserve_cold_start_seconds", "tpuserve_kv_blocks_used",
                   "tpuserve_prefix_hits_total", "tpuserve_prefix_cached_tokens",
                   "tpuserve_ttft_ms", "tpuserve_itl_ms", "tpuserve_tokens_streamed_total"):
        assert f"# TYPE {family} " in text, f"missing family {family}"
    assert seen_types["tpuserve_queue_ms"] == "histogram"
    assert seen_types["tpuserve_ttft_ms"] == "histogram"
    assert "tpuserve_draining 1" in text
    assert "tpuserve_recovery_state 1" in text  # "recovering" encodes as 1


def test_label_escaping_round_trips():
    text = _loaded_hub().render_prometheus()
    assert r'model="mo\"del\\weird"' in text
    assert "with\nnewline" not in text.replace(r"\n", "")
    assert r'model="gpt2\"paged"' in text


def test_histograms_are_exact_and_carry_no_exemplars():
    """A bucket carries an exemplar only for a traced observation (one with
    a trace id; tests/test_torch_serverpath.py holds those): these records
    carry none, so no bucket line has one, and the counts are exact
    cumulative ones with a JSON twin."""
    hub = _loaded_hub()
    text = hub.render_prometheus()
    assert 'tpuserve_queue_ms_bucket{model="bert_base",le="+Inf"} 4' in text
    assert 'tpuserve_queue_ms_count{model="bert_base"} 4' in text
    assert 'tpuserve_queue_ms_bucket{model="bert_base",le="1"} 1' in text
    assert 'tpuserve_ttft_ms_bucket{model="gpt2",le="25"} 1' in text
    assert " # " not in text
    snap = hub.models["bert_base"].snapshot()
    assert snap["queue_hist"]["count"] == 4
    assert {"queue_ms", "device_ms", "total_ms"} <= set(snap)


def _check_metrics_mod():
    path = Path(__file__).resolve().parents[1] / "tools" / "check_metrics.py"
    spec = importlib.util.spec_from_file_location("tpuserve_check_metrics", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exposition_matches_checked_in_manifest():
    mod = _check_metrics_mod()
    text = _engine_render(_loaded_hub(), DeviceRunner, torch.device("cpu"))
    manifest = mod.load_manifest()
    assert mod.check(text, manifest) == []
    # The check bites: an undeclared family and a drifted label set.
    assert mod.check(text + "\n# TYPE tpuserve_rogue counter\ntpuserve_rogue 1\n", manifest)
    mutated = text.replace('tpuserve_requests_total{model="bert_base"}',
                           'tpuserve_requests_total{rogue="x"}', 1)
    assert any("label set" in p for p in mod.check(mutated, manifest))


def _traffic(hub, resilience_cls, cfg_cls, faults_cls):
    for model in ("bert_base", "gpt2"):
        ring = hub.ring(model)
        for i in range(3):
            ring.record(1.0 + i, 4.0 * i, 5.0 + i)
        ring.record_error()
    hub.resilience = resilience_cls(cfg_cls(breaker_threshold=0.5, breaker_min_samples=2))
    mr = hub.resilience.model("bert_base")
    mr.stats.retries, mr.stats.deadline_admission, mr.stats.breaker_fast_fails = 2, 1, 3
    mr.breaker.record(False)
    mr.breaker.record(False)
    hub.resilience.model("gpt2").breaker.record(True)
    hub.resilience.quarantined.add("bert_base")
    hub.faults = faults_cls()
    hub.faults.configure(model="bert_base", fail_every_n=1, kind="fatal")
    try:
        hub.faults.on_dispatch("bert_base")
    except RuntimeError:
        pass
    hub.watchdog = SimpleNamespace(snapshot=lambda: {
        "state": "gave_up", "attempts": 3, "max_attempts": 3, "recoveries_total": 1,
        "requeued_jobs_total": 0, "last_reason": "x", "last_recovery_ts": None})
    gen = _generation()
    # The reference's paged snapshot also carries speculation counters.
    hub.generation = (_generation if isinstance(hub, MetricsHub) else
                      lambda: {m: {**s, "spec": {"proposed": 0, "accepted": 0}}
                               if "kv" in s else s for m, s in gen.items()})
    return hub


def test_families_match_the_jax_hub_after_the_same_traffic():
    mod = _check_metrics_mod()
    port = _engine_render(_traffic(MetricsHub(), ResilienceHub, ServeConfig, FaultInjector),
                          DeviceRunner, torch.device("cpu"))
    ref = _engine_render(_traffic(JMetricsHub(), JResilienceHub, JServeConfig,
                                  JFaultInjector), JDeviceRunner)
    ptypes, pseries = mod.parse_exposition(port)
    rtypes, rseries = mod.parse_exposition(ref)
    shared = set(ptypes) & set(rtypes)
    assert len(shared) >= 35
    for family in sorted(shared):
        assert ptypes[family] == rtypes[family], family
        assert pseries[family] == rseries[family], family
    # What the port renders beyond the reference is nothing; what the
    # reference renders beyond the port is the planes it has not ported.
    assert set(ptypes) <= set(rtypes)
    assert set(rtypes) - set(ptypes) <= {"tpuserve_gauge", "tpuserve_spec_proposed_total",
                                         "tpuserve_spec_accepted_total"}


def test_served_exposition_passes_check_metrics():
    """``GET /metrics?format=prometheus`` from a server that answered real
    traffic (a predict, a 504, fault rules, a :generate stream on the paged
    lane with the prefix cache) fits the manifest, and JSON stays default."""
    arch = {"d_model": 32, "layers": 1, "heads": 2, "ffn_dim": 64, "vocab_size": 500,
            "max_positions": 64}
    bert = ModelConfig(name="bert_base", dtype="float32", seq_buckets=(8,), batch_buckets=(1,),
                       extra={"arch": {"num_layers": 1, "num_heads": 2, "head_dim": 16,
                                       "mlp_dim": 64, "vocab_size": 512, "max_position": 64},
                              "params_dtype": "int8"})
    gpt2 = ModelConfig(name="gpt2", dtype="float32", batch_buckets=(1,), seq_buckets=(16,),
                       kv_cache="paged", kv_block_size=4,
                       extra={"arch": arch, "max_new_tokens": 4, "gen_slots": 2,
                              "segment_tokens": 2})
    cfg = ServeConfig(models=[bert, gpt2], breaker_threshold=0.5, watchdog_interval_s=30.0)
    eng = build_engine(cfg, device="cpu")

    def post(port, path, body, headers=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json",
                                              **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    try:
        with BackgroundServer(cfg, eng) as srv:
            assert post(srv.port, "/v1/models/bert_base:predict", {"input_ids": [5, 6]})[0] == 200
            assert post(srv.port, "/v1/models/bert_base:predict", {"input_ids": [5]},
                        {"X-Deadline-Ms": "0"})[0] == 504
            assert post(srv.port, "/admin/faults", {"model": "gpt2", "latency_ms": 1})[0] == 200
            for _ in range(2):
                assert post(srv.port, "/v1/models/gpt2:generate",
                            {"input_ids": list(range(3, 12))})[0] == 200
            base = f"http://127.0.0.1:{srv.port}/metrics"
            with urllib.request.urlopen(base + "?format=prometheus") as r:
                assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
                text = r.read().decode()
            req = urllib.request.Request(base, headers={"Accept": "text/plain"})
            with urllib.request.urlopen(req) as r:
                assert r.read().decode().startswith("# HELP")
            with urllib.request.urlopen(base) as r:
                doc = json.loads(r.read())
    finally:
        eng.shutdown()
    mod = _check_metrics_mod()
    assert mod.check(text, mod.load_manifest()) == []
    for family in ("tpuserve_prefix_hits_total", "tpuserve_ttft_ms", "tpuserve_kv_blocks_used",
                   "tpuserve_deadline_exceeded_total", "tpuserve_recovery_state",
                   "tpuserve_faults_injected_total"):
        assert f"# TYPE {family} " in text, family
    assert {"resilience", "faults", "recovery", "models", "runner", "dispatch"} <= set(doc)


HOST_FAMILIES = ("tpuserve_loop_lag_ms", "tpuserve_loop_lag_max_ms", "tpuserve_ingest_ms",
                 "tpuserve_stack_samples_total", "tpuserve_perf_samples_per_s",
                 "tpuserve_perf_tokens_per_s", "tpuserve_perf_step_ms",
                 "tpuserve_perf_device_util_pct", "tpuserve_perf_mfu_pct",
                 "tpuserve_ingest_workers", "tpuserve_shm_ring_depth",
                 "tpuserve_shm_ring_occupancy_pct", "tpuserve_acceptor_accepts_total",
                 "tpuserve_acceptor_sheds_total", "tpuserve_acceptor_responses_total",
                 "tpuserve_acceptor_bytes_total", "tpuserve_acceptor_worker_up",
                 "tpuserve_acceptor_heartbeat_age_s", "tpuserve_acceptor_restarts_total",
                 "tpuserve_acceptor_inworker_ms", "tpuserve_acceptor_ring_wait_ms")


def _host_planes(hub, perf_mod, cfg_cls, tele):
    """The perf plane after injected lag, stages, stack samples and two
    gauge samples, and the fast path's snapshot of one worker's stats block
    and the pump's histograms, as the server wires them."""
    now = [0.0]
    perf = perf_mod.PerfPlane(cfg_cls())
    perf.loop_lag = perf_mod.LoopLagSampler(interval_s=0.25, clock=lambda: now[0])
    perf.loop_lag.arm()
    for dt in (0.25, 0.31, 0.26):
        now[0] += dt
        perf.loop_lag.note()
    for i, stage in enumerate(perf_mod.INGEST_STAGES):
        perf.note_stage("bert_base", stage, 0.05 * (i + 1))
    perf.stacks.sample_once(0.1)
    stats = {"bert_base": SimpleNamespace(samples=0, batches=0, device_seconds=0.0)}
    gens = {"gpt2": {"tokens_emitted": 0, "segment_rounds": 0}}
    perf.runner_stats, perf.gen_snapshots = (lambda: stats), (lambda: gens)
    perf.observe_models(now=0.0)
    stats["bert_base"] = SimpleNamespace(samples=80, batches=40, device_seconds=0.5)
    gens["gpt2"] = {"tokens_emitted": 96, "segment_rounds": 12}
    perf.observe_models(now=4.0)
    perf.flops_hint = lambda m: 22.3e9
    perf.peak_flops = 989.4e12
    hub.perf = perf
    blk = tele.WorkerStatsBlock(create=True)
    blk.inc("accepts", 5)
    blk.inc("bytes_in", 4096)
    blk.inc("bytes_out", 512)
    blk.inc("responses_ok", 4)
    blk.inc("responses_err")
    blk.note_shed(413)
    blk.observe_ms(0.3)
    blk.heartbeat()
    wait = tele.StatHist(tele.RING_WAIT_BUCKETS_MS)
    wait.observe(0.8)
    occ = tele.StatHist(tele.OCCUPANCY_BUCKETS_PCT)
    occ.observe(12.5)
    row = {"worker": 0, "up": True, **blk.snapshot()}
    hub.serverpath = lambda: {
        "ingest_workers": 1, "ring_depth": {"req:0": 1, "resp:0": 0},
        "binary_requests": {"bert_base": 3}, "wire_pool": {"free": 0, "hits": 0, "misses": 0},
        "acceptor": {"workers": [row], "restarts": 1, "ring_wait_ms": wait.snapshot(),
                     "ring_occupancy_pct": {"req:0": occ.snapshot()}}}
    blk.close()
    blk.unlink()
    return hub


def test_host_plane_families_match_the_jax_hub_and_the_manifest():
    """The perf plane's and the acceptors' families (``tpuserve_loop_lag_*``,
    ``tpuserve_ingest_ms``, ``tpuserve_perf_*``, ``tpuserve_ingest_workers``,
    ``tpuserve_shm_ring_*``, the nine ``tpuserve_acceptor_*``) render in the
    port with the reference's types and label sets, every one present and
    declared in the unedited manifest."""
    from pytorch_zappa_serverless_tpu.serving import acceptor_telemetry as JT
    from pytorch_zappa_serverless_tpu.serving import perfplane as JP
    from pytorch_zappa_serverless_tpu_torch.serving import acceptor_telemetry as PT
    from pytorch_zappa_serverless_tpu_torch.serving import perfplane as PP

    mod = _check_metrics_mod()
    port = _host_planes(MetricsHub(), PP, ServeConfig, PT).render_prometheus()
    ref = _host_planes(JMetricsHub(), JP, JServeConfig, JT).render_prometheus()
    assert mod.check(port, mod.load_manifest()) == []
    ptypes, pseries = mod.parse_exposition(port)
    rtypes, rseries = mod.parse_exposition(ref)
    for family in HOST_FAMILIES:
        assert family in ptypes, family
        assert ptypes[family] == rtypes[family], family
        assert pseries[family] == rseries[family], family
    assert 'tpuserve_acceptor_sheds_total{code="413",worker="0"} 1' in port
    assert "tpuserve_acceptor_restarts_total 1" in port
    assert 'tpuserve_ingest_ms_count{model="bert_base",stage="ring_wait"} 1' in port
    assert 'tpuserve_perf_samples_per_s{model="bert_base"} 20.0' in port
    for name in ("loop_lag_max_ms", "perf_step_ms", "perf_mfu_pct", "shm_ring_depth"):
        pl = sorted(ln for ln in port.splitlines() if ln.startswith(f"tpuserve_{name}"))
        rl = sorted(ln for ln in ref.splitlines() if ln.startswith(f"tpuserve_{name}"))
        assert pl == rl, name
