"""The bench's serving plane sections at narrow widths on the CPU: each
runs through the port's server and client and keeps the keys and verdicts
the reference's smoke of the same section asserts (``test_perfplane.py``
for ``serverpath``, ``test_lifecycle.py``, ``test_adapters.py``,
``test_qos.py``'s mixed HTTP twin), or, where the reference has none, the
section's own claims (``trace_path``, ``variants``, ``fleet``,
``recovery``).  ``mixed_path`` and the kill -9 hooks are ``slow``, as the
reference's mixed HTTP test and ``test_torch_fleet_crash.py`` are."""

import pytest

from pytorch_zappa_serverless_tpu_torch import benchmark as B
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig


def run(name: str, **kw) -> dict:
    """``bench_<name>`` on the CPU."""
    return getattr(B, f"bench_{name}")(device="cpu", **kw)


@pytest.fixture
def narrow_resnet50(monkeypatch):
    """``trace_path``'s ResNet-50 at 64 px in float32 (the section has no
    tiny knob: its full width is the card's)."""
    monkeypatch.setattr(B, "_resnet50_served", lambda kw=None: ModelConfig(
        name="resnet50", batch_buckets=(1, 4), coalesce_ms=3.0, dtype="float32",
        extra={"image_size": 64, "resize_to": 72}))


def test_trace_path_attributes_every_stage(narrow_resnet50):
    out = run("trace_path", n_requests=8, concurrency=4)
    assert out["model"] == "resnet50" and out["n_traces"] == 8
    assert out["coverage_p50_pct"] >= 95.0, out
    for stage in ("admission", "queue", "device", "respond"):
        assert out[f"{stage}_p99_ms"] >= out[f"{stage}_p50_ms"] >= 0.0
    assert out["device_p50_ms"] > 0
    assert out["slowest_total_ms"] > 0
    assert out["slowest_waterfall"][0].startswith("predict resnet50 trace ")
    assert any(line.startswith("stages: ") for line in out["slowest_waterfall"])
    assert "launches" not in out  # the CPU's plain versions count nothing


def test_serverpath_tiny_smoke(monkeypatch):
    """The reference smoke's bar: the stage table tiles >= 95 % of the
    http-to-device gap, the substages price the JSON lane, the on/off pair
    reports, and the fast lane holds the same bar with the worker substages
    priced."""
    monkeypatch.setenv("BENCH_SERVERPATH_TINY", "1")
    out = run("serverpath")
    assert out["tiny"] is True and out["model"] == "resnet18"
    assert out["n_traces"] >= 1
    assert out["gap_coverage_p50_pct"] >= 95.0, out
    assert out["coverage_p50_pct"] >= 95.0
    for stage in ("payload_read", "json_decode", "b64_decode", "validate", "serialize"):
        assert stage in out["substage_p50_ms"], out
    assert {"admission", "queue", "device", "respond"} <= set(out["stage_p50_ms"])
    assert "overhead_pct" in out and out["perfplane_off_p50_ms"] > 0
    assert "ingest_p50_ms" in out and "batch_form" in out["ingest_p50_ms"]
    assert out["fast_lane_gap_coverage_p50_pct"] >= 95.0, out
    for sub in ("sock_read", "frame_validate", "ring_wait", "binary_decode"):
        assert sub in out["fast_lane_substage_p50_ms"], out
    assert out["fast_lane_rps_on"] > 0 and out["fast_lane_rps_off"] > 0
    assert set(out["lanes"]) == {"json_b64", "raw_image", "binary"}
    assert all(lane["ok"] == out["n_requests"] for lane in out["lanes"].values())
    assert out["binary_rps_vs_json"] > 0


def test_lifecycle_emits_the_activation_ladder():
    """The reference's ladder less ``warm_cache`` (no compile cache), with
    the disk tier streamed: a host-tier restore never costs what a cold
    build does, and steady state is the same path warm."""
    out = run("lifecycle", trials=1, steady_requests=4)
    for key in ("cold_activation_p50_ms", "cold_activation_p99_ms",
                "resident_activation_p50_ms", "resident_activation_p99_ms",
                "steady_p50_ms", "steady_p99_ms", "steady_eager_p50_ms",
                "streamed_cold_activation_p50_ms", "cold_load_ms_p50", "cold_compile_ms_p50"):
        assert out[key] is not None and out[key] > 0, (key, out)
    assert not {"warm_cache_activation_p50_ms", "warm_cache_activation_p99_ms"} & set(out)
    assert out["resident_activation_p50_ms"] < out["cold_activation_p50_ms"]
    assert out["steady_p50_ms"] < out["steady_eager_p50_ms"] * 3 + 50.0


def test_variants_degrade_where_exact_requests_shed():
    """Under the step overload the exact requests shed on the forecast
    while the family-addressed ones degrade to the lite rung and serve,
    each inside 4x its objective."""
    out = run("variants", n_requests=6)
    assert out["exact_idle_p50_ms"] > 0 and out["family_idle_p50_ms"] > 0
    assert out["overload_served_fraction_exact"] == 0.0, out
    assert out["overload_served_fraction_family"] == 1.0, out
    assert out["overload_degraded_fraction_family"] == 1.0
    assert out["objective_bound_misses"] == 0
    assert out["overload_taught_requests"] >= 3


def test_adapters_tiny_smoke(monkeypatch):
    monkeypatch.setenv("BENCH_ADAPTERS_TINY", "1")
    out = run("adapters", n_requests=4)
    for key in ("attach_p50_ms", "attach_p99_ms", "base_predict_p50_ms",
                "mixed_adapter_predict_p50_ms", "scale_to_zero_cold_hit_p50_ms"):
        assert out[key] is not None and out[key] > 0, (key, out)
    assert out["multi_adapter_batches"] >= 0 and out["adapters"] == 3


def _check_fleet(out: dict) -> None:
    for key in ("direct_p50_ms", "direct_p99_ms", "routed_p50_ms", "routed_p99_ms",
                "failover_p50_ms", "failover_p99_ms"):
        assert out[key] > 0, (key, out)
    assert out["router_tax_p50_ms"] == round(out["routed_p50_ms"] - out["direct_p50_ms"], 3)
    assert out["failover_added_p50_ms"] == round(
        out["failover_p50_ms"] - out["routed_p50_ms"], 3)


def test_fleet_routes_and_fails_over(monkeypatch):
    """Direct, routed and failed-over predicts; the replica-kill hook is
    stubbed here (it runs in the ``slow`` test below)."""
    from pytorch_zappa_serverless_tpu_torch.tools import crashtest

    seen = []
    monkeypatch.setattr(crashtest, "run_fleet_crashtest", lambda td, n_jobs, platform: (
        seen.append((n_jobs, platform)) or {"first_failover_s": 1.0, "kill_to_readmit_s": 2.0,
                                            "lost": 0, "deduped_resubmits": 6}))
    out = run("fleet", n_requests=6)
    _check_fleet(out)
    assert seen == [(6, "cpu")]
    assert out["replica_kill"] == {"first_failover_s": 1.0, "kill_to_readmit_s": 2.0,
                                   "zero_loss": True, "deduped_resubmits": 6}


@pytest.mark.slow
def test_fleet_with_its_replica_kill():
    out = run("fleet", n_requests=4)
    _check_fleet(out)
    kill = out["replica_kill"]
    assert kill["zero_loss"] is True, out
    assert kill["first_failover_s"] > 0 and kill["kill_to_readmit_s"] > 0


@pytest.mark.slow
def test_recovery_hook_loses_nothing():
    out = run("recovery")
    assert out["zero_loss"] is True and out["lost"] == 0, out
    assert out["restart_ready_s"] > 0 and out["replay_ms"] >= 0
    assert out["platform"] == "cpu"


@pytest.mark.slow
def test_mixed_path_tiny_phases(monkeypatch):
    """The tiny twin of the mixed section (the reference's is
    ``test_qos.py``'s mixed HTTP test): predicts stay green in every phase
    while SD-1.5 jobs complete beside them, chunked and monolithic."""
    for k, v in {"BENCH_MIXED_TINY": "1", "BENCH_MIXED_REQS": "6", "BENCH_MIXED_SD_STEPS": "4",
                 "BENCH_MIXED_SD_CHUNK": "2"}.items():
        monkeypatch.setenv(k, v)
    out = run("mixed_path")
    assert set(out["phases"]) == {"isolated", "mixed_qos", "mixed_fifo_chunked",
                                  "mixed_fifo_mono"}
    for name, ph in out["phases"].items():
        assert ph["resnet18"]["n"] + ph["n_429"] == 6, (name, ph)
        assert ph["resnet18"]["wall_p99_ms"] >= ph["resnet18"]["wall_p50_ms"] > 0
        if name != "isolated":
            assert ph["sd15_jobs_completed"] >= 1, (name, ph)
    assert not set(B.DROPPED) & set(out)  # no relay floor
    assert out["sd15_chunks_per_image"] == 2
    assert out["sd15_graphs_per_job"] == {"chunked": 4, "mono": 1}
    assert out["phases"]["mixed_fifo_mono"]["first_job_s"] > 0
    assert out["lane_wait"]["throughput"]["dispatches"] >= 1
    for key in ("isolated_wall_p99_ms", "mixed_qos_wall_p99_ms", "mixed_qos_queue_p99_ms",
                "mixed_fifo_mono_wall_p99_ms"):
        assert out[key] > 0
