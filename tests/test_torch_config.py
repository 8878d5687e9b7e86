"""The port's config loader against the JAX package's: ``TPUSERVE_*`` env
overrides and the dev profile that boots with no file.

The port's ``ServeConfig`` carries a subset of the reference's fields (the
ones it reads so far), under the same names and defaults; on that subset the
two loaders must agree exactly, env overrides included.
"""

import dataclasses
import json

import pytest

from pytorch_zappa_serverless_tpu import config as JC
from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch import models as _port_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu_torch.utils.registry import list_models

# Structured fields are file-only in both packages.
SHARED = [f.name for f in dataclasses.fields(PC.ServeConfig)
          if f.name not in ("models", "faults", "slo", "fleet")]
# One value per field, as an operator would write it in the environment.
ENV_VALUES = {"profile": "prod", "host": "0.0.0.0", "port": "9123",
              "warmup_at_boot": "false", "priority_dispatch": "0",
              "job_max_backlog": "7", "job_keep_done": "3", "job_result_ttl_s": "7.5",
              "job_max_result_mb": "12", "dispatch_probe_timeout_s": "30",
              "deadline_default_ms": "250", "deadline_max_ms": "5000",
              "retry_max_attempts": "2", "retry_base_ms": "5", "retry_max_ms": "200",
              "breaker_threshold": "0.5", "breaker_window": "8",
              "breaker_min_samples": "4", "breaker_open_s": "2.5",
              "drain_timeout_s": "20", "watchdog_interval_s": "0.5",
              "recover_max_attempts": "5", "recover_backoff_s": "0.25",
              "lazy_load": "true", "idle_unload_s": "6", "hbm_budget_bytes": "1000000",
              "host_idle_drop_s": "30", "host_budget_bytes": "2000000",
              "ckpt_store_dir": "/srv/tpuserve/store", "ckpt_chunk_bytes": "65536",
              "lifecycle_tick_s": "0.25", "activation_max_wait_s": "30",
              "activation_estimate_ms": "2500", "adapter_idle_unload_s": "-1",
              "adapter_attach_estimate_ms": "125.5",
              "journal_dir": "/srv/tpuserve/journal", "journal_fsync": "interval",
              "trace_ring": "64", "trace_flight_slow": "2", "trace_flight_errors": "5",
              "trace_max_spans": "128", "trace_dir": "/srv/tpuserve/traces",
              "binary_lane": "false", "tensor_max_bytes": "4096",
              "autoscale": "histogram", "autoscale_tick_s": "0.5", "keepwarm_quantile": "0.9",
              "keepwarm_min_s": "2", "keepwarm_max_s": "120", "autoscale_min_history": "4",
              "prewarm_margin_s": "0.5", "autoscale_mispredict_limit": "2",
              "autoscale_reactive_hold_s": "10", "brownout": "forced",
              "brownout_exit_ticks": "5", "brownout_min_hold_s": "2.5",
              "slo_latency_objective_ms": "250", "slo_availability_target": "0.99",
              "slo_fast_window_s": "60", "slo_slow_window_s": "600",
              "slo_fast_burn_alarm": "10", "slo_slow_burn_alarm": "3",
              "perfplane": "false", "perf_loop_lag_interval_s": "0.1", "perf_stack_hz": "0",
              "perf_stack_topk": "16", "perf_window_s": "10", "ingest_workers": "2",
              "ingest_port": "9124", "shm_ring_slots": "32",
              "shm_ring_slot_bytes": "2097152", "mesh": '{"data": 4, "model": 2}',
              "coordinator_address": "10.0.0.1:8476", "num_processes": "2",
              "process_id": "1", "supervise_interval_s": "5",
              "supervise_fail_threshold": "4", "heartbeat_interval_s": "30",
              "exit_on_fatal": "false"}


def _env(name):
    return "TPUSERVE_" + name.upper()


def test_every_shared_field_has_the_reference_default():
    ref = {f.name: f for f in dataclasses.fields(JC.ServeConfig)}
    for f in dataclasses.fields(PC.ServeConfig):
        assert f.name in ref
        assert f.default == ref[f.name].default, f.name
    assert set(SHARED) == set(ENV_VALUES)


@pytest.mark.parametrize("field", SHARED)
def test_env_override_matches_reference(field):
    environ = {_env(field): ENV_VALUES[field]}
    got = PC.apply_env_overrides(PC.ServeConfig(), environ)
    want = JC.apply_env_overrides(JC.ServeConfig(), environ)
    assert getattr(got, field) == getattr(want, field)
    assert type(getattr(got, field)) is type(getattr(want, field))
    assert getattr(got, field) != getattr(PC.ServeConfig(), field)


def test_faults_and_deadline_fields_match_the_reference():
    """The resilience slice's structured and per-model fields: ``faults`` is
    file-only (an env var leaves it alone in both packages) and
    ``ModelConfig.deadline_ms`` has the reference's default."""
    environ = {"TPUSERVE_FAULTS": '{"m": {"fail_every_n": 1}}'}
    assert PC.apply_env_overrides(PC.ServeConfig(), environ).faults == {}
    assert JC.apply_env_overrides(JC.ServeConfig(), environ).faults == {}
    assert PC.ModelConfig(name="m").deadline_ms == JC.ModelConfig(name="m").deadline_ms == 0.0


def test_float_field_loaded_as_int_takes_a_float_override(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    path.write_text("port: 9001\njob_result_ttl_s: 20\nmodels: []\n")
    monkeypatch.setenv("TPUSERVE_JOB_RESULT_TTL_S", "7.5")
    got, want = PC.load_config(path), JC.load_config(path)
    assert got.job_result_ttl_s == want.job_result_ttl_s == 7.5
    assert got.port == want.port == 9001


def test_port_env_var_in_both_packages(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUSERVE_PORT", "9123")
    assert PC.load_config().port == JC.load_config().port == 9123
    path = tmp_path / "cfg.json"
    path.write_text('{"profiles": {"dev": {"port": 8001}}}')
    assert PC.load_config(path).port == JC.load_config(path).port == 9123
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert PC.load_config(empty).port == JC.load_config(empty).port == 9123


def test_structured_fields_are_file_only():
    environ = {"TPUSERVE_MODELS": '[{"name": "gpt2"}]', "TPUSERVE_FLEET": '{"spawn": 2}',
               "TPUSERVE_FAULTS": "[]", "TPUSERVE_SLO": "{}"}
    got = PC.apply_env_overrides(PC.ServeConfig(), environ)
    want = JC.apply_env_overrides(JC.ServeConfig(), environ)
    assert got.models == want.models == []
    assert dataclasses.asdict(got) == dataclasses.asdict(PC.ServeConfig())


def test_bad_mesh_raises_in_the_reference_and_the_port_has_no_mesh():
    """Both packages read ``TPUSERVE_MESH`` as a JSON object and raise on
    anything else (the port serves the mesh since parallel/ landed)."""
    environ = {"TPUSERVE_MESH": "[4, 2]"}
    with pytest.raises(ValueError, match="JSON object"):
        JC.apply_env_overrides(JC.ServeConfig(), environ)
    assert "mesh" in SHARED
    with pytest.raises(ValueError, match="JSON object"):
        PC.apply_env_overrides(PC.ServeConfig(), environ)


def test_default_config_is_the_reference_dev_profile_filtered_by_the_port_registry():
    got, want = PC.default_config(), JC.default_config()
    registered = set(list_models())
    kept = [m for m in want.models if (m.builder or m.name) in registered]
    assert [m.name for m in got.models] == [m.name for m in kept] == [
        "resnet18", "resnet50", "efficientnet_b0", "vit_b16", "bert_base", "whisper_tiny",
        "gpt2", "sd15"]
    port_fields = [f.name for f in dataclasses.fields(PC.ModelConfig)]
    for g, w in zip(got.models, kept):
        for name in port_fields:
            assert getattr(g, name) == getattr(w, name), (g.name, name)
    for name in SHARED:
        assert getattr(got, name) == getattr(want, name), name
    assert dataclasses.asdict(got.fleet) == dataclasses.asdict(want.fleet)
    assert got.model("gpt2").extra["params_dtype"] == "bfloat16"
    assert got.model("sd15").extra["variant"] == "tiny"


def test_load_config_without_a_file_is_the_dev_profile(monkeypatch):
    for name in SHARED:
        monkeypatch.delenv(_env(name), raising=False)
    cfg = PC.load_config()
    assert cfg == PC.default_config()
    assert cfg.profile == "dev" and not cfg.warmup_at_boot


GEN_FIELDS = ("kv_cache", "kv_block_size", "kv_num_blocks", "prefill_chunk_tokens",
              "spec_draft", "spec_k", "prefix_cache", "prefix_cache_ttl_s",
              "prefix_cache_blocks", "kv_migrate")


@pytest.mark.parametrize("field", GEN_FIELDS)
def test_generate_lane_fields_have_the_reference_defaults(field):
    ref = {f.name: f for f in dataclasses.fields(JC.ModelConfig)}
    port = {f.name: f for f in dataclasses.fields(PC.ModelConfig)}
    assert port[field].default == ref[field].default
    assert type(port[field].default) is type(ref[field].default)


@pytest.mark.parametrize("values", [
    {"kv_cache": "paged", "kv_block_size": 8, "kv_num_blocks": 64, "prefill_chunk_tokens": 32},
    {"prefix_cache": False, "prefix_cache_ttl_s": 12.5, "prefix_cache_blocks": 16},
])
def test_profile_loads_the_generate_fields_as_the_reference(tmp_path, values):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"models": [{"name": "gpt2", **values}]}))
    got, want = PC.load_config(path).models[0], JC.load_config(path).models[0]
    for field in GEN_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    for field, value in values.items():
        assert getattr(got, field) == value


@pytest.mark.parametrize("over,match", [({"spec_draft": "auto"}, "paged lane"),
                                        ({"kv_cache": "blocks"}, "'slot' or 'paged'")])
def test_generate_fields_the_port_refuses(over, match):
    """The reference's config takes these; the port refuses at load what
    its server would refuse at boot: speculation, "auto" included, off the
    paged lane, and an unknown KV engine."""
    JC.ModelConfig(name="gpt2", **over)  # the reference takes them
    with pytest.raises(ValueError, match=match):
        PC.ModelConfig(name="gpt2", **over)


def test_spec_draft_auto_loads_as_the_reference_and_names_the_lowest_rung(tmp_path):
    """``spec_draft: "auto"`` with the variant fields loads to the same
    values in both packages, and the family ladder's lowest rung is the
    draft it resolves to, in both."""
    from pytorch_zappa_serverless_tpu.serving import variants as JV
    from pytorch_zappa_serverless_tpu_torch.serving import variants as PV

    models = [{"name": "gpt2_bf16", "family": "gpt2x", "quality_rank": 2, "cost_hint_ms": 30.5,
               "kv_cache": "paged", "spec_draft": "auto"},
              {"name": "gpt2_int8", "builder": "gpt2", "family": "gpt2x", "quality_rank": 1,
               "kv_cache": "paged"},
              {"name": "gpt2_mid", "builder": "gpt2", "family": "gpt2x", "quality_rank": 1}]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"models": models}))
    got, want = PC.load_config(path), JC.load_config(path)
    for g, w in zip(got.models, want.models, strict=True):
        for field in ("family", "quality_rank", "cost_hint_ms", "spec_draft", "builder"):
            assert getattr(g, field) == getattr(w, field), field
    assert got.models[0].spec_draft == "auto"
    rungs = [[m.name for m in R(cfg.models).ladder("gpt2x")]
             for R, cfg in ((PV.FamilyRegistry, got), (JV.FamilyRegistry, want))]
    assert rungs[0] == rungs[1] == ["gpt2_bf16", "gpt2_int8", "gpt2_mid"]
    assert rungs[0][-1] == "gpt2_mid"  # quality-descending, name-tied


@pytest.mark.parametrize("over", [
    {"spec_k": 2},
    {"kv_cache": "paged", "spec_draft": "gpt2_draft", "spec_k": 6},
    {"kv_cache": "paged", "kv_migrate": False},
])
def test_speculation_and_migration_fields_the_port_takes(tmp_path, over):
    """Served since the port has speculation and live migration: a profile
    that sets them loads in both packages to the same values."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"models": [{"name": "gpt2", **over}]}))
    got, want = PC.load_config(path).models[0], JC.load_config(path).models[0]
    for field, value in over.items():
        assert getattr(got, field) == getattr(want, field) == value


@pytest.mark.parametrize("over,match", [
    ({"spec_draft": "gpt2"}, "different deploy"),
    ({"spec_draft": "gpt2_draft"}, "paged lane"),
    ({"kv_cache": "paged", "spec_k": 0}, "spec_k"),
])
def test_speculation_settings_the_port_refuses(over, match):
    """A model drafting for itself (the reference's server refuses it too),
    speculation off the paged lane (the reference runs it on paged lanes
    only) and a non-positive spec_k fail at load."""
    with pytest.raises(ValueError, match=match):
        PC.ModelConfig(name="gpt2", **over)


RESIDENCY = ("lazy_load", "idle_unload_s", "hbm_budget_bytes", "host_idle_drop_s",
             "host_budget_bytes", "ckpt_store_dir", "ckpt_chunk_bytes", "lifecycle_tick_s",
             "activation_max_wait_s", "activation_estimate_ms")


def test_profile_loads_the_residency_fields_as_the_reference(tmp_path):
    """A reference profile with every residency knob and the per-model
    lazy_load/pinned loads in the port with the same values; left out, the
    reference's defaults."""
    values = {"lazy_load": True, "idle_unload_s": 2.0, "hbm_budget_bytes": 1 << 30,
              "host_idle_drop_s": 8.0, "host_budget_bytes": 1 << 31,
              "ckpt_store_dir": str(tmp_path / "store"), "ckpt_chunk_bytes": 1 << 18,
              "lifecycle_tick_s": 0.1, "activation_max_wait_s": 60.0,
              "activation_estimate_ms": 4000.0}
    models = [{"name": "bert_base", "pinned": True}, {"name": "gpt2", "lazy_load": True},
              {"name": "resnet50", "lazy_load": False}]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({**values, "models": models}))
    got, want = PC.load_config(path), JC.load_config(path)
    for field in RESIDENCY:
        assert getattr(got, field) == getattr(want, field) == values[field], field
    for g, w in zip(got.models, want.models):
        assert (g.lazy_load, g.pinned) == (w.lazy_load, w.pinned)
    path.write_text(json.dumps({"models": [{"name": "gpt2"}]}))
    got, want = PC.load_config(path), JC.load_config(path)
    for field in RESIDENCY:
        assert getattr(got, field) == getattr(want, field), field
    assert (got.models[0].lazy_load, got.models[0].pinned) == (None, False)
    assert (want.models[0].lazy_load, want.models[0].pinned) == (None, False)


@pytest.mark.parametrize("glob,own,pinned,lazy", [
    (False, None, False, False), (True, None, False, True), (True, False, False, False),
    (False, True, False, True), (True, True, True, False)])
def test_lazy_effective_matches_the_reference(glob, own, pinned, lazy):
    from pytorch_zappa_serverless_tpu.engine.loader import lazy_effective as j_lazy
    from pytorch_zappa_serverless_tpu_torch.engine.loader import lazy_effective

    mc = dict(name="m", lazy_load=own, pinned=pinned)
    assert lazy_effective(PC.ServeConfig(lazy_load=glob), PC.ModelConfig(**mc)) is lazy
    assert j_lazy(JC.ServeConfig(lazy_load=glob), JC.ModelConfig(**mc)) is lazy


def test_profile_loads_the_request_plane_fields_as_the_reference(tmp_path):
    values = {"journal_dir": str(tmp_path / "j"), "journal_fsync": "never",
              "trace_ring": 32, "trace_flight_slow": 3, "trace_flight_errors": 4,
              "trace_max_spans": 64, "trace_dir": str(tmp_path / "t"),
              "binary_lane": False, "tensor_max_bytes": 1 << 20}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"default_profile": "p", "profiles": {"p": values}}))
    got, want = PC.load_config(path), JC.load_config(path)
    for field, value in values.items():
        assert getattr(got, field) == getattr(want, field) == value, field


def test_profiler_port_is_refused_by_name(tmp_path):
    """The reference's jax.profiler live-server port has no torch
    counterpart: the port refuses it with an error that names it, not a
    bare TypeError."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"profiler_port": 9012, "models": []}))
    assert JC.load_config(path).profiler_port == 9012
    with pytest.raises(ValueError, match="profiler_port"):
        PC.load_config(path)


PLANES = {"brownout": "forced", "brownout_exit_ticks": 4, "brownout_min_hold_s": 1.5,
          "slo": {"gpt2x": {"latency_objective_ms": 250.0}, "gpt2:t0": {"availability_target": 0.99}},
          "slo_latency_objective_ms": 500.0, "slo_availability_target": 0.995,
          "slo_fast_window_s": 30.0, "slo_slow_window_s": 300.0, "slo_fast_burn_alarm": 7.0,
          "slo_slow_burn_alarm": 2.0, "autoscale": "histogram", "autoscale_tick_s": 0.25,
          "keepwarm_quantile": 0.9, "keepwarm_min_s": 0.5, "keepwarm_max_s": 60.0,
          "autoscale_min_history": 3, "prewarm_margin_s": 0.25,
          "autoscale_mispredict_limit": 2, "autoscale_reactive_hold_s": 8.0}


def test_profile_loads_the_tenancy_and_control_plane_fields_as_the_reference(tmp_path):
    """The 19 fields of the variant, SLO and autoscale planes, and the
    variant fields of a model, load to the same values in both packages;
    left out, both take the reference's defaults."""
    models = [{"name": "gpt2", "family": "gpt2x", "quality_rank": 3, "cost_hint_ms": 12.5}]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({**PLANES, "models": models}))
    got, want = PC.load_config(path), JC.load_config(path)
    assert len(PLANES) == 19
    for field, value in PLANES.items():
        assert getattr(got, field) == getattr(want, field) == value, field
    for field in ("family", "quality_rank", "cost_hint_ms"):
        assert getattr(got.models[0], field) == getattr(want.models[0], field)
    path.write_text(json.dumps({"models": [{"name": "gpt2"}]}))
    got, want = PC.load_config(path), JC.load_config(path)
    for field in PLANES:
        assert getattr(got, field) == getattr(want, field), field
    assert (got.models[0].family, got.models[0].quality_rank,
            got.models[0].cost_hint_ms) == ("", 0, 0.0)


HOST_PLANES = {"perfplane": False, "perf_loop_lag_interval_s": 0.1, "perf_stack_hz": 3.0,
               "perf_stack_topk": 8, "perf_window_s": 12.5, "ingest_workers": 2,
               "ingest_port": 18001, "shm_ring_slots": 32, "shm_ring_slot_bytes": 1 << 21}


def test_profile_loads_the_perf_and_ingest_fields_as_the_reference(tmp_path):
    """The 9 fields of the perf plane and the acceptor workers load to the
    same values in both packages, and left out take the reference's
    defaults; the refused fields stay as they were."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({**HOST_PLANES, "models": []}))
    got, want = PC.load_config(path), JC.load_config(path)
    assert len(HOST_PLANES) == 9
    for field, value in HOST_PLANES.items():
        assert getattr(got, field) == getattr(want, field) == value, field
    path.write_text(json.dumps({"models": []}))
    got, want = PC.load_config(path), JC.load_config(path)
    for field in HOST_PLANES:
        assert getattr(got, field) == getattr(want, field), field
    assert (got.perfplane, got.ingest_workers, got.shm_ring_slots,
            got.shm_ring_slot_bytes) == (True, 0, 256, 1 << 20)
    assert set(PC.REFUSED_FIELDS) == {"profiler_port", "compile_cache_dir"}


# -- the mesh and multi-host fields (parallel/) --------------------------------

WORLD_FIELDS = ("mesh", "coordinator_address", "num_processes", "process_id",
                "supervise_interval_s", "supervise_fail_threshold", "heartbeat_interval_s",
                "exit_on_fatal")


@pytest.mark.parametrize("field", WORLD_FIELDS)
def test_world_field_has_the_reference_default(field):
    got, want = PC.ServeConfig(), JC.ServeConfig()
    assert getattr(got, field) == getattr(want, field), field
    assert type(getattr(got, field)) is type(getattr(want, field))
    assert field not in PC.REFUSED_FIELDS


@pytest.mark.parametrize("raw,want", [('{"data": 4, "model": 2}', {"data": 4, "model": 2}),
                                      ('{"model": "2"}', {"model": 2}), ("{}", {})])
def test_mesh_env_is_a_json_object_in_both_packages(raw, want):
    environ = {"TPUSERVE_MESH": raw}
    assert PC.apply_env_overrides(PC.ServeConfig(), environ).mesh == want
    assert JC.apply_env_overrides(JC.ServeConfig(), environ).mesh == want


def test_world_fields_load_from_a_profile_as_the_reference(tmp_path):
    path = tmp_path / "cfg.json"
    body = {"mesh": {"data": 2, "model": 2}, "coordinator_address": "10.0.0.1:8476",
            "num_processes": 2, "process_id": 1, "supervise_interval_s": 5.0,
            "supervise_fail_threshold": 2, "heartbeat_interval_s": 30.0,
            "exit_on_fatal": False}
    path.write_text(json.dumps({**body, "models": []}))
    got, want = PC.load_config(path), JC.load_config(path)
    for field, value in body.items():
        assert getattr(got, field) == getattr(want, field) == value, field
