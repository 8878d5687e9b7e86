"""The port's config loader against the JAX package's: ``TPUSERVE_*`` env
overrides and the dev profile that boots with no file.

The port's ``ServeConfig`` carries a subset of the reference's fields (the
ones it reads so far), under the same names and defaults; on that subset the
two loaders must agree exactly, env overrides included.
"""

import dataclasses

import pytest

from pytorch_zappa_serverless_tpu import config as JC
from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch import models as _port_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu_torch.utils.registry import list_models

SHARED = [f.name for f in dataclasses.fields(PC.ServeConfig) if f.name != "models"]
# One value per field, as an operator would write it in the environment.
ENV_VALUES = {"profile": "prod", "host": "0.0.0.0", "port": "9123",
              "warmup_at_boot": "false", "priority_dispatch": "0",
              "job_max_backlog": "7", "job_keep_done": "3", "job_result_ttl_s": "7.5",
              "job_max_result_mb": "12"}


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
    """The reference reads ``TPUSERVE_MESH`` as a JSON object and raises on
    anything else; the port has no mesh field yet, so the variable names no
    field of it and is not read."""
    environ = {"TPUSERVE_MESH": "[4, 2]"}
    with pytest.raises(ValueError, match="JSON object"):
        JC.apply_env_overrides(JC.ServeConfig(), environ)
    assert "mesh" not in SHARED
    got = PC.apply_env_overrides(PC.ServeConfig(), environ)
    assert not hasattr(got, "mesh")


def test_default_config_is_the_reference_dev_profile_filtered_by_the_port_registry():
    got, want = PC.default_config(), JC.default_config()
    registered = set(list_models())
    kept = [m for m in want.models if (m.builder or m.name) in registered]
    assert [m.name for m in got.models] == [m.name for m in kept] == ["bert_base", "gpt2",
                                                                       "sd15"]
    port_fields = [f.name for f in dataclasses.fields(PC.ModelConfig)]
    for g, w in zip(got.models, kept):
        for name in port_fields:
            assert getattr(g, name) == getattr(w, name), (g.name, name)
    for name in SHARED:
        assert getattr(got, name) == getattr(want, name), name
    assert got.model("gpt2").extra["params_dtype"] == "bfloat16"
    assert got.model("sd15").extra["variant"] == "tiny"


def test_load_config_without_a_file_is_the_dev_profile(monkeypatch):
    for name in SHARED:
        monkeypatch.delenv(_env(name), raising=False)
    cfg = PC.load_config()
    assert cfg == PC.default_config()
    assert cfg.profile == "dev" and not cfg.warmup_at_boot
