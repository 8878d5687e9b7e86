"""The port's deployment entry: ``cli deploy`` (``deploy/render.py``),
``config.dump_config`` and ``cli stage`` (``deploy/stage.py``), against the
JAX package's ``tests/test_cli_deploy.py`` and its ``deploy/stage.py``.

Staging then building from the staged ``config.json`` must serve what the
unstaged build serves, byte for byte (every family's seeded tree is its own
across both builds); the quantized lanes stage their float tree and
re-quantize at boot.  Across packages: a staged tree loads in the other
package's ``load_native`` to equal arrays, and the tiny SD-1.5 staged by
both (the same ``default_rng`` init, or the same diffusers directory) is
byte-equal.  The stated differences: ``config.json`` (JSON) where the
reference writes ``config.yaml``; a list ``extra.labels`` stays in the
staged config (the reference raises ``TypeError``); a config the JAX package
dumps is refused by name (it carries ``compile_cache_dir`` and ``mesh``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.config import ServeConfig as JServeConfig
from pytorch_zappa_serverless_tpu.config import dump_config as j_dump_config
from pytorch_zappa_serverless_tpu.config import load_config as j_load_config
from pytorch_zappa_serverless_tpu.deploy.stage import stage_assets as j_stage_assets
from pytorch_zappa_serverless_tpu.engine import weights as JW
from pytorch_zappa_serverless_tpu_torch import models as _port_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu_torch.cli import main
from pytorch_zappa_serverless_tpu_torch.config import (REFUSED_FIELDS, FleetConfig, ModelConfig,
                                                       ServeConfig, default_config, dump_config,
                                                       load_config)
from pytorch_zappa_serverless_tpu_torch.deploy.render import BASE_IMAGE, render_deploy
from pytorch_zappa_serverless_tpu_torch.deploy.stage import stage_assets
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder as p_builder
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_tree_fn
from sd_diffusers import write_diffusers_dir

GPT2_ARCH = {"vocab_size": 512, "d_model": 128, "layers": 2, "heads": 2, "ffn_dim": 256,
             "max_positions": 64, "eos_id": 511}
WHISPER_ARCH = {"d_model": 128, "encoder_layers": 2, "decoder_layers": 2, "heads": 2,
                "ffn_dim": 256, "vocab_size": 512, "target_positions": 96}
BERT_ARCH = {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64, "vocab_size": 512}
SD_TINY = {"variant": "tiny", "height": 64, "width": 64, "num_steps": 3}


def _same_tree(got, want):
    got, want = PW.flatten_tree(got), PW.flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), k


def _write_json(path, cfg: dict):
    path.write_text(json.dumps(cfg))
    return path


# -- render -------------------------------------------------------------------

def test_render_deploy(tmp_path):
    cfg = ServeConfig(profile="prod", port=8080)
    summary = render_deploy(cfg, target="cloudrun", out_dir=tmp_path)
    assert set(summary["files"]) == {"Dockerfile", "config.json", "service.yaml",
                                     "undeploy.sh", "warmpool.sh"}
    docker = (tmp_path / "Dockerfile").read_text()
    assert "EXPOSE 8080" in docker and f"FROM {BASE_IMAGE}" in docker and "nvcc" in docker
    assert "COPY pytorch_zappa_serverless_tpu_torch " in docker
    assert "pip install" not in docker and "COMPILE_CACHE" not in docker
    assert ('"pytorch_zappa_serverless_tpu_torch.cli", "serve"' in docker
            and '"/etc/tpuserve/config.json"' in docker)
    assert "tpuserve-prod" in (tmp_path / "service.yaml").read_text()
    assert json.loads((tmp_path / "deploy.json").read_text())["profile"] == "prod"
    warm = (tmp_path / "warmpool.sh").read_text()
    assert "cli warm" in warm and "--platform cuda" in warm and "trap stop INT TERM" in warm
    assert "pip install" not in warm
    undeploy = (tmp_path / "undeploy.sh").read_text()
    assert "tpuserve-prod" in undeploy and "gcloud compute instances delete" in undeploy
    assert "tpu-vm" not in undeploy
    for script in ("warmpool.sh", "undeploy.sh"):
        subprocess.run(["bash", "-n", str(tmp_path / script)], check=True, timeout=30)
    local = render_deploy(cfg, target="local", out_dir=tmp_path / "local")
    assert "service.yaml" not in local["files"]


@pytest.mark.parametrize("answer,rc,said", [
    ("ok", 0, "deleted: GPU VM vm-1"),
    ("ERROR: (gcloud) NOT_FOUND: the resource was not found", 0, "already gone: GPU VM vm-1"),
    ("ERROR: (gcloud) PERMISSION_DENIED", 1, "FAILED to delete GPU VM vm-1"),
])
def test_undeploy_is_idempotent_and_fails_loudly(tmp_path, answer, rc, said):
    """The teardown against a stand-in ``gcloud`` on PATH: a deletion, a
    resource already gone (success) and any other failure (the script
    fails)."""
    render_deploy(ServeConfig(profile="p"), target="cloudrun", out_dir=tmp_path)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "gcloud"
    fake.write_text("#!/usr/bin/env bash\n"
                    f'echo "$@" >> {tmp_path}/calls\n'
                    'if [ "$1" = run ]; then exit 0; fi\n'
                    f'echo "{answer}"; [ "{answer}" = ok ]\n')
    fake.chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}", "PROJECT": "x",
           "REGION": "r", "ZONE": "z", "POOL_VMS": "vm-1"}
    proc = subprocess.run(["bash", str(tmp_path / "undeploy.sh")], env=env, capture_output=True,
                          text=True, timeout=30)
    assert proc.returncode == rc, proc.stderr
    assert said in proc.stdout + proc.stderr
    calls = (tmp_path / "calls").read_text().splitlines()
    assert calls[0].startswith("run services delete tpuserve-p")
    assert calls[1].startswith("compute instances delete vm-1 --project x --zone z")


def test_render_deploy_emits_mounted_config(tmp_path):
    cfg = ServeConfig(profile="prod", port=8080, models=[
        ModelConfig(name="resnet18", batch_buckets=(1, 4))])
    summary = render_deploy(cfg, target="cloudrun", out_dir=tmp_path)
    assert "config.json" in summary["files"]
    loaded = load_config(tmp_path / "config.json")
    assert loaded == cfg and loaded.models[0].batch_buckets == (1, 4)


def test_cli_deploy(tmp_path, capsys):
    cfg = _write_json(tmp_path / "c.json", {"profile": "edge", "port": 9000,
                                            "models": [{"name": "bert_base"}]})
    assert main(["deploy", "--config", str(cfg), "--target", "local",
                 "--out", str(tmp_path / "out")]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["profile"] == "edge" and out["models"] == ["bert_base"]
    assert load_config(tmp_path / "out" / "config.json") == load_config(cfg)


# -- dump_config --------------------------------------------------------------

def _structured_config() -> ServeConfig:
    """Every structured field set: tuples, nested dicts and lists, the fleet."""
    return ServeConfig(
        profile="x", port=9999, deadline_default_ms=250.0, journal_dir="/tmp/j",
        faults={"bert_base": {"latency_ms": 5.0, "fail_every_n": 3}},
        slo={"bert_base": {"latency_ms": 50.0, "target": 0.99}},
        fleet=FleetConfig(replicas=["http://a:1", "http://b:2"], spawn=2, disagg=True,
                          prefill_replicas=["http://a:1"], quarantine_after=5),
        models=[
            ModelConfig(name="bert_base", seq_buckets=(64, 128), batch_buckets=(1, 8),
                        extra={"num_labels": 3, "labels": ["a", "b", "c"],
                               "arch": {"num_layers": 2}}),
            ModelConfig(name="gpt2", builder="gpt2", family="g", quality_rank=2,
                        kv_cache="paged", adapter_slots=2, adapter_targets=("q", "v", "out"),
                        adapters={"t1": {"seed": 1, "alpha": 16.0, "tenants": ["alice"]}},
                        lazy_load=True, pinned=False, spec_draft="auto"),
        ])


@pytest.mark.parametrize("which", ["dev", "structured"])
def test_config_dump_round_trip(tmp_path, which):
    cfg = default_config() if which == "dev" else _structured_config()
    path = tmp_path / "config.json"
    path.write_text(dump_config(cfg))
    loaded = load_config(path)
    assert loaded == cfg
    assert loaded.models[-1].adapter_targets == cfg.models[-1].adapter_targets
    doc = json.loads(path.read_text())
    assert doc["default_profile"] == cfg.profile and set(doc["profiles"]) == {cfg.profile}
    assert not set(REFUSED_FIELDS) & set(doc["profiles"][cfg.profile])


def test_a_config_the_jax_package_dumps_is_refused_by_name(tmp_path):
    """The reference's dump carries ``compile_cache_dir``, ``mesh`` and the
    multi-host fields: the port names the first it refuses; without them
    the same document loads in the port, equal field for field."""
    jcfg = JServeConfig(profile="x", port=9999, models=[
        JModelConfig(name="bert_base", seq_buckets=(64, 128), extra={"num_labels": 3})])
    path = tmp_path / "config.yaml"
    path.write_text(j_dump_config(jcfg))
    with pytest.raises(ValueError, match="is not served by the port") as err:
        load_config(path)
    assert any(repr(f) in str(err.value) for f in REFUSED_FIELDS)
    doc = yaml.safe_load(path.read_text())
    assert {"compile_cache_dir", "mesh"} <= set(doc["profiles"]["x"])
    for f in REFUSED_FIELDS:
        doc["profiles"]["x"].pop(f, None)
    path.write_text(yaml.safe_dump(doc))
    port = load_config(path)
    assert port.port == 9999 and port.models[0].seq_buckets == (64, 128)
    assert dataclasses.asdict(port.models[0]) == {
        k: v for k, v in dataclasses.asdict(jcfg.models[0]).items()
        if k in dataclasses.asdict(port.models[0])}


# -- stage --------------------------------------------------------------------

def _topk(sv, img):
    with torch.inference_mode():
        return sv.apply_fn(sv.module, {"image": torch.from_numpy(img)})["topk_packed"].numpy()


def test_stage_assets_round_trip(tmp_path, capsys):
    """``cli stage`` → the staged ``config.json`` → ``build_engine`` serves
    the unstaged build's answers byte for byte, the labels file copied."""
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps([f"l{i}" for i in range(1000)]))
    cfg_path = _write_json(tmp_path / "cfg.json", {"models": [
        {"name": "resnet18", "batch_buckets": [1, 2], "dtype": "float32",
         "extra": {"image_size": 64, "labels": str(labels)}}]})
    out = tmp_path / "staged"
    assert main(["stage", "--config", str(cfg_path), "--out", str(out),
                 "--mount-root", str(out / "assets"), "--platform", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads((out / "stage.json").read_text())
    info = printed["models"]["resnet18"]
    assert info["source"] == "random-init" and info["param_count"] > 1e7
    assert printed["total_bytes"] == info["params_bytes"] == (
        out / "assets" / "resnet18" / "params.tpu.safetensors").stat().st_size

    staged_cfg = load_config(out / "config.json")
    mc = staged_cfg.models[0]
    assert mc.checkpoint == f"{out}/assets/resnet18/params.tpu.safetensors"
    assert mc.extra["labels"] == f"{out}/assets/resnet18/labels.json"
    assert (out / "assets" / "resnet18" / "labels.json").read_text() == labels.read_text()
    imgs = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), np.uint8)
    answers = []
    for cfg in (load_config(cfg_path), staged_cfg):
        eng = build_engine(cfg, device="cpu")
        try:
            cm = eng.model("resnet18")
            answers.append(eng.runner.run_sync(cm, [cm.servable.preprocess(i) for i in imgs]))
        finally:
            eng.shutdown()
    assert answers[0] == answers[1]
    assert answers[1][0]["top_k"][0]["label"].startswith("l")


def _gpt2_inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, 500, (batch, 16)).astype(np.int32),
            "length": np.asarray([16, 9][:batch], np.int32),
            "temperature": np.zeros((batch,), np.float32), "seed": np.zeros((batch,), np.int32),
            "top_k": np.zeros((batch,), np.int32), "top_p": np.ones((batch,), np.float32),
            "repetition_penalty": np.ones((batch,), np.float32)}


def _run(sv, inputs) -> np.ndarray:
    with torch.inference_mode():
        out = sv.apply_fn(sv.module, {k: torch.from_numpy(v) for k, v in inputs.items()})
    return out["tokens"].numpy()


@pytest.mark.parametrize("name,params_dtype", [("gpt2", "int8"), ("gpt2", "auto"),
                                               ("whisper_tiny", "int8")])
def test_stage_quantized_lane_round_trip(tmp_path, name, params_dtype):
    """A quantized lane stages its float tree (no ``kernel_q``); the staged
    config keeps ``params_dtype``, and the boot re-quantizes to the same
    module, serving the same tokens as building the lane from its seed."""
    arch = GPT2_ARCH if name == "gpt2" else WHISPER_ARCH
    extra = {"max_new_tokens": 4, "params_dtype": params_dtype, "quantize_min_size": 1024,
             "arch": arch, **({"int8_crossover_batch": 1} if params_dtype == "auto" else {})}
    mc = ModelConfig(name=name, dtype="bfloat16", batch_buckets=(1, 2), seq_buckets=(16,),
                     extra=extra)
    out = tmp_path / "staged"
    stage_assets(ServeConfig(models=[mc]), out_dir=out, mount_root=str(out / "assets"))
    staged = load_config(out / "config.json").models[0]
    assert staged.extra["params_dtype"] == params_dtype
    tree = PW.load_native(staged.checkpoint)
    assert not any(k.endswith("kernel_q") for k in PW.flatten_tree(tree))
    _same_tree(tree, get_tree_fn(name)(mc)[0])
    orig, boot = p_builder(name)(mc), p_builder(name)(staged)
    sd_o, sd_b = orig.module.state_dict(), boot.module.state_dict()
    assert sorted(sd_o) == sorted(sd_b) and any(k.endswith("kernel_q") for k in sd_b)
    for k in sd_o:
        assert sd_o[k].dtype == sd_b[k].dtype and torch.equal(sd_o[k], sd_b[k]), k
    if name == "gpt2":
        inputs = _gpt2_inputs()
    else:
        inputs = {"mel": np.random.default_rng(3).standard_normal((2, 80, 3000)).astype(
            np.float32)}
    np.testing.assert_array_equal(_run(orig, inputs), _run(boot, inputs))


def test_staged_tree_is_the_builders_float_tree(tmp_path):
    """The staged GPT-2 int8 tree is the float tree the builder starts from
    (``init_gpt2_params``), byte for byte; the JAX package's stage of the
    same config saves the same bytes (its init draws the same numbers)."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as PG

    extra = {"max_new_tokens": 4, "params_dtype": "int8", "quantize_min_size": 1024,
             "arch": GPT2_ARCH}
    kw = dict(name="gpt2", dtype="bfloat16", batch_buckets=(1,), seq_buckets=(16,), extra=extra)
    out = tmp_path / "port"
    stage_assets(ServeConfig(models=[ModelConfig(**kw)]), out_dir=out, mount_root=str(out))
    params, _ = PG.gpt2_params(ModelConfig(**kw))
    port_tree = PW.load_native(out / "assets" / "gpt2" / "params.tpu.safetensors")
    _same_tree(port_tree, params)
    jout = tmp_path / "jax"
    j_stage_assets(JServeConfig(models=[JModelConfig(**kw)]), out_dir=jout, mount_root=str(jout))
    _same_tree(JW.load_native(jout / "assets" / "gpt2" / "params.tpu.safetensors"), port_tree)
    # ...and the JAX package reads what the port staged, to equal arrays
    _same_tree(JW.load_native(out / "assets" / "gpt2" / "params.tpu.safetensors"), params)


def test_jax_staged_tree_serves_in_the_port(tmp_path):
    """A ResNet-18 staged by the JAX package (its own init) serves in the
    port, pointed at the staged file, as the port's servable fed the same
    tree through ``params_from_jax``."""
    kw = dict(name="resnet18", batch_buckets=(1,), dtype="float32", extra={"image_size": 64})
    jout = tmp_path / "jax"
    j_stage_assets(JServeConfig(models=[JModelConfig(**kw)]), out_dir=jout,
                   mount_root=str(jout / "assets"))
    jmc = j_load_config(jout / "config.yaml").models[0]
    staged = p_builder("resnet18")(ModelConfig(**{**kw, "checkpoint": jmc.checkpoint}))
    fed = p_builder("resnet18")(ModelConfig(**kw))
    fed.module.load_state_dict(PW.params_from_jax(JW.load_native(jmc.checkpoint)))
    img = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3), np.uint8)
    got, want = _topk(staged, img), _topk(fed, img)
    assert got.tobytes() == want.tobytes()


def test_sd15_staged_by_both_packages_is_byte_equal(tmp_path):
    """Tiny SD-1.5 staged by both packages, from its seed and from a
    diffusers directory: the same bytes; the port's staged tree serves the
    unstaged build's image byte for byte."""
    from pytorch_zappa_serverless_tpu_torch.models import sd15 as PS

    seeded = PS.init_sd15_params(0, PS.TINY)
    ckpt = write_diffusers_dir(seeded, tmp_path / "diffusers")
    for tag, checkpoint in (("seed", None), ("diffusers", str(ckpt))):
        kw = dict(name="sd15", dtype="float32", batch_buckets=(1,), checkpoint=checkpoint,
                  extra=SD_TINY)
        out, jout = tmp_path / f"port_{tag}", tmp_path / f"jax_{tag}"
        summary = stage_assets(ServeConfig(models=[ModelConfig(**kw)]), out_dir=out,
                               mount_root=str(out / "assets"))
        assert summary["models"]["sd15"]["source"] == (checkpoint or "random-init")
        j_stage_assets(JServeConfig(models=[JModelConfig(**kw)]), out_dir=jout,
                       mount_root=str(jout / "assets"))
        port = PW.load_native(out / "assets" / "sd15" / "params.tpu.safetensors")
        _same_tree(port, seeded)
        _same_tree(JW.load_native(jout / "assets" / "sd15" / "params.tpu.safetensors"), port)
    staged = load_config(out / "config.json").models[0]
    images = []
    for mc in (ModelConfig(name="sd15", dtype="float32", batch_buckets=(1,), extra=SD_TINY),
               staged):
        sv = p_builder("sd15")(mc)
        sample = sv.preprocess({"prompt": "a red fox", "seed": 3})
        with torch.inference_mode():
            out_ = sv.apply_fn(sv.module, {k: torch.from_numpy(np.asarray(v)[None])
                                           for k, v in sample.items()})
        images.append(out_["image"].numpy())
    assert images[0].tobytes() == images[1].tobytes() and images[0].std() > 0


def test_list_labels_stay_in_the_staged_config(tmp_path):
    """BERT's ``extra.labels`` may be a list: the port leaves it in the
    staged config and copies nothing (the reference's stage raises
    ``TypeError`` on ``Path(list)``)."""
    kw = dict(name="bert_base", dtype="float32", seq_buckets=(8,), batch_buckets=(1,),
              extra={"arch": BERT_ARCH, "num_labels": 2, "labels": ["neg", "pos"]})
    out = tmp_path / "port"
    stage_assets(ServeConfig(models=[ModelConfig(**kw)]), out_dir=out,
                 mount_root=str(out / "assets"))
    staged = load_config(out / "config.json").models[0]
    assert staged.extra["labels"] == ["neg", "pos"]
    assert sorted(p.name for p in (out / "assets" / "bert_base").iterdir()) == [
        "params.tpu.safetensors"]
    sv = p_builder("bert_base")(staged)
    ids = sv.preprocess({"text": "a fine day"})
    scores = sv.postprocess({"probs": np.asarray([[0.25, 0.75]], np.float32)}, 0)["scores"]
    assert [s["label"] for s in scores] == ["pos", "neg"]
    assert int(ids["input_ids"][0]) == 101  # [CLS]
    with pytest.raises(TypeError):
        j_stage_assets(JServeConfig(models=[JModelConfig(**kw)]), out_dir=tmp_path / "jax",
                       mount_root=str(tmp_path / "jax"))


@pytest.mark.parametrize("name,damage", [("bert_base", "shape"), ("bert_base", "missing"),
                                         ("gpt2", "shape"), ("sd15", "missing")])
def test_stage_refuses_a_tree_that_does_not_fit(tmp_path, name, damage):
    """A checkpoint whose tree does not fit the family is refused at stage
    time: strictly on the module on meta (BERT), leaf for leaf against the
    seeded tree's shapes (GPT-2, SD-1.5)."""
    extra = {"bert_base": {"arch": BERT_ARCH}, "gpt2": {"arch": GPT2_ARCH},
             "sd15": SD_TINY}[name]
    mc = ModelConfig(name=name, dtype="float32", seq_buckets=(8,), batch_buckets=(1,),
                     extra=extra)
    tree, _ = get_tree_fn(name)(mc)
    flat = PW.flatten_tree(tree)
    key = sorted(k for k in flat if k.endswith("kernel"))[0]
    if damage == "shape":
        flat[key] = np.zeros(np.asarray(flat[key]).shape[:-1] + (3,), np.float32)
    else:
        del flat[key]
    bad = tmp_path / "bad.tpu.safetensors"
    PW.save_native(PW.unflatten_tree(flat), bad)
    with pytest.raises((RuntimeError, ValueError), match="size mismatch|Missing key|missing|shape"):
        stage_assets(ServeConfig(models=[dataclasses.replace(mc, checkpoint=str(bad))]),
                     out_dir=tmp_path / "out")


def test_staging_loads_no_safetensors_package(tmp_path):
    """The native format is read and written without the ``safetensors``
    package (a serving host need not have it): a stage and a load in a process
    where importing it fails."""
    cfg = _write_json(tmp_path / "c.json", {"models": [
        {"name": "gpt2", "dtype": "float32", "batch_buckets": [1], "seq_buckets": [16],
         "extra": {"max_new_tokens": 2, "arch": GPT2_ARCH}}]})
    code = ("import sys\n"
            "sys.modules['safetensors'] = None\n"
            "from pytorch_zappa_serverless_tpu_torch.cli import main\n"
            f"assert main(['stage', '--config', {str(cfg)!r}, '--out', {str(tmp_path / 'o')!r},"
            f" '--mount-root', {str(tmp_path / 'o' / 'assets')!r}]) == 0\n"
            "from pytorch_zappa_serverless_tpu_torch.config import load_config\n"
            "from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder\n"
            f"mc = load_config({str(tmp_path / 'o' / 'config.json')!r}).models[0]\n"
            "get_model_builder('gpt2')(mc)\n"
            "print(sorted(n for n, m in sys.modules.items() if m is not None and n.split('.')[0]"
            " in ('safetensors', 'jax', 'flax', 'pytorch_zappa_serverless_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=180, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"



def test_crash_harness_boots_from_a_staged_tree(tmp_path):
    """``tools/crashtest.py`` passes a checkpoint (``chip_smoke.py`` phase 16
    boots its SD-1.5 servers from phase 22a's staged tree) into both
    profiles of the servers' config, and the kill -9 scenario holds with
    it: ResNet-18 at 64 px staged, then crashed and recovered."""
    from pytorch_zappa_serverless_tpu_torch.tools import crashtest

    mc = ModelConfig(**{**crashtest.MODELS["resnet18"],
                        "batch_buckets": tuple(crashtest.MODELS["resnet18"]["batch_buckets"])})
    stage_assets(ServeConfig(models=[mc]), out_dir=tmp_path / "st",
                 mount_root=str(tmp_path / "st" / "assets"))
    ckpt = load_config(tmp_path / "st" / "config.json").models[0].checkpoint
    crashtest.write_config(tmp_path / "c.json", 1, tmp_path, "sd15", 5.0, checkpoint="x.tpu.ckpt")
    doc = json.loads((tmp_path / "c.json").read_text())
    assert [p["models"][0]["checkpoint"] for p in doc["profiles"].values()] == ["x.tpu.ckpt"] * 2
    out = crashtest.run_crashtest(tmp_path / "ct", n_jobs=3, platform="cpu", checkpoint=ckpt)
    assert out["lost"] == 0 and out["completed"] == 3 and out["fresh_equal"] is True
