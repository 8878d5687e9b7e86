"""The port's device mesh (``parallel/mesh.py``) against the JAX package's.

A ``{"data": 2, "model": 2}`` world of 4 ``gloo`` ranks (one process a rank,
``tests/torch_worlds.py``) is built through the port's ``build_engine(cfg,
device="cpu")`` at the tiny widths of the JAX package's
``tests/test_mesh_serving.py`` and ``__graft_entry__.dryrun_multichip``:
ResNet-18 and ResNet-50 at 64 px, BERT, GPT-2's fixed route, Whisper-tiny and
SD-1.5 tiny, their weights one staged ``*.tpu.safetensors`` file a model that
both packages load.  Rank 0 leads the requests and the other ranks follow.
Its answers are held to the port's single-device engine and to the JAX
engine on its ``{"data": 4, "model": 2}`` 8-device CPU mesh.

Tolerances, everything in f32: port mesh against port single ``atol 1e-5``
on probabilities (TP changes only the order of the sums), tokens equal, SD
pixels within 1 (a uint8 rounding at .5 may flip); port against JAX
``atol 1e-4`` on probabilities with the labels equal wherever the top-2
margin exceeds 1e-3, tokens equal, SD pixels within 1.
"""

import logging

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.parallel import mesh as PM
from torch_worlds import engine_world, run_world

MESH = {"data": 2, "model": 2}
JAX_MESH = {"data": 4, "model": 2}
TINY_BERT = {"num_layers": 2, "num_heads": 4, "head_dim": 8, "mlp_dim": 64,
             "vocab_size": 2048, "max_position": 64}
TINY_GPT2 = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 64, "vocab_size": 512,
             "max_positions": 32}
TINY_WHISPER = {"d_model": 32, "encoder_layers": 2, "decoder_layers": 2, "heads": 2,
                "ffn_dim": 64, "vocab_size": 64, "source_positions": 1500,
                "target_positions": 96}
SD = {"variant": "tiny", "height": 64, "width": 64, "num_steps": 2}


def _models(ckpt: dict, mc_cls=ModelConfig):
    """The five families (and ResNet-50, of the dry run) as either
    package's ModelConfig, each on its staged checkpoint."""
    return [
        mc_cls(name="resnet18", batch_buckets=(1, 4), dtype="float32",
               checkpoint=ckpt["resnet18"], extra={"image_size": 64, "resize_to": 72}),
        mc_cls(name="resnet50", batch_buckets=(4,), dtype="float32",
               checkpoint=ckpt["resnet50"], extra={"image_size": 64, "resize_to": 72}),
        mc_cls(name="bert_base", batch_buckets=(1, 4), seq_buckets=(16,), dtype="float32",
               checkpoint=ckpt["bert_base"], extra={"arch": TINY_BERT}),
        mc_cls(name="gpt2", batch_buckets=(4,), seq_buckets=(8,), dtype="float32",
               checkpoint=ckpt["gpt2"], extra={"max_new_tokens": 4, "arch": TINY_GPT2}),
        mc_cls(name="whisper_tiny", batch_buckets=(1, 2), dtype="float32",
               checkpoint=ckpt["whisper_tiny"],
               extra={"max_new_tokens": 3, "gen_slots": 2, "segment_tokens": 2,
                      "arch": TINY_WHISPER}),
        mc_cls(name="sd15", batch_buckets=(1,), dtype="float32", checkpoint=ckpt["sd15"],
               extra=dict(SD)),
    ]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Each family's seeded float tree, staged once for both packages."""
    from pytorch_zappa_serverless_tpu_torch import models  # noqa: F401
    from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_tree_fn

    d = tmp_path_factory.mktemp("mesh_ckpt")
    out = {}
    for mc in _models({m: None for m in ("resnet18", "resnet50", "bert_base", "gpt2",
                                         "whisper_tiny", "sd15")}):
        tree, _ = get_tree_fn(mc.name)(mc)
        out[mc.name] = str(d / f"{mc.name}.tpu.safetensors")
        PW.save_native(tree, out[mc.name])
    return out


def _requests(engine):
    """{model: [sample lists]}: each bucket met once, preprocessed by the
    port (both packages run these samples)."""
    rng = np.random.default_rng(0)
    sv = {name: engine.model(name).servable for name in engine.models}
    imgs = [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8) for _ in range(4)]
    audio = [{"array": (rng.standard_normal(8000 * (i + 1)) * 0.1).tolist(), "rate": 16000}
             for i in range(2)]
    texts = [[101, 1010, 1234, 1999, 102], [5, 6, 7], [9, 10, 11, 12, 13, 14, 15], [42]]
    return {
        "resnet18": [[sv["resnet18"].preprocess(imgs[0])],
                     [sv["resnet18"].preprocess(x) for x in imgs]],
        "resnet50": [[sv["resnet50"].preprocess(x) for x in imgs]],
        "bert_base": [[sv["bert_base"].preprocess({"input_ids": texts[0]})],
                      [sv["bert_base"].preprocess({"input_ids": t}) for t in texts]],
        "gpt2": [[sv["gpt2"].preprocess({"input_ids": t}) for t in
                  ([5, 6, 7], [9], [1, 2, 3, 4, 5], [42, 43])]],
        "whisper_tiny": [[sv["whisper_tiny"].preprocess(audio[0])],
                         [sv["whisper_tiny"].preprocess(a) for a in audio]],
        "sd15": [[sv["sd15"].preprocess({"prompt": "a red fox", "seed": 7})]],
    }


PROBES = {
    "bert_base": ["layer0/attention/query/weight", "layer0/attention/query/bias",
                  "layer0/attention_output/weight", "layer0/attention_output/bias",
                  "layer0/intermediate/weight", "layer0/output/weight", "classifier/weight"],
    "resnet18": ["fc/weight", "fc/bias"],
    "gpt2": ["layer0/q/kernel", "layer0/q/bias", "layer0/out/kernel", "layer0/fc2/kernel",
             "wte"],
    "whisper_tiny": ["decoder/layer0/cq/kernel", "decoder/layer0/cout/kernel",
                     "encoder/layer0/fc1/kernel", "encoder/conv1/weight"],
    "sd15": ["clip/layer0/q/weight", "clip/layer0/fc2/weight", "clip/layer0/out/bias"],
}


@pytest.fixture(scope="module")
def single(ckpt):
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    engine = build_engine(ServeConfig(models=_models(ckpt)), device="cpu")
    yield engine
    engine.shutdown()


@pytest.fixture(scope="module")
def requests(single):
    return _requests(single)


@pytest.fixture(scope="module")
def world(ckpt, requests):
    """The 4-rank world's answers and probes, from rank 0."""
    cfg = ServeConfig(mesh=dict(MESH), models=_models(ckpt))
    return run_world(4, engine_world, cfg, requests, PROBES)


@pytest.fixture(scope="module")
def single_answers(single, requests):
    return {name: [single.runner.run_sync(single.model(name), s) for s in lists]
            for name, lists in requests.items()}


@pytest.fixture(scope="module")
def jax_answers(ckpt, requests, tmp_path_factory):
    """The JAX package's engine on its {"data": 4, "model": 2} 8-device CPU
    mesh (tests/conftest.py), on the same checkpoints and samples."""
    import jax

    from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
    from pytorch_zappa_serverless_tpu.config import ServeConfig as JServeConfig
    from pytorch_zappa_serverless_tpu.engine.loader import build_engine as jax_build

    assert len(jax.devices()) >= 8
    cfg = JServeConfig(compile_cache_dir=str(tmp_path_factory.mktemp("xla_mesh")),
                       mesh=dict(JAX_MESH),
                       models=[m for m in _models(ckpt, JModelConfig) if m.name != "resnet50"])
    engine = jax_build(cfg)
    try:
        return {name: [engine.runner.run_sync(engine.model(name), s) for s in lists]
                for name, lists in requests.items() if name != "resnet50"}
    finally:
        engine.shutdown()


# -- the rule sets, on the port's parameter names --------------------------------

class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.axes = {a: PM.AxisGroup(a, n, 0, tuple(range(n))) for a, n in shape.items()}

    def axis(self, name):
        return self.axes[name]


def _shard(module, rules, shape):
    return PM.shard_params(_FakeMesh(shape), module, rules)


@pytest.mark.parametrize("family,builder,extra,want", [
    ("bert", "bert_base", {"arch": TINY_BERT}, {
        "layer0/attention/query/weight": ("model", None),
        "layer0/attention/value/bias": ("model",),
        "layer1/attention_output/weight": (None, "model"),
        "layer0/intermediate/weight": ("model", None),
        "layer0/intermediate/bias": ("model",),
        "layer1/output/weight": (None, "model")}),
    ("cnn_head", "resnet18", {"image_size": 64}, {"fc/weight": ("model", None),
                                                  "fc/bias": ("model",)}),
    ("gpt2", "gpt2", {"arch": TINY_GPT2, "max_new_tokens": 4}, {
        "layer0/q/kernel": (None, "model"), "layer1/v/bias": ("model",),
        "layer0/out/kernel": ("model", None), "layer0/fc1/kernel": (None, "model"),
        "layer1/fc1/bias": ("model",), "layer1/fc2/kernel": ("model", None)}),
    ("whisper", "whisper_tiny", {"arch": TINY_WHISPER}, {
        "encoder/layer0/q/kernel": (None, "model"), "decoder/layer1/cq/kernel": (None, "model"),
        "decoder/layer0/cq/bias": ("model",), "decoder/layer0/cout/kernel": ("model", None),
        "encoder/layer1/out/kernel": ("model", None), "decoder/layer1/fc2/kernel": ("model", None),
        "encoder/layer0/fc1/bias": ("model",)}),
    ("vit", "vit_b16", {"image_size": 32, "arch": {"num_layers": 1, "num_heads": 2,
                                                   "head_dim": 8, "mlp_dim": 32,
                                                   "patch_size": 16}}, {
        "layer0/attention/key/weight": ("model", None), "layer0/output/weight": (None, "model"),
        "classifier/weight": ("model", None), "classifier/bias": ("model",)}),
])
def test_rule_sets_shard_the_ports_leaves(family, builder, extra, want):
    """Which leaf shards on which dim, on the port's names: the first match
    wins, unmatched leaves stay whole, a [out, in] weight's contracting dim
    is 1 and a [in, out] kernel's 0."""
    from pytorch_zappa_serverless_tpu_torch import models  # noqa: F401
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder

    sv = get_model_builder(builder)(ModelConfig(name=builder, dtype="float32",
                                                batch_buckets=(1,), seq_buckets=(8,),
                                                extra=extra))
    full = {f"{m}/{k}".replace(".", "/").lstrip("/"): tuple(t.shape)
            for m, mod in sv.module.named_modules()
            for store in (mod._parameters, mod._buffers) for k, t in store.items()
            if t is not None}
    matched = _shard(sv.module, sv.meta["tp_rules"], {"data": 2, "model": 2})
    for path, spec in want.items():
        assert matched[path] == spec, path
    after = {f"{m}/{k}".replace(".", "/").lstrip("/"): tuple(t.shape)
             for m, mod in sv.module.named_modules()
             for store in (mod._parameters, mod._buffers) for k, t in store.items()
             if t is not None}
    for path, shape in full.items():
        spec = matched.get(path, ())
        assert after[path] == tuple(n // 2 if i < len(spec) and spec[i] else n
                                    for i, n in enumerate(shape)), path


class _Warnings(logging.Handler):
    """The mesh logger's records (the port's loggers do not propagate)."""

    def __enter__(self):
        self.lines = []
        PM.log.addHandler(self)
        return self

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __exit__(self, *exc):
        PM.log.removeHandler(self)

    @property
    def text(self):
        return "\n".join(self.lines)


def test_pruned_rule_axes_replicate_with_a_warning():
    """A DP-only mesh serves with the TP rules as no-ops, loudly."""
    from pytorch_zappa_serverless_tpu_torch import models  # noqa: F401
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder

    sv = get_model_builder("bert_base")(ModelConfig(name="bert_base", dtype="float32",
                                                    batch_buckets=(1,), seq_buckets=(8,),
                                                    extra={"arch": TINY_BERT}))
    before = {n: tuple(p.shape) for n, p in sv.module.named_parameters()}
    with _Warnings() as w:
        matched = _shard(sv.module, sv.meta["tp_rules"], {"data": 4})
    assert "TP rule axes ['model'] not in mesh ['data']; affected dims replicate" in w.text
    assert matched["layer0/attention/query/weight"] == (None, None)
    assert {n: tuple(p.shape) for n, p in sv.module.named_parameters()} == before
    assert getattr(sv.module.layer0.attention_output, "tp_reduce", None) is None


def test_sd15_rules_shard_the_clip_tower_only():
    """SD-1.5's rules are anchored under clip/: the UNet's and VAE's q/k/v
    stay whole."""
    from pytorch_zappa_serverless_tpu_torch import models  # noqa: F401
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder

    sv = get_model_builder("sd15")(ModelConfig(name="sd15", dtype="float32",
                                               batch_buckets=(1,), extra=dict(SD)))
    leaves = [f"{m}/{k}".replace(".", "/") for m, mod in sv.module.named_modules()
              for k in mod._buffers]
    matched = _shard(sv.module, sv.meta["tp_rules"], {"data": 4, "model": 2})
    assert matched["clip/layer0/q/weight"] == ("model", None)
    assert matched["clip/layer0/fc2/weight"] == (None, "model")
    assert matched and all(p.startswith("clip/") for p in matched)
    qkv = [p for p in leaves if p.startswith(("vae/", "unet/")) and "/q/" in p]
    assert qkv and not set(qkv) & set(matched)


def test_uneven_shard_is_an_error_naming_the_leaf():
    import torch

    from pytorch_zappa_serverless_tpu_torch.models.bert import Dense

    d = Dense(4, 6, torch.float32)
    with pytest.raises(ValueError, match="weight: dim 0 of \\[6, 4\\] does not divide"):
        _shard(d, [(r"^weight$", ("model", None))], {"model": 4})


def test_heads_that_do_not_divide_are_refused_naming_the_model():
    with pytest.raises(ValueError, match="bert_base: 3 attention heads do not divide over "
                                         "model=2"):
        PM.check_heads("bert_base", 3, _FakeMesh({"data": 1, "model": 2}))
    PM.check_heads("bert_base", 4, _FakeMesh({"data": 1, "model": 2}))


# -- make_mesh's errors and warning; the placement policy ----------------------

def test_make_mesh_device_check_errors_and_warns():
    with pytest.raises(ValueError, match=r"mesh \{'model': 2\} needs 2 devices, have 1"):
        PM.check_devices({"model": 2}, 1)
    with _Warnings() as w:
        assert PM.check_devices({"data": 4}, 8) == 4
        assert PM.check_devices({"data": 2, "model": 2}, 4) == 4
    assert w.lines == ["mesh {'data': 4} uses 4 of 8 visible devices"]


def test_world_layout_splits_the_mesh_over_processes():
    assert PM.world_layout({"data": 4, "model": 2}, 1) == (8, 8)
    assert PM.world_layout({"data": 4, "model": 2}, 2) == (8, 4)
    assert PM.world_layout({}, 3) == (3, 1)
    with pytest.raises(ValueError, match="does not split over num_processes=3"):
        PM.world_layout({"data": 4}, 3)


@pytest.mark.parametrize("rows,data,index,want", [
    (4, 2, 0, slice(0, 2)), (4, 2, 1, slice(2, 4)), (1, 2, 1, None), (6, 4, 0, None),
    (8, 4, 3, slice(6, 8)), (3, 1, 0, slice(0, 3))])
def test_placement_policy_per_bucket(rows, data, index, want):
    """Buckets are never padded up for the mesh: divisible buckets split
    over ``data``, the others replicate (a mesh of one splits into one)."""
    mesh = _FakeMesh({"data": data, "model": 2})
    mesh.coords = {"data": index, "model": 0}
    assert PM.batch_sharding(mesh, rows) == want
    assert PM.replicated(mesh, rows) == (want is None)


# -- the 4-rank world through build_engine --------------------------------------

def test_world_is_a_gloo_mesh_of_four_ranks(world):
    assert world["world"]["backend"] == "gloo"
    assert world["world"]["world_size"] == 4 and world["world"]["rank"] == 0
    assert world["world"]["mesh"] == MESH and world["world"]["lead"]
    assert world["mesh"]["coords"] == {"data": 0, "model": 0}
    # Every request was led (the followers ran it), and the shutdown.
    assert world["world"]["leads"]["run"] == sum(len(v) for v in _REQ_COUNTS.values())


_REQ_COUNTS = {"resnet18": [1, 4], "resnet50": [4], "bert_base": [1, 4], "gpt2": [4],
               "whisper_tiny": [1, 2], "sd15": [1]}


def test_world_shards_the_weights(world):
    info = world["info"]
    bert = info["bert_base"]["leaves"]
    assert bert["layer0/attention/query/weight"] == (16, 32)
    assert bert["layer0/attention/query/bias"] == (16,)
    assert bert["layer0/attention_output/weight"] == (32, 16)
    assert bert["layer0/attention_output/bias"] == (32,)
    assert bert["layer0/intermediate/weight"] == (32, 32)
    assert bert["layer0/output/weight"] == (32, 32)
    assert bert["classifier/weight"] == (2, 32)
    assert info["resnet18"]["leaves"] == {"fc/weight": (500, 512), "fc/bias": (500,)}
    gpt = info["gpt2"]["leaves"]
    assert gpt["layer0/q/kernel"] == (32, 16) and gpt["layer0/out/kernel"] == (16, 32)
    assert gpt["layer0/fc2/kernel"] == (32, 32) and gpt["wte"] == (512, 32)
    wh = info["whisper_tiny"]["leaves"]
    assert wh["decoder/layer0/cq/kernel"] == (32, 16) and wh["decoder/layer0/cout/kernel"] == (
        16, 32)
    assert wh["encoder/layer0/fc1/kernel"] == (32, 32)
    sd = info["sd15"]["leaves"]
    assert sd["clip/layer0/q/weight"] == (16, 32) and sd["clip/layer0/fc2/weight"] == (32, 32)
    assert sd["clip/layer0/out/bias"] == (32,)
    assert {info[m]["tp_size"] for m in info} == {2}


def test_world_splits_rows_only_where_the_bucket_divides(world):
    info = world["info"]
    assert info["resnet18"]["splits"] == {"[1]": (False, 1), "[4]": (True, 2)}
    assert info["bert_base"]["splits"] == {"[1, 16]": (False, 1), "[4, 16]": (True, 2)}
    assert info["whisper_tiny"]["splits"] == {"[1]": (False, 1), "[2]": (True, 1)}
    assert info["sd15"]["splits"] == {"[1]": (False, 1)}


def test_five_family_dry_run_configuration_dispatches_once(world):
    """The dry run's families (ResNet-50, BERT, GPT-2, Whisper, SD-1.5), each
    dispatched through the world and answered whole."""
    got = world["answers"]
    assert [len(a) for a in got["resnet50"][0]] == [1, 1, 1, 1]
    assert all(len(r["top_k"]) == 5 for r in got["resnet50"][0])
    assert len(got["gpt2"][0]) == 4 and len(got["whisper_tiny"][1]) == 2
    assert got["sd15"][0][0]["pixels"].shape == (64, 64, 3)
    assert got["sd15"][0][0]["pixels"].dtype == np.uint8
    for name, counts in _REQ_COUNTS.items():
        assert [len(a) for a in got[name]] == counts, name


def _probs(rows, key):
    return [[(x.get("index", x.get("label")), x["prob"]) for x in r[key]] for r in rows]


def _close_probs(got, want, key, atol):
    for g, w in zip(got, want):
        gp = dict((lab, p) for lab, p in _probs([g], key)[0])
        wp = dict((lab, p) for lab, p in _probs([w], key)[0])
        ranked = sorted(wp.values(), reverse=True)
        if len(ranked) < 2 or ranked[0] - ranked[1] > 1e-3:
            assert [lab for lab, _ in _probs([g], key)[0]][:1] == \
                   [lab for lab, _ in _probs([w], key)[0]][:1]
        for lab in set(gp) & set(wp):
            assert abs(gp[lab] - wp[lab]) <= atol, (lab, gp[lab], wp[lab])


@pytest.mark.parametrize("model", ["resnet18", "resnet50", "bert_base", "gpt2", "whisper_tiny",
                                   "sd15"])
def test_world_answers_equal_the_single_device_engine(world, single_answers, model):
    for got, want in zip(world["answers"][model], single_answers[model]):
        _check(model, got, want, atol=1e-5)


@pytest.mark.parametrize("model", ["resnet18", "bert_base", "gpt2", "whisper_tiny", "sd15"])
def test_world_answers_equal_the_jax_meshed_engine(world, jax_answers, model):
    for got, want in zip(world["answers"][model], jax_answers[model]):
        _check(model, got, want, atol=1e-4)


def _check(model, got, want, atol):
    assert len(got) == len(want)
    if model.startswith("resnet"):
        _close_probs(got, want, "top_k", atol)
    elif model == "bert_base":
        _close_probs(got, want, "scores", atol)
    elif model in ("gpt2", "whisper_tiny"):
        assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    else:
        for g, w in zip(got, want):
            diff = np.abs(np.asarray(g["pixels"], np.int32) - np.asarray(w["pixels"], np.int32))
            assert diff.max() <= 1, diff.max()


# -- refusals on a mesh -----------------------------------------------------------

@pytest.mark.parametrize("extra,msg", [
    ({"params_dtype": "int8", "quantize_min_size": 1024},
     "bert_base: params_dtype=int8 cannot be served on a mesh (quantized kernels are "
     "invisible to the TP rules"),
    ({"params_dtype": "auto", "quantize_min_size": 1024},
     "gpt2: params_dtype=auto cannot be served on a mesh (the int8 half is invisible to the "
     "TP rules"),
])
def test_int8_and_auto_are_refused_on_a_mesh(extra, msg):
    from pytorch_zappa_serverless_tpu_torch import models  # noqa: F401
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import CompiledModel
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_servable

    name = "gpt2" if extra["params_dtype"] == "auto" else "bert_base"
    arch = ({"d_model": 128, "layers": 2, "heads": 2, "ffn_dim": 256, "vocab_size": 512,
             "max_positions": 64} if name == "gpt2" else TINY_BERT)
    mc = ModelConfig(name=name, dtype="float32", batch_buckets=(1,), seq_buckets=(8,),
                     extra={**extra, "arch": arch})
    with pytest.raises(ValueError) as e:
        CompiledModel(build_servable(mc), mc, "cpu", mesh=_FakeMesh({"data": 1, "model": 2}))
    assert msg in str(e.value)
    assert str(e.value).endswith("drop the mesh for this model or use params_dtype=bfloat16")


def test_adapters_are_refused_on_a_mesh():
    from pytorch_zappa_serverless_tpu_torch import models  # noqa: F401
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import CompiledModel
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_servable

    mc = ModelConfig(name="gpt2", dtype="float32", batch_buckets=(1,), seq_buckets=(8,),
                     adapter_slots=2, extra={"arch": TINY_GPT2, "max_new_tokens": 4})
    with pytest.raises(ValueError, match="gpt2: adapter_slots cannot be served on a mesh; "
                                         "drop the mesh for this model or its adapters"):
        CompiledModel(build_servable(mc), mc, "cpu", mesh=_FakeMesh({"data": 1, "model": 2}))

