"""The port's image classifiers (ResNet-18/50, EfficientNet-B0) against the
JAX package's, on the CPU.

The same seeded numpy param trees (a seeded init in the JAX layout, with
BN statistics, BN affines and biases made non-trivial) go through both
packages: the port gets them through ``params_from_jax`` or a staged
``*.tpu.safetensors`` checkpoint that both packages load.  Tolerances:

- fp32 logits ``atol = 2e-3, rtol = 1e-3``, as ``tests/test_resnet_parity.py``
  holds the JAX package against torch (the two frameworks sum a conv's
  products in another order);
- the servable's ``topk_packed``: the same indices, probabilities within
  ``rtol = 2e-3, atol = 1e-6`` (the logits' tolerance carried through an
  f32 softmax);
- FrozenBatchNorm at bf16: bit-equal to the JAX package's formula, fold in
  f32, two bf16 roundings (``x * w``, then ``+ b``).
"""

import base64
import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import linen as fnn
from PIL import Image

from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.engine import weights as JW
from pytorch_zappa_serverless_tpu.models import efficientnet as JE
from pytorch_zappa_serverless_tpu.models import layers as JLayers
from pytorch_zappa_serverless_tpu.models import resnet as JR
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import efficientnet as PE
from pytorch_zappa_serverless_tpu_torch.models import layers as PL
from pytorch_zappa_serverless_tpu_torch.models import resnet as PR
from pytorch_zappa_serverless_tpu_torch.models import vision_common as PV
from pytorch_zappa_serverless_tpu_torch.models.sd15 import png_bytes
from pytorch_zappa_serverless_tpu_torch.ops import preprocessing as PP
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_latency_class, list_models

from torch_refs import randomize_bn_stats, torch_resnet18, torch_resnet50

LOGIT_TOL = {"atol": 2e-3, "rtol": 1e-3}


def _randomize(tree, seed: int):
    """The JAX init with every BN's statistics and affine, and every bias,
    made non-trivial (numpy leaves)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.array(v, np.float32)
            if "var" in node and k != "var":  # a BN node: scale, bias, mean
                v = (rng.uniform(0.5, 1.5, v.shape) if k == "scale"
                     else rng.normal(0, 0.1, v.shape)).astype(np.float32)
            elif k == "var":
                v = rng.uniform(0.75, 1.25, v.shape).astype(np.float32)
            elif k == "bias":
                v = rng.normal(0, 0.1, v.shape).astype(np.float32)
            out[k] = v
        return out

    return walk(jax.tree.map(np.asarray, tree))


def _tree(port_module, seed: int = 0):
    """A param tree in the JAX layout for ``port_module``'s architecture
    (the port's seeded init, whose layout a test below holds against the
    JAX modules' own init), made non-trivial everywhere."""
    return _randomize(PL.init_params(port_module, seed), seed)


def _port(module, tree):
    module.load_state_dict(PW.params_from_jax(tree), assign=True)
    return module.to(memory_format=torch.channels_last).eval()


def _images(n: int, size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _logits(jax_module, port_module, tree, x):
    want = np.asarray(jax.jit(jax_module.apply)({"params": tree}, x))
    with torch.inference_mode():
        got = port_module(torch.from_numpy(x)).numpy()
    return got, want


RESNETS = {
    "basic_1111": (lambda **kw: JR.ResNet(stage_sizes=(1, 1, 1, 1), block=JR.BasicBlock, **kw),
                   lambda **kw: PR.ResNet((1, 1, 1, 1), PR.BasicBlock, **kw), 32),
    "bottleneck_1111": (lambda **kw: JR.ResNet(stage_sizes=(1, 1, 1, 1), block=JR.Bottleneck,
                                               **kw),
                        lambda **kw: PR.ResNet((1, 1, 1, 1), PR.Bottleneck, **kw), 40),
    "resnet18": (JR.ResNet18, PR.ResNet18, 64),
}


@pytest.mark.parametrize("name", list(RESNETS))
def test_resnet_logits_match_jax(name):
    jax_builder, port_builder, size = RESNETS[name]
    jm = jax_builder(dtype=jnp.float32, num_classes=100)
    pm = port_builder(dtype=torch.float32, num_classes=100)
    tree = _tree(pm)
    pm = _port(pm, tree)
    got, want = _logits(jm, pm, tree, _images(2, size, 1))
    assert got.shape == (2, 100) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("size", [33, 48], ids=["odd", "even"])
def test_efficientnet_logits_match_jax(size):
    """Width 0.25, depth 0.5; an odd input size takes XLA's SAME pad
    symmetric at stride 2, an even one asymmetric (the odd pixel after)."""
    kw = {"width_coefficient": 0.25, "depth_coefficient": 0.5, "hidden_dim": 320,
          "num_classes": 50}
    jm = JE.EfficientNet(dtype=jnp.float32, **kw)
    pm = PE.EfficientNet(dtype=torch.float32, **kw)
    tree = _tree(pm)
    pm = _port(pm, tree)
    got, want = _logits(jm, pm, tree, _images(2, size, 2))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("size,kernel,stride", [(7, 3, 2), (8, 3, 2), (9, 5, 2), (10, 5, 2),
                                                (6, 3, 1), (5, 5, 1)])
def test_same_padding_is_xlas(size, kernel, stride):
    x = _images(1, size, 3)[..., :2]
    jc = fnn.Conv(4, (kernel, kernel), strides=stride, padding="SAME", use_bias=False)
    params = jax.tree.map(np.asarray, jc.init(jax.random.key(0), x)["params"])
    want = np.asarray(jc.apply({"params": params}, x))
    pc = PL.Conv(2, 4, kernel, stride, "same")
    pc.load_state_dict(PW.params_from_jax(params), assign=True)
    with torch.inference_mode():
        got = pc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_frozen_batchnorm_bf16_rounds_as_the_jax_package():
    rng = np.random.default_rng(4)
    c = 48
    x = rng.standard_normal((2, 5, 5, c)).astype(ml_dtypes.bfloat16)
    p = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.1, c),
         "mean": rng.normal(0, 0.1, c), "var": rng.uniform(0.75, 1.25, c)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = np.asarray(JLayers.FrozenBatchNorm(dtype=jnp.bfloat16).apply(
        {"params": p}, jnp.asarray(x)))
    # The formula: the fold in f32, w and b cast once, x * w and + b rounded.
    inv = np.asarray(jax.lax.rsqrt(jnp.asarray(p["var"]) + 1e-5)) * p["scale"]
    w = inv.astype(ml_dtypes.bfloat16)
    b = (p["bias"] - p["mean"] * inv).astype(ml_dtypes.bfloat16)
    formula = (x * w).astype(ml_dtypes.bfloat16) + b
    bn = PL.FrozenBatchNorm(c, dtype=torch.bfloat16)
    bn.load_state_dict(PW.params_from_jax(p), assign=True)
    xt = torch.from_numpy(x.astype(np.float32)).bfloat16().permute(0, 3, 1, 2)
    got = bn(xt).permute(0, 2, 3, 1).float().numpy()
    assert got.tobytes() == formula.astype(np.float32).tobytes()
    assert got.tobytes() == want.astype(np.float32).tobytes()


def test_topk_orders_ties_as_jax_lax_top_k():
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 4, (16, 40)).astype(np.float32) / 4  # many ties
    probs[3] = 0.0  # a whole row tied
    values, idx = PV.topk_first_index(torch.from_numpy(probs), 7)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    assert idx[3].tolist() == list(range(7))


def _stage(tree, tmp_path, name):
    path = tmp_path / f"{name}.tpu.safetensors"
    PW.save_native(tree, path)
    return str(path)


def _servables(name, tree, tmp_path, size):
    """The JAX package's and the port's servable of ``name`` over one staged
    checkpoint, both at f32."""
    from pytorch_zappa_serverless_tpu.models import efficientnet, resnet  # noqa: F401
    from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as jax_builder
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder

    extra = {"image_size": size, "resize_to": size + 8}
    ckpt = _stage(tree, tmp_path, name)
    js = jax_builder(name)(JModelConfig(name=name, dtype="float32", checkpoint=ckpt,
                                        batch_buckets=(4,), extra=extra))
    ps = get_model_builder(name)(ModelConfig(name=name, dtype="float32", checkpoint=ckpt,
                                             batch_buckets=(4,), extra=extra))
    return js, ps


def _topk_both(js, ps, images: np.ndarray):
    batch = {"image": images}
    want = np.asarray(jax.jit(js.apply_fn)(js.params, batch)["topk_packed"])
    with torch.inference_mode():
        got = ps.apply_fn(ps.module, {"image": torch.from_numpy(images)})["topk_packed"].numpy()
    return got, want


def test_servable_topk_matches_jax(tmp_path):
    name, size = "resnet18", 32
    tree = _tree(PR.ResNet18())
    js, ps = _servables(name, tree, tmp_path, size)
    rng = np.random.default_rng(6)
    samples = [ps.preprocess(png_bytes(rng.integers(0, 256, (40 + 9 * i, 50, 3), np.uint8)))
               for i in range(3)]
    for s in samples:
        assert s["image"].shape == (size, size, 3) and s["image"].dtype == np.uint8
    images = default_collate(samples, (4,), ps.input_spec((4,)))["image"]
    got, want = _topk_both(js, ps, images)
    assert got.shape == (4, 10)
    np.testing.assert_array_equal(got[:, 5:], want[:, 5:])
    np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=2e-3, atol=1e-6)
    answer = ps.postprocess({"topk_packed": got}, 0)["top_k"]
    assert [a["index"] for a in answer] == got[0, 5:].astype(int).tolist()
    assert answer[0]["label"] == f"class_{answer[0]['index']:04d}"


def test_efficientnet_servable_packs_its_own_softmax_top_k():
    """EfficientNet-B0's servable (the JAX side of the shared servable code
    is held by the ResNet-18 case above): ``topk_packed`` is the f32
    softmax's top five of the module's own logits, values then indices."""
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder

    ps = get_model_builder("efficientnet_b0")(ModelConfig(
        name="efficientnet_b0", dtype="float32", extra={"image_size": 32, "topk": 5}))
    images = np.random.default_rng(11).integers(0, 256, (2, 32, 32, 3), np.uint8)
    x = torch.from_numpy(images)
    with torch.inference_mode():
        packed = ps.apply_fn(ps.module, {"image": x})["topk_packed"]
        logits = ps.module(PP.normalize_on_device(x, ps.module.norm_mean, ps.module.norm_std))
    values, idx = torch.softmax(logits, -1).sort(dim=-1, descending=True, stable=True)
    assert torch.equal(packed, torch.cat([values[:, :5], idx[:, :5].float()], -1))


def test_servable_ties_take_the_lower_index_first(tmp_path):
    """fc kernel 0 and a planted bias: the logits tie exactly, and f32
    softmax underflows every class but three to exactly 0.0, so the 4th and
    5th entries are ties among zeros; both packages answer the same order."""
    tree = _tree(PR.ResNet18())
    tree["fc"]["kernel"][:] = 0.0
    bias = np.full(1000, -200.0, np.float32)
    bias[[700, 3, 512]] = 0.0
    tree["fc"]["bias"] = bias
    js, ps = _servables("resnet18", tree, tmp_path, 32)
    images = np.random.default_rng(7).integers(0, 256, (4, 32, 32, 3), np.uint8)
    got, want = _topk_both(js, ps, images)
    np.testing.assert_array_equal(got, want)
    assert got[:, 5:].astype(int).tolist() == [[3, 512, 700, 0, 1]] * 4
    assert (got[:, 3:5] == 0.0).all()


def test_seeded_init_has_the_jax_layout():
    for jm, pm in ((JR.ResNet50(dtype=jnp.float32), PR.ResNet50()),
                   (JE.EfficientNetB0(dtype=jnp.float32), PE.EfficientNetB0())):
        ref = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                             jnp.zeros((1, 32, 32, 3), jnp.float32)))
        tree = PL.init_params(pm, seed=3)
        JW.assert_tree_shapes_match(tree, jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), ref["params"]))
        again = PL.init_params(pm, seed=3)
        flat, flat2 = PW.flatten_tree(tree), PW.flatten_tree(again)
        assert all(flat[k].tobytes() == flat2[k].tobytes() for k in flat)


def _same_tree(a, b):
    fa, fb = PW.flatten_tree(a), PW.flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


@pytest.mark.parametrize("builder,port_builder", [(torch_resnet18, PR.ResNet18),
                                                  (torch_resnet50, PR.ResNet50)],
                         ids=["resnet18", "resnet50"])
def test_convert_resnet_is_the_jax_packages(builder, port_builder):
    torch.manual_seed(0)
    tm = randomize_bn_stats(builder()).eval()
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    tree = PW.convert_resnet(sd)
    _same_tree(tree, JW.convert_resnet(sd))
    pm = _port(port_builder(dtype=torch.float32), tree)
    x = _images(1, 64, 8)
    with torch.inference_mode():
        want = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)


def test_convert_efficientnet_is_the_jax_packages():
    """A Hugging Face EfficientNet state_dict (width 0.25, depth 0.5), both
    converters byte for byte, and the port's logits against the HF torch
    model's at an even size (HF pads (0, 1) at stride 2, XLA's SAME rule
    only there)."""
    from transformers import EfficientNetConfig
    from transformers.models.efficientnet.modeling_efficientnet import (
        EfficientNetForImageClassification)

    torch.manual_seed(0)
    hf = EfficientNetForImageClassification(EfficientNetConfig(
        width_coefficient=0.25, depth_coefficient=0.5, hidden_dim=320, num_labels=20))
    randomize_bn_stats(hf).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    tree = PW.convert_efficientnet(sd)
    _same_tree(tree, JW.convert_efficientnet(sd))
    pm = _port(PE.EfficientNet(0.25, 0.5, hidden_dim=320, num_classes=20,
                               dtype=torch.float32), tree)
    x = _images(2, 64, 9)
    with torch.inference_mode():
        want = hf(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).logits
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)


def test_activations_stay_channels_last():
    pm = PR.ResNet((1, 1, 1, 1), PR.Bottleneck, num_classes=10)
    pm = _port(pm, PL.init_params(pm))
    seen = []
    for m in pm.modules():
        if isinstance(m, PL.Conv):
            m.register_forward_hook(lambda _m, _i, y: seen.append(
                y.is_contiguous(memory_format=torch.channels_last)))
    with torch.inference_mode():
        pm(torch.zeros(2, 32, 32, 3))
    assert len(seen) == 17 and all(seen)
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in pm.parameters() if p.ndim == 4)


def test_vision_models_registered_as_latency():
    for name in ("resnet18", "resnet50", "efficientnet_b0"):
        assert name in list_models() and get_latency_class(name) == "latency"


def test_params_dtype_bfloat16_holds_convs_in_bf16():
    cfg = ServeConfig(models=[ModelConfig(name="resnet18", batch_buckets=(1,),
                                          extra={"image_size": 32,
                                                 "params_dtype": "bfloat16"})])
    eng = build_engine(cfg, device="cpu")
    try:
        m = eng.model("resnet18").servable.module
        assert m.conv1.weight.dtype == torch.bfloat16 and m.fc.weight.dtype == torch.bfloat16
        assert m.bn1.var.dtype == torch.float32 and m.norm_mean.dtype == torch.float32
        out = eng.model("resnet18").forward({"image": np.zeros((1, 32, 32, 3), np.uint8)})
        assert out["topk_packed"].shape == (1, 10)
    finally:
        eng.shutdown()


# -- HTTP -------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    cfg = ServeConfig(models=[ModelConfig(name="resnet18", dtype="float32",
                                          batch_buckets=(1, 4),
                                          extra={"image_size": 32, "resize_to": 40})])
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as s:
            yield s
    finally:
        eng.shutdown()


def _post(port, body: bytes, ctype=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/resnet18:predict",
                                 data=body, headers={"Content-Type": ctype} if ctype else {},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pngs(n: int):
    rng = np.random.default_rng(10)
    return [png_bytes(rng.integers(0, 256, (30 + 7 * i, 60 - 5 * i, 3), np.uint8))
            for i in range(n)]


def test_http_predict_raw_b64_and_instances(server):
    cm = server.server.engine.model("resnet18")
    pngs = _pngs(4)
    direct = [cm.run_batch([cm.servable.preprocess(p)])[0][0] for p in pngs]
    status, raw = _post(server.port, pngs[0], "image/png")
    assert status == 200 and raw["model"] == "resnet18"
    assert raw["predictions"] == direct[0]
    status, wrapped = _post(server.port,
                            json.dumps({"b64": base64.b64encode(pngs[1]).decode()}).encode(),
                            "application/json")
    assert status == 200 and wrapped["predictions"] == direct[1]
    body = {"instances": [{"b64": base64.b64encode(p).decode()} for p in pngs]}
    status, many = _post(server.port, json.dumps(body).encode())
    assert status == 200 and many["timing"]["samples"] == 4
    assert [p["top_k"][0]["index"] for p in many["predictions"]] == \
        [d["top_k"][0]["index"] for d in direct]
    for pred in many["predictions"]:
        assert len(pred["top_k"]) == 5
        assert all(a["prob"] >= b["prob"] for a, b in zip(pred["top_k"], pred["top_k"][1:]))
    array = cm.servable.preprocess(pngs[2])["image"]
    status, decoded = _post(server.port, json.dumps(array.tolist()).encode())
    assert status == 200 and decoded["predictions"] == direct[2]
    jpeg = io.BytesIO()
    Image.fromarray(np.full((40, 52, 3), 90, np.uint8)).save(jpeg, format="JPEG")
    status, body = _post(server.port, jpeg.getvalue(), "image/jpeg")
    assert status == 200 and len(body["predictions"]["top_k"]) == 5


def test_http_predict_refuses_what_it_cannot_decode(server):
    status, body = _post(server.port, b"\xff\xd8\xff\xe0 not really a jpeg")
    assert status == 400 and "preprocess failed" in body["error"]
    status, body = _post(server.port, b'{"b64": 12}')
    assert status == 400 and "bad request body" in body["error"]
    status, body = _post(server.port, b'{"instances": [{"b64": "%%%"}]}')
    assert status == 400
    status, body = _post(server.port, json.dumps(np.zeros((8, 8, 3)).tolist()).encode())
    assert status == 400 and "expected (32, 32, 3)" in body["error"]
