"""The port's ViT-B/16 (pytorch_zappa_serverless_tpu_torch/models/vit.py)
against the JAX package's, on the CPU.

A narrow ViT (32x32 images, 8x8 patches, 2 layers, 2 heads of 16) with the
JAX module's own seeded init, every bias and LayerNorm and the [CLS] token
made non-trivial, goes through both packages; the port gets the tree
through ``params_from_jax``.  Tolerances:

- fp32 logits within 1e-4 of the largest (XLA's and PyTorch's summation
  orders on the CPU);
- bf16 logits within 3e-2 of the largest (the two frameworks round bf16
  at other places, as tests/test_torch_bert.py holds BERT);
- the servable's ``topk_packed`` at fp32: the same indices, probabilities
  within ``rtol = 2e-3, atol = 1e-6``;
- the converter: byte-identical trees.
"""

import base64
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.engine import weights as JWT
from pytorch_zappa_serverless_tpu.models import vit as JV
from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as j_builder
from pytorch_zappa_serverless_tpu_torch import models as _port_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import weights as PWT
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import vit as PV
from pytorch_zappa_serverless_tpu_torch.models.sd15 import png_bytes
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_latency_class
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder as p_builder

ARCH = {"patch_size": 8, "num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64}
SIZE, LABELS = 32, 10


def _randomize(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            v = v if isinstance(v, dict) else np.array(v, np.float32)
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bias", "cls_token"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(jax.tree.map(np.asarray, tree))


def _pair(dtype, seed=0):
    jdt, pdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JV.ViTClassifier(image_size=SIZE, num_labels=LABELS, dtype=jdt, **ARCH)
    tree = _randomize(jm.init(jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 3)))["params"],
                      seed)
    pm = PV.ViTClassifier(image_size=SIZE, num_labels=LABELS, dtype=pdt, **ARCH)
    pm.load_state_dict(PWT.params_from_jax(tree), assign=True)
    return jm, pm.eval(), tree


def _logits(jm, pm, tree, x):
    want = np.asarray(jax.jit(jm.apply)({"params": tree}, x), np.float32)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x)).numpy()
    return got, want


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_vit_logits_match_jax(dtype, tol):
    jm, pm, tree = _pair(dtype)
    got, want = _logits(jm, pm, tree, _images(3, 1))
    assert got.shape == (3, LABELS) and got.dtype == np.float32
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_patch_embedding_reads_patches_in_row_order():
    """The HWIO patch kernel as an OIHW weight, patches flattened (h, w) as
    the JAX reshape does: one image whose patches differ, fp32."""
    jm, pm, tree = _pair("float32", seed=2)
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    x[0, :8, 8:16] = 1.0  # patch (0, 1) only
    conv = jax.lax.conv_general_dilated(
        x, tree["patch_embed"]["kernel"], (8, 8), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + tree["patch_embed"]["bias"]
    with torch.inference_mode():
        y = pm.patch_embed(torch.from_numpy(x).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
    np.testing.assert_allclose(y.numpy(), np.asarray(conv).reshape(1, 16, -1), rtol=0,
                               atol=1e-5)


def test_init_params_layout_matches_jax():
    jm = JV.ViTClassifier(image_size=SIZE, num_labels=LABELS, dtype=jnp.float32, **ARCH)
    want = jax.tree.map(np.asarray, jm.init(jax.random.key(0),
                                            jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    pm = PV.ViTClassifier(image_size=SIZE, num_labels=LABELS, dtype=torch.float32, **ARCH)
    got = PV.init_params(pm, seed=0)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    pm.load_state_dict(PWT.params_from_jax(got), assign=True)  # every name lands


def test_convert_vit_synthetic_byte_identical():
    rng = np.random.default_rng(3)
    D, M = 16, 32
    sd = {"vit.embeddings.cls_token": (1, 1, D), "vit.embeddings.position_embeddings": (1, 5, D),
          "vit.embeddings.patch_embeddings.projection.weight": (D, 3, 8, 8),
          "vit.embeddings.patch_embeddings.projection.bias": (D,),
          "vit.layernorm.weight": (D,), "vit.layernorm.bias": (D,),
          "vit.pooler.dense.weight": (D, D), "classifier.weight": (LABELS, D),
          "classifier.bias": (LABELS,)}
    pre = "vit.encoder.layer.0."
    for proj in ("query", "key", "value"):
        sd[f"{pre}attention.attention.{proj}.weight"] = (D, D)
        sd[f"{pre}attention.attention.{proj}.bias"] = (D,)
    sd.update({f"{pre}attention.output.dense.weight": (D, D),
               f"{pre}attention.output.dense.bias": (D,),
               f"{pre}layernorm_before.weight": (D,), f"{pre}layernorm_before.bias": (D,),
               f"{pre}layernorm_after.weight": (D,), f"{pre}layernorm_after.bias": (D,),
               f"{pre}intermediate.dense.weight": (M, D), f"{pre}intermediate.dense.bias": (M,),
               f"{pre}output.dense.weight": (D, M), f"{pre}output.dense.bias": (D,)})
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in sd.items()}
    want, got = JWT.convert_vit(sd), PWT.convert_vit(sd)
    assert jax.tree.structure(got) == jax.tree.structure(want) and "pooler" not in got
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    with pytest.raises(KeyError, match="unrecognized vit key"):
        PWT.convert_vit({"vit.embeddings.bogus": np.zeros(2, np.float32)})


def _cfg(dtype="float32", **extra):
    return dict(name="vit_b16", dtype=dtype, batch_buckets=(1, 4),
                extra={"image_size": SIZE, "num_labels": LABELS, "arch": ARCH, **extra})


def test_servable_matches_jax_servable():
    """Same weights in both servables: the host crop (resize to 36, ViT's
    image_size·256/224, crop 32), the 0.5/0.5 normalization on the device,
    and the packed top-k at fp32."""
    jsv = j_builder("vit_b16")(JModelConfig(**_cfg()))
    psv = p_builder("vit_b16")(ModelConfig(**_cfg()))
    tree = _randomize(jsv.params, 5)
    jsv.params = jax.tree.map(jnp.asarray, tree)
    psv.module.load_state_dict(PWT.params_from_jax(tree))
    assert psv.module.norm_mean.tolist() == [0.5, 0.5, 0.5] == psv.module.norm_std.tolist()
    rng = np.random.default_rng(0)
    pngs = [png_bytes(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
            for h, w in ((48, 64), (40, 40), (70, 45))]
    jb = np.stack([jsv.preprocess(p)["image"] for p in pngs])
    pb = np.stack([psv.preprocess(p)["image"] for p in pngs])
    assert jb.tobytes() == pb.tobytes() and pb.shape == (3, SIZE, SIZE, 3)
    want = np.asarray(jax.jit(jsv.apply_fn)(jsv.params, {"image": jb})["topk_packed"])
    with torch.inference_mode():
        got = psv.apply_fn(psv.module, {"image": torch.from_numpy(pb)})["topk_packed"].numpy()
    k = got.shape[1] // 2
    assert (got[:, k:] == want[:, k:]).all()
    np.testing.assert_allclose(got[:, :k], want[:, :k], rtol=2e-3, atol=1e-6)


def test_vit_served_on_the_cpu():
    cfg = ServeConfig(models=[ModelConfig(**_cfg("bfloat16"))])
    engine = build_engine(cfg, device="cpu")
    rng = np.random.default_rng(1)
    png = png_bytes(rng.integers(0, 256, (50, 70, 3)).astype(np.uint8))
    b64 = base64.b64encode(png).decode()
    try:
        with BackgroundServer(cfg, engine) as srv:
            def post(data, ctype):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/v1/models/vit_b16:predict", data=data,
                    method="POST", headers={"Content-Type": ctype})
                with urllib.request.urlopen(req, timeout=60) as r:
                    return json.loads(r.read())

            raw = post(png, "image/png")["predictions"]
            one = post(json.dumps({"b64": b64}).encode(), "application/json")["predictions"]
            many = post(json.dumps({"instances": [{"b64": b64}] * 3}).encode(),
                        "application/json")["predictions"]
    finally:
        engine.shutdown()
    assert raw == one and len(many) == 3
    assert [t["index"] for t in many[0]["top_k"]] == [t["index"] for t in raw["top_k"]]
    assert len(raw["top_k"]) == 5 and all(0 <= t["index"] < LABELS for t in raw["top_k"])
    assert get_latency_class("vit_b16") == "latency"
