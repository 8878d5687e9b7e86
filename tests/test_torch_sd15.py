"""The port's SD-1.5 pieces on the CPU against the JAX package's, on TINY.

Both packages get the same bytes: the JAX package's seed-initialised tree,
carried across with ``params_from_jax``, and numpy inputs.  Everything runs
in f32.  The UNet and the whole pipeline run at 256x256 (32x32 latents, 1024
tokens at the top level), so the self-attention there takes the flash route
on both sides: the Pallas kernel in interpret mode, the port's plain version.

Tolerances: CLIP and the UNet ``atol = 1e-4 · max|want|`` (f32 arithmetic
in another summation order, through ~40 layers); the VAE ``atol = 1e-5``
(outputs in [0, 1]); the uint8 image within 2 LSB with at most 1 % of the
values off by more than 1 (a float that lands near an integer boundary
rounds either way).
"""

import asyncio
import base64
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.models import clip_text as JC
from pytorch_zappa_serverless_tpu.models import sd15 as JS
from pytorch_zappa_serverless_tpu.models import sd_unet as JU
from pytorch_zappa_serverless_tpu.models import sd_vae as JV
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.engine.weights import ParamTree, params_from_jax
from pytorch_zappa_serverless_tpu_torch.models import clip_text as PC
from pytorch_zappa_serverless_tpu_torch.models import sd15 as PS
from pytorch_zappa_serverless_tpu_torch.models import sd_unet as PU
from pytorch_zappa_serverless_tpu_torch.models import sd_vae as PV

TINY = PS.TINY
PROMPTS = ["a red fox", "an astronaut riding a horse on the moon", ""]


@pytest.fixture(scope="module")
def jparams():
    return JS.init_sd15_params(0, JS.TINY)


@pytest.fixture(scope="module")
def tparams(jparams):
    return ParamTree(params_from_jax(jparams)).tree()


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("port_fn,jax_fn,cfg", [
    (PC.init_clip_text_params, JC.init_clip_text_params, TINY.clip),
    (PU.init_unet_params, JU.init_unet_params, TINY.unet),
    (PV.init_vae_params, JV.init_vae_params, TINY.vae),
    (PS.init_sd15_params, JS.init_sd15_params, TINY),
], ids=["clip", "unet", "vae", "sd15"])
def test_init_params_are_the_jax_bytes(port_fn, jax_fn, cfg):
    got, want = dict(_leaves(port_fn(3, cfg))), dict(_leaves(jax_fn(3, cfg)))
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0)])
def test_conv_bridge_matches_jax(stride, padding):
    """An asymmetric 3x3 HWIO kernel: a bridge that swapped the spatial axes
    (HWIO → OIWH) keeps every shape and gives another answer."""
    rng = np.random.default_rng(1)
    kernel = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    kernel[0, 2] += 3.0  # top-right tap dominates: not symmetric under a transpose
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), (stride, stride), [(padding, padding)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    weight = params_from_jax({"conv": {"kernel": kernel}})["conv.weight"]
    assert tuple(weight.shape) == (7, 5, 3, 3)
    got = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), weight,
                                     stride=stride, padding=padding).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    swapped = torch.from_numpy(np.ascontiguousarray(kernel.T))  # the old bridge
    bad = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), swapped,
                                     stride=stride, padding=padding).permute(0, 2, 3, 1)
    assert np.abs(bad.numpy() - np.asarray(want)).max() > 1.0


@pytest.mark.parametrize("num_steps", [3, 10, 20])
def test_ddim_schedule_equal(num_steps):
    got, want = PS.ddim_schedule(num_steps, PS.FULL), JS.ddim_schedule(num_steps, JS.FULL)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("prompt", PROMPTS + [" ".join(["word"] * 40)])
@pytest.mark.parametrize("cfg", ["full", "tiny"])
def test_prompt_ids_equal(prompt, cfg):
    p_cfg, j_cfg = (PS.FULL.clip, JS.FULL.clip) if cfg == "full" else (TINY.clip, JS.TINY.clip)
    np.testing.assert_array_equal(PS.make_prompt_ids(prompt, p_cfg),
                                  JS.make_prompt_ids(prompt, j_cfg))


def test_encode_text_matches_jax(jparams, tparams):
    ids = np.stack([PS.make_prompt_ids(p, TINY.clip) for p in PROMPTS])
    want = JC.encode_text(jparams["clip"], jnp.asarray(ids), JS.TINY.clip, jnp.float32)
    got = PC.encode_text(tparams["clip"], torch.from_numpy(ids), TINY.clip, torch.float32)
    _close(got, want)


def test_unet_matches_jax_through_the_flash_route(jparams, tparams):
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    t = np.array([901.0, 1.0], np.float32)
    ctx = rng.standard_normal((2, TINY.clip.max_len, TINY.unet.context_dim)).astype(np.float32)
    want = jax.jit(lambda p, *a: JU.unet_apply(p, *a, JS.TINY.unet, jnp.float32))(
        jparams["unet"], lat, t, ctx)
    routed = []

    def spy(*args, **kw):
        routed.append(args[0].shape)
        return PU.flash_attention(*args, **kw)

    PU.flash, calls = spy, PU.unet_apply.calls
    try:
        got = PU.unet_apply(tparams["unet"], torch.from_numpy(lat), torch.from_numpy(t),
                            torch.from_numpy(ctx), TINY.unet, torch.float32)
    finally:
        PU.flash = PU.flash_attention
    # TINY has one transformer per block: down0 and up3 (two) at 32x32.
    assert routed == [(2, 1024, 2, 8)] * 3
    assert PU.unet_apply.calls == calls + 1
    assert got.shape == (2, 32, 32, 4) and got.dtype == torch.float32
    _close(got, want)


def test_vae_matches_jax(jparams, tparams):
    lat = np.random.default_rng(3).standard_normal((1, 16, 16, 4)).astype(np.float32)
    want = JV.vae_decode(jparams["vae"], jnp.asarray(lat), JS.TINY.vae, jnp.float32)
    got = PV.vae_decode(tparams["vae"], torch.from_numpy(lat), TINY.vae, torch.float32)
    assert got.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _inputs(cfg, prompts, seed, hw, guidance=7.5):
    lat = np.random.default_rng(seed).standard_normal(
        (len(prompts), hw // 8, hw // 8, 4)).astype(np.float32)
    return {"cond_ids": np.stack([PS.make_prompt_ids(p, cfg.clip) for p in prompts]),
            "uncond_ids": np.stack([PS.make_prompt_ids("", cfg.clip) for _ in prompts]),
            "latents": lat,
            "guidance": np.full((len(prompts),), guidance, np.float32)}


def test_txt2img_matches_jax(jparams, tparams):
    """The whole pipeline at 256x256, 2 steps: uint8 within 2 LSB."""
    inputs = _inputs(TINY, ["a red fox", "a blue bird"], seed=4, hw=256)
    sched = PS.ddim_schedule(2, TINY)
    want = np.asarray(jax.jit(lambda p, i: JS.txt2img(p, i, sched, JS.TINY, jnp.float32))(
        jparams, inputs)["image"])
    got = PS.txt2img(tparams, {k: torch.from_numpy(v) for k, v in inputs.items()}, sched,
                     TINY, torch.float32)["image"].numpy()
    assert got.shape == want.shape == (2, 256, 256, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2 and (diff > 1).mean() <= 0.01, (diff.max(), (diff > 1).mean())
    assert want.std() > 1.0  # not a constant image


def test_chunked_equals_monolithic():
    """Within the port, the job lane's prepare → 5 chunks of 4 steps →
    finalize is the 20-step loop in slices: the same image, bit for bit."""
    cfg = ServeConfig(models=[ModelConfig(
        name="sd15", dtype="float32", batch_buckets=(1,),
        extra={"variant": "tiny", "height": 64, "width": 64, "num_steps": 20,
               "chunk_steps": 4})])
    eng = build_engine(cfg, device="cpu")
    try:
        cm = eng.model("sd15")
        ch = cm.servable.meta["chunked"]
        assert ch["num_chunks"] == 5 and ch["steps_per_chunk"] == 4
        sample = cm.servable.preprocess({"prompt": "a red fox", "seed": 7})
        [mono] = eng.runner.run_sync(cm, [sample])
        [chunked] = asyncio.run(eng.runner.run_chunked(cm, [sample]))
        np.testing.assert_array_equal(mono["pixels"], chunked["pixels"])
        assert eng.runner.stats["sd15"].chunks == 5
    finally:
        eng.shutdown()


def test_png_writer_decodes_with_pil():
    from PIL import Image

    pixels = np.random.default_rng(5).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    img = Image.open(io.BytesIO(PS.png_bytes(pixels)))
    assert img.format == "PNG" and img.mode == "RGB" and img.size == (53, 37)
    np.testing.assert_array_equal(np.asarray(img), pixels)
    result = PS.make_sd15_servable("sd15", ModelConfig(
        name="sd15", extra={"variant": "tiny", "height": 64, "width": 64})).meta["finalize"](
        {"pixels": pixels, "height": 37, "width": 53})
    assert result["format"] == "png" and set(result) == {"image_b64", "format", "height",
                                                         "width"}
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(base64.b64decode(result["image_b64"])))), pixels)


def test_build_refuses_checkpoint_and_tokenizer(tmp_path, monkeypatch):
    """Checkpoints and tokenizer files are served (tests/test_torch_sd_convert.py);
    the build refuses a diffusers directory missing a part, and a tokenizer
    file on a machine without ``tokenizers``, with an error naming the
    package rather than a fall back to the offline tokenizer."""
    (tmp_path / "text_encoder").mkdir()
    with pytest.raises(FileNotFoundError, match="no model file under"):
        PS.make_sd15_servable("sd15", ModelConfig(name="sd15", checkpoint=str(tmp_path),
                                                  extra={"variant": "tiny"}))
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="`tokenizers` package"):
        PS.make_sd15_servable("sd15", ModelConfig(name="sd15", extra={
            "variant": "tiny", "tokenizer": str(tmp_path / "tok.json")}))


def test_weights_held_in_the_compute_dtype():
    m = PS.make_sd15_servable("sd15", ModelConfig(
        name="sd15", dtype="bfloat16", extra={"variant": "tiny"})).module
    tree = m.tree()
    assert tree["unet"]["conv_in"]["weight"].dtype == torch.bfloat16
    assert tree["unet"]["conv_in"]["weight"].is_contiguous(memory_format=torch.channels_last)
    assert tree["unet"]["conv_in"]["bias"].dtype == torch.bfloat16
    assert tree["clip"]["token_embedding"].dtype == torch.bfloat16
    # Read in f32 by the JAX package: norms and the time MLP stay f32.
    assert tree["unet"]["norm_out"]["weight"].dtype == torch.float32
    assert tree["unet"]["down0"]["res0"]["norm1"]["bias"].dtype == torch.float32
    assert tree["unet"]["time_mlp1"]["weight"].dtype == torch.float32
    assert tree["clip"]["final_ln"]["weight"].dtype == torch.float32
