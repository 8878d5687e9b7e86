"""The SD-1.5 converters of the port's ``engine/weights.py`` against the JAX
package's, and SD-1.5 served from a checkpoint and a tokenizer file.

- ``convert_clip_text``, ``convert_sd_unet``, ``convert_sd_vae`` and
  ``convert_sd15`` give trees byte-identical to the JAX package's on
  synthetic TINY state dicts (made from the seeded tree by
  ``tests/sd_diffusers.py``, so both must also give that tree back), in
  every naming case: the ``text_model.`` prefix and the ``position_ids``
  buffer, 1x1 projections as convs or linears, the VAE's new, legacy and
  1x1-conv attention names, a directory of ``.safetensors`` or ``.bin``
  parts (``sorted(...)[0]``, safetensors first), one flat prefixed file, and
  fp16 parts (fp16 leaves, as the reference keeps them).
- CLIP against ``transformers``' ``CLIPTextModel`` (the reference's
  ``tests/test_clip_parity.py``, through the port): f32 last hidden states
  within ``atol=2e-5, rtol=1e-4``.
- The tiny ``sd15`` servable from a diffusers directory with a CLIP-style
  ``tokenizer.json`` built in the process: the JAX servable's prompt ids
  exactly, and its image within 2 LSB at f32 (``tests/test_torch_sd15.py``'s
  pipeline tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.engine import weights as JW
from pytorch_zappa_serverless_tpu.models import sd15 as JS
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig
from pytorch_zappa_serverless_tpu_torch.engine import tensorfile
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.models import clip_text as PC
from pytorch_zappa_serverless_tpu_torch.models import sd15 as PS
from sd_diffusers import PARTS, clip_state, sd15_states, unet_state, vae_state, write_diffusers_dir

SEEDED = PS.init_sd15_params(0, PS.TINY)


def _same(got, want):
    got, want = PW.flatten_tree(got), PW.flatten_tree(want)
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), k


def _both(fn_name: str, arg):
    """The port's converter and the JAX package's on the same input: byte
    for byte equal; returns the port's tree."""
    port, ref = getattr(PW, fn_name)(arg), getattr(JW, fn_name)(arg)
    _same(port, ref)
    return port


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("position_ids", [True, False])
def test_convert_clip_text_matches_jax(prefix, position_ids):
    _same(_both("convert_clip_text", clip_state(SEEDED["clip"], prefix, position_ids)),
          SEEDED["clip"])


@pytest.mark.parametrize("proj_linear", [False, True])
def test_convert_sd_unet_matches_jax(proj_linear):
    _same(_both("convert_sd_unet", unet_state(SEEDED["unet"], proj_linear)), SEEDED["unet"])


@pytest.mark.parametrize("attn", ["new", "legacy", "conv"])
@pytest.mark.parametrize("encoder", [True, False])
def test_convert_sd_vae_matches_jax(attn, encoder):
    _same(_both("convert_sd_vae", vae_state(SEEDED["vae"], attn, encoder)), SEEDED["vae"])


def test_unknown_keys_are_refused_as_the_reference_does():
    for fn, sd in (("convert_clip_text", {"text_model.pooler.weight": np.zeros(2)}),
                   ("convert_sd_unet", {"add_embedding.linear_1.weight": np.zeros(2)}),
                   ("convert_sd_vae", {"decoder.mid_block.attentions.0.rel_pos": np.zeros(2)})):
        with pytest.raises(KeyError, match="unrecognized"):
            getattr(PW, fn)(sd)
        with pytest.raises(KeyError, match="unrecognized"):
            getattr(JW, fn)(sd)


def _torch_save(state: dict, path):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, str(path))


@pytest.mark.parametrize("layout", ["safetensors", "bin", "both", "sorted_first", "flat",
                                    "flat_bin", "legacy_names", "fp16"])
def test_convert_sd15_matches_jax(tmp_path, layout):
    """``convert_sd15`` on a directory (each part's ``*.safetensors``, else
    ``*.bin``, the sorted first) and on one prefixed file."""
    naming = ({"prefix": False, "position_ids": False, "proj_linear": True, "attn": "legacy"}
              if layout == "legacy_names" else {})
    states = sd15_states(SEEDED, **naming)
    want = SEEDED
    if layout == "fp16":
        states = {part: {k: v.astype(np.float16) if v.dtype == np.float32 else v
                         for k, v in sd.items()} for part, sd in states.items()}
        want = {part: {k: v for k, v in PW.flatten_tree(t).items()}
                for part, t in SEEDED.items()}
        want = {part: PW.unflatten_tree({k: v.astype(np.float16) for k, v in flat.items()})
                for part, flat in want.items()}
    root = tmp_path / "ckpt"
    if layout in ("flat", "flat_bin"):
        flat = {f"{part}.{k}": v for part, sd in states.items() for k, v in sd.items()}
        root = tmp_path / ("sd15.safetensors" if layout == "flat" else "sd15.bin")
        if layout == "flat":
            tensorfile.save(flat, root)
        else:
            _torch_save(flat, root)
    else:
        for part, fname in PARTS:
            (root / part).mkdir(parents=True)
            if layout in ("safetensors", "legacy_names", "fp16"):
                tensorfile.save(states[part], root / part / fname)
            elif layout == "bin":
                _torch_save(states[part], root / part / fname.replace(".safetensors", ".bin"))
            elif layout == "both":  # the .safetensors file wins over a .bin one
                tensorfile.save(states[part], root / part / fname)
                (root / part / "aaa.bin").write_bytes(b"not a checkpoint")
            else:  # sorted_first: a.safetensors before b.safetensors
                tensorfile.save(states[part], root / part / "a.safetensors")
                tensorfile.save({"junk": np.zeros(3, np.float32)}, root / part / "b.safetensors")
    _same(_both("convert_sd15", root), want)


def test_convert_sd15_names_a_missing_part(tmp_path):
    write_diffusers_dir(SEEDED, tmp_path)
    for f in (tmp_path / "vae").iterdir():
        f.unlink()
    with pytest.raises(FileNotFoundError, match="no model file under"):
        PW.convert_sd15(tmp_path)


def test_assert_tree_shapes_match_reports_the_leaf():
    ref = PS.init_sd15_params(0, PS.TINY, rng=PW.ShapeDraws())
    PW.assert_tree_shapes_match(SEEDED, ref)
    JW.assert_tree_shapes_match(SEEDED, ref)
    bad = {**SEEDED, "vae": {**SEEDED["vae"], "conv_in": {
        **SEEDED["vae"]["conv_in"], "bias": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="at /vae/conv_in/bias: shape"):
        PW.assert_tree_shapes_match(bad, ref)
    with pytest.raises(ValueError, match=r"missing=\['clip'\]"):
        PW.assert_tree_shapes_match({k: v for k, v in SEEDED.items() if k != "clip"}, ref)
    # the shape-only draws: zero-stride leaves of the seeded tree's shapes and dtypes
    flat = PW.flatten_tree(ref)
    assert all(v.dtype == np.float32 for v in flat.values())
    assert flat["unet/conv_in/kernel"].strides == (0, 0, 0, 0)


def test_clip_text_matches_transformers():
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel

    hf_cfg = HFConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=3, num_attention_heads=4,
                      max_position_embeddings=77, hidden_act="quick_gelu")
    torch.manual_seed(0)
    model = CLIPTextModel(hf_cfg).eval()
    cfg = PC.CLIPTextConfig(vocab_size=512, width=64, layers=3, heads=4, mlp_dim=128,
                            max_len=77)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = PW.ParamTree(PW.params_from_jax(_both("convert_clip_text", sd))).tree()
    ids = np.random.default_rng(0).integers(0, 512, (2, 77)).astype(np.int64)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids)).last_hidden_state.numpy()
        got = PC.encode_text(params, torch.from_numpy(ids.astype(np.int32)), cfg,
                             torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def _clip_tokenizer_json(path, cfg) -> str:
    """A CLIP-style ``tokenizer.json``: lowercased whitespace words over a
    small vocabulary, ``<|startoftext|>``/``<|endoftext|>`` at the config's
    BOS/EOS ids added by the post-processor, as CLIP's file adds them."""
    from tokenizers import Tokenizer, normalizers, pre_tokenizers, processors
    from tokenizers.models import WordLevel

    words = "a red fox in the snow oil painting photograph of an astronaut riding horse".split()
    vocab = {w: i + 3 for i, w in enumerate(words)}
    vocab.update({"<unk>": 0, "<|startoftext|>": cfg.bot_id, "<|endoftext|>": cfg.eot_id})
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.normalizer = normalizers.Lowercase()
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<|startoftext|> $A <|endoftext|>",
        special_tokens=[("<|startoftext|>", cfg.bot_id), ("<|endoftext|>", cfg.eot_id)])
    tok.save(str(path))
    return str(path)


def test_sd15_from_a_checkpoint_and_tokenizer_matches_jax(tmp_path):
    ckpt = write_diffusers_dir(SEEDED, tmp_path / "ckpt")
    tok = _clip_tokenizer_json(tmp_path / "tokenizer.json", PS.TINY.clip)
    kw = dict(name="sd15", dtype="float32", batch_buckets=(1,), checkpoint=str(ckpt),
              extra={"variant": "tiny", "height": 64, "width": 64, "num_steps": 2,
                     "tokenizer": tok})
    jsv = JS.make_sd15_servable("sd15", JModelConfig(**kw))
    psv = PS.make_sd15_servable("sd15", ModelConfig(**kw))
    body = {"prompt": "A red FOX in the snow", "negative_prompt": "oil painting", "seed": 5}
    js, ps = jsv.preprocess(body), psv.preprocess(body)
    for key in ("cond_ids", "uncond_ids", "latents", "guidance"):
        assert np.array_equal(np.asarray(js[key]), np.asarray(ps[key])), key
    assert list(ps["cond_ids"][:8]) == [PS.TINY.clip.bot_id, 3, 4, 5, 6, 7, 8,
                                        PS.TINY.clip.eot_id]
    batch = {k: np.asarray(v)[None] for k, v in js.items()}
    want = np.asarray(jax.jit(jsv.apply_fn)(jsv.params, {k: jnp.asarray(v)
                                                          for k, v in batch.items()})["image"])
    with torch.inference_mode():
        got = psv.apply_fn(psv.module, {k: torch.from_numpy(v) for k, v in batch.items()})[
            "image"].numpy()
    assert got.shape == want.shape == (1, 64, 64, 3) and want.std() > 1.0
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2, diff.max()
    # the seeded servable reads the same weights: the same image, bit for bit
    seeded = PS.make_sd15_servable("sd15", ModelConfig(**{**kw, "checkpoint": None}))
    with torch.inference_mode():
        again = seeded.apply_fn(seeded.module, {k: torch.from_numpy(v)
                                                for k, v in batch.items()})["image"].numpy()
    assert again.tobytes() == got.tobytes()


def test_sd15_serves_an_fp16_checkpoint_as_its_f32_copy(tmp_path):
    """An fp16 diffusers checkpoint (the common SD-1.5 download): its norms
    and time MLP are held in f32, the rest in the compute dtype, so it
    serves the image of the same weights written in f32, bit for bit."""
    f16 = {part: PW.unflatten_tree({k: v.astype(np.float16)
                                    for k, v in PW.flatten_tree(t).items()})
           for part, t in SEEDED.items()}
    f32 = {part: PW.unflatten_tree({k: v.astype(np.float32)
                                    for k, v in PW.flatten_tree(t).items()})
           for part, t in f16.items()}
    images = []
    for tag, tree in (("f16", f16), ("f32", f32)):
        ckpt = write_diffusers_dir(tree, tmp_path / tag)
        sv = PS.make_sd15_servable("sd15", ModelConfig(
            name="sd15", dtype="float32", checkpoint=str(ckpt),
            extra={"variant": "tiny", "height": 64, "width": 64, "num_steps": 2}))
        batch = {k: torch.from_numpy(np.asarray(v)[None])
                 for k, v in sv.preprocess({"prompt": "a red fox", "seed": 2}).items()}
        with torch.inference_mode():
            images.append(sv.apply_fn(sv.module, batch)["image"].numpy())
    assert images[0].tobytes() == images[1].tobytes() and images[0].std() > 1.0
