"""The inverse of the SD-1.5 converters: an SD-1.5 param tree (the JAX
package's layout, which the port shares) → Hugging Face / diffusers state
dicts, and a diffusers-layout checkpoint directory written from them.

Neither package has this mapping; the converter tests and ``chip_smoke.py``
(phase 22) use it to make checkpoints from a seeded tree, so that
``convert_sd15`` of the result must give the tree back byte for byte.  The
naming cases the converters accept are options: the CLIP ``text_model.``
prefix and its ``position_ids`` buffer, 1x1 projections as convs
``[O, I, 1, 1]`` or linears ``[O, I]``, and the VAE attention's new
(``to_q``/``to_k``/``to_v``/``to_out.0``), legacy
(``query``/``key``/``value``/``proj_attn``) and 1x1-conv forms.  Imports
numpy and the port's ``engine/tensorfile.py`` only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _conv(w: np.ndarray) -> np.ndarray:
    """HWIO → OIHW."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _linear(w: np.ndarray) -> np.ndarray:
    """[in, out] → [out, in]."""
    return np.ascontiguousarray(w.T)


def _put_conv(sd: dict, name: str, p: dict) -> None:
    sd[name + ".weight"] = _conv(p["kernel"])
    sd[name + ".bias"] = p["bias"]


def _put_linear(sd: dict, name: str, p: dict, conv: bool = False) -> None:
    w = _linear(p["kernel"])
    sd[name + ".weight"] = np.ascontiguousarray(w[:, :, None, None]) if conv else w
    if "bias" in p:
        sd[name + ".bias"] = p["bias"]


def _put_norm(sd: dict, name: str, p: dict) -> None:
    sd[name + ".weight"] = p["scale"]
    sd[name + ".bias"] = p["bias"]


def clip_state(tree: dict, prefix: bool = True, position_ids: bool = True) -> dict:
    """``models.clip_text`` params → a ``CLIPTextModel`` state dict."""
    pre = "text_model." if prefix else ""
    sd = {pre + "embeddings.token_embedding.weight": tree["token_embedding"],
          pre + "embeddings.position_embedding.weight": tree["pos_embedding"]}
    if position_ids:
        sd[pre + "embeddings.position_ids"] = np.arange(
            tree["pos_embedding"].shape[0], dtype=np.int64)[None]
    layers = sorted((k for k in tree if k.startswith("layer")), key=lambda k: int(k[5:]))
    for key in layers:
        i, p = int(key[5:]), tree[key]
        base = f"{pre}encoder.layers.{i}."
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            _put_linear(sd, base + "self_attn." + theirs, p[ours])
        _put_norm(sd, base + "layer_norm1", p["ln1"])
        _put_norm(sd, base + "layer_norm2", p["ln2"])
        _put_linear(sd, base + "mlp.fc1", p["fc1"])
        _put_linear(sd, base + "mlp.fc2", p["fc2"])
    _put_norm(sd, pre + "final_layer_norm", tree["final_ln"])
    return sd


def _put_resnet(sd: dict, name: str, p: dict) -> None:
    _put_norm(sd, name + ".norm1", p["norm1"])
    _put_conv(sd, name + ".conv1", p["conv1"])
    if "time_emb" in p:
        _put_linear(sd, name + ".time_emb_proj", p["time_emb"])
    _put_norm(sd, name + ".norm2", p["norm2"])
    _put_conv(sd, name + ".conv2", p["conv2"])
    if "shortcut" in p:
        _put_conv(sd, name + ".conv_shortcut", p["shortcut"])


_TX = (("self_q", "attn1.to_q"), ("self_k", "attn1.to_k"), ("self_v", "attn1.to_v"),
       ("self_out", "attn1.to_out.0"), ("cross_q", "attn2.to_q"), ("cross_k", "attn2.to_k"),
       ("cross_v", "attn2.to_v"), ("cross_out", "attn2.to_out.0"), ("ff1", "ff.net.0.proj"),
       ("ff2", "ff.net.2"))


def _put_transformer(sd: dict, name: str, p: dict, proj_linear: bool) -> None:
    _put_norm(sd, name + ".norm", p["norm"])
    for proj in ("proj_in", "proj_out"):
        if proj_linear:  # newer diffusers: a Linear [O, I]
            sd[f"{name}.{proj}.weight"] = np.ascontiguousarray(
                _conv(p[proj]["kernel"])[:, :, 0, 0])
            sd[f"{name}.{proj}.bias"] = p[proj]["bias"]
        else:
            _put_conv(sd, f"{name}.{proj}", p[proj])
    b, t = p["block"], name + ".transformer_blocks.0"
    for i in (1, 2, 3):
        _put_norm(sd, f"{t}.norm{i}", b[f"ln{i}"])
    for ours, theirs in _TX:
        _put_linear(sd, f"{t}.{theirs}", b[ours])


def _numbered(node: dict, stem: str) -> list[str]:
    return sorted((k for k in node if k.startswith(stem) and k[len(stem):].isdigit()),
                  key=lambda k: int(k[len(stem):]))


def unet_state(tree: dict, proj_linear: bool = False) -> dict:
    """``models.sd_unet`` params → a ``UNet2DConditionModel`` state dict."""
    sd: dict = {}
    _put_linear(sd, "time_embedding.linear_1", tree["time_mlp1"])
    _put_linear(sd, "time_embedding.linear_2", tree["time_mlp2"])
    _put_conv(sd, "conv_in", tree["conv_in"])
    _put_norm(sd, "conv_norm_out", tree["norm_out"])
    _put_conv(sd, "conv_out", tree["conv_out"])
    for side, theirs, sample in (("down", "down_blocks", "downsamplers"),
                                 ("up", "up_blocks", "upsamplers")):
        for key in _numbered(tree, side):
            blk, base = tree[key], f"{theirs}.{key[len(side):]}"
            for r in _numbered(blk, "res"):
                _put_resnet(sd, f"{base}.resnets.{r[3:]}", blk[r])
            for a in _numbered(blk, "attn"):
                _put_transformer(sd, f"{base}.attentions.{a[4:]}", blk[a], proj_linear)
            if side in blk:
                _put_conv(sd, f"{base}.{sample}.0.conv", blk[side])
    mid = tree["mid"]
    _put_resnet(sd, "mid_block.resnets.0", mid["res0"])
    _put_resnet(sd, "mid_block.resnets.1", mid["res1"])
    _put_transformer(sd, "mid_block.attentions.0", mid["attn"], proj_linear)
    return sd


def vae_state(tree: dict, attn: str = "new", encoder: bool = True) -> dict:
    """``models.sd_vae`` (decoder) params → an ``AutoencoderKL`` state dict.
    ``attn``: ``"new"`` (``group_norm``, ``to_q``, ``to_out.0``), ``"legacy"``
    (``norm``, ``query``, ``proj_attn``) or ``"conv"`` (legacy names, 1x1
    conv weights).  ``encoder`` adds an encoder tensor and ``quant_conv``,
    which the converter must skip."""
    sd: dict = {}
    _put_conv(sd, "post_quant_conv", tree["post_quant"])
    _put_conv(sd, "decoder.conv_in", tree["conv_in"])
    _put_norm(sd, "decoder.conv_norm_out", tree["norm_out"])
    _put_conv(sd, "decoder.conv_out", tree["conv_out"])
    mid = tree["mid"]
    _put_resnet(sd, "decoder.mid_block.resnets.0", mid["res0"])
    _put_resnet(sd, "decoder.mid_block.resnets.1", mid["res1"])
    a, base = mid["attn"], "decoder.mid_block.attentions.0"
    if attn == "new":
        _put_norm(sd, base + ".group_norm", a["norm"])
        for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("out", "to_out.0")):
            _put_linear(sd, f"{base}.{theirs}", a[ours])
    else:
        _put_norm(sd, base + ".norm", a["norm"])
        for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value"), ("out", "proj_attn")):
            _put_linear(sd, f"{base}.{theirs}", a[ours], conv=attn == "conv")
    for key in _numbered(tree, "up"):
        blk, name = tree[key], f"decoder.up_blocks.{key[2:]}"
        for r in _numbered(blk, "res"):
            _put_resnet(sd, f"{name}.resnets.{r[3:]}", blk[r])
        if "up" in blk:
            _put_conv(sd, f"{name}.upsamplers.0.conv", blk["up"])
    if encoder:
        c = tree["conv_in"]["kernel"].shape[2]  # the latent channels
        sd["quant_conv.weight"] = np.zeros((2 * c, 2 * c, 1, 1), np.float32)
        sd["quant_conv.bias"] = np.zeros((2 * c,), np.float32)
        sd["encoder.conv_in.weight"] = np.zeros((tree["conv_out"]["kernel"].shape[2], 3, 3, 3),
                                                np.float32)
    return sd


PARTS = (("text_encoder", "model.safetensors"), ("unet", "diffusion_pytorch_model.safetensors"),
         ("vae", "diffusion_pytorch_model.safetensors"))


def sd15_states(tree: dict, **naming) -> dict[str, dict]:
    """The three parts' state dicts of an SD-1.5 tree (``clip``, ``unet``,
    ``vae``), keyed by their diffusers subdirectory."""
    clip_kw = {k: naming[k] for k in ("prefix", "position_ids") if k in naming}
    unet_kw = {k: naming[k] for k in ("proj_linear",) if k in naming}
    vae_kw = {k: naming[k] for k in ("attn", "encoder") if k in naming}
    return {"text_encoder": clip_state(tree["clip"], **clip_kw),
            "unet": unet_state(tree["unet"], **unet_kw),
            "vae": vae_state(tree["vae"], **vae_kw)}


def write_diffusers_dir(tree: dict, root: str | Path, **naming) -> Path:
    """A diffusers-layout SD-1.5 directory (``text_encoder/``, ``unet/``,
    ``vae/``, each one ``.safetensors`` file written by the port's own
    writer) holding ``tree``; returns ``root``."""
    from pytorch_zappa_serverless_tpu_torch.engine import tensorfile

    root = Path(root)
    states = sd15_states(tree, **naming)
    for part, fname in PARTS:
        (root / part).mkdir(parents=True, exist_ok=True)
        tensorfile.save(states[part], root / part / fname)
    return root
