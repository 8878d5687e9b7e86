"""Checkpoint import and the bridge from the JAX package's param layout.

Weights travel as a nested-dict param tree in the JAX package's layout (the
flax names; dense kernels ``[in, out]``, conv kernels HWIO), which is what
that package's servables hold and what the family converters build from a
torchvision or Hugging Face state dict (``convert_resnet``,
``convert_efficientnet``, ``convert_bert``, ``convert_gpt2``, ``convert_vit``,
``convert_whisper``, and SD-1.5's ``convert_clip_text``, ``convert_sd_unet``,
``convert_sd_vae`` and ``convert_sd15``, copies of that package's own).
:func:`params_from_jax` turns such a tree into the port's ``state_dict``, so
a checkpoint, a seed-initialised tree and the JAX servable's own params all
load through one path, and the parity tests feed both packages the same
bytes.  Safetensors files, staged trees included, are read and written by
:mod:`.tensorfile`, without the ``safetensors`` package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from . import tensorfile


def load_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """Read a torch ``.pt``/``.pth``/``.bin`` or ``.safetensors`` file into
    numpy; bf16 tensors of either kind come back as float32."""
    path = Path(path).expanduser()
    if path.suffix == ".safetensors":
        return tensorfile.load(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16
            else v.detach().numpy() for k, v in sd.items()}


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """OIHW → HWIO (the JAX package's conv layout)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


# Torch depthwise (C, 1, H, W) → HWIO (H, W, 1, C): the same transpose as a
# regular conv; the alias documents intent at call sites.
depthwise_kernel = conv_kernel


def linear_kernel(w: np.ndarray) -> np.ndarray:
    """(out, in) → (in, out)."""
    return np.ascontiguousarray(w.T)


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


_BN_MAP = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def convert_resnet(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """torchvision-format ResNet state_dict → param tree for ``models.resnet``.

    Handles both BasicBlock (resnet18/34) and Bottleneck (resnet50/101) keys.
    """
    params: dict[str, Any] = {}
    for key, w in sd.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if parts[0] == "conv1":
            _set(params, ("conv1", "kernel"), conv_kernel(w))
        elif parts[0] == "bn1":
            _set(params, ("bn1", _BN_MAP[parts[1]]), w)
        elif parts[0] == "fc":
            _set(params, ("fc", "kernel" if parts[1] == "weight" else "bias"),
                 linear_kernel(w) if parts[1] == "weight" else w)
        elif parts[0].startswith("layer"):
            stage = int(parts[0][len("layer"):])  # 1..4
            block = f"layer{stage}_{parts[1]}"
            rest = parts[2:]
            if rest[0] == "downsample":
                if rest[1] == "0":  # conv
                    _set(params, (block, "downsample_conv", "kernel"), conv_kernel(w))
                else:  # "1" → bn
                    _set(params, (block, "downsample_bn", _BN_MAP[rest[2]]), w)
            elif rest[0].startswith("conv"):
                _set(params, (block, rest[0], "kernel"), conv_kernel(w))
            elif rest[0].startswith("bn"):
                _set(params, (block, rest[0], _BN_MAP[rest[1]]), w)
            else:
                raise KeyError(f"unrecognized resnet key: {key}")
        else:
            raise KeyError(f"unrecognized resnet key: {key}")
    return params


def convert_efficientnet(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """HF-transformers-format EfficientNet state_dict → param tree for
    ``models.efficientnet``.

    Accepts both ``EfficientNetModel`` (``efficientnet.`` prefix) and
    ``EfficientNetForImageClassification`` (adds ``classifier.*``) keys.
    """
    params: dict[str, Any] = {}
    for key, w in sd.items():
        parts = key.split(".")
        if parts[0] == "efficientnet":
            parts = parts[1:]
        if parts[-1] == "num_batches_tracked":
            continue
        if parts[0] == "classifier":
            _set(params, ("classifier", "kernel" if parts[1] == "weight" else "bias"),
                 linear_kernel(w) if parts[1] == "weight" else w)
        elif parts[0] == "embeddings":
            if parts[1] == "convolution":
                _set(params, ("stem_conv", "kernel"), conv_kernel(w))
            else:  # batchnorm
                _set(params, ("stem_bn", _BN_MAP[parts[2]]), w)
        elif parts[0] == "encoder":
            if parts[1] == "top_conv":
                _set(params, ("top_conv", "kernel"), conv_kernel(w))
            elif parts[1] == "top_bn":
                _set(params, ("top_bn", _BN_MAP[parts[2]]), w)
            elif parts[1] == "blocks":
                block = f"block{parts[2]}"
                layer, rest = parts[3], parts[4:]
                if layer == "expansion":
                    if rest[0] == "expand_conv":
                        _set(params, (block, "expand_conv", "kernel"), conv_kernel(w))
                    else:
                        _set(params, (block, "expand_bn", _BN_MAP[rest[1]]), w)
                elif layer == "depthwise_conv":
                    if rest[0] == "depthwise_conv":
                        _set(params, (block, "dw_conv", "kernel"), depthwise_kernel(w))
                    else:
                        _set(params, (block, "dw_bn", _BN_MAP[rest[1]]), w)
                elif layer == "squeeze_excite":
                    which = "se_reduce" if rest[0] == "reduce" else "se_expand"
                    if rest[1] == "weight":
                        _set(params, (block, which, "kernel"), conv_kernel(w))
                    else:
                        _set(params, (block, which, "bias"), w)
                elif layer == "projection":
                    if rest[0] == "project_conv":
                        _set(params, (block, "project_conv", "kernel"), conv_kernel(w))
                    else:
                        _set(params, (block, "project_bn", _BN_MAP[rest[1]]), w)
                else:
                    raise KeyError(f"unrecognized efficientnet key: {key}")
            else:
                raise KeyError(f"unrecognized efficientnet key: {key}")
        else:
            raise KeyError(f"unrecognized efficientnet key: {key}")
    return params


_BERT_LN = {"weight": "scale", "bias": "bias", "gamma": "scale", "beta": "bias"}


def convert_bert(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """HF-format BertForSequenceClassification state_dict → param tree."""
    params: dict[str, Any] = {}

    def dense(path, parts, w):
        _set(params, path + ("kernel" if parts[-1] == "weight" else "bias",),
             linear_kernel(w) if parts[-1] == "weight" else w)

    for key, w in sd.items():
        parts = key.split(".")
        if parts[0] == "bert":
            parts = parts[1:]
        if parts[-1] == "position_ids":  # non-weight buffer
            continue
        if parts[0] == "embeddings":
            if parts[1] == "LayerNorm":
                _set(params, ("embeddings_ln", _BERT_LN[parts[2]]), w)
            else:  # word/position/token_type embeddings
                _set(params, (parts[1], "embedding"), w)
        elif parts[0] == "encoder":
            layer = f"layer{parts[2]}"
            rest = parts[3:]
            if rest[0] == "attention":
                if rest[1] == "self":
                    dense((layer, "attention", rest[2]), rest, w)
                elif rest[2] == "dense":
                    dense((layer, "attention_output"), rest, w)
                else:  # attention.output.LayerNorm
                    _set(params, (layer, "attention_ln", _BERT_LN[rest[3]]), w)
            elif rest[0] == "intermediate":
                dense((layer, "intermediate"), rest, w)
            elif rest[0] == "output":
                if rest[1] == "dense":
                    dense((layer, "output"), rest, w)
                else:
                    _set(params, (layer, "output_ln", _BERT_LN[rest[2]]), w)
            else:
                raise KeyError(f"unrecognized bert key: {key}")
        elif parts[0] == "pooler":
            dense(("pooler",), parts, w)
        elif parts[0] == "classifier":
            dense(("classifier",), parts, w)
        elif parts[0] == "cls":  # pretraining heads — not served
            continue
        else:
            raise KeyError(f"unrecognized bert key: {key}")
    return params


def convert_gpt2(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """HF-format GPT2LMHeadModel state_dict → param tree for ``models.gpt2``.

    HF GPT-2's Conv1D modules store weights ``[in, out]``, the tree's own
    orientation, so kernels map without a transpose.  The fused ``c_attn``
    ``[D, 3D]`` splits into q/k/v.  ``lm_head.weight`` is tied to ``wte``
    and ``attn.bias`` / ``masked_bias`` are mask buffers: all skipped.
    """
    params: dict[str, Any] = {}
    ln_names = {"weight": "scale", "bias": "bias"}
    for key, w in sd.items():
        parts = key.split(".")
        if parts[0] == "transformer":
            parts = parts[1:]
        if parts[0] == "lm_head" or parts[-1] == "masked_bias" or parts[-1] == "bias" \
                and parts[-2] == "attn":
            continue
        if parts[0] in ("wte", "wpe"):
            _set(params, (parts[0],), w)
        elif parts[0] == "ln_f":
            _set(params, ("ln_f", ln_names[parts[1]]), w)
        elif parts[0] == "h":
            layer = f"layer{parts[1]}"
            rest = parts[2:]
            leaf = "kernel" if rest[-1] == "weight" else "bias"
            if rest[0] in ("ln_1", "ln_2"):
                name = "ln1" if rest[0] == "ln_1" else "ln2"
                _set(params, (layer, name, ln_names[rest[1]]), w)
            elif rest[0] == "attn" and rest[1] == "c_attn":
                for sub, piece in zip(("q", "k", "v"), np.split(w, 3, axis=-1)):
                    _set(params, (layer, sub, leaf), np.ascontiguousarray(piece))
            elif rest[0] == "attn" and rest[1] == "c_proj":
                _set(params, (layer, "out", leaf), w)
            elif rest[0] == "mlp" and rest[1] == "c_fc":
                _set(params, (layer, "fc1", leaf), w)
            elif rest[0] == "mlp" and rest[1] == "c_proj":
                _set(params, (layer, "fc2", leaf), w)
            else:
                raise KeyError(f"unrecognized gpt2 key: {key}")
        else:
            raise KeyError(f"unrecognized gpt2 key: {key}")
    return params


def convert_vit(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """HF-format ViTForImageClassification state_dict → param tree for
    ``models.vit``, whose layer names are BERT's."""
    params: dict[str, Any] = {}

    def dense(path, leaf, w):
        _set(params, path + ("kernel" if leaf == "weight" else "bias",),
             linear_kernel(w) if leaf == "weight" else w)

    for key, w in sd.items():
        parts = key.split(".")
        if parts[0] == "vit":
            parts = parts[1:]
        if parts[0] == "embeddings":
            if parts[1] == "cls_token":
                _set(params, ("cls_token",), w)
            elif parts[1] == "position_embeddings":
                _set(params, ("pos_embed",), w)
            elif parts[1] == "patch_embeddings":
                _set(params, ("patch_embed", "kernel" if parts[-1] == "weight" else "bias"),
                     conv_kernel(w) if parts[-1] == "weight" else w)
            else:
                raise KeyError(f"unrecognized vit key: {key}")
        elif parts[0] == "encoder":
            layer = f"layer{parts[2]}"
            rest = parts[3:]
            if rest[0] == "attention":
                if rest[1] == "attention":  # .attention.attention.{query,key,value}
                    dense((layer, "attention", rest[2]), rest[-1], w)
                else:  # .attention.output.dense
                    dense((layer, "attention_output"), rest[-1], w)
            elif rest[0] in ("layernorm_before", "layernorm_after"):
                name = "ln_before" if rest[0] == "layernorm_before" else "ln_after"
                _set(params, (layer, name, _BERT_LN[rest[1]]), w)
            elif rest[0] == "intermediate":
                dense((layer, "intermediate"), rest[-1], w)
            elif rest[0] == "output":
                dense((layer, "output"), rest[-1], w)
            else:
                raise KeyError(f"unrecognized vit key: {key}")
        elif parts[0] == "layernorm":
            _set(params, ("final_ln", _BERT_LN[parts[1]]), w)
        elif parts[0] == "classifier":
            dense(("classifier",), parts[-1], w)
        elif parts[0] == "pooler":  # ViTModel's pooler: the classifier does not use it
            continue
        else:
            raise KeyError(f"unrecognized vit key: {key}")
    return params


def convert_whisper(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """HF-format Whisper state_dict → param tree for ``models.whisper`` (the
    stem's conv weights ``(out, in, k)`` → ``(k, in, out)``; ``proj_out`` is
    tied to ``decoder.embed_tokens`` and skipped)."""
    params: dict[str, Any] = {"encoder": {}, "decoder": {}}
    attn_map = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "out"}
    cross_map = {"q_proj": "cq", "k_proj": "ck", "v_proj": "cv", "out_proj": "cout"}

    def dense(side, path, leaf, w):
        _set(params[side], path + ("kernel" if leaf == "weight" else "bias",),
             linear_kernel(w) if leaf == "weight" else w)

    for key, w in sd.items():
        parts = key.split(".")
        if parts[0] == "model":
            parts = parts[1:]
        if parts[0] == "proj_out":
            continue
        side = parts[0]
        if side not in ("encoder", "decoder"):
            raise KeyError(f"unrecognized whisper key: {key}")
        rest = parts[1:]
        if rest[0] in ("conv1", "conv2"):
            if rest[1] == "weight":
                _set(params[side], (rest[0], "kernel"),
                     np.ascontiguousarray(np.transpose(w, (2, 1, 0))))
            else:
                _set(params[side], (rest[0], "bias"), w)
        elif rest[0] == "embed_positions":
            _set(params[side], ("pos_embed",), w)
        elif rest[0] == "embed_tokens":
            _set(params[side], ("embed_tokens",), w)
        elif rest[0] == "layer_norm":
            _set(params[side], ("final_ln", _BERT_LN[rest[1]]), w)
        elif rest[0] == "layers":
            layer = f"layer{rest[1]}"
            sub, tail = rest[2], rest[3:]
            if sub == "self_attn":
                dense(side, (layer, attn_map[tail[0]]), tail[1], w)
            elif sub == "encoder_attn":
                dense(side, (layer, cross_map[tail[0]]), tail[1], w)
            elif sub == "self_attn_layer_norm":
                _set(params[side], (layer, "self_ln", _BERT_LN[tail[0]]), w)
            elif sub == "encoder_attn_layer_norm":
                _set(params[side], (layer, "cross_ln", _BERT_LN[tail[0]]), w)
            elif sub in ("fc1", "fc2"):
                dense(side, (layer, sub), tail[0], w)
            elif sub == "final_layer_norm":  # the FFN's pre-LN in the pre-LN layout
                _set(params[side], (layer, "ffn_ln", _BERT_LN[tail[0]]), w)
            else:
                raise KeyError(f"unrecognized whisper key: {key}")
        else:
            raise KeyError(f"unrecognized whisper key: {key}")
    return params


def convert_clip_text(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """HF-format CLIPTextModel state_dict → params for models.clip_text."""
    params: dict[str, Any] = {}
    attn_map = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "out"}
    for key, w in sd.items():
        parts = key.split(".")
        if parts[0] == "text_model":
            parts = parts[1:]
        if parts[-1] == "position_ids":  # non-weight buffer
            continue
        if parts[0] == "embeddings":
            if parts[1] == "token_embedding":
                _set(params, ("token_embedding",), w)
            elif parts[1] == "position_embedding":
                _set(params, ("pos_embedding",), w)
            else:
                raise KeyError(f"unrecognized clip key: {key}")
        elif parts[0] == "encoder":
            layer = f"layer{parts[2]}"
            sub, tail = parts[3], parts[4:]
            if sub == "self_attn":
                _set(params, (layer, attn_map[tail[0]],
                              "kernel" if tail[1] == "weight" else "bias"),
                     linear_kernel(w) if tail[1] == "weight" else w)
            elif sub in ("layer_norm1", "layer_norm2"):
                _set(params, (layer, "ln1" if sub.endswith("1") else "ln2",
                              _BERT_LN[tail[0]]), w)
            elif sub == "mlp":
                _set(params, (layer, tail[0], "kernel" if tail[1] == "weight" else "bias"),
                     linear_kernel(w) if tail[1] == "weight" else w)
            else:
                raise KeyError(f"unrecognized clip key: {key}")
        elif parts[0] == "final_layer_norm":
            _set(params, ("final_ln", _BERT_LN[parts[1]]), w)
        else:
            raise KeyError(f"unrecognized clip key: {key}")
    return params


def _conv_or_linear(w: np.ndarray) -> np.ndarray:
    """1x1-conv weights appear as either conv [O,I,1,1] or linear [O,I]
    across diffusers versions; both land on our HWIO 1x1 conv kernel."""
    if w.ndim == 2:
        return linear_kernel(w)[None, None]
    return conv_kernel(w)


_SD_RES = {"norm1": ("norm1",), "conv1": ("conv1",), "time_emb_proj": ("time_emb",),
           "norm2": ("norm2",), "conv2": ("conv2",), "conv_shortcut": ("shortcut",)}

_SD_TX = {  # transformer_blocks.0.<torch> → our attn param path
    ("norm1",): ("ln1",), ("norm2",): ("ln2",), ("norm3",): ("ln3",),
    ("attn1", "to_q"): ("self_q",), ("attn1", "to_k"): ("self_k",),
    ("attn1", "to_v"): ("self_v",), ("attn1", "to_out", "0"): ("self_out",),
    ("attn2", "to_q"): ("cross_q",), ("attn2", "to_k"): ("cross_k",),
    ("attn2", "to_v"): ("cross_v",), ("attn2", "to_out", "0"): ("cross_out",),
    ("ff", "net", "0", "proj"): ("ff1",), ("ff", "net", "2"): ("ff2",),
}


def _sd_set(params, path, parts, w):
    """Route one leaf by kind: conv (4d kernel), norm/linear weight, bias."""
    leaf = parts[-1]
    kind = parts[-2] if len(parts) > 1 else ""
    is_norm = (kind.startswith(("norm", "ln", "group_norm"))
               or path[-1].startswith(("norm", "ln")))
    if leaf == "bias":
        _set(params, path + ("bias",), w)
    elif is_norm:
        _set(params, path + (_BERT_LN[leaf],), w)
    elif w.ndim == 4:
        _set(params, path + ("kernel",), conv_kernel(w))
    else:
        _set(params, path + ("kernel",), linear_kernel(w))


def _convert_sd_resnet(params, block_path, rest, w):
    name = rest[0]
    _sd_set(params, block_path + _SD_RES[name], rest, w)


def _convert_sd_transformer(params, attn_path, rest, w):
    if rest[0] in ("norm", "group_norm"):
        _set(params, attn_path + ("norm", _BERT_LN[rest[1]]), w)
    elif rest[0] in ("proj_in", "proj_out"):
        if rest[1] == "weight":
            _set(params, attn_path + (rest[0], "kernel"), _conv_or_linear(w))
        else:
            _set(params, attn_path + (rest[0], "bias"), w)
    elif rest[0] == "transformer_blocks":
        tail = tuple(rest[2:-1])
        ours = _SD_TX[tail]
        leaf = rest[-1]
        if leaf == "bias":
            _set(params, attn_path + ("block",) + ours + ("bias",), w)
        elif tail[0].startswith("norm"):
            _set(params, attn_path + ("block",) + ours + (_BERT_LN[leaf],), w)
        else:
            _set(params, attn_path + ("block",) + ours + ("kernel",), linear_kernel(w))
    else:
        raise KeyError(f"unrecognized transformer key tail: {rest}")


def convert_sd_unet(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """diffusers UNet2DConditionModel state_dict → params for models.sd_unet."""
    params: dict[str, Any] = {}
    for key, w in sd.items():
        parts = key.split(".")
        p0 = parts[0]
        if p0 == "time_embedding":
            which = "time_mlp1" if parts[1] == "linear_1" else "time_mlp2"
            _set(params, (which, "kernel" if parts[2] == "weight" else "bias"),
                 linear_kernel(w) if parts[2] == "weight" else w)
        elif p0 in ("conv_in", "conv_out"):
            _set(params, (p0, "kernel" if parts[1] == "weight" else "bias"),
                 conv_kernel(w) if parts[1] == "weight" else w)
        elif p0 == "conv_norm_out":
            _set(params, ("norm_out", _BERT_LN[parts[1]]), w)
        elif p0 in ("down_blocks", "up_blocks"):
            b = int(parts[1])
            block = ("down" if p0 == "down_blocks" else "up") + str(b)
            sub, rest = parts[2], parts[3:]
            if sub == "resnets":
                _convert_sd_resnet(params, (block, f"res{rest[0]}"), rest[1:], w)
            elif sub == "attentions":
                _convert_sd_transformer(params, (block, f"attn{rest[0]}"), rest[1:], w)
            elif sub == "downsamplers":  # downsamplers.0.conv.{weight,bias}
                _set(params, (block, "down", "kernel" if rest[2] == "weight" else "bias"),
                     conv_kernel(w) if rest[2] == "weight" else w)
            elif sub == "upsamplers":  # upsamplers.0.conv.{weight,bias}
                _set(params, (block, "up", "kernel" if rest[2] == "weight" else "bias"),
                     conv_kernel(w) if rest[2] == "weight" else w)
            else:
                raise KeyError(f"unrecognized unet key: {key}")
        elif p0 == "mid_block":
            sub, rest = parts[1], parts[2:]
            if sub == "resnets":
                _convert_sd_resnet(params, ("mid", f"res{rest[0]}"), rest[1:], w)
            elif sub == "attentions":
                _convert_sd_transformer(params, ("mid", "attn"), rest[1:], w)
            else:
                raise KeyError(f"unrecognized unet key: {key}")
        else:
            raise KeyError(f"unrecognized unet key: {key}")
    return params


_VAE_ATTN = {  # new diffusers naming and the legacy one
    "to_q": "q", "to_k": "k", "to_v": "v", "query": "q", "key": "k", "value": "v",
}


def convert_sd_vae(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """diffusers AutoencoderKL state_dict → decoder params for models.sd_vae.

    Encoder-side keys (``encoder.*``, ``quant_conv``) are skipped — txt2img
    never encodes pixels.
    """
    params: dict[str, Any] = {}

    def linear_leaf(path, leaf, w):
        if leaf == "bias":
            _set(params, path + ("bias",), w)
        else:
            if w.ndim == 4:  # very old checkpoints store 1x1 convs
                w = w[:, :, 0, 0]
            _set(params, path + ("kernel",), linear_kernel(w))

    for key, w in sd.items():
        parts = key.split(".")
        if parts[0] in ("encoder", "quant_conv"):
            continue
        if parts[0] == "post_quant_conv":
            _set(params, ("post_quant", "kernel" if parts[1] == "weight" else "bias"),
                 conv_kernel(w) if parts[1] == "weight" else w)
            continue
        assert parts[0] == "decoder", f"unrecognized vae key: {key}"
        parts = parts[1:]
        p0 = parts[0]
        if p0 in ("conv_in", "conv_out"):
            _set(params, (p0, "kernel" if parts[1] == "weight" else "bias"),
                 conv_kernel(w) if parts[1] == "weight" else w)
        elif p0 == "conv_norm_out":
            _set(params, ("norm_out", _BERT_LN[parts[1]]), w)
        elif p0 == "mid_block":
            sub, rest = parts[1], parts[2:]
            if sub == "resnets":
                _convert_sd_resnet(params, ("mid", f"res{rest[0]}"), rest[1:], w)
            else:  # attentions.0
                rest = rest[1:]
                if rest[0] in ("group_norm", "norm"):
                    _set(params, ("mid", "attn", "norm", _BERT_LN[rest[1]]), w)
                elif rest[0] in _VAE_ATTN:
                    linear_leaf(("mid", "attn", _VAE_ATTN[rest[0]]), rest[1], w)
                elif rest[0] in ("to_out", "proj_attn"):
                    leaf = rest[2] if rest[0] == "to_out" else rest[1]
                    linear_leaf(("mid", "attn", "out"), leaf, w)
                else:
                    raise KeyError(f"unrecognized vae key: {key}")
        elif p0 == "up_blocks":
            block = f"up{parts[1]}"
            sub, rest = parts[2], parts[3:]
            if sub == "resnets":
                _convert_sd_resnet(params, (block, f"res{rest[0]}"), rest[1:], w)
            elif sub == "upsamplers":  # upsamplers.0.conv.{weight,bias}
                _set(params, (block, "up", "kernel" if rest[2] == "weight" else "bias"),
                     conv_kernel(w) if rest[2] == "weight" else w)
            else:
                raise KeyError(f"unrecognized vae key: {key}")
        else:
            raise KeyError(f"unrecognized vae key: {key}")
    return params


def convert_sd15(path: str | Path) -> dict[str, Any]:
    """A diffusers-layout SD-1.5 checkpoint directory → full pipeline params.

    Expects ``text_encoder/``, ``unet/``, ``vae/`` subdirectories each holding
    a ``*.safetensors`` or ``*.bin`` model file (the HF hub layout).  A single
    flat file with ``text_encoder.``/``unet.``/``vae.`` key prefixes also
    works (our own re-export format).
    """
    path = Path(path).expanduser()
    if path.is_dir():
        def load_part(name):
            part = path / name
            files = sorted(part.glob("*.safetensors")) or sorted(part.glob("*.bin"))
            if not files:
                raise FileNotFoundError(f"no model file under {part}")
            return load_state_dict(files[0])

        return {"clip": convert_clip_text(load_part("text_encoder")),
                "unet": convert_sd_unet(load_part("unet")),
                "vae": convert_sd_vae(load_part("vae"))}
    sd = load_state_dict(path)
    split = {"text_encoder": {}, "unet": {}, "vae": {}}
    for key, w in sd.items():
        prefix, rest = key.split(".", 1)
        if prefix in split:
            split[prefix][rest] = w
    return {"clip": convert_clip_text(split["text_encoder"]),
            "unet": convert_sd_unet(split["unet"]),
            "vae": convert_sd_vae(split["vae"])}


def assert_tree_shapes_match(converted, reference, path=""):
    """Raise with a per-leaf report if two param pytrees disagree in structure/shape."""
    if isinstance(reference, Mapping):
        missing = set(reference) - set(converted)
        extra = set(converted) - set(reference)
        if missing or extra:
            raise ValueError(f"at {path or '<root>'}: missing={sorted(missing)} extra={sorted(extra)}")
        for k in reference:
            assert_tree_shapes_match(converted[k], reference[k], f"{path}/{k}")
    else:
        if tuple(np.shape(converted)) != tuple(np.shape(reference)):
            raise ValueError(
                f"at {path}: shape {np.shape(converted)} != expected {np.shape(reference)}")


class _Draw:
    """A draw's shape alone: the init's scaling keeps it, and ``astype``
    makes a zero-stride array of that shape and dtype."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __mul__(self, other):
        return self

    __truediv__ = __mul__

    def astype(self, dtype):
        return np.broadcast_to(np.zeros((), dtype), self.shape)


class ShapeDraws:
    """Stands in for ``np.random.default_rng(seed)`` in a seeded init
    function (``rng=ShapeDraws()``), which then returns the family's tree
    with every drawn leaf a zero-stride array: its shapes and dtypes, what
    :func:`assert_tree_shapes_match` reads, at no cost in draws or memory."""

    def standard_normal(self, shape):
        return _Draw(shape)


def meta_tree(tree: Mapping[str, Any]) -> dict[str, Any]:
    """The tree with each leaf a tensor on the ``meta`` device of its shape
    and dtype: :func:`params_from_jax` of it is a ``state_dict`` that loads
    into a module built on ``meta`` with every key and shape checked and no
    byte copied."""
    def leaf(value):
        value = np.asarray(value)
        return torch.empty(value.shape, dtype=torch.from_numpy(np.empty(0, value.dtype)).dtype,
                           device="meta")

    return {k: meta_tree(v) if isinstance(v, Mapping) else leaf(v) for k, v in tree.items()}


# A staged checkpoint: the param tree already converted to the JAX package's
# layout, in one safetensors file with the tree keys joined by "/" (what that
# package's ``tpuserve stage`` writes), so loading it runs no converter.
NATIVE_SUFFIX = ".tpu.safetensors"


def is_native(path: str | Path) -> bool:
    return str(path).endswith(NATIVE_SUFFIX)


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """A nested tree → ``{"a/b/c": leaf}``; torch tensors stay tensors,
    anything else becomes a numpy array."""
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        if "/" in key:
            raise ValueError(f"param name {key!r} contains the '/' separator")
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = value if isinstance(value, torch.Tensor) else np.asarray(value)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_native(params: Mapping[str, Any], path: str | Path) -> None:
    """Stage a param tree (JAX layout, numpy leaves) as ``*.tpu.safetensors``
    (through :mod:`.tensorfile`, not the ``safetensors`` package)."""
    if not is_native(path):
        raise ValueError(f"staged params path must end with {NATIVE_SUFFIX}: {path}")
    tensorfile.save(flatten_tree(params), path)


def load_native(path: str | Path) -> dict[str, Any]:
    return unflatten_tree(tensorfile.load(path))


def import_params(checkpoint: str | Path, converter) -> dict[str, Any]:
    """A checkpoint file → param tree: a ``*.tpu.ckpt`` stream or a staged
    ``*.tpu.safetensors`` tree as it is, anything else through a family
    converter."""
    if is_stream(checkpoint):
        return open_stream(checkpoint)[0]
    if is_native(checkpoint):
        return load_native(checkpoint)
    return converter(load_state_dict(checkpoint))


# ---------------------------------------------------------------------------
# The stream format (engine/streamio.py): the loading-ordered sibling of the
# staged-native file above.  The same flattened tree, laid out as fixed-size
# hashed chunks in layer execution order, so a load overlaps the disk read
# with the copies to the device.  The bytes are the JAX package's format:
# either package opens what the other's ``save_stream`` wrote.
# ---------------------------------------------------------------------------

STREAM_SUFFIX = ".tpu.ckpt"


def is_stream(path: str | Path) -> bool:
    return str(path).endswith(STREAM_SUFFIX)


def save_stream(params: Mapping[str, Any], path: str | Path, chunk_bytes: int | None = None):
    """Write a param tree (numpy or torch leaves) as a chunked stream
    checkpoint; returns the index."""
    from . import streamio

    if not is_stream(path):
        raise ValueError(f"stream params path must end with {STREAM_SUFFIX}: {path}")
    return streamio.write_stream_file(flatten_tree(params), path,
                                      chunk_bytes or streamio.DEFAULT_CHUNK_BYTES)


def open_stream(path: str | Path, *, place_fn=None, on_layer=None,
                chaos_fn=None) -> tuple[dict[str, Any], Any]:
    """Streamed load of a ``*.tpu.ckpt``; returns ``(params, stats)``, the
    leaves CPU tensors (or what ``place_fn`` made of each, e.g.
    ``streamio.device_placer``'s device copy, the moment its bytes land);
    ``on_layer`` fires per completed execution-order layer."""
    from . import streamio

    flat, stats = streamio.load_stream_file(Path(path).expanduser(), place_fn=place_fn,
                                            on_layer=on_layer, chaos_fn=chaos_fn)
    return unflatten_tree(flat), stats


def _leaf_tensor(value) -> torch.Tensor:
    """A tree leaf as a CPU tensor: a tensor (a stream's, bf16 included) as
    it is, anything else through numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach() if value.is_meta else value.detach().cpu()
    return torch.from_numpy(np.asarray(value))


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A param tree in the JAX package's layout → the port's ``state_dict``.

    - float dense ``kernel [in, out]`` → ``weight [out, in]`` (the inverse
      of :func:`linear_kernel`);
    - conv ``kernel [kh, kw, in, out]`` (HWIO) → ``weight [out, in, kh, kw]``
      (OIHW, the inverse of the JAX package's ``conv_kernel``);
    - int8 nodes keep ``kernel_q [K, N]`` and ``scale [N]`` as they are:
      that is the kernel's own layout;
    - depthwise ``kernel [kh, kw, 1, C]`` → ``weight [C, 1, kh, kw]`` (the
      same transpose);
    - LayerNorm/GroupNorm/BatchNorm ``scale`` → ``weight``; ``embedding``
      tables → ``weight``;
    - everything else keeps its name.  Submodule paths join with ".".
    """
    sd: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str):
        quantized = "kernel_q" in node
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            t = _leaf_tensor(value)
            if key == "kernel":
                key, t = "weight", (t.permute(3, 2, 0, 1) if t.ndim == 4
                                    else t.permute(*reversed(range(t.ndim))))
            elif key == "embedding" or (key == "scale" and not quantized):
                key = "weight"
            sd[prefix + key] = t.clone(memory_format=torch.contiguous_format)

    walk(tree, "")
    return sd


def tree_state_from_jax(tree: Mapping[str, Any], dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A param tree of a model written over a param dict (GPT-2, Whisper;
    numpy, the JAX package's layout) → a ``state_dict`` for
    :class:`ParamTree` that keeps that layout: names as they are, dense
    kernels ``[in, out]`` and int8 ``kernel_q [K, N]`` row-major and
    contiguous, the layout ``int8_matmul`` and the fused decode kernels
    read.  Float leaves of two or more dims are held in ``dtype`` (the JAX
    package casts them to the compute dtype at every use, or holds them in
    bf16 on the int8 lane); 1-D leaves (norms, biases, scales) and int8
    leaves keep their dtype."""
    sd: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            t = _leaf_tensor(value).clone(memory_format=torch.contiguous_format)
            if t.is_floating_point() and t.ndim >= 2:
                t = t.to(dtype)
            sd[prefix + key] = t

    walk(tree, "")
    return sd


class ParamTree(nn.Module):
    """A ``state_dict`` held as nested modules of buffers, for models written
    as functions over a param dict (the JAX package's style): ``.to()``
    places every tensor, and :meth:`tree` hands the functions the nested
    dict of the tensors as they now lie."""

    def __init__(self, sd: Mapping[str, torch.Tensor]):
        super().__init__()
        for key, value in sd.items():
            *path, leaf = key.split(".")
            node: nn.Module = self
            for name in path:
                if name not in node._modules:
                    node.add_module(name, nn.Module())
                node = node._modules[name]
            node.register_buffer(leaf, value)

    def tree(self) -> dict[str, Any]:
        """The nested dict; a node a mesh made row-parallel
        (``parallel.mesh.shard_params``) carries its axis group under
        ``tp_reduce``."""
        def walk(m: nn.Module) -> dict[str, Any]:
            node = {**m._buffers, **{k: walk(c) for k, c in m._modules.items()}}
            if getattr(m, "tp_reduce", None) is not None:
                node["tp_reduce"] = m.tp_reduce
            return node

        return walk(self)


# ---------------------------------------------------------------------------
# LoRA adapters (serving/adapters.py): per-tenant low-rank fine-tunes of a
# frozen base.  A torch/PEFT state dict converts mechanically, and the
# staged-native ``*.tpu.safetensors`` form applies unchanged; the bytes of
# each function's output are the JAX package's.
# ---------------------------------------------------------------------------

_LORA_PROJ = {"q": "q", "k": "k", "v": "v", "out": "out", "fc1": "fc1", "fc2": "fc2",
              "q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "out",
              "attn.c_proj": "out", "mlp.c_fc": "fc1", "mlp.c_proj": "fc2", "c_fc": "fc1"}


def convert_lora(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """A torch/PEFT LoRA state dict → an adapter tree.

    Takes keys like ``base_model.model.transformer.h.{i}.attn.{proj}
    .lora_A.weight`` (PEFT) or the bare ``h.{i}.{proj}.lora_A.weight``.
    Torch holds ``lora_A [r, in]`` and ``lora_B [out, r]``; the tree holds
    ``a [in, r]`` and ``b [r, out]``.  GPT-2's fused ``c_attn`` splits
    exactly: ``delta_W = B @ A`` with ``B [3D, r]``, whose rows are q|k|v,
    so each projection gets the shared ``A`` and its third of ``B``.

    Returns ``{layer{i}: {proj: {"a": [K, r], "b": [r, N]}}}``."""
    halves: dict[tuple[str, str], dict[str, np.ndarray]] = {}
    for key, w in sd.items():
        if ".lora_A." in key:
            path, half = key.split(".lora_A."), "a"
        elif ".lora_B." in key:
            path, half = key.split(".lora_B."), "b"
        else:
            continue
        parts = [p for p in path[0].split(".")
                 if p not in ("base_model", "model", "transformer", "default")]
        if parts and parts[0] == "h":
            parts = parts[1:]
        if len(parts) < 2 or not parts[0].isdigit():
            raise KeyError(f"unrecognized lora key: {key}")
        layer, proj = f"layer{parts[0]}", ".".join(parts[1:])
        if proj.startswith("attn.") and proj != "attn.c_proj":
            proj = proj[len("attn."):]  # attn.c_attn, attn.q_proj, ...
        halves.setdefault((layer, proj), {})[half] = np.asarray(w, np.float32)
    out: dict[str, Any] = {}
    for (layer, proj), node in sorted(halves.items()):
        if "a" not in node or "b" not in node:
            raise KeyError(f"lora pair incomplete for {layer}.{proj}")
        a = np.ascontiguousarray(node["a"].T)   # [r, in] -> [in, r]
        b = np.ascontiguousarray(node["b"].T)   # [out, r] -> [r, out]
        if proj == "c_attn":
            for sub, piece in zip(("q", "k", "v"), np.split(b, 3, axis=1)):
                _set(out, (layer, sub, "a"), a)
                _set(out, (layer, sub, "b"), np.ascontiguousarray(piece))
            continue
        ours = _LORA_PROJ.get(proj)
        if ours is None:
            raise KeyError(f"unrecognized lora projection {proj!r} in {layer}")
        _set(out, (layer, ours, "a"), a)
        _set(out, (layer, ours, "b"), b)
    if not out:
        raise ValueError("state dict carries no lora_A/lora_B pairs")
    return out


def import_adapter(checkpoint: str | Path) -> dict[str, Any]:
    """One adapter from a file: a staged-native tree as it is, anything else
    through :func:`convert_lora`."""
    if is_native(checkpoint):
        return load_native(checkpoint)
    return convert_lora(load_state_dict(checkpoint))


def save_adapter(tree: Mapping[str, Any], path: str | Path) -> None:
    """Stage an adapter tree in the native format."""
    save_native(tree, path)


def merge_adapter(params: dict[str, Any], adapter: Mapping[str, Any],
                  scaling: float = 1.0) -> dict[str, Any]:
    """Fold an adapter into the base kernels: ``W + A @ B * scaling``, for a
    tenant served as a plain model of its own.  Returns a new tree; the
    base is untouched."""
    def copy(node):
        return {k: copy(v) if isinstance(v, dict) else v for k, v in node.items()}

    out = copy(params)
    for lname, layer in adapter.items():
        for proj, node in layer.items():
            dst = out[lname][proj]
            a = np.asarray(node["a"], np.float32)
            b = np.asarray(node["b"], np.float32)
            dst["kernel"] = np.asarray(dst["kernel"], np.float32) + a @ b * float(scaling)
    return out


def init_lora(layers: int, dims: Mapping[str, tuple[int, int]], rank: int, seed: int = 0,
              scale: float = 0.05) -> dict[str, Any]:
    """A seeded random adapter (dev mode): both factors non-zero, unlike a
    training init, so that distinct dev adapters give distinct outputs."""
    g = np.random.default_rng(seed)
    return {f"layer{i}": {t: {
        "a": (g.standard_normal((k, rank)) * scale).astype(np.float32),
        "b": (g.standard_normal((rank, n)) * scale).astype(np.float32)}
        for t, (k, n) in dims.items()}
        for i in range(layers)}
