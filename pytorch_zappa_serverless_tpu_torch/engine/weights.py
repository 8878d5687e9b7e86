"""Checkpoint import and the bridge from the JAX package's param layout.

Weights travel as a nested-dict param tree in the JAX package's layout (the
flax names; dense kernels ``[in, out]``), which is what that package's
servables hold and what ``convert_bert`` builds from a Hugging Face state
dict.  :func:`params_from_jax` turns such a tree into the port's
``state_dict``, so a checkpoint, a seed-initialised tree and the JAX
servable's own params all load through one path, and the parity tests feed
both packages the same bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def load_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """Read a torch ``.pt``/``.pth`` or ``.safetensors`` file into numpy."""
    path = Path(path).expanduser()
    if path.suffix == ".safetensors":
        from safetensors.numpy import load_file

        return dict(load_file(str(path)))
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16
            else v.detach().numpy() for k, v in sd.items()}


def linear_kernel(w: np.ndarray) -> np.ndarray:
    """(out, in) → (in, out)."""
    return np.ascontiguousarray(w.T)


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


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


# A staged checkpoint: the param tree already converted to the JAX package's
# layout, in one safetensors file with the tree keys joined by "/" (what that
# package's ``tpuserve stage`` writes), so loading it runs no converter.
NATIVE_SUFFIX = ".tpu.safetensors"


def is_native(path: str | Path) -> bool:
    return str(path).endswith(NATIVE_SUFFIX)


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if "/" in key:
            raise ValueError(f"param name {key!r} contains the '/' separator")
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
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
    """Stage a param tree (JAX layout, numpy leaves) as ``*.tpu.safetensors``."""
    from safetensors.numpy import save_file

    if not is_native(path):
        raise ValueError(f"staged params path must end with {NATIVE_SUFFIX}: {path}")
    save_file({k: np.ascontiguousarray(v) for k, v in flatten_tree(params).items()},
              str(path))


def load_native(path: str | Path) -> dict[str, Any]:
    from safetensors.numpy import load_file

    return unflatten_tree(load_file(str(Path(path).expanduser())))


def import_params(checkpoint: str | Path, converter) -> dict[str, Any]:
    """A checkpoint file → param tree: a staged ``*.tpu.safetensors`` tree as
    it is, anything else through a family converter.  (``.tpu.ckpt``
    streams are not read yet.)"""
    if is_native(checkpoint):
        return load_native(checkpoint)
    return converter(load_state_dict(checkpoint))


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A param tree in the JAX package's layout → the port's ``state_dict``.

    - float dense ``kernel [in, out]`` → ``weight [out, in]`` (the inverse
      of :func:`linear_kernel`);
    - conv ``kernel [kh, kw, in, out]`` (HWIO) → ``weight [out, in, kh, kw]``
      (OIHW, the inverse of the JAX package's ``conv_kernel``);
    - int8 nodes keep ``kernel_q [K, N]`` and ``scale [N]`` as they are:
      that is the kernel's own layout;
    - LayerNorm/GroupNorm ``scale`` → ``weight``; ``embedding`` tables →
      ``weight``;
    - everything else keeps its name.  Submodule paths join with ".".
    """
    sd: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str):
        quantized = "kernel_q" in node
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value)
            if key == "kernel":
                key, arr = "weight", (arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
            elif key == "embedding" or (key == "scale" and not quantized):
                key = "weight"
            sd[prefix + key] = torch.from_numpy(np.array(arr, order="C"))

    walk(tree, "")
    return sd


def gpt2_state_from_jax(tree: Mapping[str, Any], dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A GPT-2 param tree (numpy, the JAX package's layout) → a ``state_dict``
    for :class:`ParamTree` that keeps that layout: names as they are, dense
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
            t = torch.from_numpy(np.array(value, order="C"))
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
        def walk(m: nn.Module) -> dict[str, Any]:
            return {**m._buffers, **{k: walk(c) for k, c in m._modules.items()}}

        return walk(self)
