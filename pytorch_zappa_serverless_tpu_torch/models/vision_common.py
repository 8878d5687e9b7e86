"""Shared servable construction for the image classifiers (ResNet,
EfficientNet, ViT): the JAX package's ``models/vision_common.py``.

The host decodes, resizes and crops each request to **uint8** HWC (4x fewer
bytes over PCIe than f32); one device program — on the GPU one captured CUDA
graph per batch bucket — normalizes, runs the network, takes an f32 softmax
and the top-k, and packs values and indices into one ``topk_packed`` tensor,
so a batch costs one device-to-host copy; the host maps indices to labels.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..engine.servable import Servable
from ..parallel.mesh import CNN_HEAD_TP_RULES
from ..ops.preprocessing import (IMAGENET_MEAN, IMAGENET_STD, normalize_on_device,
                                 preprocess_image_bytes_uint8)
from ..utils.labels import load_labels
from .layers import init_params


def topk_first_index(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row, largest first, and among equal values
    the lower index first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among ties): a stable descending sort, cut to ``k``."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


# The input size unless ``cfg.extra`` sets ``image_size``.
IMAGE_SIZE = 224


def image_tree(name: str, module: nn.Module, cfg: ModelConfig, convert_fn: Callable | None,
               init_fn: Callable = init_params) -> dict:
    """The float tree a classifier loads: a checkpoint through
    ``convert_fn`` (a staged or stream file as it is), else
    ``init_fn(module)`` from a seed (a module on meta will do)."""
    from ..engine import weights as W

    if not cfg.checkpoint:
        return init_fn(module)
    if convert_fn is None and not W.is_native(cfg.checkpoint):
        raise ValueError(f"{name}: no checkpoint converter available")
    return W.import_params(cfg.checkpoint, convert_fn)


def classifier_tree_fn(name: str, make_module: Callable[[ModelConfig], nn.Module],
                 convert_fn: Callable | None, init_fn: Callable = init_params) -> Callable:
    """A family's tree function (``utils.registry.register_tree``): its
    module built on meta by ``make_module(cfg)``, and :func:`image_tree` of
    it."""
    def tree_fn(cfg: ModelConfig) -> tuple[dict, nn.Module]:
        with torch.device("meta"):
            module = make_module(cfg)
        return image_tree(name, module, cfg, convert_fn, init_fn), module
    return tree_fn


def make_image_classifier(name: str, module: nn.Module, cfg: ModelConfig,
                          convert_fn: Callable | None, init_fn: Callable = init_params,
                          resize_to: int = 256, num_classes: int = 1000,
                          norm_mean=IMAGENET_MEAN,
                          norm_std=IMAGENET_STD, tp_rules=None,
                          tp_heads: int | None = None) -> Servable:
    """module: an ``nn.Module`` taking normalized NHWC floats → f32 logits
    over ``num_classes``, with its weights still to load (a checkpoint
    through ``convert_fn``, or ``init_fn(module)`` from a seed).  The
    keyword arguments are the family's input and head (ImageNet's for the
    CNNs; ViT passes its own); ``cfg.extra`` overrides the input size, the
    resize, the normalization and ``topk``.  On a mesh the head shards by
    ``CNN_HEAD_TP_RULES`` unless the family passes its ``tp_rules`` (and its
    attention heads, ``tp_heads``)."""
    from ..engine import weights as W

    image_size = int(cfg.extra.get("image_size", IMAGE_SIZE))
    resize_to = int(cfg.extra.get("resize_to", resize_to))
    module.load_state_dict(W.params_from_jax(image_tree(name, module, cfg, convert_fn, init_fn)),
                           assign=True)
    # Conv weights in channels_last, the activations' layout: cuDNN then
    # takes them as they lie, with no per-call layout copy.
    module.to(memory_format=torch.channels_last).eval()
    # Normalization constants as device buffers (out of the state_dict): the
    # captured graph reads them where they lie.
    for key, default in (("norm_mean", norm_mean), ("norm_std", norm_std)):
        module.register_buffer(key, torch.tensor(np.asarray(
            cfg.extra.get(key, default), np.float32)), persistent=False)
    labels = load_labels(cfg.extra.get("labels"), num_classes)
    if len(labels) < num_classes:
        raise ValueError(f"{name}: labels file has {len(labels)} entries, "
                         f"model has {num_classes} classes")
    topk = int(cfg.extra.get("topk", 5))

    def apply_fn(m, inputs):
        x = normalize_on_device(inputs["image"], m.norm_mean, m.norm_std)
        probs = torch.softmax(m(x).float(), dim=-1)
        values, idx = topk_first_index(probs, topk)
        return {"topk_packed": torch.cat([values, idx.float()], dim=-1)}

    def input_spec(bucket):
        return {"image": ((bucket[0], image_size, image_size, 3), torch.uint8)}

    def preprocess(payload) -> dict:
        if isinstance(payload, (bytes, bytearray)):
            return {"image": preprocess_image_bytes_uint8(bytes(payload), resize_to,
                                                          image_size)}
        # Pre-decoded array path (tests / batch API): HWC uint8.
        arr = np.asarray(payload, dtype=np.uint8)
        if arr.shape != (image_size, image_size, 3):
            raise ValueError(f"expected {(image_size, image_size, 3)} uint8, got {arr.shape}")
        return {"image": arr}

    def postprocess(out, i):
        packed = out["topk_packed"][i]
        values, idx = packed[:topk], packed[topk:].astype(int)
        return {"top_k": [{"label": labels[int(j)], "index": int(j),
                           "prob": float(v)} for v, j in zip(values, idx)]}

    return Servable(name=name, apply_fn=apply_fn, module=module, input_spec=input_spec,
                    preprocess=preprocess, postprocess=postprocess,
                    bucket_axes=("batch",),
                    meta={"num_classes": num_classes,
                          "tp_rules": CNN_HEAD_TP_RULES if tp_rules is None else tp_rules,
                          "tp_heads": tp_heads})
