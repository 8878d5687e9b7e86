"""Asset staging: each configured model's param tree converted once and
saved where serving hosts mount it.

- **Conversion runs here, once.**  Each model's tree is the one its builder
  would load (``utils.registry.register_tree``: a torchvision, Hugging Face
  or diffusers checkpoint through the family converter, a staged or stream
  file as it is, else the seeded init), checked against what it must fit
  (loaded strictly into the family's module on the ``meta`` device, or
  matched leaf for leaf against the seeded tree's shapes), and saved as
  ``assets/<model>/params.tpu.safetensors`` (``engine/weights.py``'s native
  format, written without the ``safetensors`` package).  A serving host
  then runs no converter.  Nothing is placed on a GPU.
- **Quantized lanes stage the float tree.**  ``params_dtype`` ``int8`` and
  ``auto`` rewrite the float tree at build time; the staged file holds the
  tree before that rewrite and the staged config keeps ``params_dtype``, so
  the boot re-quantizes (staging the rewritten tree would feed the rewrite
  its own output, and the held tensors are bf16-rounded).
- Label and tokenizer files named by a path are copied next to the params;
  ``extra.labels`` given as a list stays in the staged config as it is.
- ``config.json`` (``config.dump_config``) points the checkpoint, label and
  tokenizer paths into the staged tree under ``mount_root`` (default
  ``/srv/assets``, the path the rendered Dockerfile mounts).

Output layout::

    <out>/assets/<model>/params.tpu.safetensors
    <out>/assets/<model>/<labels file>      (if configured as a path)
    <out>/assets/<model>/<tokenizer file>   (if configured)
    <out>/config.json
    <out>/stage.json
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import time
from pathlib import Path

import numpy as np
from torch import nn

from ..config import ModelConfig, ServeConfig, dump_config
from ..utils.logging import get_logger, log_event

log = get_logger("deploy.stage")

# extra keys that name host files to copy into the staged asset tree.
_FILE_EXTRAS = ("labels", "tokenizer")


def check_tree(tree: dict, reference) -> None:
    """Raise unless ``tree`` fits ``reference``: a module on the meta device
    it must load into strictly (every key and shape, no byte copied), or
    the seeded tree whose structure and shapes it must match."""
    from ..engine import weights as W

    if isinstance(reference, nn.Module):
        reference.load_state_dict(W.params_from_jax(W.meta_tree(tree)), strict=True)
    else:
        W.assert_tree_shapes_match(tree, reference)


def _stage_model(mc: ModelConfig, out: Path, mount_root: str) -> tuple[ModelConfig, dict]:
    from .. import models as _zoo  # noqa: F401  (populates the registry)
    from ..engine import weights as W
    from ..utils.registry import get_tree_fn

    model_dir = out / "assets" / mc.name
    model_dir.mkdir(parents=True, exist_ok=True)
    staged = dataclasses.replace(mc, extra=dict(mc.extra))
    t0 = time.perf_counter()
    tree, reference = get_tree_fn(mc.builder or mc.name)(mc)
    check_tree(tree, reference)
    params_path = model_dir / ("params" + W.NATIVE_SUFFIX)
    W.save_native(tree, params_path)
    staged.checkpoint = f"{mount_root}/{mc.name}/{params_path.name}"
    info = {"params_bytes": params_path.stat().st_size,
            "param_count": int(sum(np.size(x) for x in W.flatten_tree(tree).values())),
            "source": mc.checkpoint or "random-init"}
    for key in _FILE_EXTRAS:
        src = mc.extra.get(key)
        if not isinstance(src, str) or not src:
            continue
        src = Path(src).expanduser()
        shutil.copy2(src, model_dir / src.name)
        staged.extra[key] = f"{mount_root}/{mc.name}/{src.name}"
    info["seconds"] = round(time.perf_counter() - t0, 3)
    log_event(log, "model staged", model=mc.name, **info)
    return staged, info


def stage_assets(cfg: ServeConfig, out_dir: str | Path = "stage_out",
                 mount_root: str = "/srv/assets") -> dict:
    """Stage every model of ``cfg`` under ``out_dir``; returns the summary
    written to ``stage.json``."""
    out = Path(out_dir).expanduser()
    out.mkdir(parents=True, exist_ok=True)
    staged_models: list[ModelConfig] = []
    manifest: dict[str, dict] = {}
    for mc in cfg.models:
        staged, info = _stage_model(mc, out, mount_root)
        staged_models.append(staged)
        manifest[mc.name] = info
    (out / "config.json").write_text(dump_config(dataclasses.replace(cfg, models=staged_models)))
    summary = {
        "profile": cfg.profile,
        "out_dir": str(out),
        "mount_root": mount_root,
        "models": manifest,
        "total_bytes": sum(m["params_bytes"] for m in manifest.values()),
    }
    (out / "stage.json").write_text(json.dumps(summary, indent=2))
    return summary
