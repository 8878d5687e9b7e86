"""Stable-Diffusion 1.5 txt2img in PyTorch, served on the async job lane.

prompt → CLIP text states → DDIM denoise loop over the UNet with
classifier-free guidance → VAE decode → PNG, through ``POST
/v1/models/sd15:submit`` and ``GET /v1/jobs/{id}``.

- The denoise loop is a Python loop over the schedule rows (the JAX
  package scans them); scheduler constants are precomputed on the host.
- Classifier-free guidance by batch doubling: the UNet runs on [uncond;
  cond] stacked along the batch.
- Compute in ``dtype``; latents and the DDIM update in f32.
- On the job lane the pipeline runs as ``prepare`` (CLIP encode) →
  ``chunk_steps``-step denoise chunks → ``finalize`` (VAE decode), each its
  own dispatch with the device lane released between, so a latency request
  waits at most one chunk (``engine.runner.run_chunked``).  The latents and
  the conditioning stay on the device between chunks.

Scheduler: DDIM (eta=0) with SD's scaled-linear beta schedule (β in
[0.00085, 0.012] in sqrt space, 1000 train steps), "leading" timestep
spacing with steps_offset=1, the JAX package's ``ddim_schedule``.
"""

from __future__ import annotations

import base64
import hashlib
import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .clip_text import VIT_L14, CLIPTextConfig, encode_text, init_clip_text_params
from .sd_unet import SD15_UNET, UNetConfig, init_unet_params, unet_apply
from .sd_vae import SD15_VAE, VAEConfig, init_vae_params, vae_decode


@dataclass(frozen=True)
class SD15Config:
    clip: CLIPTextConfig = VIT_L14
    unet: UNetConfig = SD15_UNET
    vae: VAEConfig = SD15_VAE
    # Training-noise schedule (SD-1.5 scheduler/config.json).
    beta_start: float = 0.00085
    beta_end: float = 0.012
    train_steps: int = 1000
    steps_offset: int = 1


FULL = SD15Config()

# Tiny variant for tests: the same topology (4 stages, attention placement,
# GEGLU, mid attention) at ~1000x fewer FLOPs.
TINY = SD15Config(
    clip=CLIPTextConfig(vocab_size=256, width=32, layers=2, heads=2, mlp_dim=64,
                        max_len=16, bot_id=254, eot_id=255),
    unet=UNetConfig(block_channels=(16, 16, 32, 32), layers_per_block=1,
                    heads=2, context_dim=32, groups=4),
    vae=VAEConfig(up_channels=(32, 32, 16, 16), resnets_per_block=1, groups=4),
)


# ---------------------------------------------------------------------------
# DDIM schedule (host-side constants; the loop consumes per-step rows)
# ---------------------------------------------------------------------------

def ddim_schedule(num_steps: int, cfg: SD15Config = FULL) -> dict[str, np.ndarray]:
    """Per-step DDIM constants in descending-time order, each [num_steps]:
    ``t`` (fed to the UNet), ``sqrt_alpha``/``sqrt_one_minus_alpha`` at t,
    and the same at the previous step the update lands on."""
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                        cfg.train_steps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    step_ratio = cfg.train_steps // num_steps
    t = (np.arange(num_steps) * step_ratio).round()[::-1].astype(np.int64)
    t = t + cfg.steps_offset
    t = np.clip(t, 0, cfg.train_steps - 1)
    prev_t = t - step_ratio
    # set_alpha_to_one=False in SD: the final step lands on alphas_cumprod[0].
    alpha_prev = np.where(prev_t >= 0, alphas_cumprod[np.clip(prev_t, 0, None)],
                          alphas_cumprod[0])
    alpha_t = alphas_cumprod[t]
    return {
        "t": t.astype(np.float32),
        "sqrt_alpha": np.sqrt(alpha_t).astype(np.float32),
        "sqrt_one_minus_alpha": np.sqrt(1.0 - alpha_t).astype(np.float32),
        "sqrt_alpha_prev": np.sqrt(alpha_prev).astype(np.float32),
        "sqrt_one_minus_alpha_prev": np.sqrt(1.0 - alpha_prev).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def encode_condition(params: dict, inputs: dict, cfg: SD15Config = FULL,
                     dtype=torch.bfloat16):
    """Prompt conditioning: (context [2B, T, D], guidance [B, 1, 1, 1]).
    One [2B]-batched CLIP call, uncond rows first."""
    both_ids = torch.cat([inputs["uncond_ids"], inputs["cond_ids"]], dim=0)
    context = encode_text(params["clip"], both_ids, cfg.clip, dtype)
    g = inputs["guidance"].float()[:, None, None, None]
    return context, g


def denoise(params: dict, latents: torch.Tensor, context: torch.Tensor, g: torch.Tensor,
            rows: dict, cfg: SD15Config = FULL, dtype=torch.bfloat16) -> torch.Tensor:
    """The DDIM update over the given schedule rows (any contiguous slice:
    all steps in the monolithic pipeline, one chunk on the job lane; the same
    body either way, so chunked serving is the monolithic loop in slices).

    ``rows`` are f32 arrays or tensors; they go to the device once and each
    step reads its constants there, never on the host, so a chunk captures
    into one CUDA graph whose rows buffer is refilled per chunk."""
    B = latents.shape[0]
    rows = {k: torch.as_tensor(v, dtype=torch.float32, device=latents.device)
            for k, v in rows.items()}
    for i in range(rows["t"].shape[0]):
        lat2 = torch.cat([latents, latents], dim=0)
        t2 = rows["t"][i].expand(2 * B)
        eps_u, eps_c = unet_apply(params["unet"], lat2, t2, context, cfg.unet,
                                  dtype).chunk(2, dim=0)
        eps = eps_u + g * (eps_c - eps_u)
        # DDIM (eta=0): x0-prediction, then the deterministic step.
        x0 = (latents - rows["sqrt_one_minus_alpha"][i] * eps) / rows["sqrt_alpha"][i]
        latents = rows["sqrt_alpha_prev"][i] * x0 + rows["sqrt_one_minus_alpha_prev"][i] * eps
    return latents


def decode_image(params: dict, latents: torch.Tensor, cfg: SD15Config = FULL,
                 dtype=torch.bfloat16) -> dict:
    """Latents → {"image": uint8 [B, 8h, 8w, 3]}; one image per decode, as
    the JAX package decodes (its ``lax.map`` for B > 1)."""
    image = torch.cat([vae_decode(params["vae"], latents[i:i + 1], cfg.vae, dtype)
                       for i in range(latents.shape[0])], dim=0)
    return {"image": (image * 255.0 + 0.5).to(torch.uint8)}


def txt2img(params: dict, inputs: dict, schedule: dict, cfg: SD15Config = FULL,
            dtype=torch.bfloat16) -> dict:
    """Tokens + noise → uint8 image.

    inputs: cond_ids/uncond_ids [B, T] int32, latents [B,h,w,4] f32 (unit
    normal), guidance [B] f32.  The job lane runs the same three pieces
    (encode_condition → denoise → decode_image) as separate dispatches.
    """
    context, g = encode_condition(params, inputs, cfg, dtype)
    latents = denoise(params, inputs["latents"].float(), context, g, schedule, cfg, dtype)
    return decode_image(params, latents, cfg, dtype)


# ---------------------------------------------------------------------------
# Tokenization: a CLIP ``tokenizer.json`` through the ``tokenizers`` library
# when ``extra.tokenizer`` names one, else the offline stub
# ---------------------------------------------------------------------------

def _fallback_tokenize(text: str, cfg: CLIPTextConfig) -> list[int]:
    """Deterministic offline stub: whitespace words hashed into the vocab
    (the JAX package's, id for id)."""
    ids = []
    for w in text.lower().split():
        h = int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "big")
        ids.append(h % max(cfg.vocab_size - 3, 1))
    return ids


def make_prompt_ids(text: str, cfg: CLIPTextConfig, tokenizer=None) -> np.ndarray:
    """[BOS] + ids + [EOS], padded with EOS to ``max_len`` (CLIP's padding).
    A ``tokenizers.Tokenizer``'s BOS and EOS are stripped first (a CLIP
    tokenizer.json's post-processor adds them), so the wrap is applied once
    either way."""
    if tokenizer is not None:
        ids = [i for i in tokenizer.encode(text).ids if i not in (cfg.bot_id, cfg.eot_id)]
    else:
        ids = _fallback_tokenize(text, cfg)
    ids = [cfg.bot_id] + ids[: cfg.max_len - 2] + [cfg.eot_id]
    ids = ids + [cfg.eot_id] * (cfg.max_len - len(ids))
    return np.asarray(ids, np.int32)


def load_tokenizer(name: str, path: str):
    """``tokenizers.Tokenizer.from_file(path)``; the package is imported
    only here, and its absence is an error that names it."""
    try:
        from tokenizers import Tokenizer
    except ImportError as e:
        raise ImportError(f"{name}: extra.tokenizer {path!r} needs the `tokenizers` package, "
                          f"which is not installed; leave extra.tokenizer unset to serve the "
                          f"offline tokenizer") from e
    return Tokenizer.from_file(str(path))


# ---------------------------------------------------------------------------
# PNG without PIL (a deployment may not have Pillow)
# ---------------------------------------------------------------------------

def png_bytes(pixels: np.ndarray) -> bytes:
    """uint8 [H, W, 3] → an 8-bit RGB PNG: one IDAT, filter 0 on every row."""
    h, w, c = pixels.shape
    if c != 3 or pixels.dtype != np.uint8:
        raise ValueError(f"png_bytes wants uint8 [H, W, 3], got {pixels.dtype} {pixels.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def _png_b64(arr: np.ndarray) -> str:
    return base64.b64encode(png_bytes(arr)).decode()


# ---------------------------------------------------------------------------
# Servable
# ---------------------------------------------------------------------------

def init_sd15_params(seed: int = 0, cfg: SD15Config = FULL, rng=None) -> dict:
    return {"clip": init_clip_text_params(seed, cfg.clip, rng),
            "unet": init_unet_params(seed + 1, cfg.unet, rng),
            "vae": init_vae_params(seed + 2, cfg.vae, rng)}


def sd15_config(cfg_model) -> SD15Config:
    return TINY if cfg_model.extra.get("variant") == "tiny" else FULL


def sd15_params(cfg_model, cfg: SD15Config) -> dict:
    """The tree the builder loads: a staged tree or a stream as it is, a
    diffusers directory or a flat prefixed file through ``convert_sd15``,
    else the seeded init."""
    from ..engine import weights as W

    ckpt = cfg_model.checkpoint
    if not ckpt:
        return init_sd15_params(0, cfg)
    if W.is_native(ckpt) or W.is_stream(ckpt):
        return W.import_params(ckpt, None)
    return W.convert_sd15(ckpt)


def _held_in(key: str, value: torch.Tensor, sd: dict, dtype: torch.dtype) -> torch.Tensor:
    """The at-rest form of one bridged tensor.  The JAX package casts conv
    and dense weights and biases, and the CLIP embeddings, to the compute
    dtype at every use, so holding them in that dtype gives the same values;
    norm scales and biases (1-D, read in f32) and the UNet's time MLP (run
    in f32) are held in f32.  Conv weights are held ``channels_last``."""
    sibling = sd.get(key.rsplit(".", 1)[0] + ".weight") if key.endswith(".bias") else value
    if sibling is not None and sibling.ndim >= 2 and not key.startswith("unet.time_mlp"):
        value = value.to(dtype)
    elif value.is_floating_point():
        value = value.float()  # an f16 checkpoint's norms and time MLP, read in f32
    if value.ndim == 4:
        value = value.contiguous(memory_format=torch.channels_last)
    return value


def make_sd15_servable(name: str, cfg_model, cfg: SD15Config | None = None):
    from ..engine.servable import Servable
    from ..engine.weights import ParamTree, params_from_jax
    from .bert import resolve_dtype

    if cfg is None:
        cfg = sd15_config(cfg_model)
    dtype = resolve_dtype(cfg_model.dtype)
    height = int(cfg_model.extra.get("height", 512))
    width = int(cfg_model.extra.get("width", 512))
    num_steps = int(cfg_model.extra.get("num_steps", 20))
    default_guidance = float(cfg_model.extra.get("guidance_scale", 7.5))
    lh, lw = height // 8, width // 8

    tok_path = cfg_model.extra.get("tokenizer")
    tokenizer = load_tokenizer(name, tok_path) if tok_path else None
    sd = params_from_jax(sd15_params(cfg_model, cfg))
    module = ParamTree({k: _held_in(k, v, sd, dtype) for k, v in sd.items()})
    module.eval()
    schedule = ddim_schedule(num_steps, cfg)

    def apply_fn(m, inputs):
        return txt2img(m.tree(), inputs, schedule, cfg, dtype)

    # The job lane's chunked contract (engine.runner.run_chunked): prepare
    # (CLIP encode) → chunks of ``chunk_steps`` DDIM steps → finalize (VAE
    # decode), each its own dispatch.  chunk_steps=0 disables it.
    chunk_steps = int(cfg_model.extra.get("chunk_steps", 4))
    chunked = None
    if 0 < chunk_steps < num_steps:
        chunk_rows = [{k: v[i: i + chunk_steps] for k, v in schedule.items()}
                      for i in range(0, num_steps, chunk_steps)]

        def prepare_fn(p, batch):
            context, g = encode_condition(p, batch, cfg, dtype)
            return {"latents": batch["latents"].float(), "context": context, "g": g}

        def chunk_fn(p, state, rows):
            latents = denoise(p, state["latents"], state["context"], state["g"],
                              rows, cfg, dtype)
            return {**state, "latents": latents}

        def finalize_fn(p, state):
            return decode_image(p, state["latents"], cfg, dtype)

        chunked = {"num_chunks": len(chunk_rows), "steps_per_chunk": chunk_steps,
                   "chunk_rows": chunk_rows, "prepare": prepare_fn,
                   "chunk": chunk_fn, "finalize": finalize_fn}

    def input_spec(bucket):
        B = bucket[0]
        T = cfg.clip.max_len
        return {"cond_ids": ((B, T), torch.int32),
                "uncond_ids": ((B, T), torch.int32),
                "latents": ((B, lh, lw, 4), torch.float32),
                "guidance": ((B,), torch.float32)}

    def preprocess(payload):
        if isinstance(payload, (bytes, str)):
            payload = {"prompt": payload.decode() if isinstance(payload, bytes) else payload}
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise ValueError('expected JSON body {"prompt": ...}')
        seed = int(payload.get("seed", 0))
        latents = np.random.default_rng(seed).standard_normal((lh, lw, 4)).astype(np.float32)
        return {
            "cond_ids": make_prompt_ids(str(payload["prompt"]), cfg.clip, tokenizer),
            "uncond_ids": make_prompt_ids(str(payload.get("negative_prompt", "")), cfg.clip,
                                          tokenizer),
            "latents": latents,
            "guidance": np.float32(payload.get("guidance_scale", default_guidance)),
        }

    def postprocess(out, i):
        # Raw pixels only: PNG + base64 is host work that must not run on
        # the dispatch thread; the job worker applies ``finalize`` in the
        # event loop's executor.
        return {"pixels": np.asarray(out["image"][i]), "height": height, "width": width}

    def finalize(result):
        pixels = result.pop("pixels")
        return {**result, "image_b64": _png_b64(pixels), "format": "png"}

    meta = {"num_steps": num_steps, "async_only": True, "finalize": finalize,
            "config": cfg, "dtype": dtype}
    if chunked is not None:
        meta["chunked"] = chunked
    return Servable(name=name, apply_fn=apply_fn, module=module, input_spec=input_spec,
                    preprocess=preprocess, postprocess=postprocess,
                    bucket_axes=("batch",), meta=meta)


from ..utils.registry import register_model, register_tree  # noqa: E402


@register_tree("sd15")
def sd15_tree(cfg_model) -> tuple[dict, dict]:
    from ..engine.weights import ShapeDraws

    cfg = sd15_config(cfg_model)
    return sd15_params(cfg_model, cfg), init_sd15_params(0, cfg, rng=ShapeDraws())


@register_model("sd15", latency_class="throughput")
def build_sd15(cfg):
    return make_sd15_servable("sd15", cfg)
