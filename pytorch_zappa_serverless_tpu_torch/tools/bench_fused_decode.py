"""Micro-bench: the fused decode step against the unfused ``decode_segment``
step, GPT-2 small, on one GPU.

    python -m pytorch_zappa_serverless_tpu_torch.tools.bench_fused_decode [--profile]

A pool of S = 8 rows decodes greedily over caches of T = 96 positions (a
64-token prompt bucket plus 32 new tokens), on weights made from a seed.
Three lanes:

- ``seg1``: ``models.gpt2.decode_segment`` with ``seg=1``, the serving
  path's unfused step, on the bf16 tree with separate q/k/v;
- ``fused``: :func:`fused_step`, per layer one ``fused_attn_step`` and one
  ``fused_mlp_step`` launch (24 per step), bf16 weights, q|k|v fused;
- ``fused_int8``: :func:`fused_step_int8`, the same with int8 weights and
  per-column scales, and the int8 lm head.

The pool's caches come from one ragged ``prefill``; each lane is timed in
ms per step with CUDA events over steps that feed back their own tokens.
``--profile`` adds a ``torch.profiler`` breakdown per lane: device time by
kernel name and the device's idle share of the window.
``--platform cpu --arch '{...}'`` runs a narrow model on the CPU, where the
fused wrappers compute their plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..engine import weights as W
from ..models import gpt2 as G
from ..ops.fused_decode import (fused_attn_step, fused_attn_step_int8, fused_mlp_step,
                                fused_mlp_step_int8)

S, P, MAX_NEW = 8, 64, 32
T = P + MAX_NEW
DTYPE = torch.bfloat16


def to_device(tree: dict, device) -> dict:
    """A numpy tree on ``device`` through the servable's bridge: float leaves
    of two or more dims in bf16, norms, biases and scales in f32, integers
    as they are; every tensor contiguous, kernels ``[in, out]``."""
    return W.ParamTree(W.gpt2_state_from_jax(tree, DTYPE)).to(device).tree()


def int8_tree(params: dict, layers: int) -> dict:
    """The int8 lane's numpy tree: the fused tree with every layer kernel
    int8 + per-column scales, and the padded transposed int8 lm head."""
    return G.quantize_gpt2(params, layers, min_size=0)


def mask_bias(pos: torch.Tensor, total: int) -> torch.Tensor:
    """[T, S, 1] f32: 0 where key position <= pos[s], -1e9 elsewhere; built
    once per step and read by every layer's attention launch."""
    kpos = torch.arange(total, device=pos.device)
    return torch.where(kpos[:, None, None] <= pos.long()[None, :, None], 0.0, -1e9).float()


def _fused(p: dict, cks, cvs, tok, pos, cfg: G.GPT2Config, int8: bool):
    """One decode step through the fused kernels: (next token [S] int32,
    logits [S, V] f32).  The per-layer caches ``cks[i]``/``cvs[i]``
    ``[T, S, D]`` take this step's K/V at ``pos`` in place."""
    x = G._embed(p, tok, pos, cfg, DTYPE).contiguous()
    mask = mask_bias(pos, cks[0].shape[0])
    pos = pos.to(torch.int32).contiguous()
    for i in range(cfg.layers):
        lp = p[f"layer{i}"]
        ln1, ln2, qkv, out, fc1, fc2 = (lp[n] for n in ("ln1", "ln2", "qkv", "out", "fc1",
                                                        "fc2"))
        if int8:
            x, _, _ = fused_attn_step_int8(
                x, ln1["scale"], ln1["bias"], qkv["kernel_q"], qkv["bias"], qkv["scale"],
                out["kernel_q"], out["bias"], out["scale"], cks[i], cvs[i], pos, mask,
                heads=cfg.heads, eps=cfg.ln_eps)
            x = fused_mlp_step_int8(
                x, ln2["scale"], ln2["bias"], fc1["kernel_q"], fc1["bias"], fc1["scale"],
                fc2["kernel_q"], fc2["bias"], fc2["scale"], eps=cfg.ln_eps)
        else:
            x, _, _ = fused_attn_step(
                x, ln1["scale"], ln1["bias"], qkv["kernel"], qkv["bias"], out["kernel"],
                out["bias"], cks[i], cvs[i], pos, mask, heads=cfg.heads, eps=cfg.ln_eps)
            x = fused_mlp_step(x, ln2["scale"], ln2["bias"], fc1["kernel"], fc1["bias"],
                               fc2["kernel"], fc2["bias"], eps=cfg.ln_eps)
    logits = G._logits(p, G._ln(p["ln_f"], x, cfg.ln_eps))
    return logits.argmax(-1).to(torch.int32), logits


def fused_step(p: dict, cks, cvs, tok, pos, cfg: G.GPT2Config):
    """One greedy step of the fused bf16 lane: 24 launches at 12 layers."""
    return _fused(p, cks, cvs, tok, pos, cfg, False)


def fused_step_int8(p: dict, cks, cvs, tok, pos, cfg: G.GPT2Config):
    """One greedy step of the fused int8 lane: 24 launches at 12 layers, plus
    the int8 lm head."""
    return _fused(p, cks, cvs, tok, pos, cfg, True)


def per_layer(cache: torch.Tensor) -> list[torch.Tensor]:
    """A serving cache ``[L, S, T, D]`` → L contiguous ``[T, S, D]`` caches."""
    return [c.transpose(0, 1).contiguous() for c in cache]


def prompts(cfg: G.GPT2Config, seed: int = 0, rows: int = S, bucket: int = P):
    """``rows`` ragged prompts in one bucket: (tokens [rows, bucket] int32,
    zero-padded; lengths [rows] int32, from bucket/2 to bucket)."""
    rng = np.random.default_rng(seed)
    lengths = np.linspace(bucket // 2, bucket, rows).astype(np.int32)
    toks = rng.integers(1, cfg.vocab_size - 1, (rows, bucket)).astype(np.int32)
    toks[np.arange(bucket)[None, :] >= lengths[:, None]] = 0
    return toks, lengths


@dataclasses.dataclass
class Lane:
    """One lane's weights and decode state: ``ck``/``cv`` are the serving
    caches ``[L, S, T, D]`` (``seg1``) or lists of per-layer ``[T, S, D]``
    caches (fused lanes); ``tok`` is the next token to feed, ``pos`` its
    write position."""

    name: str
    params: dict
    ck: object
    cv: object
    tok: torch.Tensor
    pos: torch.Tensor


def build_lanes(cfg: G.GPT2Config, device, seed: int = 0) -> dict[str, Lane]:
    """The three lanes on seed weights, each from its own ragged prefill of
    the same prompts (each lane on its own weights)."""
    params = G.init_gpt2_params(seed, cfg)
    trees = {"seg1": to_device(params, device),
             "fused": to_device(G.fuse_qkv(params, cfg.layers), device),
             "fused_int8": to_device(int8_tree(params, cfg.layers), device)}
    toks, lengths = prompts(cfg, seed)
    toks, lengths = torch.from_numpy(toks).to(device), torch.from_numpy(lengths).to(device)
    lanes = {}
    with torch.inference_mode():
        for name, tree in trees.items():
            logits, ck, cv = G.prefill(tree, toks, lengths, T, cfg, DTYPE)
            if name != "seg1":
                ck, cv = per_layer(ck), per_layer(cv)
            lanes[name] = Lane(name, tree, ck, cv, logits.argmax(-1).to(torch.int32),
                               lengths.clone())
    return lanes


def step(lane: Lane, cfg: G.GPT2Config, advance: bool = True) -> torch.Tensor:
    """One greedy step of ``lane``; feeds its own token back and, with
    ``advance``, moves ``pos`` on.  Returns the emitted token [S]."""
    with torch.inference_mode():
        if lane.name == "seg1":
            z = torch.zeros_like(lane.tok)
            emits, _, _, nxt, *_ = G.decode_segment(
                lane.params, lane.ck, lane.cv, lane.tok, lane.pos, z, z.bool(),
                z.float(), z, 1, cfg, DTYPE)
            emit = emits[:, 0]
        else:
            fn = fused_step_int8 if lane.name == "fused_int8" else fused_step
            nxt, _ = fn(lane.params, lane.ck, lane.cv, lane.tok, lane.pos, cfg)
            emit = lane.tok
    lane.tok = nxt
    if advance:
        lane.pos = (lane.pos + 1).clamp(max=T - 1)
    return emit


def time_lane(lane: Lane, cfg: G.GPT2Config, steps: int = 60, reps: int = 5) -> float:
    """Median over ``reps`` of ms per step over ``steps`` back-to-back steps
    (CUDA events on a GPU, the host clock on the CPU), after a warm-up; the
    write position stays fixed so every rep decodes the same shape."""
    cuda = lane.tok.device.type == "cuda"
    for _ in range(3):
        step(lane, cfg, advance=False)
    times = []
    for _ in range(reps):
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(steps):
                step(lane, cfg, advance=False)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / steps)
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(lane, cfg, advance=False)
            times.append((time.perf_counter() - t0) * 1e3 / steps)
    return float(np.median(times))


def profile_lane(lane: Lane, cfg: G.GPT2Config, steps: int = 20, top: int = 10) -> dict:
    """``torch.profiler`` over ``steps`` steps: device time by kernel name
    and the device's idle share of the window (host clock to a synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step(lane, cfg, advance=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(lane, cfg, advance=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in rows)
    return {"wall_ms_per_step": wall_ms / steps, "busy_ms_per_step": busy_ms / steps,
            "idle_share": 1 - busy_ms / wall_ms,
            "top": [(name[:90], count / steps, ms / steps)
                    for name, count, ms in sorted(rows, key=lambda r: -r[2])[:top]]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--arch", default="{}", help="GPT2Config overrides as JSON (CPU runs)")
    ap.add_argument("--steps", type=int, default=60, help="steps per timed rep")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    from ..engine.loader import resolve_device

    device = resolve_device(args.platform)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(G.SMALL, **json.loads(args.arch))
    lanes = build_lanes(cfg, device)
    for name, lane in lanes.items():
        print(f"{name}: {time_lane(lane, cfg, args.steps):.4f} ms/step", flush=True)
    if args.profile and device.type == "cuda":
        for name, lane in lanes.items():
            prof = profile_lane(lane, cfg)
            print(f"== {name}: wall {prof['wall_ms_per_step']:.4f} ms/step, device busy "
                  f"{prof['busy_ms_per_step']:.4f} ms/step, idle share "
                  f"{prof['idle_share']:.3f}", flush=True)
            for kname, count, ms in prof["top"]:
                print(f"   {ms:8.4f} ms  x{count:<5g} {kname}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
