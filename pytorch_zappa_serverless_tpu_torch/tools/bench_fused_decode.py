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

The pool's caches come from one ragged ``prefill``.  On the GPU each lane's
step is captured once as a CUDA graph (the JAX bench jits it) and replayed:
the caches update in place, and the graph feeds its token (and, with
``advance``, its position) back into the lane's own ``tok``/``pos`` buffers.
Each lane is timed in ms per step with CUDA events over replays that feed
back their own tokens.  ``--profile`` adds a ``torch.profiler`` breakdown
per lane, eager against replayed: device time by kernel name and the
device's idle share of the window.
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
from ..ops.sampling import Gates

S, P, MAX_NEW = 8, 64, 32
T = P + MAX_NEW
DTYPE = torch.bfloat16


def to_device(tree: dict, device) -> dict:
    """A numpy tree on ``device`` through the servable's bridge: float leaves
    of two or more dims in bf16, norms, biases and scales in f32, integers
    as they are; every tensor contiguous, kernels ``[in, out]``."""
    return W.ParamTree(W.tree_state_from_jax(tree, DTYPE)).to(device).tree()


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
    write position.  Steps update all four in place (a captured step reads
    and writes these very buffers); ``graphs`` holds the captured steps by
    ``advance``."""

    name: str
    params: dict
    ck: object
    cv: object
    tok: torch.Tensor
    pos: torch.Tensor
    graphs: dict = dataclasses.field(default_factory=dict)

    def caches(self) -> list[torch.Tensor]:
        return list(self.ck) + list(self.cv)

    def state(self) -> list[torch.Tensor]:
        """Copies of the decode state (caches, tok, pos)."""
        return [t.clone() for t in (*self.caches(), self.tok, self.pos)]

    def set_state(self, state: list[torch.Tensor]) -> None:
        """Copy ``state`` (from :meth:`state`) back into the lane's buffers."""
        with torch.inference_mode():
            for dst, src in zip((*self.caches(), self.tok, self.pos), state):
                dst.copy_(src)


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


def eager_step(lane: Lane, cfg: G.GPT2Config, advance: bool = True) -> torch.Tensor:
    """One greedy step of ``lane``, eagerly; feeds its own token back and,
    with ``advance``, moves ``pos`` on, in place.  Returns the emitted token
    [S] (a new tensor)."""
    with torch.inference_mode():
        if lane.name == "seg1":
            z = torch.zeros_like(lane.tok)
            emits, _, _, nxt, *_ = G.decode_segment(
                lane.params, lane.ck, lane.cv, lane.tok, lane.pos, z, z.bool(),
                z.float(), z, 1, cfg, DTYPE, gates=Gates(False, False, False))
            emit = emits[:, 0]
        else:
            fn = fused_step_int8 if lane.name == "fused_int8" else fused_step
            nxt, _ = fn(lane.params, lane.ck, lane.cv, lane.tok, lane.pos, cfg)
            emit = lane.tok.clone()
        lane.tok.copy_(nxt)
        if advance:
            lane.pos.copy_((lane.pos + 1).clamp(max=T - 1))
    return emit


def step_graph(lane: Lane, cfg: G.GPT2Config, advance: bool = True):
    """The lane's step captured as one CUDA graph (once per ``advance``); the
    lane's decode state is as it was before (the capture's eager warm-up
    step is undone)."""
    from ..engine.compiled import capture

    if advance not in lane.graphs:
        before = lane.state()
        with torch.inference_mode():
            lane.graphs[advance] = capture(lambda: eager_step(lane, cfg, advance),
                                           lane.tok.device)
        lane.set_state(before)
    return lane.graphs[advance]


def step(lane: Lane, cfg: G.GPT2Config, advance: bool = True) -> torch.Tensor:
    """One greedy step of ``lane``: a replay of its captured step on the GPU,
    :func:`eager_step` on the CPU.  Returns the emitted token [S] (on the
    GPU the graph's static output, overwritten by its next replay)."""
    if lane.tok.device.type != "cuda":
        return eager_step(lane, cfg, advance)
    return step_graph(lane, cfg, advance).replay()


def time_lane(lane: Lane, cfg: G.GPT2Config, steps: int = 60, reps: int = 5,
              replay: bool = True) -> float:
    """Median over ``reps`` of ms per step over ``steps`` back-to-back steps
    (replays of the captured step, or with ``replay=False`` eager steps; CUDA
    events on a GPU, the host clock on the CPU), after a warm-up; the write
    position stays fixed so every rep decodes the same shape."""
    cuda = lane.tok.device.type == "cuda"
    run = step if replay else eager_step
    for _ in range(3):
        run(lane, cfg, advance=False)
    times = []
    for _ in range(reps):
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(steps):
                run(lane, cfg, advance=False)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / steps)
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                run(lane, cfg, advance=False)
            times.append((time.perf_counter() - t0) * 1e3 / steps)
    return float(np.median(times))


# Host calls that put one kernel on a stream (CUDA runtime and ``cu*``
# API names); a replayed window should show none, only ``cudaGraphLaunch``.
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                       "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def host_calls(prof) -> dict[str, int]:
    """Counts of the host's graph launches and kernel launches in a
    ``torch.profiler`` window."""
    counts = {"cudaGraphLaunch": 0, "kernel_launches": 0}
    for e in prof.key_averages():
        if e.key == "cudaGraphLaunch":
            counts["cudaGraphLaunch"] += e.count
        elif e.key in KERNEL_LAUNCH_CALLS:
            counts["kernel_launches"] += e.count
    return counts


def profile(fn, calls: int) -> dict:
    """``torch.profiler`` over ``calls`` calls of ``fn`` (on the calling
    thread, which must be the one that issues the device work), after a
    warm-up, ending in a synchronize: wall ms, device-busy ms and the idle
    share of the window, device time by kernel name (``top``, largest
    first) and the host's ``cudaGraphLaunch`` and kernel-launch calls, all
    per call.  The tracer lengthens the wall time (it records every kernel,
    a graph's too), so the same calls are first timed without it
    (``wall_ms_untraced``) and ``idle_share_untraced`` sets the traced busy
    time against that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / calls
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # Device-side events only: a CPU op's self device time repeats its kernels'.
    rows = [(e.key, e.count / calls, e.self_device_time_total / 1e3 / calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in rows)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "wall_ms_untraced": untraced_ms, "idle_share_untraced": 1 - busy_ms / untraced_ms,
            "host_calls": {k: v / calls for k, v in host_calls(prof).items()},
            "top": sorted(rows, key=lambda r: -r[2])}


def profile_lane(lane: Lane, cfg: G.GPT2Config, steps: int = 20, replay: bool = True) -> dict:
    """:func:`profile` over ``steps`` steps of ``lane``, replayed or (with
    ``replay=False``) eager, at a fixed write position."""
    run = step if replay else eager_step
    return profile(lambda: run(lane, cfg, advance=False), steps)


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
            for replay in (False, True):
                prof = profile_lane(lane, cfg, replay=replay)
                print(f"== {name} {'replayed' if replay else 'eager'}: wall "
                      f"{prof['wall_ms']:.4f} ms/step ({prof['wall_ms_untraced']:.4f} "
                      f"untraced), device busy {prof['busy_ms']:.4f} ms/step, idle share "
                      f"{prof['idle_share']:.3f} ({prof['idle_share_untraced']:.3f} "
                      f"untraced), host calls per step {prof['host_calls']}", flush=True)
                for kname, count, ms in prof["top"][:10]:
                    print(f"   {ms:8.4f} ms  x{count:<5g} {kname[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
