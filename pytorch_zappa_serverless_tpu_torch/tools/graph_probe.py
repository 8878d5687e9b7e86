"""Whether the port's kernels launch correctly inside a captured CUDA graph.

    python -m pytorch_zappa_serverless_tpu_torch.tools.graph_probe

Two launches of each of the three hand-written kernels, captured into one
``torch.cuda.CUDAGraph`` and replayed, held byte for byte against the same
launches run eagerly on the same inputs:

- ``int8_matmul`` at GPT-2 small's decode shapes (M = 8; a K split over a
  cluster, launched with programmatic dependent launch), the second product
  fed the first's output, so the programmatic edge between them matters;
- ``flash_attention`` at the SD-1.5 UNet's [2, 4096, 8, 40];
- the four fused decode entry points (cooperative launches of thread-block
  clusters with a grid barrier) at S = 8, D = 768, T = 96, F = 3072, each
  layer's K/V written into the caches in place.

Each kernel runs once eagerly first (shared-memory limits, plans, the
tensor-map entry point), then the graph is captured, replayed on the eager
inputs, then on fresh inputs copied into its static buffers (the eager
result on those inputs must match again).  Prints the CUDA versions (the
runtime PyTorch loaded, the toolkit the kernels are built with, the driver)
and one JSON line per kernel, then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch


def _versions() -> dict:
    nvcc = subprocess.run(["bash", "-c", "${CUDA_HOME:-/usr/local/cuda}/bin/nvcc --version"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    return {"torch": torch.__version__, "torch_cuda_runtime": torch.version.cuda,
            "nvcc": nvcc[-1] if nvcc else None, "driver": driver}


def _operands(seed: int, device) -> dict:
    """Random operands at the probe's shapes, from ``seed``."""
    from ..ops.int8_matmul import quantize_per_channel

    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    def q8(k, n):
        w_q, s = quantize_per_channel(rand(k, n, scale=0.02).numpy())
        return torch.from_numpy(w_q).to(device), torch.from_numpy(s).to(device)

    S, D, T, F = 8, 768, 96, 3072
    bf = torch.bfloat16
    ops = {"x_mm": rand(8, 768).to(bf), "w1": q8(768, 2304), "w2": q8(2304, 768),
           "q": rand(2, 4096, 8, 40).to(bf), "k": rand(2, 4096, 8, 40).to(bf),
           "v": rand(2, 4096, 8, 40).to(bf),
           "x": rand(S, D).to(bf), "ln_s": 1 + rand(D, scale=0.1), "ln_b": rand(D, scale=0.1),
           "wqkv": rand(D, 3 * D, scale=0.02).to(bf), "bqkv": rand(3 * D, scale=0.02),
           "wout": rand(D, D, scale=0.02).to(bf), "bout": rand(D, scale=0.02),
           "fc1": rand(D, F, scale=0.02).to(bf), "b1": rand(F, scale=0.02),
           "fc2": rand(F, D, scale=0.02).to(bf), "b2": rand(D, scale=0.02),
           "qkv8": q8(D, 3 * D), "out8": q8(D, D), "fc18": q8(D, F), "fc28": q8(F, D),
           "ck": rand(T, S, D).to(bf), "cv": rand(T, S, D).to(bf),
           "pos": torch.arange(40, 40 + S, dtype=torch.int32)}
    kpos = torch.arange(T)
    ops["mask"] = torch.where(kpos[:, None, None] <= ops["pos"].long()[None, :, None],
                              0.0, -1e9).float()
    return {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device))
            for k, v in ops.items()}


def _program(o: dict) -> dict:
    """The launches the probe captures, on the operands ``o`` (the caches
    are updated in place)."""
    from ..ops import fused_decode as FD
    from ..ops.flash_attention import flash_attention
    from ..ops.int8_matmul import int8_matmul

    y1 = int8_matmul(o["x_mm"], *o["w1"])
    y2 = int8_matmul(y1, *o["w2"])
    fa = flash_attention(o["q"], o["k"], o["v"])
    x, _, _ = FD.fused_attn_step(o["x"], o["ln_s"], o["ln_b"], o["wqkv"], o["bqkv"], o["wout"],
                                 o["bout"], o["ck"], o["cv"], o["pos"], o["mask"], heads=12)
    x = FD.fused_mlp_step(x, o["ln_s"], o["ln_b"], o["fc1"], o["b1"], o["fc2"], o["b2"])
    x8, _, _ = FD.fused_attn_step_int8(x, o["ln_s"], o["ln_b"], o["qkv8"][0], o["bqkv"],
                                       o["qkv8"][1], o["out8"][0], o["bout"], o["out8"][1],
                                       o["ck"], o["cv"], o["pos"], o["mask"], heads=12)
    x8 = FD.fused_mlp_step_int8(x8, o["ln_s"], o["ln_b"], o["fc18"][0], o["b1"], o["fc18"][1],
                                o["fc28"][0], o["b2"], o["fc28"][1])
    return {"int8_matmul": y2, "flash_attention": fa, "fused_bf16": x, "fused_int8": x8,
            "cache_k": o["ck"], "cache_v": o["cv"]}


def _clone(o: dict) -> dict:
    return {k: (tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone())
            for k, v in o.items()}


def _copy_into(static: dict, o: dict) -> None:
    for k, v in o.items():
        for dst, src in zip(static[k] if isinstance(v, tuple) else (static[k],),
                            v if isinstance(v, tuple) else (v,)):
            dst.copy_(src)


def _eager(o: dict) -> dict:
    return {k: v.clone() for k, v in _program(_clone(o)).items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_probe needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(json.dumps(_versions()), flush=True)
    first, second = _operands(1, dev), _operands(2, dev)
    # The graph's static inputs, the caches among them, start as the first operands.
    static = _clone(first)
    want1, want2 = _eager(first), _eager(second)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _program(_clone(static))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _program(static)
    results = []
    for tag, src, want in (("first", first, want1), ("second", second, want2), ("first again",
                                                                                 first, want1)):
        _copy_into(static, src)
        graph.replay()
        torch.cuda.synchronize()
        for name, got in out.items():
            same = torch.equal(got, want[name])
            diff = (got.float() - want[name].float()).abs().max().item()
            results.append({"inputs": tag, "output": name, "bitwise_equal": same,
                            "max_abs_diff": diff})
            print(json.dumps(results[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    ok = all(r["bitwise_equal"] for r in results)
    print(json.dumps({"graph_probe_ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
