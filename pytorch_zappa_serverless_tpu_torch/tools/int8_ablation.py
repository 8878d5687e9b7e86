"""Where the bf16 W8A16 kernel's time goes, on one GPU.

    python -m pytorch_zappa_serverless_tpu_torch.tools.int8_ablation [--variants a,b,...] [--sweep]

Builds variants of ``ops/csrc/int8_matmul.cu`` in which one part of the
bf16 kernel is taken out (their outputs are wrong: they are only timed),
loads each in turn as the wrapper's library, and times three pieces of main-
path work, each over distinct weights so that they stream from device
memory as served: ``gpt2_step``, one GPT-2 small position step at M = 8
(48 layer projections and the f32 lm head [768, 50304], 123.6 MB of int8),
``bert_fwd``, one BERT-base forward at bucket (8, 128) (72 projections
at M = 1024), and ``whisper_step``, one Whisper-tiny decoder position at
M = 4 (32 projections and the f32 lm head [384, 51968], 28.2 MB of int8).
The launches are queued behind a spin kernel, so the host's time per call
leaves no gaps.  What a part costs where it does not overlap
the rest is the kernel's time less the variant's.  ``kernel`` is the source
as it is; cuBLAS on the dequantised bf16 weights of the same work is
printed beside it.

``--sweep`` also times every tile and split the kernel takes at each
distinct shape of the three pieces of work (over the layers' distinct
weights), against the one ``ops.int8_matmul.plan`` picks: the planner's
evidence.

One JSON line per (variant, work) or (shape, plan), then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops import int8_matmul as I
from .flash_ablation import launch_ms

SOURCE = "int8_matmul.cu"
GPT2_LAYER = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
GPT2_HEAD = (768, 50304)
BERT_LAYER = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
# q, k, v, out, cq, cout, fc1, fc2
WHISPER_LAYER = [(384, 384)] * 6 + [(384, 1536), (1536, 384)]
WHISPER_HEAD = (384, 51968)
WORK = {"gpt2_step": 8, "bert_fwd": 1024, "whisper_step": 4}  # name -> M
# name -> (one layer's products, layers, the f32 lm head or None)
SHAPES = {"gpt2_step": (GPT2_LAYER, 12, GPT2_HEAD), "bert_fwd": (BERT_LAYER, 12, None),
          "whisper_step": (WHISPER_LAYER, 4, WHISPER_HEAD)}

# name -> (old, new) substitutions in the kernel source, each of which must
# match exactly once.
VARIANTS: dict[str, tuple[tuple[str, str], ...]] = {
    "kernel": (),
    # the int8 bytes reinterpreted as bf16 pairs, with no conversion
    "no_convert": (("o[p] = bf16x2_of(w[2 * p], w[2 * p + 1], sel);",
                    "o[p] = w[2 * p] ^ w[2 * p + 1];"),),
    "no_products": (("Wgmma<T::BN>::template ss<0, 0>(acc, desc_sw128(xa + kk * 32, 16, 1024),\n"
                     "                                      desc_sw128(ba + kk * 32, 16, 1024), 1);",
                     ";"),),
    # each rank sums only its own partial: no reads of the other ranks
    "no_split_reduce": (("      if (q < splits) v[q] = ld_cluster_f4(at[q] + off);",
                         "      if (q < 1) v[q] = ld_cluster_f4(at[q] + off);"),
                        ("      if (q < splits) {\n        s.x += v[q].x;",
                         "      if (q < 1) {\n        s.x += v[q].x;")),
    "one_stage_fewer": (("constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),),
    # each launch waits for the one before it to finish before it starts
    "no_pdl": (("  cfg.numAttrs = 2;", "  cfg.numAttrs = 1;"),),
    # x's box of a whole tile of rows even when M is smaller (zero-filled)
    "full_x_box": (("const int x_rows = min(bm, (M + 7) / 8 * 8);", "const int x_rows = bm;"),),
    # no K tile: the launch, the set-up, the reduction and the stores
    "no_k_loop": (("const int nk = (split + 1) * k_tiles / splits - kt0;",
                   "const int nk = 0 * kt0;"),),
    # a block that returns at once: the launch alone
    "empty": (("  const int splits = gridDim.z, split = blockIdx.z;",
               "  if (k_tiles > 0) return;\n  const int splits = gridDim.z, split = blockIdx.z;"),),
}

# Sources that must refuse to launch: a consumer register budget above what
# two blocks per SM leave (the launch-time guard, error 900002).
PROBES: dict[str, tuple[tuple[str, str], ...]] = {
    "register_guard": (("CONSUMER_REGS = NC == 1 ? 232 : 240;",
                        "CONSUMER_REGS = NC == 1 ? 240 : 240;"),),
}


def apply_variant(source: str, name: str) -> str:
    """The kernel source with ``name``'s substitutions (a variant or a
    probe); raises if one of them does not match exactly once (the source
    has moved on)."""
    for old, new in {**VARIANTS, **PROBES}[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} matches {source.count(old)} times")
        source = source.replace(old, new)
    return source


def build(name: str) -> ctypes.CDLL:
    """Compile ``name``'s source beside copies of the headers, in
    ``build/int8_ablation/<name>/``, and load it with the wrapper's
    signatures."""
    out = _build.BUILD_DIR.parent / "int8_ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE).write_text(apply_variant((_build.CSRC / SOURCE).read_text(), name))
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"), str(out / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}{proc.stdout}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    for fn, (restype, argtypes) in I._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def products(work: str) -> list[tuple[int, int, torch.dtype]]:
    """(K, N, out dtype) of every product of one piece of work, in order."""
    layer, layers, head = SHAPES[work]
    out = [(k, n, torch.bfloat16) for _ in range(layers) for k, n in layer]
    if head:
        out.append((*head, torch.float32))
    return out


def operands(work: str, g: torch.Generator) -> list[tuple]:
    """Distinct random operands for every product of ``work``: (x, w_q,
    scale, out dtype, dequantised bf16 weights)."""
    m, ops = WORK[work], []
    for k, n, out_dtype in products(work):
        x = (torch.randn(m, k, device="cuda", generator=g) * 0.5).bfloat16()
        w = torch.randint(-127, 128, (k, n), device="cuda", generator=g, dtype=torch.int8)
        s = torch.rand(n, device="cuda", generator=g) * 2e-3 + 1e-4
        ops.append((x, w, s, out_dtype, (w.float() * s).bfloat16()))
    return ops


def run_kernel(ops):
    return lambda: [I.int8_matmul(x, w, s, out_dtype=o) for x, w, s, o, _ in ops]


def run_cublas(ops):
    return lambda: [x @ wd for x, _, _, _, wd in ops]


def sweep_plans(m: int, k: int, n: int) -> list[I.Plan]:
    """Every tile and split the kernel takes for one shape."""
    k_tiles = -(-k // I.BK)
    return [I.Plan(bm, bn, s, s) for bm, bn in I.TILES
            for s in range(1, min(I.MAX_CLUSTER, k_tiles) + 1)]


def sweep(work: dict) -> None:
    """Each distinct product of each piece of work under every plan the
    kernel takes: one launch per layer over the layers' distinct weights
    (the lm head's one), the mean per launch."""
    plan = I.plan
    try:
        for wname, ops in work.items():
            m = WORK[wname]
            for k, n, _ in sorted(set(products(wname))):
                same = [op for op in ops if op[1].shape == (k, n)]
                chosen = plan(m, k, n)
                for p in sweep_plans(m, k, n):
                    I.plan = lambda *_, p=p: p
                    ms = launch_ms(run_kernel(same), n=1) / len(same)
                    print(json.dumps({"shape": [m, k, n], "plan": list(p), "ms": ms,
                                      "planner": p == chosen}), flush=True)
    finally:
        I.plan = plan


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated, of: {', '.join(VARIANTS)}")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every tile and split at each distinct shape")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        print("int8_ablation needs an NVIDIA GPU", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    g = torch.Generator(device="cuda").manual_seed(0)
    work = {name: operands(name, g) for name in WORK}
    for name, ops in work.items():
        print(json.dumps({"variant": "cublas", "work": name,
                          "ms": launch_ms(run_cublas(ops), n=1)}), flush=True)
    kernel_lib = I._kernel_lib
    try:
        for name in names:
            I._kernel_lib = lambda lib=libs[name]: lib
            for wname, ops in work.items():
                ms = launch_ms(run_kernel(ops), n=1)
                print(json.dumps({"variant": name, "work": wname, "ms": ms}), flush=True)
        if args.sweep:
            I._kernel_lib = lambda lib=libs.get("kernel") or build("kernel"): lib
            sweep(work)
    finally:
        I._kernel_lib = kernel_lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
