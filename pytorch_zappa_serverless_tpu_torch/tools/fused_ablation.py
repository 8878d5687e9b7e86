"""Where the fused decode-step kernels' time goes, on one GPU.

    python -m pytorch_zappa_serverless_tpu_torch.tools.fused_ablation [--variants a,b,...]
        [--stamp-reps N]    # --variants "": the phase stamps alone
        [--race-launches N] # each variant's attention against the kernel, byte for byte

Works on the ``ops/csrc/fused_decode.cu`` of the package it is imported
from, and knows two designs of it by their source: ``first``, the first
port (three cooperative grid barriers per launch, split-K partials through
device memory), and ``hopper``, the redesign (weights and cached K/V
prefetched by TMA, tensor-core products, cluster split-K, one grid
barrier).  To measure the first design, copy this file into an unpacked
checkout of a commit that has it and run it there.

Two measurements at GPT-2 small's decode shapes (S = 8 rows, D = 768,
T = 96 cached positions, F = 3072), bf16 and int8 weights, over 12 layers'
distinct weights so that they stream from device memory as in a step:

- **phase stamps**: a build of the source with ``%globaltimer`` read by
  thread 0 of every block at each phase boundary (after a block barrier, so
  the stamp marks the whole block's arrival) into a device buffer.  For each
  stamp, the first, mean and last block's time since the earliest block
  started, in us, the median over ``--stamp-reps`` launches per layer.
  The timer ticks in steps of tens of ns to 1 us depending on the driver:
  read the stamps as a breakdown, the per-launch times below as the times.
- **variants**: builds with one part taken out (their outputs are wrong:
  they are only timed), each loaded in turn as the wrappers' library, per
  launch by CUDA events with the launches queued behind a spin kernel.  What
  a part costs where it does not overlap the rest is ``kernel``'s time less
  the variant's.

- **race check** (``--race-launches N``): each listed variant's attention
  launched N times on the same inputs (each after a launch on other rows,
  so that shared memory holds other values), at GPT-2 small's shape and at
  an odd head count whose rows take the element copies, counting the
  launches whose x_out or caches differ in any byte from the production
  kernel's.
  The kernel itself must count none; a variant that drops a barrier shows
  whether that barrier orders anything at these shapes.

Each variant is a set of text substitutions, each of which must match the
source exactly once (``apply_variant`` raises if the source has moved on;
``tests/test_torch_fused_decode.py`` checks every variant of the current
design).  One JSON line per (variant, kernel) and per stamped kernel, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops import fused_decode as FD
from ..utils.cudatime import device_ms

SOURCE = "fused_decode.cu"
S, D, T, F, HEADS, LAYERS = 8, 768, 96, 3072, 12, 12
MAX_BLOCKS, MAX_STAMPS = 1024, 12

# Prepended to a stamped build: a device buffer [block][stamp] of
# %globaltimer readings and the block count, and the C function that copies
# them out (returns the blocks of the last launch, or -cudaError_t).
STAMP_PRELUDE = f"""#include <cuda_runtime.h>
#define FUSED_MAX_BLOCKS {MAX_BLOCKS}
#define FUSED_MAX_STAMPS {MAX_STAMPS}
__device__ unsigned long long fused_stamp_buf[FUSED_MAX_BLOCKS * FUSED_MAX_STAMPS];
__device__ int fused_stamp_blocks;
__device__ __forceinline__ void fused_stamp(int i) {{
  __syncthreads();
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (b < FUSED_MAX_BLOCKS) fused_stamp_buf[b * FUSED_MAX_STAMPS + i] = t;
    if (b == 0) fused_stamp_blocks = gridDim.x * gridDim.y * gridDim.z;
  }}
}}
extern "C" int fused_stamps_read(void* dst) {{
  int n = 0;
  cudaError_t e = cudaMemcpyFromSymbol(&n, fused_stamp_blocks, sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(dst, fused_stamp_buf, sizeof(fused_stamp_buf));
  return e == cudaSuccess ? n : -(int)e;
}}
"""

# -- the first port's design (three grid barriers) ----------------------------

_FIRST_ATTN = """  ln_stats(a.c, sm.stats);
  proj_partials<W>(a.qkv, a.c, nullptr, sm.stats, sm.red, sm.hs);
  grid.sync();
  attention(a, reinterpret_cast<float*>(smem_raw));
  grid.sync();
  proj_partials<W>(a.out, a.c, a.ctx, nullptr, sm.red, sm.hs);
  grid.sync();
  residual(a.out, a.c);
"""
_FIRST_MLP = """  ln_stats(a.c, sm.stats);
  proj_partials<W>(a.fc1, a.c, nullptr, sm.stats, sm.red, sm.hs);
  grid.sync();
  gelu_phase(a);
  grid.sync();
  proj_partials<W>(a.fc2, a.c, a.h1, nullptr, sm.red, sm.hs);
  grid.sync();
  residual(a.fc2, a.c);
"""


def _first(drop: tuple[int, ...] = (), stamps: bool = False) -> tuple[tuple[str, str], ...]:
    """Both kernel bodies with the lines at ``drop`` (indices into the body)
    taken out, and with phase stamps between the lines if ``stamps``."""
    subs = []
    for body in (_FIRST_ATTN, _FIRST_MLP):
        lines = body.splitlines(keepends=True)
        out = ["  fused_stamp(0);\n"] if stamps else []
        for i, line in enumerate(lines):
            if i not in drop:
                out.append(line)
            if stamps and i >= 1:
                out.append(f"  fused_stamp({i});\n")
        subs.append((body, "".join(out)))
    return tuple(subs)


FIRST_STAMPS = ("start", "phase1_done", "barrier1", "phase2_done", "barrier2", "phase3_done",
              "barrier3", "end")

DESIGNS: dict[str, dict] = {
    "first": {
        "marker": "proj_partials<W>(a.qkv",
        "stamps": FIRST_STAMPS,
        "stamp_subs": _first(stamps=True),
        "variants": {
            "kernel": (),
            "no_barriers": _first(drop=(2, 4, 6)),
            "no_phase1_proj": _first(drop=(1,)),
            "no_phase2": _first(drop=(3,)),  # attention / GELU
            "no_phase3_proj": _first(drop=(5,)),
            "no_residual": _first(drop=(7,)),
            "only_barriers": _first(drop=(0, 1, 3, 5, 7)),
            "empty": _first(drop=tuple(range(8))),
        },
    },
}


# -- the redesign (bulk-copy prefetch, mma.sync, cluster split-K, one barrier) --

_B_PREFETCH = """  if (cid < pl.b.items)
    for (int c = 0; c < min(2, a.b.nch); ++c)
      issue<W>(a.b, &a.map_b, a, false, cid, rank, c, rb.base + c * rb.stage_bytes, &rb.bar[c]);

"""
_STEP_END = """    hopper::cluster_sync();
  }
}

// The kernel's dynamic shared-memory limit"""
_GRID_SYNC = "  cooperative_groups::this_grid().sync();  // the one grid-wide barrier\n"
# After phase A's sums: attention's block barrier (its `own` rows are read
# across threads), a cluster barrier only where the partial tile is
# rewritten before the grid barrier; the MLP's likewise.
_RELEASE = ("      if (item + pl.ncl < pl.a.items || pl.off_sc == pl.off_part) hopper::cluster_sync();\n"
            "      else __syncthreads();\n")
_OWN_WRITE = "        own[(r * 3 + sg) * segw + d] = round_bf16(y);\n"
_LATE_OWN_WRITE = "        if (threadIdx.x >= 32) __nanosleep(4000);\n" + _OWN_WRITE
_MLP_RELEASE = ("      if (item + pl.ncl < pl.a.items) hopper::cluster_sync();  "
                "// the next item rewrites the tiles\n")
# A flag barrier: the cluster's blocks meet, one block of each cluster counts
# itself in on a counter in device memory and waits for the generation to
# move (the last to arrive resets the count), then the cluster meets again.
_FLAG_BARRIER = """__device__ unsigned fused_flag_barrier[2];
__device__ void flag_barrier(int C, int ncl) {
  __threadfence();
  hopper::cluster_sync();
  if (blockIdx.x % C == 0 && threadIdx.x == 0) {
    volatile unsigned* gen = fused_flag_barrier + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(fused_flag_barrier, 1u) == (unsigned)ncl - 1) {
      atomicExch(fused_flag_barrier, 0u);
      __threadfence();
      atomicAdd(fused_flag_barrier + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == g0) {
        __nanosleep(32);
        if (clock64() - t0 > 4000000000LL) __trap();
      }
    }
    __threadfence();
  }
  hopper::cluster_sync();
}

template <typename W, bool ATTN, int NT>
__global__"""

DESIGNS["hopper"] = {
    "marker": _GRID_SYNC,
    "stamps": ("start", "loads_issued", "a_products", "a_phase_done", "barrier", "b_products",
               "end", "a_weights_in", "b_weights_in", "a_partials_met", "a_sums_done"),
    "stamp_subs": (
        ("  // Both projections' first items", "  fused_stamp(0);\n  // Both projections' first items"),
        ("  ln_stats(a, stats);\n", "  fused_stamp(1);\n  ln_stats(a, stats);\n"),
        ("    project<W, NT>(a.a, &a.map_a, a, ATTN, item, rank, ra, stats, nullptr, hs, part);\n",
         "    project<W, NT>(a.a, &a.map_a, a, ATTN, item, rank, ra, stats, nullptr, hs, part);\n"
         "    fused_stamp(2);\n"),
        (_GRID_SYNC, "  fused_stamp(3);\n" + _GRID_SYNC + "  fused_stamp(4);\n"),
        ("    project<W, NT>(a.b, &a.map_b, a, false, item, rank, rb, nullptr, a.mid, hs, part);\n",
         "    project<W, NT>(a.b, &a.map_b, a, false, item, rank, rb, nullptr, a.mid, hs, part);\n"
         "    fused_stamp(5);\n"),
        (_STEP_END, _STEP_END.replace("  }\n}\n", "  }\n  fused_stamp(6);\n}\n", 1)),
        # phase A's cluster barriers: all partial tiles written; the sums read
        ("    hopper::cluster_sync();  // every rank's partial tile is written\n",
         "    hopper::cluster_sync();  // every rank's partial tile is written\n"
         "    fused_stamp(9);\n"),
        (_RELEASE + "      if (kv) {", _RELEASE + "      fused_stamp(10);\n      if (kv) {"),
        # the last chunk's weights arrived (A: LN input, B: the mid rows)
        ("    ring.parity ^= 1u << st;\n",
         "    ring.parity ^= 1u << st;\n    fused_stamp(stats ? 7 : 8);\n"),
    ),
    "variants": {
        "kernel": (),
        # no grid barrier at all (B reads whatever A has written so far)
        "no_barrier": ((_GRID_SYNC, ""),),
        # the flag barrier above in place of cooperative groups' grid sync
        "flag_barrier": ((_GRID_SYNC, "  flag_barrier(C, pl.ncl);\n"),
                         ("template <typename W, bool ATTN, int NT>\n__global__", _FLAG_BARRIER)),
        "no_attention": (("        attend(a, s, item, p, o,", "        if (0) attend(a, s, item, p, o,"),),
        "no_products": (("      for (int nt = 0; nt < NT; ++nt) mma16816(acc[j][nt], af, b[nt][0], "
                         "b[nt][1]);", "      ;"),),
        # the weight fragments not read from shared memory (constants instead)
        "no_fragment_loads": (("      load_a(static_cast<const W*>(nullptr), f[j], k, af);",
                               "      af[0] = af[1] = af[2] = af[3] = 0x3f803f80u + j;"),),
        # B's weights requested only after the barrier, not at kernel start
        "no_b_prefetch": ((_B_PREFETCH, ""),
                          ("    if (item != cid)\n      for (int c = 0; c < min(2, a.b.nch); ++c)",
                           "    for (int c = 0; c < min(2, a.b.nch); ++c)")),
        # each rank sums only its own partial: no reads of the other ranks
        "no_cluster_reduce": (
            ("    if (q < C) v[q] = hopper::ld_cluster_f32(hopper::mapa(part_addr + 4 * off, q));",
             "    if (q < 1) v[q] = hopper::ld_cluster_f32(hopper::mapa(part_addr + 4 * off, q));"),
            ("    if (q < C) s += v[q];", "    if (q < 1) s += v[q];")),
        # the weights' TMA boxes without L2 promotion, or promoted to 128 bytes
        "l2_promotion_none": (("                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, "
                               "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);\n  return r == CUDA_SUCCESS ? 0 : "
                               "hopper::ERR_TENSOR_MAP + (int)r;\n}\n\n// The tensor map of a [T, S, D]",
                               "                        CU_TENSOR_MAP_L2_PROMOTION_NONE, "
                               "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);\n  return r == CUDA_SUCCESS ? 0 : "
                               "hopper::ERR_TENSOR_MAP + (int)r;\n}\n\n// The tensor map of a [T, S, D]"),),
        "l2_promotion_128b": (("                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, "
                               "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);\n  return r == CUDA_SUCCESS ? 0 : "
                               "hopper::ERR_TENSOR_MAP + (int)r;\n}\n\n// The tensor map of a [T, S, D]",
                               "                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, "
                               "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);\n  return r == CUDA_SUCCESS ? 0 : "
                               "hopper::ERR_TENSOR_MAP + (int)r;\n}\n\n// The tensor map of a [T, S, D]"),),
        # a cluster barrier after every item's sums of phase A (the first
        # form of the redesign)
        "cluster_release": ((_RELEASE, "      hopper::cluster_sync();\n"),
                            (_MLP_RELEASE, "      hopper::cluster_sync();\n")),
        # attention without its block barrier where the grid barrier follows:
        # the K/V rows then read `own` entries other threads may not have
        # written yet (a race, for --race-launches)
        "no_release": ((_RELEASE, _RELEASE.split("\n")[0] + "\n"),),
        # the warps past the first write their `own` sums 4 us late, with the
        # block barrier and without it: whether the K/V rows depend on it
        "late_writers": ((_OWN_WRITE, _LATE_OWN_WRITE),),
        "no_release_late_writers": ((_OWN_WRITE, _LATE_OWN_WRITE),
                                    (_RELEASE, _RELEASE.split("\n")[0] + "\n")),
        # a block that returns at once: the launch alone
        "empty": (("  const Plan& pl = a.pl;\n", "  if (a.S > 0) return;\n  const Plan& pl = a.pl;\n"),),
    },
}


def design_of(source: str) -> str:
    for name, d in DESIGNS.items():
        if d["marker"] in source:
            return name
    raise ValueError("fused_ablation knows no design of this fused_decode.cu")


def apply_variant(source: str, name: str) -> str:
    """The kernel source with variant ``name``'s substitutions (``stamps``:
    the stamped build); raises if one does not match exactly once."""
    d = DESIGNS[design_of(source)]
    subs = d["stamp_subs"] if name == "stamps" else d["variants"][name]
    for old, new in subs:
        if source.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} matches {source.count(old)} times")
        source = source.replace(old, new)
    return STAMP_PRELUDE + source if name == "stamps" else source


def build(name: str) -> ctypes.CDLL:
    """Compile variant ``name`` beside copies of the headers, in
    ``build/fused_ablation/<name>/``, and load it with the wrappers'
    signatures."""
    out = _build.BUILD_DIR.parent / "fused_ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE).write_text(apply_variant((_build.CSRC / SOURCE).read_text(), name))
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"), str(out / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}{proc.stdout}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    for fn, (restype, argtypes) in FD._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    if name == "stamps":
        lib.fused_stamps_read.restype = ctypes.c_int
        lib.fused_stamps_read.argtypes = [ctypes.c_void_p]
    return lib


def layers(g: torch.Generator, int8: bool, n: int = LAYERS, s: int = S, d: int = D,
           t: int = T, f: int = F) -> list[dict]:
    """n layers' distinct operands, by default at GPT-2 small's decode shapes."""
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    def weight(k, n):
        if int8:
            return (torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                                  dtype=torch.int8), rand(n).abs() * 2e-4 + 1e-4)
        return rand(k, n, scale=0.02).bfloat16(), None

    pos = (torch.arange(s, device="cuda", dtype=torch.int32) * 7 + 40) % t
    mask = torch.where(torch.arange(t, device="cuda")[:, None, None] <= pos.long()[None, :, None],
                       0.0, -1e9).float()
    out = []
    for _ in range(n):
        o = {"ln_s": 1 + rand(d, scale=0.1), "ln_b": rand(d, scale=0.1),
             "bqkv": rand(3 * d, scale=0.01), "bout": rand(d, scale=0.01),
             "b1": rand(f, scale=0.01), "b2": rand(d, scale=0.01),
             "ck": rand(t, s, d, scale=0.5).bfloat16(), "cv": rand(t, s, d, scale=0.5).bfloat16(),
             "pos": pos, "mask": mask}
        for key, (k, n) in {"wqkv": (d, 3 * d), "wout": (d, d), "w1": (d, f),
                            "w2": (f, d)}.items():
            o[key], o["s" + key[1:]] = weight(k, n)
        out.append(o)
    return out


def call(kind: str, o: dict, x: torch.Tensor, heads: int = HEADS):
    if kind == "attn":
        if o["sqkv"] is not None:
            return FD.fused_attn_step_int8(x, o["ln_s"], o["ln_b"], o["wqkv"], o["bqkv"],
                                           o["sqkv"], o["wout"], o["bout"], o["sout"], o["ck"],
                                           o["cv"], o["pos"], o["mask"], heads=heads)
        return FD.fused_attn_step(x, o["ln_s"], o["ln_b"], o["wqkv"], o["bqkv"], o["wout"],
                                  o["bout"], o["ck"], o["cv"], o["pos"], o["mask"], heads=heads)
    if o["s1"] is not None:
        return FD.fused_mlp_step_int8(x, o["ln_s"], o["ln_b"], o["w1"], o["b1"], o["s1"],
                                      o["w2"], o["b2"], o["s2"])
    return FD.fused_mlp_step(x, o["ln_s"], o["ln_b"], o["w1"], o["b1"], o["w2"], o["b2"])


# Attention shapes of the race check (S, D, heads, T): GPT-2 small's, and
# an odd head count whose rows take the element copies (head_dim 12).
RACE_SHAPES = ((S, D, HEADS, T), (3, 60, 5, 7))


def race_rows(libs: dict, names: list[str], launches: int) -> list[dict]:
    """Per variant, attention shape and weight type: of ``launches``
    launches on the same inputs (the caches restored before each), how many
    differ in any byte of x_out or the caches from the production kernel's.
    A launch on other rows of x goes before each, so that shared memory
    holds other values than the checked launch's: a read that comes too
    early then sees them, not the same launch's values left behind."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for s, d, h, t in RACE_SHAPES:
        for w in ("bf16", "int8"):
            o = layers(g, w == "int8", 1, s, d, t, 4 * d)[0]
            x = torch.randn(s, d, device="cuda", generator=g).bfloat16()
            other = torch.randn(s, d, device="cuda", generator=g).bfloat16()
            ck, cv = o["ck"].clone(), o["cv"].clone()

            def run():
                call("attn", o, other, h)
                o["ck"].copy_(ck)
                o["cv"].copy_(cv)
                out = call("attn", o, x, h)[0]
                return out.clone(), o["ck"].clone(), o["cv"].clone()

            FD._kernel_lib = lambda: libs["kernel"]
            want = run()
            for name in names:
                FD._kernel_lib = lambda lib=libs[name]: lib
                differ = sum(not all(torch.equal(a, b) for a, b in zip(run(), want))
                             for _ in range(launches))
                rows.append({"race_check": name, "kernel": f"attn_{w}",
                             "shape": {"S": s, "D": d, "heads": h, "T": t},
                             "launches": launches, "differ": differ})
    return rows


def stamp_rows(lib, kind: str, ops: list[dict], x: torch.Tensor, names, reps: int) -> list:
    """Per stamp: (first, mean, last) block's us since the earliest start,
    each the median over the launches."""
    buf = torch.zeros(MAX_BLOCKS * MAX_STAMPS, dtype=torch.int64)
    per = [[] for _ in names]
    for _ in range(reps):
        for o in ops:
            call(kind, o, x)
            torch.cuda.synchronize()
            n = lib.fused_stamps_read(buf.data_ptr())
            if n <= 0:
                raise RuntimeError(f"stamp readout failed ({n})")
            st = buf.view(MAX_BLOCKS, MAX_STAMPS)[:n, :len(names)].double()
            rel = (st - st[:, 0].min()) / 1e3
            for i in range(len(names)):
                # blocks that passed this stamp in this launch (a block with
                # no item of a phase keeps an older launch's reading)
                col = rel[:, i][st[:, i] >= st[:, 0]]
                per[i].append((col.min().item(), col.mean().item(), col.max().item())
                              if len(col) else (float("nan"),) * 3)
    return [{"at": name, **{k: statistics.median(v[j] for v in per[i])
                            for j, k in enumerate(("first_us", "mean_us", "last_us"))}}
            for i, name in enumerate(names)]


def main(argv: list[str] | None = None) -> int:
    source = (_build.CSRC / SOURCE).read_text()
    design = DESIGNS[design_of(source)]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(design["variants"]),
                    help=f"comma-separated, of: {', '.join(design['variants'])}")
    ap.add_argument("--stamp-reps", type=int, default=5,
                    help="stamped launches per layer (0: no stamps)")
    ap.add_argument("--race-launches", type=int, default=0,
                    help="launches per variant and shape of the race check (0: none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_ablation needs an NVIDIA GPU", file=sys.stderr)
        return 1
    names = [n for n in args.variants.split(",") if n]
    builds = names + (["stamps"] if args.stamp_reps > 0 else [])
    if args.race_launches > 0 and "kernel" not in builds:
        builds.append("kernel")
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(build, builds)))
    g = torch.Generator(device="cuda").manual_seed(0)
    work = {w: layers(g, w == "int8") for w in ("bf16", "int8")}
    x = (torch.randn(S, D, device="cuda", generator=g)).bfloat16()
    kernel_lib = FD._kernel_lib
    tag = design_of(source)
    try:
        for name in names:
            FD._kernel_lib = lambda lib=libs[name]: lib
            for w, ops in work.items():
                for kind in ("attn", "mlp"):
                    ms = device_ms(lambda: [call(kind, o, x) for o in ops]) / LAYERS
                    print(json.dumps({"design": tag, "variant": name, "kernel": f"{kind}_{w}",
                                      "ms": ms}), flush=True)
        if args.stamp_reps > 0:
            FD._kernel_lib = lambda: libs["stamps"]
            for w, ops in work.items():
                for kind in ("attn", "mlp"):
                    rows = stamp_rows(libs["stamps"], kind, ops, x, design["stamps"],
                                      args.stamp_reps)
                    print(json.dumps({"design": tag, "stamps": f"{kind}_{w}", "rows": rows}),
                          flush=True)
        if args.race_launches > 0:
            for row in race_rows(libs, names, args.race_launches):
                print(json.dumps({"design": tag, **row}), flush=True)
    finally:
        FD._kernel_lib = kernel_lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
