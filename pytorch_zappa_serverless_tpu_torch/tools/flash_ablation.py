"""Where the bf16 flash-attention kernel's time goes, on one GPU.

    python -m pytorch_zappa_serverless_tpu_torch.tools.flash_ablation [--variants a,b,...]

Builds variants of ``ops/csrc/flash_attention.cu`` in which one part of the
bf16 kernel is taken out (their outputs are wrong: they are only timed),
loads each in turn as the wrapper's library, and times one launch at the
SD-1.5 UNet's two shapes, ``[2,4096,8,40]`` and ``[2,1024,8,80]``, with the
launches queued behind a spin kernel so the host's time per call leaves no
gaps.  What a part costs where it does not overlap the rest is the
kernel's time less the variant's.  ``kernel`` is the source as it is;
SDPA's time on the same inputs is printed beside it.

One JSON line per (variant, shape), then the card's name and power limit.
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
from ..ops import flash_attention as FA

SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80)]
SOURCE = "flash_attention.cu"

# name -> (old, new) substitutions in the kernel source, each of which must
# match exactly once.
VARIANTS: dict[str, tuple[tuple[str, str], ...]] = {
    "kernel": (),
    "no_softmax": (("    softmax(it);\n", "\n"), ("  softmax(0);\n", "\n")),
    "no_exp": (("ex2(fmaf(s[4 * i + j], mul, neg_m[j / 2]))",
                "fmaf(s[4 * i + j], mul, neg_m[j / 2])"),),
    "no_qk": (("Wgmma<T::BK>::template ss<0, 0>(s, dq, dk, ks > 0);", ";"),),
    "no_pv": (("Wgmma<T::DP>::template rs<1>(o, p[kk], desc_sw128(v_addr + kk * 2048, "
               "T::KV_ATOM, 1024), 1);", ";"),),
    "two_stages": (("launch<Tile<64, 128, 3, 3>>", "launch<Tile<64, 128, 2, 3>>"),
                   ("launch<Tile<128, 128, 3, 5>>", "launch<Tile<128, 128, 2, 5>>")),
}


def apply_variant(source: str, name: str) -> str:
    """The kernel source with ``name``'s substitutions; raises if one of
    them does not match exactly once (the source has moved on)."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} matches {source.count(old)} times")
        source = source.replace(old, new)
    return source


def build(name: str) -> ctypes.CDLL:
    """Compile ``name``'s source beside copies of the headers, in
    ``build/flash_ablation/<name>/``, and load it with the wrapper's
    signatures."""
    out = _build.BUILD_DIR.parent / "flash_ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE).write_text(apply_variant((_build.CSRC / SOURCE).read_text(), name))
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"), str(out / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}{proc.stdout}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    for fn, (restype, argtypes) in FA._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def launch_ms(fn, n: int = 10, reps: int = 15) -> float:
    """Median device time of one of ``n`` back-to-back calls of ``fn``,
    queued behind ``torch.cuda._sleep``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated, of: {', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        print("flash_ablation needs an NVIDIA GPU", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {shape: [torch.randn(*shape, device="cuda", generator=g).bfloat16()
                      for _ in range(3)] for shape in SHAPES}
    for shape, (q, k, v) in inputs.items():
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = launch_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
        print(json.dumps({"variant": "sdpa", "shape": list(shape), "ms": sdpa}), flush=True)
    kernel_lib = FA._kernel_lib
    try:
        for name in names:
            FA._kernel_lib = lambda lib=libs[name]: lib
            for shape, (q, k, v) in inputs.items():
                ms = launch_ms(lambda: FA.flash_attention(q, k, v))
                print(json.dumps({"variant": name, "shape": list(shape), "ms": ms}), flush=True)
    finally:
        FA._kernel_lib = kernel_lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
