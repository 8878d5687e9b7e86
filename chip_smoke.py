"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the port's hand-written kernels from ``ops/csrc/``, one
   ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (and the edge cases each must take), with
   per-shape times (kernels and their library calls by ``device_ms``,
   launches queued behind a spin kernel; plain versions by CUDA events);
   ``int8_matmul`` at the BERT shapes, GPT-2 small's decode (M = 1, 8) and
   prefill (M = 512) shapes and its f32 lm head, two launches of a split-K
   shape bitwise equal, and one GPT-2 position step and one BERT forward
   over distinct weights beside cuBLAS on the dequantised weights; at
   flash's 4096-token shape, a planted fault (the scale of a padded head
   dim) the tolerance must reject;
4. BERT path: ``build_engine`` with full-width BERT-base int8 (seed weights),
   the port's HTTP server on a free localhost port, ``:predict`` requests
   (``text``, ``input_ids``, an 8-element ``instances`` body) and
   ``/classify``, then ``/healthz``, ``/v1/models`` and ``/metrics``; the
   int8 kernel's launch count must equal its launches per forward times the
   forwards run;
5. BERT parity: the served int8 forward against the same model with every
   projection routed through the plain version, on the same weights and
   batch;
6. SD-1.5 path: ``build_engine`` with full-width SD-1.5 at 512x512, 20 DDIM
   steps in chunks of 4 (seed weights), the server, two ``:submit`` jobs
   polled on ``/v1/jobs/{id}`` to valid 512x512 PNGs, ``:predict`` → 405,
   ``/v1/models``, ``/healthz``, ``/metrics``; the flash kernel's launch
   count must be ten per UNet call;
7. SD-1.5 parity: one UNet call with every long self-attention through the
   kernel, against the same with it routed through the plain version; and
   the PNG the job lane served for the first job against the same request
   through the same chunked route with the plain version;
8. GPT-2 path: ``build_engine`` with full-width GPT-2 small int8 (seed
   weights), batch buckets (1, 8), seq bucket 64, 32 new tokens; the server;
   ``:predict`` with ``text``, ``input_ids``, 8 ragged ``instances``, and one
   sampled request sent twice (the same answer both times); the GETs; the
   int8 kernel's launch count must be 49 per position step times 33 steps
   per generate call; then prefill and teacher-forced step logits against the
   same model with the int8 product routed to its plain version;
9. fused decode: the bench's three lanes (``tools/bench_fused_decode``) on
   8 ragged prompts through the port's prefill; each fused kernel of one step
   against its plain version, per layer, and a planted fault (the key at
   pos[s] masked) the tolerance must reject; 32 teacher-forced steps of each
   fused lane against the unfused step (12 launches of each of the four
   entry points per step of its lane); ms per step of the three lanes and
   each kernel's per-launch time beside its bound; with ``--profile``, the
   per-phase ``%globaltimer`` stamps of one launch of each fused kernel
   (``tools/fused_ablation``).

Every kernel count is set to 0 just before each path and read just after.
The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on its main path, error against its plain version, and per-call
times (kernel, plain version, one PyTorch library call) beside its bound;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import base64
import json
import statistics
import struct
import subprocess
import sys
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Data-sheet peaks of the H100 SXM at its full 700 W power limit (dense).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Exponentials: 16 special-function results per SM per clock (compute
# capability 9.0), 132 SMs, at 1.83 GHz.
PEAK_EXP_PER_S = 132 * 16 * 1.83e9

BERT = {"layers": 12, "seq": 128, "batch_buckets": (1, 8)}
# (K, N) of the six encoder projections of one layer: query, key, value,
# attention_output, intermediate, output.
LAYER_PROJECTIONS = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
MAIN_M = (128, 1024)  # the (1, 128) and (8, 128) buckets
RAGGED = [(3, 100, 50), (1, 768, 768)]
# GPT-2 small's int8 products: (K, N) of the four layer projections (q|k|v
# fused, out, fc1, fc2) at decode (M = 1, 8) and prefill (M = 512), and the
# padded lm head with f32 logits at decode.
GPT2_KN = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
GPT2_HEAD = (768, 50304)
GPT2_DECODE_M = (1, 8)
GPT2_PREFILL_M = 512
DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32)]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phase 1: device ---------------------------------------------------------

def phase_device() -> None:
    check(torch.cuda.is_available(), "CUDA is not available: chip_smoke needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # f32 products in full f32: the plain versions are the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- phase 2: build ----------------------------------------------------------

def phase_build() -> None:
    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA
    from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as FD
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    def build(name, fn):
        t0 = time.perf_counter()
        fn()
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(build, "int8_matmul.cu", I._kernel_lib),
                pool.submit(build, "flash_attention.cu", FA._kernel_lib),
                pool.submit(build, "fused_decode.cu", FD._kernel_lib)]
        for f in futs:
            name, secs = f.result()
            log(f"build {name}: {secs:.3f} s")
    log(f"build, all three sources in parallel: {time.perf_counter() - t0:.3f} s")


# -- phase 3: kernels against their plain versions ---------------------------

def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after a warm-up.  The operands stay in L2 between calls.
    Where a call is shorter than its host time this times the host: the
    kernels are timed with ``launch_ms``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def matmul_bytes_ops(m: int, k: int, n: int, x_dtype, out_dtype) -> tuple[int, int]:
    """(bytes, operations) of the W8A16 product: each input read once, the
    output written once; 2·M·K·N operations."""
    xb = torch.empty(0, dtype=x_dtype).element_size()
    ob = torch.empty(0, dtype=out_dtype).element_size()
    return m * k * xb + k * n + 4 * n + m * n * ob, 2 * m * k * n


def matmul_bound(m: int, k: int, n: int, x_dtype, out_dtype) -> tuple[float, float]:
    """(operations ms, bytes ms) of the W8A16 product: the operations at the
    peak rate of the input type (bf16 tensor cores, or f32 CUDA cores), the
    bytes at the memory rate.  The least time the card could take is the
    larger of the two."""
    nbytes, ops = matmul_bytes_ops(m, k, n, x_dtype, out_dtype)
    peak = PEAK_BF16_FLOPS if x_dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return 1e3 * ops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S


def int8_cases() -> list[tuple]:
    """(M, K, N, x dtype, out dtype, timed) of every kernel check: the BERT
    shapes and the ragged ones in the three dtype pairs, the GPT-2 shapes in
    the served ones; the served dtype pair of the BERT buckets and of GPT-2
    decode at M = 8 is timed."""
    cases = []
    for m in MAIN_M:
        for k, n in sorted(set(LAYER_PROJECTIONS)):
            cases += [(m, k, n, xd, od, (xd, od) == DTYPES[0]) for xd, od in DTYPES]
    cases += [(m, k, n, xd, od, False) for m, k, n in RAGGED for xd, od in DTYPES]
    for m in GPT2_DECODE_M + (GPT2_PREFILL_M,):
        cases += [(m, k, n, *DTYPES[0], m == 8) for k, n in GPT2_KN]
    cases += [(m, *GPT2_HEAD, *DTYPES[1], m == 8) for m in GPT2_DECODE_M]
    return cases


def phase_kernels() -> dict:
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    max_err, timings = 0.0, {}
    for m, k, n, x_dtype, out_dtype, timed in int8_cases():
        x32 = torch.randn(m, k, device=dev, generator=g) * 0.5
        w_q = torch.randint(-127, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
        scale = torch.rand(n, device=dev, generator=g) * 2e-3 + 1e-4
        x = x32.to(x_dtype)
        y = I.int8_matmul(x, w_q, scale, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = I.int8_matmul_reference(x, w_q, scale, out_dtype)
        tag = f"int8_matmul {m}x{k}x{n} {str(x_dtype)[6:]}->{str(out_dtype)[6:]}"
        check(y.shape == want.shape and y.dtype == want.dtype,
              f"{tag}: {y.shape} {y.dtype} vs {want.shape} {want.dtype}")
        check(bool(torch.isfinite(y).all()), f"{tag}: non-finite output")
        err = (y.float() - want.float()).abs().max().item()
        if out_dtype == torch.bfloat16:
            ok = torch.allclose(y.float(), want.float(), rtol=2e-2, atol=2e-2)
            tol = "rtol=atol=2e-2"
        else:
            atol = 1e-3 * want.abs().max().item()
            ok, tol = err <= atol, f"atol={atol:.3g}"
        check(ok, f"{tag}: max |err| {err} outside {tol}")
        max_err = max(max_err, err)
        log(f"{tag} (plan {tuple(I.plan(m, k, n))}): max |err| {err:.3g} ({tol}) ok")
        if not timed:
            continue
        w_deq = (w_q.float() * scale).to(torch.bfloat16)
        library = (lambda: torch.matmul(x, w_deq)) if out_dtype == torch.bfloat16 else \
            (lambda: torch.matmul(x, w_deq).float())
        row = {"ms": launch_ms(lambda: I.int8_matmul(x, w_q, scale, out_dtype=out_dtype)),
               "plain_ms": time_ms(lambda: I.int8_matmul_reference(x, w_q, scale, out_dtype)),
               "library_ms": launch_ms(library)}
        row["ops_ms"], row["bytes_ms"] = matmul_bound(m, k, n, x_dtype, out_dtype)
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        timings[m, k, n] = row
        log(f"time int8_matmul M={m} K={k} N={n}: kernel {row['ms']:.5f} ms, "
            f"plain {row['plain_ms']:.4f} ms, cuBLAS bf16 on dequantised weights "
            f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.3f} of the kernel's time)")
    # Split-K sums in fixed rank order: two launches agree bit for bit.
    m, k, n = 8, 768, 768
    check(I.plan(m, k, n).splits > 1, f"{m}x{k}x{n} is not a split-K shape")
    x = (torch.randn(m, k, device=dev, generator=g) * 0.5).bfloat16()
    w_q = torch.randint(-127, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
    scale = torch.rand(n, device=dev, generator=g) * 2e-3 + 1e-4
    runs = [I.int8_matmul(x, w_q, scale) for _ in range(2)]
    check(torch.equal(*runs), f"int8_matmul {m}x{k}x{n}: two split-K launches differ")
    log(f"int8_matmul {m}x{k}x{n} (plan {tuple(I.plan(m, k, n))}): two launches bitwise equal")
    return {"max_abs_err": max_err, "timings": timings, "work": phase_int8_work()}


def phase_int8_work() -> dict:
    """Whole pieces of main-path work over distinct weights, so that they
    stream from device memory as served: one GPT-2 small position step at
    M = 8 (48 layer projections + the f32 lm head, 123.6 MB of int8) and one
    BERT-base (8, 128) forward (72 projections at M = 1024).  Kernel and
    cuBLAS on the dequantised bf16 weights by ``device_ms``; the bound is
    the step's bytes, or the forward's operations, at the card's peak."""
    from pytorch_zappa_serverless_tpu_torch.tools import int8_ablation as IA

    g = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, m in IA.WORK.items():
        ops = IA.operands(name, g)
        nbytes = opcount = 0
        for k, n, out_dtype in IA.products(name):
            b, o = matmul_bytes_ops(m, k, n, torch.bfloat16, out_dtype)
            nbytes, opcount = nbytes + b, opcount + o
        b_ms, o_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * opcount / PEAK_BF16_FLOPS
        row = {"ms": device_ms(IA.run_kernel(ops)), "library_ms": device_ms(IA.run_cublas(ops)),
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "launches": len(ops), "weight_mb": sum(op[1].numel() for op in ops) / 1e6}
        out[name] = row
        log(f"time int8_matmul {name} ({row['launches']} launches at M={m}, "
            f"{row['weight_mb']:.1f} MB of distinct int8 weights): kernel {row['ms']:.4f} ms, "
            f"cuBLAS on dequantised bf16 {row['library_ms']:.4f} ms "
            f"({row['ms'] / row['library_ms']:.3f} x), bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.3f} of the kernel's time)")
        del ops
    return out


def per_forward(timings: dict, m: int) -> dict:
    """One forward's worth of int8_matmul at row count ``m`` from the
    per-shape rows (operands warm in L2): the layer's six projections times
    the number of layers.  The bound is the sum of the launches' bounds; it
    names what bounds most of it."""
    out = {key: BERT["layers"] * sum(timings[m, k, n][key] for k, n in LAYER_PROJECTIONS)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")}
    out["bound_by"] = "operations" if out.pop("ops_ms") >= out.pop("bytes_ms") else "bytes"
    return out


# Flash attention at the SD-1.5 path's shapes: [B, T, H, D] with the CFG
# batch of 2 and 8 heads; five launches per UNet call at each.
FLASH_MAIN = [(2, 4096, 8, 40), (2, 1024, 8, 80)]
FLASH_PER_UNET = {(2, 4096, 8, 40): 5, (2, 1024, 8, 80): 5}
# (B, Tq, Tk, H, D, dtype, causal, masked): the edge cases the kernel takes.
FLASH_EDGES = [(1, 1024, 1024, 8, 64, torch.bfloat16, False, False),
               (2, 1000, 1000, 8, 40, torch.bfloat16, False, False),   # ragged T
               (2, 1024, 1024, 8, 40, torch.bfloat16, False, True),    # kv_mask
               (1, 1024, 1024, 8, 40, torch.bfloat16, True, False),    # causal
               (2, 1024, 1024, 8, 160, torch.bfloat16, False, False),  # 1024x1024 images
               (2, 1000, 1000, 4, 80, torch.float32, False, True),     # f32, ragged
               (2, 100, 100, 8, 40, torch.bfloat16, False, False),     # Tq < one Q tile
               (1, 256, 130, 8, 64, torch.bfloat16, False, False),     # 128 keys + 2
               (1, 256, 256, 8, 64, torch.bfloat16, True, False),      # causal, 128-row tiles
               (2, 1024, 1024, 8, 20, torch.bfloat16, False, False)]   # D = 20: padded copy


# Kernel vs plain version, per element |y - want| <= atol + rtol·|want|.
# bf16: rtol = 2^-6 is two bf16 roundings at the bottom of a binade (each
# side rounds its f32 output once); atol = 2e-3 covers outputs near 0, where
# P rounded to bf16 against a running rather than the final max is what
# differs.  At [2,4096,8,40] the outputs' typical |y| is ~0.02, so the limit
# there is ~2.3e-3, and a kernel that took sm_scale from a padded D
# (1/sqrt(48)) is off by ~2.4e-3 on average: phase_flash checks that it
# fails.  f32: the special-function exponential and per-tile sums.
FLASH_TOL = {torch.bfloat16: (2e-3, 2 ** -6), torch.float32: (1e-4, 1e-4)}


def tol_share(y: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> float:
    """Largest |y - want| / (atol + rtol·|want|): at most 1 within tolerance."""
    y, want = y.float(), want.float()
    return ((y - want).abs() / (atol + rtol * want.abs())).max().item()


def flash_bound(b: int, t: int, h: int, d: int) -> dict:
    """Least time of one launch at [b, t, h, d] bf16 self-attention: the
    largest of the two products (4·b·h·t²·d operations on the tensor cores),
    the exponentials (b·h·t² on the special-function units) and the bytes (q,
    k, v read once, o written once)."""
    parts = {"products": 1e3 * 4 * b * h * t * t * d / PEAK_BF16_FLOPS,
             "exponentials": 1e3 * b * h * t * t / PEAK_EXP_PER_S,
             "bytes": 1e3 * 4 * b * t * h * d * 2 / PEAK_BYTES_PER_S}
    worst = max(parts, key=parts.get)
    return {"bound_ms": parts[worst], "bound_detail": worst,
            "bound_by": "bytes" if worst == "bytes" else "operations"}


def launch_ms(fn, n: int = 10) -> float:
    """Device time of one of ``n`` back-to-back launches of ``fn``, queued
    behind a spin kernel (``device_ms``): at [2,1024,8,80] a launch is
    shorter than the wrapper's Python, so plain events would time the host."""
    return device_ms(lambda: [fn() for _ in range(n)]) / n


def phase_flash() -> dict:
    """flash_attention against flash_attention_reference on the card, within
    ``FLASH_TOL``; at [2,4096,8,40] also a planted fault (sm_scale of a
    padded D) that the tolerance must reject."""
    import torch.nn.functional as F

    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    max_err, timings = 0.0, {}
    cases = [(b, t, t, h, d, torch.bfloat16, False, False) for b, t, h, d in FLASH_MAIN]
    for b, tq, tk, h, d, dtype, causal, masked in cases + FLASH_EDGES:
        q, k, v = (torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
                   for t in (tq, tk, tk))
        mask = None
        if masked:  # batch row 0 attends to all but 100 keys, row 1 to none
            mask = torch.zeros(b, tk, dtype=torch.bool, device=dev)
            mask[0, : tk - 100] = True
        y = FA.flash_attention(q, k, v, causal=causal, kv_mask=mask)
        torch.cuda.synchronize()
        want = FA.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
        tag = f"flash_attention [{b},{tq},{h},{d}]{'x' + str(tk) if tk != tq else ''} " \
              f"{str(dtype)[6:]}{' causal' if causal else ''}{' kv_mask' if masked else ''}"
        check(y.shape == want.shape and y.dtype == want.dtype, f"{tag}: {y.shape} {y.dtype}")
        check(bool(torch.isfinite(y).all()), f"{tag}: non-finite output")
        atol, rtol = FLASH_TOL[dtype]
        err = (y.float() - want.float()).abs().max().item()
        share = tol_share(y, want, atol, rtol)
        check(share <= 1, f"{tag}: max |err| {err}, {share:.3g} x the tolerance "
                          f"(atol={atol}, rtol={rtol})")
        if masked:  # the fully masked row: uniform over the keys, finite
            uniform = v[1].float().mean(0).expand_as(y[1])
            check(tol_share(y[1], uniform, atol, rtol) <= 1,
                  f"{tag}: fully masked row is not uniform")
        max_err = max(max_err, err)
        log(f"{tag}: max |err| {err:.3g}, {share:.3f} x the tolerance (atol={atol}, "
            f"rtol={rtol:.4g}) ok")
        if (b, tq, h, d) not in FLASH_MAIN or tq != tk or causal or masked:
            continue
        if d == 40:  # the planted fault: the scale of D padded to 48
            bad = tol_share(FA.flash_attention(q, k, v, sm_scale=48 ** -0.5), want, atol, rtol)
            check(bad > 1, f"{tag}: the tolerance passes sm_scale = 1/sqrt(48) ({bad:.3g} x)")
            log(f"{tag}: sm_scale from the padded D (1/sqrt(48)) is {bad:.3f} x the "
                f"tolerance: rejected, as it must be")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {"ms": launch_ms(lambda: FA.flash_attention(q, k, v)),
               "plain_ms": time_ms(lambda: FA.flash_attention_reference(q, k, v), reps=5),
               "library_ms": launch_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               **flash_bound(b, tq, h, d)}
        timings[b, tq, h, d] = row
        log(f"time flash_attention [{b},{tq},{h},{d}] bf16: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms "
            f"({row['ms'] / row['library_ms']:.3f} x), bound {row['bound_ms']:.5f} ms "
            f"({row['bound_detail']}; {row['bound_ms'] / row['ms']:.3f} of the kernel's time)")
    return {"max_abs_err": max_err, "timings": timings}


def per_unet_call(timings: dict) -> dict:
    """One UNet call's ten flash launches at 512x512.  The bound is the sum
    of the launches' bounds; it names what bounds most of it."""
    out = {key: sum(n * timings[shape][key] for shape, n in FLASH_PER_UNET.items())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    detail = {}
    for shape, n in FLASH_PER_UNET.items():
        row = timings[shape]
        detail[row["bound_detail"]] = detail.get(row["bound_detail"], 0.0) + n * row["bound_ms"]
    worst = max(detail, key=detail.get)
    out["bound_by"] = "bytes" if worst == "bytes" else "operations"
    out["bound_detail"] = worst
    return out


# -- phase 4: the BERT path ----------------------------------------------------

FUSED_ENTRY_POINTS = ("fused_attn_step", "fused_attn_step_int8", "fused_mlp_step",
                      "fused_mlp_step_int8")


def reset_counts() -> None:
    """Every kernel count (and the UNet calls) to 0: just before a path."""
    from pytorch_zappa_serverless_tpu_torch.models.sd_unet import unet_apply
    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA
    from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as FD
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    I.int8_matmul.launches = FA.flash_attention.launches = unet_apply.calls = 0
    for fn in FUSED_ENTRY_POINTS:
        getattr(FD, fn).launches = 0


def read_counts() -> dict:
    from pytorch_zappa_serverless_tpu_torch.models.sd_unet import unet_apply
    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA
    from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as FD
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    return {"int8_matmul": I.int8_matmul.launches,
            "flash_attention": FA.flash_attention.launches, "unet_calls": unet_apply.calls,
            **{fn: getattr(FD, fn).launches for fn in FUSED_ENTRY_POINTS}}

def http(port: int, path: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_config(arch: dict | None = None, seq: int = BERT["seq"],
                 batch_buckets=BERT["batch_buckets"]):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    extra = {"params_dtype": "int8", **({"arch": arch} if arch else {})}
    return ServeConfig(models=[ModelConfig(
        name="bert_base", dtype="bfloat16", seq_buckets=(seq,),
        batch_buckets=tuple(batch_buckets), extra=extra)])


def phase_main_path(cfg, device: str = "cuda") -> dict:
    """Build the engine, serve, and answer requests; returns the engine, the
    launch counts, the forwards run and the responses."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"engine ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"first dispatch per bucket {engine.clock.entries}")
    words = "the service answered every request it was sent in good time".split()
    requests = [
        ("/v1/models/bert_base:predict", {"text": "a short sentence to classify"}),
        ("/v1/models/bert_base:predict", {"input_ids": [101] + list(range(2000, 2100)) + [102]}),
        ("/v1/models/bert_base:predict",
         {"instances": [{"text": " ".join(words[: 3 + i])} for i in range(8)]}),
        ("/classify", {"text": "the last request goes to the classify route"}),
    ]
    answers, gets = [], {}
    with BackgroundServer(cfg, engine) as srv:
        log(f"serving on 127.0.0.1:{srv.port}")
        for path, body in requests:
            status, out = http(srv.port, path, body)
            check(status == 200, f"{path}: status {status}: {out}")
            answers.append((path, body, out))
        launches = read_counts()  # just after the path
        for path in ("/healthz", "/v1/models", "/metrics"):
            status, out = http(srv.port, path)
            check(status == 200, f"{path}: status {status}: {out}")
            gets[path] = out
    st = engine.runner.stats["bert_base"]
    forwards = len(engine.clock.entries) + st.batches
    return {"engine": engine, "launches": launches, "forwards": forwards,
            "batches": st.batches, "answers": answers, "gets": gets}


def check_answers(run: dict, num_labels: int = 2) -> None:
    for path, body, out in run["answers"]:
        check(out.get("model") == "bert_base" and {"timing", "predictions"} <= set(out),
              f"{path}: response keys {sorted(out)}")
        preds = out["predictions"] if "instances" in body else [out["predictions"]]
        check(len(preds) == len(body.get("instances", [body])),
              f"{path}: {len(preds)} predictions")
        for pred in preds:
            probs = [s["prob"] for s in pred["scores"]]
            check(len(probs) == num_labels and all(0.0 <= p <= 1.0 for p in probs),
                  f"{path}: probabilities {probs}")
            check(abs(sum(probs) - 1.0) <= 1e-3, f"{path}: probabilities sum to {sum(probs)}")
        log(f"{path} {json.dumps(body)[:60]}...: 200, timing {out['timing']}")
    health = run["gets"]["/healthz"]
    check(health["device_ok"] is True, f"/healthz: {health}")
    check("bert_base" in run["gets"]["/v1/models"]["models"], "/v1/models misses bert_base")


# -- phase 5: parity against the plain version -------------------------------

def collate(cm, instances: list[dict], seq: int) -> tuple[tuple[int, ...], dict]:
    """(bucket, collated host batch) for request bodies, as the engine pads them."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    samples = [cm.servable.preprocess(p) for p in instances]
    bucket = cm.bucket_for(len(samples), seq)
    return bucket, default_collate(samples, bucket, cm.servable.input_spec(bucket))


def phase_parity(engine, instances: list[dict], seq: int = BERT["seq"]) -> dict:
    """The served forward (kernel) vs the same module with every projection
    routed through the plain version, on the card, on one collated batch."""
    from pytorch_zappa_serverless_tpu_torch.models.bert import Int8Dense
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    cm = engine.model("bert_base")
    bucket, batch = collate(cm, instances, seq)
    dense = [m for m in cm.servable.module.modules() if isinstance(m, Int8Dense)]

    def plain_forward():
        for m in dense:
            m.matmul = I.int8_matmul_reference
        try:
            return cm.forward(batch)["probs"]
        finally:
            for m in dense:
                m.matmul = I.int8_matmul

    served = engine.runner.run_fn_sync(lambda: cm.forward(batch)["probs"])
    plain = engine.runner.run_fn_sync(plain_forward)
    check(served.shape == plain.shape == (bucket[0], 2), f"probs shape {served.shape}")
    check(bool(np.isfinite(served).all()), "served probabilities are not finite")
    n = len(instances)
    err = float(np.abs(served[:n] - plain[:n]).max())
    check(err <= 2e-2, f"served vs plain forward: max |dprob| {err} > 2e-2")
    same = bool((served[:n].argmax(-1) == plain[:n].argmax(-1)).all())
    check(same, f"served vs plain forward: argmax differs\n{served[:n]}\n{plain[:n]}")
    log(f"parity: served int8 forward vs plain-version forward on bucket {bucket}: "
        f"max |dprob| {err:.3g} (atol 2e-2), same argmax")
    return {"max_abs_prob_err": err, "dense_modules": len(dense)}


# -- phase 6: the SD-1.5 path ---------------------------------------------------

SD = {"height": 512, "width": 512, "num_steps": 20, "chunk_steps": 4}
SD_JOBS = [{"prompt": "a photograph of an astronaut riding a horse", "seed": 1},
           {"prompt": "a red fox in the snow, oil painting", "seed": 2,
            "negative_prompt": "blurry", "guidance_scale": 5.0}]


def sd_config(variant: str | None = None, **extra):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    extra = {**SD, **({"variant": variant} if variant else {}), **extra}
    return ServeConfig(models=[ModelConfig(name="sd15", dtype="bfloat16",
                                           batch_buckets=(1,), extra=extra)])


def read_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG with filter 0 on every row (what the port writes)
    → uint8 [H, W, 3], with zlib alone."""
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG signature")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        check(struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
              == zlib.crc32(tag + body) & 0xFFFFFFFF, f"PNG {tag!r} chunk CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    check(header is not None and header[2:5] == (8, 2, 0), f"PNG header {header}")
    w, h = header[:2]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    check(raw.size == h * (1 + 3 * w), f"PNG data {raw.size} bytes for {w}x{h}")
    rows = raw.reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG rows use a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def phase_sd_path(cfg, device: str = "cuda", jobs=SD_JOBS) -> dict:
    """Build the SD-1.5 engine, serve, submit the jobs and poll them to done;
    returns the engine, the counts, the finished jobs and the GET answers."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"sd15 engine ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}, first dispatch {engine.clock.entries}")
    done, gets = [], {}
    with BackgroundServer(cfg, engine) as srv:
        log(f"serving on 127.0.0.1:{srv.port}")
        ids = []
        for body in jobs:
            status, out = http(srv.port, "/v1/models/sd15:submit", body)
            check(status == 202, f":submit: status {status}: {out}")
            ids.append(out["job"]["id"])
        deadline = time.monotonic() + 600
        for job_id in ids:
            while True:
                status, out = http(srv.port, f"/v1/jobs/{job_id}")
                check(status == 200, f"/v1/jobs/{job_id}: status {status}: {out}")
                if out["job"]["status"] in ("done", "error"):
                    break
                check(time.monotonic() < deadline, f"job {job_id} still {out['job']['status']}")
                time.sleep(0.05)
            done.append(out["job"])
        counts = read_counts()  # just after the path
        for path, body in (("/v1/models/sd15:predict", {"prompt": "x"}), ("/healthz", None),
                           ("/v1/models", None), ("/metrics", None)):
            gets[path] = http(srv.port, path, body)
    return {"engine": engine, "counts": counts, "jobs": done, "gets": gets}


def check_sd(run: dict, size=(SD["height"], SD["width"])) -> list[np.ndarray]:
    images = []
    for body, job in zip(SD_JOBS, run["jobs"]):
        check(job["status"] == "done", f"job {job['id']}: {job}")
        result = job["result"]
        check(result["format"] == "png" and (result["height"], result["width"]) == size,
              f"job result {dict((k, v) for k, v in result.items() if k != 'image_b64')}")
        img = read_png(base64.b64decode(result["image_b64"]))
        check(img.shape == (*size, 3), f"PNG decodes to {img.shape}")
        check(img.std() > 0, "the image is constant")
        images.append(img)
        log(f":submit {json.dumps(body)}: done in {job['seconds']} s, PNG "
            f"{img.shape[1]}x{img.shape[0]}x3, pixel mean {img.mean():.2f} std {img.std():.2f}")
    status, out = run["gets"]["/v1/models/sd15:predict"]
    check(status == 405 and ":submit" in out["error"], f":predict on sd15: {status} {out}")
    status, out = run["gets"]["/v1/models"]
    check(status == 200 and out["models"]["sd15"]["async_only"] is True
          and out["models"]["sd15"]["endpoint"] == "/v1/models/sd15:submit", f"/v1/models: {out}")
    status, out = run["gets"]["/healthz"]
    check(status == 200 and out["device_ok"] is True and out["jobs_backlog"] == 0,
          f"/healthz: {out}")
    status, out = run["gets"]["/metrics"]
    check(status == 200 and out["jobs"]["backlog"] == 0
          and out["runner"]["sd15"]["batches"] == len(SD_JOBS), f"/metrics: {out}")
    log(f"/metrics: sd15 {out['runner']['sd15']}, jobs {out['jobs']}")
    return images


# -- phase 7: SD-1.5 parity against the plain version ----------------------------

# UNet eps, kernel vs plain route, relative max error (max|Δ| / max|eps|):
# each of the ten flash outputs differs from the plain version's by about one
# bf16 rounding (2^-8 relative), and the bf16 layers after them carry that on.
SD_EPS_RTOL = 5e-2
# The finished image, mean |Δ| over the uint8 values: twenty steps feed each
# step's small eps difference back through the sampler.
SD_IMAGE_MEAN_LSB = 4.0


def phase_sd_parity(engine, body: dict, served: np.ndarray) -> dict:
    """One UNet call with every long self-attention through the kernel and
    through the plain version, on one collated input; the PNG the job lane
    served for ``body`` against the same request through the same chunked
    route (prepare, 4-step chunks, finalize, PNG) with the plain version;
    and ms per denoise step from one 4-step chunk."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate
    from pytorch_zappa_serverless_tpu_torch.models import sd15 as S
    from pytorch_zappa_serverless_tpu_torch.models import sd_unet as U
    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA

    cm = engine.model("sd15")
    ch = cm.servable.meta["chunked"]
    samples = [cm.servable.preprocess(body)]
    batch = default_collate(samples, (1,), cm.servable.input_spec((1,)))

    def plain(fn):
        U.flash = FA.flash_attention_reference
        try:
            return fn()
        finally:
            U.flash = FA.flash_attention

    def unet_eps():
        with torch.inference_mode():
            tree = cm.servable.module.tree()
            inputs = cm._place(batch)
            sd_cfg, dtype = cm.servable.meta["config"], cm.servable.meta["dtype"]
            context, _ = S.encode_condition(tree, inputs, sd_cfg, dtype)
            lat2 = torch.cat([inputs["latents"]] * 2)
            t2 = torch.full((2,), float(ch["chunk_rows"][0]["t"][0]), device=lat2.device)
            return U.unet_apply(tree["unet"], lat2, t2, context, sd_cfg.unet,
                                dtype).cpu().numpy()

    def step_ms():
        _, state = cm.chunk_prepare(samples)
        t0 = time.perf_counter()
        cm.chunk_step(state, ch["chunk_rows"][0])  # ends in a stream synchronize
        return (time.perf_counter() - t0) * 1e3 / ch["steps_per_chunk"]

    def job_png():
        """The job lane's route (runner.run_chunked's slices, the server's
        finalize), in one dispatch: the decoded PNG."""
        _, state = cm.chunk_prepare(samples)
        for rows in ch["chunk_rows"]:
            state = cm.chunk_step(state, rows)
        result = cm.servable.meta["finalize"](cm.chunk_finalize(state, samples)[0])
        return read_png(base64.b64decode(result["image_b64"]))

    run = engine.runner.run_fn_sync
    eps_k, eps_p = run(unet_eps), run(lambda: plain(unet_eps))
    check(eps_k.shape == (2, *batch["latents"].shape[1:]), f"eps {eps_k.shape}")
    check(bool(np.isfinite(eps_k).all() and np.isfinite(eps_p).all()), "eps not finite")
    eps_err = float(np.abs(eps_k - eps_p).max() / np.abs(eps_p).max())
    check(eps_err <= SD_EPS_RTOL, f"UNet eps, kernel vs plain: rel max err {eps_err}")
    img_p = run(lambda: plain(job_png))
    check(img_p.shape == served.shape, f"plain route image {img_p.shape} vs {served.shape}")
    diff = np.abs(served.astype(np.int32) - img_p.astype(np.int32))
    img_err = float(diff.mean())
    check(img_err <= SD_IMAGE_MEAN_LSB, f"served image vs plain route: mean |d| {img_err} LSB")
    ms = [run(step_ms) for _ in range(3)]
    log(f"sd parity: UNet eps rel max err {eps_err:.4g} (<= {SD_EPS_RTOL}); the served PNG "
        f"vs the plain route's: mean |d| {img_err:.4g} LSB (<= {SD_IMAGE_MEAN_LSB}), "
        f"max {int(diff.max())}")
    log(f"sd denoise: {statistics.median(ms):.3f} ms per step (CFG batch 2, 512x512; one "
        f"4-step chunk, host clock to a stream synchronize; runs {[round(m, 3) for m in ms]})")
    return {"eps_rel_err": eps_err, "image_mean_lsb": img_err,
            "ms_per_step": statistics.median(ms)}


def phase_sd_profile(engine, body: dict, top: int = 15) -> None:
    """``torch.profiler`` over one 4-step chunk on the dispatch thread:
    device time by kernel name and the device's idle share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cm = engine.model("sd15")
    ch = cm.servable.meta["chunked"]
    samples = [cm.servable.preprocess(body)]

    def window():
        _, state = cm.chunk_prepare(samples)
        cm.chunk_step(state, ch["chunk_rows"][0])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cm.chunk_step(state, ch["chunk_rows"][1])
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    prof, wall_ms = engine.runner.run_fn_sync(window)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in rows)
    steps = ch["steps_per_chunk"]
    log(f"profile sd15: one chunk of {steps} steps: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for name, count, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        log(f"profile sd15: {ms / steps:9.4f} ms/step {100 * ms / busy_ms:5.1f}% "
            f"x{count / steps:<6g} {name[:90]}")


# -- optional: where one forward's device time goes --------------------------

def phase_profile(engine, instances: list[dict], seq: int = BERT["seq"],
                  forwards: int = 5, top: int = 12) -> None:
    """``torch.profiler`` over ``forwards`` served forwards of one batch, on
    the dispatch thread: device time by kernel name, and the device's busy
    share of the window's wall time (host clock, ending in a synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cm = engine.model("bert_base")
    bucket, batch = collate(cm, instances, seq)

    def window():
        for _ in range(3):
            cm.forward(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(forwards):
                cm.forward(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    prof, wall_ms = engine.runner.run_fn_sync(window)
    # Device-side events only: a CPU op's self device time repeats its kernels'.
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in rows)
    log(f"profile: {forwards} forwards of bucket {bucket}: wall {wall_ms:.3f} ms, device "
        f"busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for name, count, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        log(f"profile: {ms / forwards:9.4f} ms/forward {100 * ms / busy_ms:5.1f}% "
            f"x{count // forwards:<4d} {name[:90]}")


def run_bert(profile: bool) -> int:
    """The BERT path, its checks and parity; returns int8_matmul's launches."""
    cfg = serve_config()
    run = phase_main_path(cfg)
    engine = run["engine"]
    try:
        check_answers(run)
        per_fwd = 6 * BERT["layers"]
        launches = run["launches"]["int8_matmul"]
        check(launches > 0, "int8_matmul was not launched on the main path")
        check(launches == per_fwd * run["forwards"],
              f"int8_matmul launches {launches} != {per_fwd} x {run['forwards']} forwards")
        log(f"main path: {run['forwards']} forwards ({len(engine.clock.entries)} warm-up, "
            f"{run['batches']} served batches), int8_matmul launched {launches} times")
        ring = run["gets"]["/metrics"]["models"]["bert_base"]
        log(f"request latency p50 {ring['total_ms']['p50']} ms, p99 "
            f"{ring['total_ms']['p99']} ms over {ring['requests']} samples "
            f"(device p50 {ring['device_ms']['p50']} ms)")
        instances = next(b for p, b, _ in run["answers"] if "instances" in b)["instances"]
        parity = phase_parity(engine, instances)
        check(parity["dense_modules"] == per_fwd, f"{parity['dense_modules']} Int8Dense")
        if profile:
            phase_profile(engine, instances[:1])
            phase_profile(engine, instances)
    finally:
        engine.shutdown()
    return launches


def run_sd(profile: bool) -> int:
    """The SD-1.5 path, its checks and parity; returns flash_attention's
    launches."""
    t0 = time.perf_counter()
    run = phase_sd_path(sd_config())
    engine = run["engine"]
    try:
        images = check_sd(run)
        counts = run["counts"]
        launches, calls = counts["flash_attention"], counts["unet_calls"]
        check(calls > 0 and launches > 0, f"the SD path ran no UNet or no kernel: {counts}")
        check(launches == 10 * calls,
              f"flash_attention launches {launches} != 10 x {calls} UNet calls")
        check(counts["int8_matmul"] == 0, f"int8_matmul launched on the SD path: {counts}")
        log(f"sd path: {calls} UNet calls (4 warm-up, 20 per job), flash_attention launched "
            f"{launches} times; path in {time.perf_counter() - t0:.3f} s")
        parity = phase_sd_parity(engine, SD_JOBS[0], images[0])
        if profile:
            phase_sd_profile(engine, SD_JOBS[0])
    finally:
        engine.shutdown()
    seconds = [job["seconds"] for job in run["jobs"]]
    log(f"sd job seconds (started → finished, 512x512, 20 steps): {seconds}; "
        f"{parity['ms_per_step']:.3f} ms per denoise step")
    return launches


# -- phase 8: the GPT-2 path -----------------------------------------------------

GPT2 = {"seq": 64, "batch_buckets": (1, 8), "max_new_tokens": 32}
GPT2_WORDS = ("the quick brown fox jumps over the lazy dog while a server answers "
              "every request it is sent").split()
GPT2_SAMPLED = {"text": "a sampled continuation of this prompt", "temperature": 0.8,
                "top_k": 40, "top_p": 0.95, "seed": 7}
# Served int8 logits, kernel vs plain route, relative max error (max|Δ| /
# max|want|): each projection's bf16 output may round one ulp apart (2^-8
# relative), and twelve layers carry that on.
GPT2_LOGIT_RTOL = 2e-2


def gpt2_config(arch: dict | None = None, seq: int = GPT2["seq"],
                batch_buckets=GPT2["batch_buckets"],
                max_new_tokens: int = GPT2["max_new_tokens"], **extra):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    extra = {"params_dtype": "int8", "max_new_tokens": max_new_tokens,
             **({"arch": arch} if arch else {}), **extra}
    return ServeConfig(models=[ModelConfig(
        name="gpt2", dtype="bfloat16", seq_buckets=(seq,),
        batch_buckets=tuple(batch_buckets), extra=extra)])


def gpt2_instances(n: int = 8) -> list[dict]:
    """``n`` prompts of ragged lengths (3 to 3 + n - 1 words)."""
    return [{"text": " ".join(GPT2_WORDS[: 3 + i])} for i in range(n)]


def phase_gpt2_path(cfg, device: str = "cuda") -> dict:
    """Build the GPT-2 engine, serve, and answer ``:predict`` requests (text,
    input_ids, 8 ragged instances, one sampled request twice), then the GETs;
    returns the engine, the counts, the generate calls run and the answers."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"gpt2 engine ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}, first dispatch per bucket {engine.clock.entries}")
    path = "/v1/models/gpt2:predict"
    requests = [{"text": "the port serves text generation on the card"},
                {"input_ids": list(range(100, 140))},
                {"instances": gpt2_instances()}, GPT2_SAMPLED, GPT2_SAMPLED]
    answers, gets = [], {}
    with BackgroundServer(cfg, engine) as srv:
        log(f"serving on 127.0.0.1:{srv.port}")
        for body in requests:
            status, out = http(srv.port, path, body)
            check(status == 200, f"{path}: status {status}: {out}")
            answers.append((body, out))
        counts = read_counts()  # just after the path
        for get in ("/healthz", "/v1/models", "/metrics"):
            status, out = http(srv.port, get)
            check(status == 200, f"{get}: status {status}: {out}")
            gets[get] = out
    st = engine.runner.stats["gpt2"]
    calls = len(engine.clock.entries) + st.batches
    return {"engine": engine, "counts": counts, "generate_calls": calls,
            "batches": st.batches, "answers": answers, "gets": gets}


def check_gpt2(run: dict, vocab: int = 50257, max_new: int = GPT2["max_new_tokens"]) -> None:
    for body, out in run["answers"]:
        check(out.get("model") == "gpt2" and {"timing", "predictions"} <= set(out),
              f"gpt2 response keys {sorted(out)}")
        preds = out["predictions"] if "instances" in body else [out["predictions"]]
        check(len(preds) == len(body.get("instances", [body])), f"{len(preds)} predictions")
        for pred in preds:
            toks = pred["tokens"]
            check(isinstance(toks, list) and len(toks) <= max_new
                  and all(isinstance(t, int) and 0 <= t < vocab for t in toks),
                  f"gpt2 tokens {toks}")
        log(f"gpt2 :predict {json.dumps(body)[:60]}...: 200, {[len(p['tokens']) for p in preds]} "
            f"tokens, timing {out['timing']}")
    (_, first), (_, second) = run["answers"][-2:]
    check(first["predictions"] == second["predictions"],
          f"the sampled request answered twice differently: {first['predictions']} vs "
          f"{second['predictions']}")
    log(f"gpt2 sampled request (T=0.8, top_k=40, top_p=0.95, seed=7) twice: the same "
        f"{len(first['predictions']['tokens'])} tokens")
    check(run["gets"]["/healthz"]["device_ok"] is True, f"/healthz: {run['gets']['/healthz']}")
    check("gpt2" in run["gets"]["/v1/models"]["models"], "/v1/models misses gpt2")
    ring = run["gets"]["/metrics"]["models"]["gpt2"]
    log(f"gpt2 request latency p50 {ring['total_ms']['p50']} ms, p99 {ring['total_ms']['p99']} "
        f"ms over {ring['requests']} samples (device p50 {ring['device_ms']['p50']} ms)")


def phase_gpt2_parity(engine, instances: list[dict], steps: int = 4) -> dict:
    """Prefill logits and ``steps`` teacher-forced decode-step logits of the
    served int8 model, its products through the kernel, against the same
    model with ``int8_matmul`` routed to its plain version, on the card, on
    one collated batch of ragged prompts (both fed the kernel route's
    greedy tokens)."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    cm = engine.model("gpt2")
    samples = [cm.servable.preprocess(p) for p in instances]
    bucket = cm.bucket_for(len(samples), max(cm.servable.meta["seq_len_of"](s) for s in samples))
    batch = cm.servable.meta["collate"](samples, bucket, cm.servable.input_spec(bucket))
    cfg = cm.servable.meta["config"]
    fed: list = []  # the tokens both routes are fed: the kernel route's greedy picks

    def logits_chain(matmul):
        G.int8_mm = matmul
        try:
            with torch.inference_mode():
                tree, x = cm.servable.module.tree(), cm._place(batch)
                total = bucket[1] + steps
                out = []
                logits, ck, cv = G.prefill(tree, x["input_ids"], x["length"], total, cfg)
                out.append(logits)
                pos = x["length"].clone()
                for t in range(steps):
                    if t == len(fed):
                        fed.append(logits.argmax(-1).to(torch.int32))
                    tok = fed[t]
                    logits = G.decode_step(tree, ck, cv, tok, pos, cfg)
                    out.append(logits)
                    pos = pos + 1
                return [o[: len(samples)].cpu() for o in out]
        finally:
            G.int8_mm = I.int8_matmul

    run = engine.runner.run_fn_sync
    got = run(logits_chain, I.int8_matmul)
    want = run(logits_chain, I.int8_matmul_reference)
    errs = []
    for t, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape == (len(samples), cfg.vocab_size), f"logits {g.shape}")
        check(bool(torch.isfinite(g).all()), f"step {t}: logits not finite")
        errs.append(((g - w).abs().max() / w.abs().max()).item())
    worst = max(errs)
    check(worst <= GPT2_LOGIT_RTOL, f"gpt2 kernel vs plain logits: rel max err {errs}")
    log(f"gpt2 parity: prefill + {steps} teacher-forced steps on bucket {bucket}, kernel vs "
        f"plain int8_matmul: rel max err per step {[round(e, 6) for e in errs]} "
        f"(<= {GPT2_LOGIT_RTOL})")
    return {"logit_rel_err": worst}


def phase_gpt2_profile(engine, instances: list[dict], top: int = 10) -> None:
    """``torch.profiler`` over one served generate call (prefill + 32 decode
    steps) of a collated batch, on the dispatch thread: device time by
    kernel name and the device's idle share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cm = engine.model("gpt2")
    samples = [cm.servable.preprocess(p) for p in instances]
    bucket = cm.bucket_for(len(samples), max(cm.servable.meta["seq_len_of"](s) for s in samples))
    batch = cm.servable.meta["collate"](samples, bucket, cm.servable.input_spec(bucket))

    def window():
        cm.forward(batch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cm.forward(batch)  # ends in the device-to-host copy of the tokens
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    prof, wall_ms = engine.runner.run_fn_sync(window)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in rows)
    steps = 1 + GPT2["max_new_tokens"]
    log(f"profile gpt2: one generate call at bucket {bucket} ({steps} position steps): wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for name, count, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        log(f"profile gpt2: {ms / steps:9.4f} ms/step {100 * ms / busy_ms:5.1f}% "
            f"x{count / steps:<6.4g} {name[:90]}")


def run_gpt2(profile: bool) -> int:
    """The GPT-2 path, its checks and parity; returns int8_matmul's launches."""
    run = phase_gpt2_path(gpt2_config())
    engine = run["engine"]
    try:
        check_gpt2(run)
        counts = run["counts"]
        # Per forward position step: 4 projections x 12 layers + the lm head;
        # one generate call is a prefill and max_new_tokens decode steps.
        per_call = (4 * 12 + 1) * (1 + GPT2["max_new_tokens"])
        launches = counts["int8_matmul"]
        check(launches > 0, "int8_matmul was not launched on the GPT-2 path")
        check(launches == per_call * run["generate_calls"],
              f"int8_matmul launches {launches} != {per_call} x {run['generate_calls']} "
              f"generate calls")
        check(all(counts[fn] == 0 for fn in FUSED_ENTRY_POINTS),
              f"the fused decode kernels ran on the serving path: {counts}")
        log(f"gpt2 path: {run['generate_calls']} generate calls "
            f"({len(engine.clock.entries)} warm-up, {run['batches']} served batches), "
            f"int8_matmul launched {launches} times ({per_call} per call)")
        phase_gpt2_parity(engine, gpt2_instances())
        if profile:
            phase_gpt2_profile(engine, gpt2_instances())
    finally:
        engine.shutdown()
    return launches


# -- phase 9: the fused decode loop ------------------------------------------------

FUSED_STEPS = 32
# Fused kernel vs plain version, per element |y - want| <= atol + rtol·|want|:
# rtol = 2^-7 is one bf16 rounding of the output (the two sides round nearly
# equal f32 sums and may land one ulp apart at the bottom of a binade); atol
# covers outputs near 0, where an intermediate (h, qkv, ctx, h1) rounded to
# bf16 the other way moves the f32 sum by ~1e-4 at these widths.  The planted
# fault reads 7x to 34x this limit at GPT-2 small.
FUSED_TOL = (1e-3, 2 ** -7)


def device_ms(fn, reps: int = 15) -> float:
    """Median device time of ``fn``'s launches by CUDA events: a spin kernel
    holds the stream while the host queues them, so the host's time per
    launch (Python checks, ctypes) leaves no gaps between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(3 * host_s * 2e9) + 2_000_000  # ~3x the host's time at ~2 GHz
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def attn_bytes(S: int, D: int, T: int, wbytes: int) -> int:
    """Bytes an attention launch must move: its weights, both caches read
    once, x read and x_out written, the K/V rows written, norms, biases,
    scales (int8), the mask and pos."""
    scales = 4 * 4 * D if wbytes == 1 else 0
    return (wbytes * 4 * D * D + 2 * T * S * D * 2 + 2 * S * D * 2 + 2 * S * D * 2
            + 4 * 6 * D + scales + 4 * T * S + 4 * S)


def mlp_bytes(S: int, D: int, F: int, wbytes: int) -> int:
    scales = 4 * (F + D) if wbytes == 1 else 0
    return wbytes * 2 * D * F + 2 * S * D * 2 + 4 * (3 * D + F) + scales


def fused_bound(kind: str, S: int, D: int, T: int, F: int, wbytes: int) -> dict:
    """Least time of one launch: the bytes at the memory rate against the
    products (and, for attention, the scores and P·V) at the bf16 peak."""
    if kind == "attn":
        nbytes, ops = attn_bytes(S, D, T, wbytes), 2 * S * 4 * D * D + 4 * S * T * D
    else:
        nbytes, ops = mlp_bytes(S, D, F, wbytes), 2 * S * 2 * D * F
    b_ms, o_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * ops / PEAK_BF16_FLOPS
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": nbytes}


def layer_calls(p: dict, cks, cvs, pos, mask, cfg, int8: bool, plain: bool):
    """(attention, mlp) callables of each layer: the kernel wrappers, or their
    plain versions on the same operands."""
    from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as FD

    out = []
    for i in range(cfg.layers):
        lp = p[f"layer{i}"]
        ln1, ln2, qkv, o, fc1, fc2 = (lp[n] for n in ("ln1", "ln2", "qkv", "out", "fc1", "fc2"))
        kw = {"eps": cfg.ln_eps}
        if int8:
            wq, wo, w1, w2 = qkv["kernel_q"], o["kernel_q"], fc1["kernel_q"], fc2["kernel_q"]
            sc = {"sqkv": qkv["scale"], "sout": o["scale"]}
            sm = {"s1": fc1["scale"], "s2": fc2["scale"]}
        else:
            wq, wo, w1, w2 = qkv["kernel"], o["kernel"], fc1["kernel"], fc2["kernel"]
            sc, sm = {}, {}

        def attn(x, ck=cks[i], cv=cvs[i], ln1=ln1, qkv=qkv, o=o, wq=wq, wo=wo, sc=sc,
                 mask=mask):
            if plain:
                return FD.fused_attn_step_reference(
                    x, ln1["scale"], ln1["bias"], wq, qkv["bias"], wo, o["bias"], ck, cv, pos,
                    mask, heads=cfg.heads, **kw, **sc)
            if int8:
                return FD.fused_attn_step_int8(
                    x, ln1["scale"], ln1["bias"], wq, qkv["bias"], sc["sqkv"], wo, o["bias"],
                    sc["sout"], ck, cv, pos, mask, heads=cfg.heads, **kw)
            return FD.fused_attn_step(x, ln1["scale"], ln1["bias"], wq, qkv["bias"], wo,
                                      o["bias"], ck, cv, pos, mask, heads=cfg.heads, **kw)

        def mlp(x, ln2=ln2, fc1=fc1, fc2=fc2, w1=w1, w2=w2, sm=sm):
            if plain:
                return FD.fused_mlp_step_reference(x, ln2["scale"], ln2["bias"], w1,
                                                   fc1["bias"], w2, fc2["bias"], **kw, **sm)
            if int8:
                return FD.fused_mlp_step_int8(x, ln2["scale"], ln2["bias"], w1, fc1["bias"],
                                              sm["s1"], w2, fc2["bias"], sm["s2"], **kw)
            return FD.fused_mlp_step(x, ln2["scale"], ln2["bias"], w1, fc1["bias"], w2,
                                     fc2["bias"], **kw)

        out.append((attn, mlp))
    return out


def phase_fused_kernels(lane, cfg, int8: bool) -> dict:
    """Each layer's two kernels of one step against their plain versions on
    the same operands (caches cloned, so the lane's stay as they are), per
    element within ``FUSED_TOL``; the planted fault (the plain version with
    key pos[s] itself masked) must read > 5x the limit; per-launch times of
    the kernels and the plain versions over all twelve layers."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    atol, rtol = FUSED_TOL
    tag = "int8" if int8 else "bf16"
    with torch.inference_mode():
        pos = lane.pos.to(torch.int32)
        mask = BF.mask_bias(pos, BF.T)
        bad_mask = mask.clone()
        bad_mask[pos.long(), torch.arange(BF.S, device=pos.device)] = -1e9
        x = G._embed(lane.params, lane.tok, pos, cfg, BF.DTYPE).contiguous()
        ck = [c.clone() for c in lane.ck]
        cv = [c.clone() for c in lane.cv]
        kern = layer_calls(lane.params, ck, cv, pos, mask, cfg, int8, plain=False)
        shares, faults, max_err = [], [], 0.0
        for i, (attn, mlp) in enumerate(kern):
            ck_p, cv_p = ck[i].clone(), cv[i].clone()
            plain = layer_calls(lane.params, [ck_p] * cfg.layers, [cv_p] * cfg.layers, pos,
                                mask, cfg, int8, plain=True)[i]
            y, _, _ = attn(x)
            want, _, _ = plain[0](x)
            rows = (pos.long(), torch.arange(BF.S, device=pos.device))
            for got_c, want_c in ((ck[i], ck_p), (cv[i], cv_p)):
                row_share = tol_share(got_c[rows], want_c[rows], 1e-6, rtol)
                check(row_share <= 1, f"fused_attn_step {tag} layer {i}: the K/V rows "
                                      f"written at pos are {row_share:.3g} x the tolerance")
            fault = layer_calls(lane.params, [ck_p.clone()] * cfg.layers,
                                [cv_p.clone()] * cfg.layers, pos, bad_mask, cfg, int8,
                                plain=True)[i][0](x)[0]
            faults.append(tol_share(y, fault, atol, rtol))
            x2 = mlp(y)
            want2 = plain[1](y)
            for name, g, w in (("fused_attn_step", y, want), ("fused_mlp_step", x2, want2)):
                check(bool(torch.isfinite(g.float()).all()), f"{name} {tag} layer {i}: "
                                                              f"non-finite output")
                share = tol_share(g, w, atol, rtol)
                check(share <= 1, f"{name} {tag} layer {i}: {share:.3g} x the tolerance "
                                  f"(atol={atol}, rtol={rtol:.4g})")
                shares.append(share)
                max_err = max(max_err, (g.float() - w.float()).abs().max().item())
            x = x2
        sync(x.device)
        # Rejected at every layer, by more than 5x the limit.
        check(min(faults) > 5,
              f"fused_attn_step {tag}: the planted fault (key pos[s] masked) reads only "
              f"{min(faults):.3g} to {max(faults):.3g} x the tolerance")
        log(f"fused kernels {tag}, {cfg.layers} layers x (attention, mlp) of one step vs plain: "
            f"max |err| {max_err:.3g}, largest share {max(shares):.3f} of the tolerance "
            f"(atol={atol}, rtol={rtol:.4g}); planted fault (key pos[s] masked) reads "
            f"{min(faults):.3g} to {max(faults):.3g} x the tolerance: rejected")

        # Per launch over all twelve layers: ~85 MB (attention) and ~113 MB
        # (mlp) of bf16 weights and caches per pass stream from HBM, where one
        # layer's few MB would sit in the 50 MB L2 between repeats.
        x0 = G._embed(lane.params, lane.tok, pos, cfg, BF.DTYPE).contiguous()
        plain_calls = layer_calls(lane.params, ck, cv, pos, mask, cfg, int8, plain=True)

        def sweep(calls, which):
            def fn():
                for c in calls:
                    c[which](x0)
            return fn

        timing = {}
        for kind, which in (("attn", 0), ("mlp", 1)):
            row = {"ms": device_ms(sweep(kern, which)) / cfg.layers,
                   "plain_ms": device_ms(sweep(plain_calls, which), reps=5) / cfg.layers,
                   **fused_bound(kind, BF.S, cfg.d_model, BF.T, cfg.ffn_dim, 1 if int8 else 2)}
            timing[kind] = row
            log(f"time fused_{kind}_step {tag} [S={BF.S}, D={cfg.d_model}, T={BF.T}]: kernel "
                f"{row['ms']:.5f} ms per launch, plain {row['plain_ms']:.5f} ms, bound "
                f"{row['bound_ms']:.5f} ms ({row['bytes'] / 1e6:.2f} MB, {row['bound_by']}); "
                f"device time over the 12 layers' launches, queued behind a spin kernel")
    return {"max_abs_err": max_err, "timing": timing, "fault_min": min(faults)}


def teacher_forced(lane, ref_ck, ref_cv, cfg, int8: bool, steps: int) -> dict:
    """``steps`` steps of the fused lane, each held against the unfused
    serving step (``models.gpt2.decode_step``) on the same weights and its
    own serving caches; both are fed the unfused step's greedy token.  The
    fused lane's tokens must agree wherever the reference's top-2 margin
    exceeds twice the step's logit error."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    fn = BF.fused_step_int8 if int8 else BF.fused_step
    errs, agree, decided = [], 0, 0
    tok, pos = lane.tok, lane.pos
    with torch.inference_mode():
        for _ in range(steps):
            nxt, got = fn(lane.params, lane.ck, lane.cv, tok, pos, cfg)
            want = G.decode_step(lane.params, ref_ck, ref_cv, tok, pos, cfg, BF.DTYPE)
            check(bool(torch.isfinite(got).all()), "fused step logits not finite")
            err = (got - want).abs().max().item()
            top2 = want.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            sure = margin > 2 * err
            same = nxt == want.argmax(-1).to(torch.int32)
            check(bool(same[sure].all()), f"fused step tokens differ where the margin "
                                          f"exceeds 2 x {err:.3g}: {nxt} vs {want.argmax(-1)}")
            errs.append(err / want.abs().max().item())
            agree += int(same.sum())
            decided += int(sure.sum())
            tok, pos = want.argmax(-1).to(torch.int32), (pos + 1).clamp(max=BF.T - 1)
    lane.tok, lane.pos = tok, pos
    return {"rel_err": max(errs), "agree": agree, "decided": decided, "rows": steps * BF.S}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_fused(profile: bool, cfg=None, device: str = "cuda") -> dict:
    """The fused decode loop at the bench's shapes (S = 8 rows, prompts of 32
    to 64 tokens through the port's prefill, cache T = 96) on GPT-2 small
    (``cfg`` narrows it for a rehearsal): the kernels against their plain
    versions, then 32 teacher-forced steps per fused lane held against the
    unfused step, then ms per step of the three lanes."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    cfg = cfg or G.SMALL
    t0 = time.perf_counter()
    lanes = BF.build_lanes(cfg, device)
    log(f"fused decode: three lanes built and prefilled in {time.perf_counter() - t0:.3f} s "
        f"(S={BF.S}, prompts {BF.prompts(cfg)[1].tolist()}, T={BF.T})")
    kern = {name: phase_fused_kernels(lanes[name], cfg, name == "fused_int8")
            for name in ("fused", "fused_int8")}
    # The unfused reference's serving caches: the same prefill, [L, S, T, D].
    refs = {}
    with torch.inference_mode():
        for name in ("fused", "fused_int8"):
            toks, lengths = (torch.from_numpy(a).to(device) for a in BF.prompts(cfg))
            _, ck, cv = G.prefill(lanes[name].params, toks, lengths, BF.T, cfg, BF.DTYPE)
            refs[name] = (ck, cv)
    sync(device)
    reset_counts()
    tf = {name: teacher_forced(lanes[name], *refs[name], cfg, name == "fused_int8",
                               FUSED_STEPS) for name in ("fused", "fused_int8")}
    sync(device)
    counts = read_counts()  # just after the path
    # Each lane takes FUSED_STEPS steps: the bf16 entry points run on "fused",
    # the int8 ones on "fused_int8", 12 launches of each kernel a step.
    check(all(counts[fn] == cfg.layers * FUSED_STEPS for fn in FUSED_ENTRY_POINTS),
          f"fused launches {counts} != {cfg.layers} x {FUSED_STEPS} steps of each lane")
    for name, r in tf.items():
        log(f"fused decode {name}: {FUSED_STEPS} teacher-forced steps vs the unfused step: "
            f"logit rel max err {r['rel_err']:.4g}; tokens agree on {r['agree']} of "
            f"{r['rows']} rows, on all {r['decided']} whose top-2 margin exceeds 2 x the error")
    log("fused decode: launches " + ", ".join(f"{fn} {counts[fn]}" for fn in FUSED_ENTRY_POINTS)
        + f" ({cfg.layers} of each kernel per step, {FUSED_STEPS} steps a lane)")
    ms = {name: BF.time_lane(lane, cfg) for name, lane in lanes.items()}
    log(f"decode step, ms per step (S={BF.S}, T={BF.T}, CUDA events over 60 steps): "
        + ", ".join(f"{n} {v:.4f}" for n, v in ms.items()))
    lm = {"fused": 2 * cfg.vocab_size * cfg.d_model, "fused_int8": cfg.vocab_size * cfg.d_model}
    for name in ("fused", "fused_int8"):
        t = kern[name]["timing"]
        bound = cfg.layers * (t["attn"]["bound_ms"] + t["mlp"]["bound_ms"]) \
            + 1e3 * lm[name] / PEAK_BYTES_PER_S
        log(f"decode step {name}: {ms[name]:.4f} ms against a bound of {bound:.4f} ms "
            f"(24 launches + the lm head's weights)")
    if profile:
        for name, lane in lanes.items():
            prof = BF.profile_lane(lane, cfg)
            log(f"profile {name}: wall {prof['wall_ms_per_step']:.4f} ms/step, device busy "
                f"{prof['busy_ms_per_step']:.4f} ms/step, idle share {prof['idle_share']:.3f}")
            for kname, count, kms in prof["top"]:
                log(f"profile {name}: {kms:9.4f} ms/step x{count:<5g} {kname}")
        # Where one launch of each fused kernel spends its time: %globaltimer
        # stamps at the phase boundaries of every block (a stamped build).
        from pytorch_zappa_serverless_tpu_torch.tools import fused_ablation as FAB

        check(FAB.main(["--variants", "", "--stamp-reps", "3"]) == 0, "fused phase stamps failed")
    return {"counts": counts, "kernels": kern, "ms": ms, "teacher_forced": tf}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="also profile served BERT forwards at both buckets, one SD-1.5 "
                         "denoise chunk, one served GPT-2 generate call and the three "
                         "GPT-2 decode lanes (torch.profiler), and stamp the fused "
                         "kernels' phases")
    args = ap.parse_args(argv)
    phase_device()
    phase_build()
    kern = phase_kernels()
    flash = phase_flash()
    int8_launches = run_bert(args.profile)
    flash_launches = run_sd(args.profile)
    gpt2_launches = run_gpt2(args.profile)
    fused = run_fused(args.profile)
    for m in MAIN_M:
        fwd = per_forward(kern["timings"], m)
        log(f"one forward's int8_matmul at M={m} (72 launches, the per-shape times summed): "
            f"kernel {fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, cuBLAS "
            f"{fwd['library_ms']:.4f} ms ({fwd['ms'] / fwd['library_ms']:.3f} x), bound "
            f"{fwd['bound_ms']:.5f} ms ({fwd['bound_by']})")
    fwd = per_forward(kern["timings"], 1024)
    bert, step = kern["work"]["bert_fwd"], kern["work"]["gpt2_step"]
    unet = per_unet_call(flash["timings"])
    log(f"one UNet call's flash_attention at 512x512 (10 launches): kernel {unet['ms']:.4f} "
        f"ms, plain {unet['plain_ms']:.4f} ms, SDPA {unet['library_ms']:.4f} ms "
        f"({unet['ms'] / unet['library_ms']:.3f} x), bound {unet['bound_ms']:.5f} ms "
        f"({unet['bound_detail']}; {unet['bound_ms'] / unet['ms']:.3f} of the kernel's time)")
    kernels = [{
        "name": "int8_matmul", "route": "cuda",
        "source": "pytorch_zappa_serverless_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "pytorch_zappa_serverless_tpu/ops/int8_matmul.py:107",
        "launches": int8_launches, "max_abs_err": kern["max_abs_err"],
        "ms": bert["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": bert["bound_ms"],
        "bound_by": bert["bound_by"], "library_ms": bert["library_ms"],
        "timed_work": "one BERT-base forward at bucket (8,128): 72 launches at M=1024 over "
                      "12 layers' distinct weights, bf16 (plain: the per-shape times summed)",
        "per_shape_sum": {k: fwd[k] for k in ("ms", "library_ms", "bound_ms")},
        "gpt2_step": {**{k: step[k] for k in ("ms", "library_ms", "bound_ms", "bound_by")},
                      "lm_head_ms": kern["timings"][(8, *GPT2_HEAD)]["ms"],
                      "timed_work": "one GPT-2 small position step at M=8: 48 layer "
                                    "projections + the f32 lm head [768, 50304] over 123.6 MB "
                                    "of distinct int8 weights"},
        "launches_gpt2_path": gpt2_launches,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "pytorch_zappa_serverless_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "pytorch_zappa_serverless_tpu/ops/flash_attention.py:57",
        "launches": flash_launches, "max_abs_err": flash["max_abs_err"],
        "ms": unet["ms"], "plain_ms": unet["plain_ms"], "bound_ms": unet["bound_ms"],
        "bound_by": unet["bound_by"], "library_ms": unet["library_ms"],
        "bound_detail": unet["bound_detail"],
        "timed_work": "one SD-1.5 UNet call at 512x512: 5 launches at [2,4096,8,40] "
                      "+ 5 at [2,1024,8,80], bf16",
    }]
    for name, kind, lane, line in (("fused_attn_step", "attn", "fused", 86),
                                   ("fused_attn_step_int8", "attn", "fused_int8", 97),
                                   ("fused_mlp_step", "mlp", "fused", 216),
                                   ("fused_mlp_step_int8", "mlp", "fused_int8", 222)):
        row = fused["kernels"][lane]["timing"][kind]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pytorch_zappa_serverless_tpu_torch/ops/csrc/fused_decode.cu",
            "replaces": f"pytorch_zappa_serverless_tpu/ops/fused_decode.py:{line}",
            "launches": fused["counts"][name],
            "max_abs_err": fused["kernels"][lane]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "unfused_step_ms": fused["ms"]["seg1"],
            "timed_work": "one launch at GPT-2 small [S=8, D=768, T=96, F=3072], "
                          + ("int8 (W8A16)" if lane == "fused_int8" else "bf16")
                          + " weights, the mean over all 12 layers",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
