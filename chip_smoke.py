"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the port's hand-written kernels from ``ops/csrc/``, one
   ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (and the edge cases each must take), with
   per-shape times (CUDA events); at flash's 4096-token shape, a planted
   fault (the scale of the padded head dim) the tolerance must reject;
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
   through the same chunked route with the plain version.

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
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    def build(name, fn):
        t0 = time.perf_counter()
        fn()
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(build, "int8_matmul.cu", I._kernel_lib),
                pool.submit(build, "flash_attention.cu", FA._kernel_lib)]
        for f in futs:
            name, secs = f.result()
            log(f"build {name}: {secs:.3f} s")
    log(f"build, both kernels in parallel: {time.perf_counter() - t0:.3f} s")


# -- phase 3: kernels against their plain versions ---------------------------

def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after a warm-up.  The operands stay in L2 between calls."""
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


def matmul_bound(m: int, k: int, n: int, x_dtype, out_dtype) -> tuple[float, float]:
    """(operations ms, bytes ms) of the W8A16 product: 2·M·K·N operations at
    the peak rate of the input type (bf16 tensor cores, or f32 CUDA cores),
    and each input read once and the output written once at the memory
    rate.  The least time the card could take is the larger of the two."""
    xb = torch.empty(0, dtype=x_dtype).element_size()
    ob = torch.empty(0, dtype=out_dtype).element_size()
    nbytes = m * k * xb + k * n + 4 * n + m * n * ob
    peak = PEAK_BF16_FLOPS if x_dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return 1e3 * 2 * m * k * n / peak, 1e3 * nbytes / PEAK_BYTES_PER_S


def phase_kernels() -> dict:
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    max_err, timings = 0.0, {}
    shapes = [(m, k, n) for m in MAIN_M for k, n in sorted(set(LAYER_PROJECTIONS))]
    for m, k, n in shapes + RAGGED:
        x32 = torch.randn(m, k, device=dev, generator=g) * 0.5
        w_q = torch.randint(-127, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
        scale = torch.rand(n, device=dev, generator=g) * 2e-3 + 1e-4
        for x_dtype, out_dtype in DTYPES:
            x = x32.to(x_dtype)
            y = I.int8_matmul(x, w_q, scale, out_dtype=out_dtype)
            torch.cuda.synchronize()
            want = I.int8_matmul_reference(x, w_q, scale, out_dtype)
            check(y.shape == want.shape and y.dtype == want.dtype,
                  f"int8_matmul {m}x{k}x{n}: {y.shape} {y.dtype} vs {want.shape} {want.dtype}")
            check(bool(torch.isfinite(y).all()), f"int8_matmul {m}x{k}x{n}: non-finite output")
            err = (y.float() - want.float()).abs().max().item()
            if out_dtype == torch.bfloat16:
                ok = torch.allclose(y.float(), want.float(), rtol=2e-2, atol=2e-2)
                tol = "rtol=atol=2e-2"
            else:
                atol = 1e-3 * want.abs().max().item()
                ok, tol = err <= atol, f"atol={atol:.3g}"
            check(ok, f"int8_matmul {m}x{k}x{n} {x_dtype}->{out_dtype}: "
                      f"max |err| {err} outside {tol}")
            max_err = max(max_err, err)
            log(f"int8_matmul {m}x{k}x{n} {str(x_dtype)[6:]}->{str(out_dtype)[6:]}: "
                f"max |err| {err:.3g} ({tol}) ok")
            if (m, k, n) not in shapes or (x_dtype, out_dtype) != DTYPES[0]:
                continue
            # The main path's dtypes: bf16 in, bf16 out.
            w_deq = (w_q.float() * scale).to(torch.bfloat16)
            row = {"ms": time_ms(lambda: I.int8_matmul(x, w_q, scale)),
                   "plain_ms": time_ms(lambda: I.int8_matmul_reference(x, w_q, scale)),
                   "library_ms": time_ms(lambda: torch.matmul(x, w_deq))}
            row["ops_ms"], row["bytes_ms"] = matmul_bound(m, k, n, x_dtype, out_dtype)
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
            timings[m, k, n] = row
            log(f"time int8_matmul M={m} K={k} N={n}: kernel {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, cuBLAS bf16 on dequantised weights "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
                f"({row['bound_by']})")
    return {"max_abs_err": max_err, "timings": timings}


def per_forward(timings: dict, m: int) -> dict:
    """One forward's worth of int8_matmul at row count ``m``: the layer's six
    projections times the number of layers.  The bound is the sum of the
    launches' bounds; it names what bounds most of it."""
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
               (2, 1000, 1000, 4, 80, torch.float32, False, True)]     # f32, ragged


# Kernel vs plain version, per element |y - want| <= atol + rtol·|want|.
# bf16: rtol = 2^-6 is two bf16 roundings at the bottom of a binade (each
# side rounds its f32 output once); atol = 2e-3 covers outputs near 0, where
# P rounded to bf16 against a running rather than the final max is what
# differs.  At [2,4096,8,40] the outputs' typical |y| is ~0.02, so the limit
# there is ~2.3e-3, and a kernel that took sm_scale from the padded D
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


def phase_flash() -> dict:
    """flash_attention against flash_attention_reference on the card, within
    ``FLASH_TOL``; at [2,4096,8,40] also a planted fault (sm_scale from the
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
        row = {"ms": time_ms(lambda: FA.flash_attention(q, k, v)),
               "plain_ms": time_ms(lambda: FA.flash_attention_reference(q, k, v), reps=5),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               **flash_bound(b, tq, h, d)}
        timings[b, tq, h, d] = row
        log(f"time flash_attention [{b},{tq},{h},{d}] bf16: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_detail']})")
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

def reset_counts() -> None:
    """Every kernel count (and the UNet calls) to 0: just before a path."""
    from pytorch_zappa_serverless_tpu_torch.models.sd_unet import unet_apply
    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    I.int8_matmul.launches = FA.flash_attention.launches = unet_apply.calls = 0


def read_counts() -> dict:
    from pytorch_zappa_serverless_tpu_torch.models.sd_unet import unet_apply
    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    return {"int8_matmul": I.int8_matmul.launches,
            "flash_attention": FA.flash_attention.launches, "unet_calls": unet_apply.calls}

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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="also profile served BERT forwards at both buckets and one "
                         "SD-1.5 denoise chunk (torch.profiler)")
    args = ap.parse_args(argv)
    phase_device()
    phase_build()
    kern = phase_kernels()
    flash = phase_flash()
    int8_launches = run_bert(args.profile)
    flash_launches = run_sd(args.profile)
    for m in MAIN_M:
        fwd = per_forward(kern["timings"], m)
        log(f"one forward's int8_matmul at M={m} (72 launches): kernel {fwd['ms']:.4f} ms, "
            f"plain {fwd['plain_ms']:.4f} ms, cuBLAS {fwd['library_ms']:.4f} ms, "
            f"bound {fwd['bound_ms']:.5f} ms ({fwd['bound_by']})")
    fwd = per_forward(kern["timings"], 1024)
    unet = per_unet_call(flash["timings"])
    log(f"one UNet call's flash_attention at 512x512 (10 launches): kernel {unet['ms']:.4f} "
        f"ms, plain {unet['plain_ms']:.4f} ms, SDPA {unet['library_ms']:.4f} ms, bound "
        f"{unet['bound_ms']:.5f} ms ({unet['bound_detail']})")
    kernels = [{
        "name": "int8_matmul", "route": "cuda",
        "source": "pytorch_zappa_serverless_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "pytorch_zappa_serverless_tpu/ops/int8_matmul.py:107",
        "launches": int8_launches, "max_abs_err": kern["max_abs_err"],
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
        "timed_work": "one forward at bucket (8,128): 72 launches, M=1024, bf16",
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
