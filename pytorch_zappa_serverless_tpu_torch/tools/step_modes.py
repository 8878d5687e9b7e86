r"""Why one bucket graph's step time comes in two modes.

The bench's step (``benchmark._measure``) is K back-to-back replays of a
bucket's captured graph behind one spin kernel, timed by CUDA events.  On
the H100 the flagship's trials fall in two groups about 13 % apart, and
the p50 of a run lands in either.  This tool builds the flagship's engine
(``benchmark.bench_image_model``'s config, seeded weights at full width),
captures the bucket, and times many trials of the same graph in variants
that each rule a cause in or out:

- ``bench``: the bench's own trial (a spin ~3x the host's queueing time);
- ``long_spin``: the same with a spin ~30x the host's time, so the host
  can never let the queue run dry;
- ``main_thread``: the bench's trial from the main thread, not the
  engine's dispatch thread (the engine's threads idle);
- ``single``: K = 1, one replay a trial;
- ``after_idle_<s>``: the bench's trial again after the card idled ``s``
  seconds (``--idle``).

``--repeat N`` runs the bench's trial N times instead, to see when in a
process's life its slow trials fall; ``--preload S`` keeps the card busy
with bf16 products for S seconds before the engine is built; ``--traced N``
first times N trials each under a ``torch.profiler`` window, to split a
replay into its kernels' busy time and the gaps between them.

With ``--smi PATH`` an ``nvidia-smi`` sampler writes the card's
performance state, SM and memory clocks and power every 100 ms to PATH
while the variants run (each trial row carries ``t``, its seconds since
the process started).

Its findings on one H100 are in PERF.md (the flagship's two modes).  For
each trial it keeps the ms a replay, the SM clock of a spin just
before and just after the work (a spin's cycles over its elapsed time),
the host's queueing ms, and two probes just after it: a 256 MiB device
copy's GB/s (read and write) and the TFLOP/s of products of an
L2-resident bf16 matrix, each a median over the fast and the slow trials.
One JSON line a variant: the trials in order,
and their split at the midpoint of the fastest and slowest::

    python -m pytorch_zappa_serverless_tpu_torch.tools.step_modes [--trials 60] \
        [--idle 5,30] [--smi chiprun_out/smi.csv] [--repeat 4] [--preload 40] \
        [--traced 16]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

_T0 = time.time()
_AFTER_CYCLES = 2_000_000  # ~1 ms at ~2 GHz


def trials(replay, K: int, n: int, spin_factor: float) -> list[dict]:
    """``n`` trials of ``K`` replays behind a spin ``spin_factor`` times the
    host's queueing time of one trial."""
    import torch

    def k_calls():
        for _ in range(K):
            replay()

    k_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_calls()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(spin_factor * host_s * 2e9) + 2_000_000
    # Probes after each trial: a 256 MiB device copy (the memory system)
    # and products of an L2-resident bf16 matrix (the SMs' tensor cores).
    src = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    a = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    out = []
    for _ in range(n):
        es, e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(4))
        es.record()
        torch.cuda._sleep(cycles)
        e0.record()
        h0 = time.perf_counter()
        k_calls()
        h1 = time.perf_counter()
        e1.record()
        torch.cuda._sleep(_AFTER_CYCLES)
        e2.record()
        p0, p1, p2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        p0.record()
        dst.copy_(src)
        p1.record()
        for _ in range(10):
            a @ a
        p2.record()
        p2.synchronize()
        spin_ms = es.elapsed_time(e0)
        out.append({"t": round(time.time() - _T0, 3), "ms": round(e0.elapsed_time(e1) / K, 4),
                    "mhz_before": round(cycles / spin_ms / 1e3, 1),
                    "mhz_after": round(_AFTER_CYCLES / e1.elapsed_time(e2) / 1e3, 1),
                    "host_ms": round((h1 - h0) * 1e3, 3), "spin_ms": round(spin_ms, 3),
                    "copy_gbps": round(2 * src.numel() / p0.elapsed_time(p1) / 1e6, 1),
                    "mm_tflops": round(10 * 2 * 2048 ** 3 / p1.elapsed_time(p2) / 1e9, 1)})
    return out


def traced_trials(replay, K: int, n: int) -> list[dict]:
    """``n`` trials of ``K`` replays, each under its own ``torch.profiler``
    window: the events' ms a replay beside the kernels' busy time (their
    union) and the span from the first kernel's start to the last one's
    end, each a replay; the span less the busy time is the gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    for _ in range(n):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            e0.record()
            for _ in range(K):
                replay()
            e1.record()
            e1.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for a, b in spans:  # the union of the kernels' intervals
            busy += max(b - max(a, end), 0.0)
            end = max(end, b)
        out.append({"t": round(time.time() - _T0, 3), "ms": round(e0.elapsed_time(e1) / K, 4),
                    "kernels": len(spans) // K,
                    "busy_ms": round(busy / 1e3 / K, 4) if spans else None,
                    "span_ms": round((end - spans[0][0]) / 1e3 / K, 4) if spans else None})
    return out


def summary(name: str, rows: list[dict]) -> dict:
    ms = [r["ms"] for r in rows]
    mid = (min(ms) + max(ms)) / 2
    low = [m for m in ms if m <= mid]
    high = [m for m in ms if m > mid]
    return {"variant": name, "trials": len(ms), "p50": round(float(np.median(ms)), 4),
            "min": min(ms), "max": max(ms),
            "low_n": len(low), "low_median": round(float(np.median(low)), 4),
            "high_n": len(high),
            "high_median": round(float(np.median(high)), 4) if high else None,
            **({"mhz_before_range": [min(r["mhz_before"] for r in rows),
                                     max(r["mhz_before"] for r in rows)],
                "mhz_after_range": [min(r["mhz_after"] for r in rows),
                                    max(r["mhz_after"] for r in rows)],
                "host_ms_max": max(r["host_ms"] for r in rows),
                "spin_ms_min": min(r["spin_ms"] for r in rows)}
               if "mhz_before" in rows[0] else {}),
            **{f"{k}_{side}": round(float(np.median([r[k] for r, m in zip(rows, ms)
                                                    if (m <= mid) == (side == "low")])), 4)
               for k in ("copy_gbps", "mm_tflops", "busy_ms", "span_ms")
               for side in ("low", "high") if k in rows[0]
               if any((m <= mid) == (side == "low") for m in ms)},
            "t": [rows[0]["t"], rows[-1]["t"]],
            "order": "".join("L" if m <= mid else "H" for m in ms), "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50, help="K, replays a trial")
    ap.add_argument("--trials", type=int, default=60)
    ap.add_argument("--idle", default="", help="comma list of idle seconds")
    ap.add_argument("--smi", default="", help="where the nvidia-smi sampler writes")
    ap.add_argument("--repeat", type=int, default=0, help="the bench's trial N times only")
    ap.add_argument("--preload", type=float, default=0.0, help="seconds of products first")
    ap.add_argument("--traced", type=int, default=0,
                    help="first, N trials each under a profiler window")
    args = ap.parse_args(argv)
    sampler = smi_log = None
    if args.smi:
        import subprocess

        smi_log = open(args.smi, "w")  # noqa: SIM115 (closed with the sampler)
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,pstate,clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu", "--format=csv", "-lms", "100"],
            stdout=smi_log, stderr=subprocess.DEVNULL)

    from .. import benchmark as B

    if args.preload:
        import torch

        a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.preload:
            for _ in range(20):
                a @ a
            torch.cuda.synchronize()
        del a
    mc = B._model_config(args.model, dtype="bfloat16", batch_buckets=(args.batch,))
    engine, _ = B._engine(mc, "cuda")
    try:
        cm = engine.model(args.model)
        size = cm.servable.input_spec((args.batch,))["image"][0][1]
        batch = B._image_inputs(args.batch, size)
        engine.runner.run_fn_sync(cm.forward, batch)
        replay = cm.bucket_graph(batch).captured.graph.replay
        run = engine.runner.run_fn_sync
        K, n = args.iters, args.trials
        bench = ([("traced", lambda: run(traced_trials, replay, K, args.traced))]
                 if args.traced else [])
        bench += [(f"bench_{i}", lambda: run(trials, replay, K, n, 3))
                  for i in range(args.repeat)]
        variants = bench or [("bench", lambda: run(trials, replay, K, n, 3)),
                    ("long_spin", lambda: run(trials, replay, K, n, 30)),
                    ("main_thread", lambda: trials(replay, K, n, 3)),
                    ("single", lambda: run(trials, replay, 1, n, 3)),
                    ("bench_again", lambda: run(trials, replay, K, n, 3))]
        for idle in (float(x) for x in args.idle.split(",") if x and not bench):
            variants.append((f"after_idle_{idle:g}",
                             lambda idle=idle: (time.sleep(idle), run(trials, replay, K, n, 3))[1]))
        for name, fn in variants:
            print(json.dumps(summary(name, fn())), flush=True)
    finally:
        engine.shutdown()
        if sampler is not None:
            sampler.terminate()
            sampler.wait()
            smi_log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
