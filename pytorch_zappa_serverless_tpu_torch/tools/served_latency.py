"""Client latency of sequential single requests to an in-process server.

One server holds BERT-base int8 (1, 8) x 128 and ResNet-50 bf16 (1, 8) at
224x224.  A client thread in the server's process sends them single JSON
requests in turn, alternating the models, ``--requests`` each after
``--warmup`` (BERT: 64 token ids; ResNet-50: a 640x480 PNG as the raw
body, decoded and resized on the host).  It prints one JSON line: the
client p50, p90 and mean a model, and the server's own recent ``queue_ms``,
``device_ms`` and ``total_ms`` p50 from ``/metrics``.

It uses only ``config``, ``serving.server.BackgroundServer`` and
``/metrics``, so it runs unchanged on earlier commits of the port: copy it
into another checkout's ``tools/`` and run both, alternating, on one card
to compare two commits::

    python -m pytorch_zappa_serverless_tpu_torch.tools.served_latency --requests 300

Where the port has ``serving.tracing``, it also times the tracer alone: a
BERT request's span tree (root, admission, queue, batch_form, device, exec,
respond) opened, ended and finished into a private tracer's ring, the mean
microseconds a trace (``tracer_us``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import urllib.request

import numpy as np


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def _post(port: int, path: str, body: bytes, ctype: str) -> float:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        r.read()
        if r.status != 200:
            raise RuntimeError(f"{path}: {r.status}")
    return (time.perf_counter() - t) * 1e3


def tracer_us(n: int = 5000) -> float | None:
    """Mean microseconds of one BERT-shaped trace on a private tracer, or
    None where the port has no ``serving.tracing``."""
    try:
        from pytorch_zappa_serverless_tpu_torch.serving.tracing import Tracer
    except ImportError:
        return None
    tracer = Tracer(ring=256)
    t0 = time.perf_counter()
    for _ in range(n):
        root = tracer.start("predict", model="bert_base")
        root.child("admission").end()
        queue = root.child("queue")
        queue.child("batch_form", batch_size=1).end()
        queue.end()
        dev = root.child("device", bucket=[1, 128])
        dev.child("exec", lane="latency", batch=1).end(bucket=[1, 128])
        dev.end()
        root.child("respond").end()
        tracer.finish(root.trace, "ok")
    return (time.perf_counter() - t0) / n * 1e6


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
    from pytorch_zappa_serverless_tpu_torch.models.sd15 import png_bytes
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    cfg = ServeConfig(models=[
        ModelConfig(name="bert_base", dtype="bfloat16", seq_buckets=(128,),
                    batch_buckets=(1, 8), extra={"params_dtype": "int8"}),
        ModelConfig(name="resnet50", dtype="bfloat16", batch_buckets=(1, 8),
                    extra={"image_size": 224, "resize_to": 256})])
    rng = np.random.default_rng(0)
    bert = json.dumps({"input_ids": rng.integers(1, 30521, 64).tolist()}).encode()
    png = png_bytes(rng.integers(0, 256, (480, 640, 3)).astype(np.uint8))
    reqs = {"bert_base": (bert, "application/json"), "resnet50": (png, "image/png")}
    times: dict[str, list[float]] = {m: [] for m in reqs}
    t0 = time.perf_counter()
    with BackgroundServer(cfg, device=args.device) as srv:
        boot_s = time.perf_counter() - t0
        for i in range(args.warmup + args.requests):
            for m, (body, ctype) in reqs.items():
                ms = _post(srv.port, f"/v1/models/{m}:predict", body, ctype)
                if i >= args.warmup:
                    times[m].append(ms)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=60) as r:
            server = json.loads(r.read())["models"]
    out = {"boot_s": round(boot_s, 3), "requests": args.requests, "models": {}}
    for m, xs in times.items():
        snap = server.get(m, {})
        out["models"][m] = {
            "client_p50_ms": round(statistics.median(xs), 4),
            "client_p90_ms": round(_pct(xs, 90), 4),
            "client_mean_ms": round(statistics.fmean(xs), 4),
            **{f"server_{k}_p50": snap.get(k, {}).get("p50")
               for k in ("queue_ms", "device_ms", "total_ms")}}
    us = tracer_us()
    out["tracer_us"] = None if us is None else round(us, 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
