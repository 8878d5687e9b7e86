"""The kill -9 harness of the port: an acknowledged ``:submit`` survives a crash.

The port's counterpart of the JAX package's ``tools/crashtest.py``.  Every
``:submit`` a client saw a 202 for must reach ``done`` across a ``kill -9``
and a restart, and a resubmit with the same ``Idempotency-Key`` after the
crash must answer the original job id instead of running the work twice.
Against the real command line::

    python -m pytorch_zappa_serverless_tpu_torch.tools.crashtest \\
        --workdir /tmp/ct --platform cpu

1. boot ``python -m pytorch_zappa_serverless_tpu_torch.cli serve --config
   … --profile boot --platform {cpu|cuda}`` with ``journal_dir``,
   ``journal_fsync: always`` and a ``faults`` latency rule, so that a
   backlog forms;
2. submit N jobs with idempotency keys and wait for a backlog of N/2;
3. ``SIGKILL`` the server (no drain, no cleanup);
4. restart on the same journal (the ``restart`` profile, no fault rule);
5. every acknowledged id must reach ``done``, every resubmit dedupe to its
   original id, and the replay counters must have moved; one recovered
   payload is submitted again under a new key and its result must equal
   its recovered twin's.

Returns the reference's evidence dict (``lost``, ``completed``,
``backlog_at_kill``, ``recovered_jobs``, ``restored_done``, ``replay_ms``,
``deduped_resubmits``, ``deduped_submits_metric``) plus the boot seconds of
both processes, each process's kernel launches (``/metrics`` ``kernels``)
and the job seconds.  The port has no persistent compile cache, so the
restart builds (and on CUDA captures) from scratch.  Every wait has a
timeout, and whatever process is still alive at the end is killed.

It runs on the card unless asked for the CPU: ``--platform cuda`` (the
default) raises at once where CUDA is not available, never serving on the
CPU in its place; ``--platform cpu`` asks for the CPU.  ResNet-18 serves at
64 px; ``--model sd15`` serves SD-1.5 txt2img at 512x512, 20 DDIM steps.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]

# The model entries the harness knows, by name.
MODELS = {
    "resnet18": {"name": "resnet18", "batch_buckets": [1], "dtype": "float32",
                 "coalesce_ms": 0.0, "extra": {"image_size": 64, "resize_to": 72}},
    "sd15": {"name": "sd15", "batch_buckets": [1], "dtype": "bfloat16",
             "extra": {"height": 512, "width": 512, "num_steps": 20, "chunk_steps": 4}},
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(method: str, url: str, body: dict | None = None, timeout: float = 10.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _wait_ready(port: int, proc: subprocess.Popen, timeout_s: float) -> float:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited with rc={proc.returncode} before it was ready")
        try:
            status, _ = _http("GET", f"http://127.0.0.1:{port}/", timeout=2.0)
            if status == 200:
                return time.monotonic() - t0
        except (urllib.error.URLError, OSError, ValueError):
            pass
        time.sleep(0.25)
    raise TimeoutError(f"server not ready within {timeout_s:.0f} s")


def _tiny_png_b64(seed: int = 0) -> str:
    import numpy as np
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, (80, 100, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def payloads_for(model: str, n: int) -> list[dict]:
    """The jobs' bodies: an image (ResNet-18) or a prompt and seed (SD-1.5)."""
    if model == "sd15":
        return [{"prompt": f"a lighthouse on a cliff at dusk, study {i}", "seed": 100 + i}
                for i in range(n)]
    return [{"b64": _tiny_png_b64(i)} for i in range(n)]


def write_config(path: Path, port: int, workdir: Path, model: str,
                 latency_ms: float) -> None:
    """Two profiles on one journal: ``boot`` with the latency rule, so a
    backlog forms, and ``restart`` without it.  JSON: the card's machine
    has no PyYAML."""
    base = {"host": "127.0.0.1", "port": port, "warmup_at_boot": True,
            "journal_dir": str(workdir / "journal"), "journal_fsync": "always",
            "job_max_backlog": 64, "trace_dir": str(workdir / "traces"),
            "models": [MODELS[model]]}
    path.write_text(json.dumps({
        "default_profile": "boot",
        "profiles": {"boot": {**base, "faults": {model: {"latency_ms": latency_ms}}},
                     "restart": base}}, indent=1))


def _spawn(cfg_path: Path, profile: str, workdir: Path, platform: str) -> subprocess.Popen:
    logf = open(workdir / f"server-{profile}.log", "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli", "serve",
             "--config", str(cfg_path), "--profile", profile, "--platform", platform],
            cwd=str(REPO_ROOT), stdout=logf, stderr=logf)
    finally:
        logf.close()  # the child holds its own descriptor


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=30)


def _wait_done(base: str, ids: dict[str, str], timeout_s: float) -> dict[str, dict]:
    """Poll every job to a terminal state: {key: job}; a 404 (a lost job)
    or an error fails at once."""
    pending, done = dict(ids), {}
    deadline = time.monotonic() + timeout_s
    while pending and time.monotonic() < deadline:
        for key, jid in list(pending.items()):
            status, body = _http("GET", f"{base}/v1/jobs/{jid}")
            assert status != 404, f"acknowledged job {jid} (key={key}) LOST across the restart"
            job = body["job"]
            if job["status"] == "done":
                done[key] = job
                pending.pop(key)
            elif job["status"] == "error":
                raise AssertionError(f"job {jid} (key={key}) failed: {job.get('error')}")
        if pending:
            time.sleep(0.1)
    assert not pending, f"{len(pending)} acknowledged jobs never finished: {pending}"
    return done


def run_crashtest(workdir: str | Path, n_jobs: int = 6, model: str = "resnet18",
                  platform: str = "cuda", latency_ms: float = 600.0,
                  boot_timeout_s: float = 300.0, finish_timeout_s: float = 120.0) -> dict:
    """Run the kill -9 scenario; returns the evidence dict.  Raises
    AssertionError on any acknowledged job lost or run twice, and
    RuntimeError for ``platform="cuda"`` without CUDA (the servers would
    refuse to boot)."""
    if platform == "cuda":
        from ..engine.loader import resolve_device

        resolve_device("cuda")
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    cfg_path = workdir / "crashtest.json"
    write_config(cfg_path, port, workdir, model, latency_ms)
    base = f"http://127.0.0.1:{port}"
    payloads = payloads_for(model, n_jobs)
    out: dict = {"n_jobs": n_jobs, "model": model, "platform": platform}

    # -- boot, submit, SIGKILL in the middle of the backlog ------------------
    p1 = _spawn(cfg_path, "boot", workdir, platform)
    acked: dict[str, str] = {}  # idempotency key -> acknowledged job id
    try:
        out["boot_ready_s"] = round(_wait_ready(port, p1, boot_timeout_s), 3)
        for i, body in enumerate(payloads):
            key = f"crash-{i}"
            status, ack = _http("POST", f"{base}/v1/models/{model}:submit",
                                {**body, "idempotency_key": key})
            assert status == 202, f"submit {i} not acknowledged: {status} {ack}"
            acked[key] = ack["job"]["id"]
        # Kill once the backlog (acknowledged, not finished) is provably there.
        deadline = time.monotonic() + 30.0
        backlog = 0
        while time.monotonic() < deadline:
            _, health = _http("GET", f"{base}/healthz", timeout=30.0)
            backlog = health.get("jobs_backlog", 0)
            if backlog >= max(n_jobs // 2, 1):
                break
            time.sleep(0.1)
        assert backlog >= 1, "no backlog formed; a SIGKILL would prove nothing"
        out["backlog_at_kill"] = backlog
        _, m = _http("GET", f"{base}/metrics", timeout=30.0)
        out["launches_boot_at_kill"] = m.get("kernels", {})
    finally:
        _stop(p1)

    # -- restart, recover, verify ---------------------------------------------
    p2 = _spawn(cfg_path, "restart", workdir, platform)
    try:
        out["restart_ready_s"] = round(_wait_ready(port, p2, boot_timeout_s), 3)
        _, m = _http("GET", f"{base}/metrics", timeout=30.0)
        dur = m.get("durability", {})
        out["recovered_jobs"] = dur.get("recovered_jobs", 0)
        out["restored_done"] = dur.get("restored_done", 0)
        out["replay_ms"] = dur.get("replay_ms", 0.0)
        done = _wait_done(base, acked, finish_timeout_s)
        out["completed"] = len(done)
        out["lost"] = n_jobs - len(done)
        out["job_seconds"] = {key: job.get("seconds") for key, job in sorted(done.items())}
        # The same key answers the original id, deduped: no second run.
        dedupes = 0
        for key, jid in acked.items():
            i = int(key.split("-")[1])
            status, ack = _http("POST", f"{base}/v1/models/{model}:submit",
                                {**payloads[i], "idempotency_key": key})
            assert ack.get("deduped") is True, f"resubmit of {key} was not deduped: {status} {ack}"
            assert ack["job"]["id"] == jid, f"resubmit of {key} returned {ack['job']['id']}, not {jid}"
            dedupes += 1
        out["deduped_resubmits"] = dedupes
        # A recovered job against the same payload run fresh in this
        # process, under a new key.
        key = next(k for k, job in done.items() if job.get("recovered"))
        i = int(key.split("-")[1])
        status, ack = _http("POST", f"{base}/v1/models/{model}:submit",
                            {**payloads[i], "idempotency_key": f"fresh-{i}"})
        assert status == 202, f"fresh submit: {status} {ack}"
        fresh = _wait_done(base, {"fresh": ack["job"]["id"]}, finish_timeout_s)["fresh"]
        out["fresh_equal"] = fresh["result"] == done[key]["result"]
        out["fresh_seconds"] = fresh.get("seconds")
        _, m = _http("GET", f"{base}/metrics", timeout=30.0)
        out["deduped_submits_metric"] = m.get("durability", {}).get("deduped_submits", 0)
        out["launches_restart"] = m.get("kernels", {})
    finally:
        _stop(p2)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--platform", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--model", choices=sorted(MODELS), default="resnet18")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--latency-ms", type=float, default=600.0)
    args = ap.parse_args(argv)
    out = run_crashtest(args.workdir, n_jobs=args.jobs, model=args.model,
                        platform=args.platform, latency_ms=args.latency_ms)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
