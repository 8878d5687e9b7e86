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

Three fleet scenarios put the fleet router (``cli fleet``) in front of
``cli serve`` replicas, each with a journal of its own, as the JAX
package's harness does:

- ``--fleet`` (:func:`run_fleet_crashtest`): two replicas, a backlog of
  acknowledged ``:submit`` jobs (a 600 ms latency rule), one replica killed:
  sync predicts fail over within one retry, the router quarantines the dead
  replica and readmits it after a restart on its journal, no acknowledged
  job is lost and every resubmit dedupes.  ``--model bert_int8`` serves
  BERT-base on the int8 lane at (1,) x 128.
- ``--variants`` (:func:`run_variant_crashtest`): two lazy replicas of a
  ResNet-18 family at 64 px, the preferred rung warm on one, the cheap rung
  on the other; the first is killed with a backlog, and family-addressed
  predicts keep answering degraded from the second (``X-Served-Variant``,
  ``X-Degraded``), with no loss after the restart.
- ``--disagg`` (:func:`run_disagg_crashtest`): three replicas with GPT-2 on
  the paged lane (GPT-2 small int8 on the card), the first tagged prefill,
  behind a disaggregated router; the decode replica of a greedy stream is
  killed mid-stream and the stream resumes on the third, its tokens equal
  to the same prompt's undisturbed stream.

Each returns the reference's evidence and adds the replicas' boot seconds
and kernel launches (``/metrics`` ``kernels``) and the seconds the router
took to quarantine and readmit.  Configs are JSON, without the reference's
``compile_cache_dir`` (the port keeps no compile cache).
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
    "bert_int8": {"name": "bert_int8", "builder": "bert_base", "batch_buckets": [1],
                  "seq_buckets": [128], "dtype": "bfloat16", "coalesce_ms": 0.0,
                  "extra": {"params_dtype": "int8"}},
    "sd15": {"name": "sd15", "batch_buckets": [1], "dtype": "bfloat16",
             "extra": {"height": 512, "width": 512, "num_steps": 20, "chunk_steps": 4}},
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_port_run(n: int, avoid: tuple[int, ...] = ()) -> int:
    """A port ``p`` with ``p .. p + n - 1`` each free now (each bound once to
    test it) and none in ``avoid``: the base of ``cli fleet --spawn n``."""
    for _ in range(256):
        base = _free_port()
        run = range(base, base + n)
        if base + n > 65536 or any(p in avoid for p in run):
            continue
        try:
            for p in run[1:]:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
        except OSError:
            continue
        return base
    raise RuntimeError(f"no run of {n} free ports")


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
    """The jobs' bodies: an image (ResNet-18), token ids (BERT) or a prompt
    and seed (SD-1.5)."""
    if model == "sd15":
        return [{"prompt": f"a lighthouse on a cliff at dusk, study {i}", "seed": 100 + i}
                for i in range(n)]
    if model == "bert_int8":
        return [{"input_ids": [101, *range(1000 + 7 * i, 1000 + 7 * i + 24), 102]}
                for i in range(n)]
    return [{"b64": _tiny_png_b64(i)} for i in range(n)]


def write_config(path: Path, port: int, workdir: Path, model: str,
                 latency_ms: float, checkpoint: str | None = None) -> None:
    """Two profiles on one journal: ``boot`` with the latency rule, so a
    backlog forms, and ``restart`` without it.  JSON, which the port reads
    without PyYAML.  ``checkpoint`` (e.g. a staged tree) replaces the
    model's seeded weights."""
    entry = {**MODELS[model], **({"checkpoint": checkpoint} if checkpoint else {})}
    base = {"host": "127.0.0.1", "port": port, "warmup_at_boot": True,
            "journal_dir": str(workdir / "journal"), "journal_fsync": "always",
            "job_max_backlog": 64, "trace_dir": str(workdir / "traces"),
            "models": [entry]}
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
                  boot_timeout_s: float = 300.0, finish_timeout_s: float = 120.0,
                  checkpoint: str | None = None) -> dict:
    """Run the kill -9 scenario; returns the evidence dict.  Raises
    AssertionError on any acknowledged job lost or run twice, and
    RuntimeError for ``platform="cuda"`` without CUDA (the servers would
    refuse to boot)."""
    _need_platform(platform)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    cfg_path = workdir / "crashtest.json"
    write_config(cfg_path, port, workdir, model, latency_ms, checkpoint)
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


# -- the fleet scenarios -----------------------------------------------------

FLEET_KNOBS = {"poll_interval_s": 0.4, "connect_timeout_s": 1.0, "quarantine_after": 2,
               "failover_retries": 1, "breaker_threshold": 0.5, "breaker_min_samples": 4}
# The variant family: two ResNet-18 rungs at 64 px.
VARIANT_MODELS = [{**MODELS["resnet18"], "name": name, "builder": "resnet18", "family": "rn",
                   "quality_rank": rank} for name, rank in (("rn_full", 2), ("rn_lite", 1))]
# GPT-2 small int8 on the paged lane (16-token pages, 8 slots); ``extra``
# replaces ``arch`` and ``params_dtype`` for a CPU run.
DISAGG_MODEL = {"name": "gpt2", "dtype": "bfloat16", "batch_buckets": [1], "seq_buckets": [16],
                "coalesce_ms": 0.0, "kv_cache": "paged", "kv_block_size": 16,
                "prefill_chunk_tokens": 64, "extra": {"params_dtype": "int8", "gen_slots": 8, "segment_tokens": 2,
                          "max_new_tokens": 16}}
DISAGG_PROMPT = list(range(5, 15))


def _need_platform(platform: str) -> None:
    if platform == "cuda":
        from ..engine.loader import resolve_device

        resolve_device("cuda")  # raises without CUDA: no CPU fleet in its place


def _fleet_config(path: Path, workdir: Path, models: list[dict], **profile) -> None:
    """One ``replica`` profile for the replicas and the router (JSON, which
    the port reads without PyYAML); each replica's port and journal come from
    its environment."""
    path.write_text(json.dumps({"default_profile": "replica", "profiles": {"replica": {
        "host": "127.0.0.1", "port": 8000, "warmup_at_boot": True,
        "journal_dir": str(workdir / "journal-default"), "journal_fsync": "always",
        "job_max_backlog": 64, "drain_timeout_s": 10.0, "trace_dir": str(workdir / "traces"),
        "fleet": FLEET_KNOBS, "models": models, **profile}}}, indent=1))


def _spawn_replica(cfg_path: Path, workdir: Path, port: int, tag: str,
                   platform: str) -> subprocess.Popen:
    env = {**os.environ, "TPUSERVE_PORT": str(port),
           "TPUSERVE_JOURNAL_DIR": str(workdir / f"journal-{tag.split('-')[0]}")}
    logf = open(workdir / f"replica-{tag}.log", "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli", "serve",
             "--config", str(cfg_path), "--profile", "replica", "--platform", platform],
            env=env, cwd=str(REPO_ROOT), stdout=logf, stderr=logf)
    finally:
        logf.close()


def _spawn_router(cfg_path: Path, workdir: Path, port: int, urls: list[str],
                  extra: tuple[str, ...] = ()) -> subprocess.Popen:
    logf = open(workdir / "router.log", "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli", "fleet",
             "--config", str(cfg_path), "--profile", "replica", "--port", str(port),
             "--replicas", ",".join(urls), *extra],
            cwd=str(REPO_ROOT), stdout=logf, stderr=logf)
    finally:
        logf.close()


def _http_h(method: str, url: str, body: dict | None = None, headers: dict | None = None,
            timeout: float = 10.0):
    """(status, body, headers), HTTP errors folded in: the scenarios assert on
    503s, they are evidence."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            parsed = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            parsed = {"raw": raw.decode(errors="replace")}
        return e.code, parsed, dict(e.headers)


def _wait_fleet_state(base: str, rid: str, want: set[str], timeout_s: float) -> str:
    """Poll the router's /admin/fleet until replica ``rid`` is in ``want``."""
    deadline = time.monotonic() + timeout_s
    state = "?"
    while time.monotonic() < deadline:
        try:
            _, fleet = _http("GET", f"{base}/admin/fleet", timeout=5.0)
            state = fleet["replicas"].get(rid, {}).get("state", "?")
            if state in want:
                return state
        except (urllib.error.URLError, OSError, ValueError):
            pass
        time.sleep(0.05)
    raise TimeoutError(f"replica {rid} never reached {want} (last: {state}) within "
                       f"{timeout_s:.0f} s")


def _kernels(port: int) -> dict:
    """A replica's kernel launches (``/metrics`` ``kernels``)."""
    _, m = _http("GET", f"http://127.0.0.1:{port}/metrics", timeout=30.0)
    return m.get("kernels", {})


def _wait_backlog(port: int, timeout_s: float = 30.0) -> int:
    deadline = time.monotonic() + timeout_s
    backlog = 0
    while time.monotonic() < deadline:
        _, health = _http("GET", f"http://127.0.0.1:{port}/healthz", timeout=30.0)
        backlog = health.get("jobs_backlog", 0)
        if backlog >= 1:
            break
        time.sleep(0.05)
    return backlog


def _boots(pairs, t_spawn: float, timeout_s: float) -> list[float]:
    """Each replica's seconds from the spawn to its first answer."""
    out = []
    for port, proc in pairs:
        _wait_ready(port, proc, timeout_s)
        out.append(round(time.monotonic() - t_spawn, 3))
    return out


def _reap(procs) -> None:
    for proc in procs:
        if proc is not None and proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)
    for proc in procs:
        if proc is not None:
            proc.wait(timeout=30)


def _zero_loss(base: str, model: str, acked: dict[str, str], bodies: dict[str, dict],
               finish_timeout_s: float, out: dict) -> None:
    """Every acknowledged job reaches done through the router, and every
    resubmit with its key dedupes to its id."""
    pending = dict(acked)
    deadline = time.monotonic() + finish_timeout_s
    while pending and time.monotonic() < deadline:
        for key, jid in list(pending.items()):
            status, body, _ = _http_h("GET", f"{base}/v1/jobs/{jid}", timeout=10.0)
            assert status != 404, f"acked job {jid} (key={key}) LOST across the fleet kill"
            job = body.get("job", {})
            if job.get("status") == "done":
                pending.pop(key)
            elif job.get("status") == "error":
                raise AssertionError(f"job {jid} (key={key}) failed: {job.get('error')}")
        if pending:
            time.sleep(0.1)
    assert not pending, f"{len(pending)} acked jobs never finished: {sorted(pending)}"
    out["completed"] = len(acked)
    out["lost"] = 0
    dedupes = 0
    for key, jid in acked.items():
        status, body, _ = _http_h("POST", f"{base}/v1/models/{model}:submit", bodies[key],
                                  headers={"Idempotency-Key": key}, timeout=30.0)
        assert body.get("deduped") is True and body["job"]["id"] == jid, \
            f"resubmit of {key} not deduped to {jid}: {status} {body}"
        dedupes += 1
    out["deduped_resubmits"] = dedupes


def run_fleet_crashtest(workdir: str | Path, n_jobs: int = 6, model: str = "resnet18",
                        platform: str = "cuda", latency_ms: float = 600.0,
                        model_extra: dict | None = None, boot_timeout_s: float = 300.0,
                        finish_timeout_s: float = 180.0) -> dict:
    """The fleet kill -9 scenario: two journaled replicas behind the
    router, a backlog of acknowledged jobs across them, one replica killed
    with work in its backlog.  Sync predicts through the router keep
    answering within one failover retry; the router quarantines the dead
    replica, and readmits it after a restart on its journal; every
    acknowledged job reaches done and every resubmit dedupes.
    ``model_extra`` is merged into the model's ``extra`` (a narrow arch for
    the CPU)."""
    _need_platform(platform)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    p1, p2, pr = _free_port(), _free_port(), _free_port()
    entry = {**MODELS[model], "extra": {**MODELS[model]["extra"], **(model_extra or {})}}
    cfg_path = workdir / "fleetcrash.json"
    _fleet_config(cfg_path, workdir, [entry], faults={model: {"latency_ms": latency_ms}})
    urls = [f"http://127.0.0.1:{p1}", f"http://127.0.0.1:{p2}"]
    base = f"http://127.0.0.1:{pr}"
    payloads = payloads_for(model, n_jobs)
    out: dict = {"n_jobs": n_jobs, "model": model, "platform": platform, "replicas": 2}
    t_spawn = time.monotonic()
    r1 = _spawn_replica(cfg_path, workdir, p1, "1", platform)
    r2 = _spawn_replica(cfg_path, workdir, p2, "2", platform)
    router = r1b = None
    try:
        out["replica_boot_s"] = _boots(((p1, r1), (p2, r2)), t_spawn, boot_timeout_s)
        router = _spawn_router(cfg_path, workdir, pr, urls)
        _wait_ready(pr, router, 60.0)
        _wait_fleet_state(base, "r0", {"healthy"}, 30.0)
        _wait_fleet_state(base, "r1", {"healthy"}, 30.0)
        acked, bodies, owner = {}, {}, {}
        for i, body in enumerate(payloads):
            key = f"fleet-crash-{i}"
            status, ack, headers = _http_h("POST", f"{base}/v1/models/{model}:submit", body,
                                           headers={"Idempotency-Key": key}, timeout=60.0)
            assert status == 202, f"submit {i} not acked: {status} {ack}"
            acked[key], bodies[key] = ack["job"]["id"], body
            owner[key] = headers.get("X-Fleet-Replica")
        by_replica: dict[str, int] = {}
        for rid in owner.values():
            by_replica[rid] = by_replica.get(rid, 0) + 1
        out["acked_by_replica"] = by_replica
        victim = max(by_replica, key=by_replica.get)
        vproc, vport, vtag = {"r0": (r1, p1, "1"), "r1": (r2, p2, "2")}[victim]
        backlog = _wait_backlog(vport)
        assert backlog >= 1, "no backlog on the victim; a kill proves nothing"
        out["victim"], out["backlog_at_kill"] = victim, backlog
        launches = {"r0": _kernels(p1), "r1": _kernels(p2)}
        t_kill = time.monotonic()
        os.kill(vproc.pid, signal.SIGKILL)
        vproc.wait(timeout=30)
        ok, attempts = 0, []
        for _ in range(4):
            status, body, headers = _http_h("POST", f"{base}/v1/models/{model}:predict",
                                            payloads[0], timeout=60.0)
            assert status == 200, f"predict after the kill failed: {status} {body}"
            attempts.append(int(headers.get("X-Fleet-Attempts", "9")))
            assert attempts[-1] <= 2, f"failover took {attempts[-1]} attempts (> 1 retry)"
            ok += 1
        out["failover_predicts_ok"], out["failover_attempts"] = ok, attempts
        out["first_failover_s"] = round(time.monotonic() - t_kill, 3)
        out["quarantined_state"] = _wait_fleet_state(base, victim, {"quarantined"}, 30.0)
        out["kill_to_quarantine_s"] = round(time.monotonic() - t_kill, 3)
        jid0 = next(acked[k] for k, rid in owner.items() if rid == victim)
        status, body, headers = _http_h("GET", f"{base}/v1/jobs/{jid0}", timeout=30.0)
        assert status in (503, 200), f"dead-replica job poll: {status} {body}"
        if status == 503:
            assert headers.get("Retry-After"), "a 503 job poll without Retry-After"
        out["dead_owner_poll"] = status
        t_restart = time.monotonic()
        r1b = _spawn_replica(cfg_path, workdir, vport, f"{vtag}-restart", platform)
        out["restart_boot_s"] = round(_wait_ready(vport, r1b, boot_timeout_s), 3)
        out["readmitted_state"] = _wait_fleet_state(base, victim, {"healthy"}, 60.0)
        out["restart_to_readmit_s"] = round(time.monotonic() - t_restart, 3)
        out["kill_to_readmit_s"] = round(time.monotonic() - t_kill, 3)
        _zero_loss(base, model, acked, bodies, finish_timeout_s, out)
        _, m = _http("GET", f"{base}/metrics")
        fleet = m.get("fleet", {})
        out["failovers"] = fleet.get("failovers", {})
        out["quarantines"] = {rid: r.get("quarantines", 0)
                              for rid, r in fleet.get("replicas", {}).items()}
        assert sum(out["failovers"].values()) >= 1, "no failovers recorded"
        assert out["quarantines"].get(victim, 0) >= 1, "victim quarantine not recorded"
        survivor = "r1" if victim == "r0" else "r0"
        launches[survivor] = _kernels(p2 if survivor == "r1" else p1)
        launches[f"{victim}-restart"] = _kernels(vport)
        out["launches"] = launches
    finally:
        _reap((router, r1, r2, r1b))
    return out


def run_variant_crashtest(workdir: str | Path, n_jobs: int = 6, platform: str = "cuda",
                          latency_ms: float = 600.0, boot_timeout_s: float = 300.0,
                          finish_timeout_s: float = 180.0) -> dict:
    """The variant-family kill -9 scenario: two lazy replicas, ``rn_full``
    (the preferred rung) activated on A only and ``rn_lite`` on B only; a
    backlog of acknowledged ``rn_full`` jobs on A, then A killed.
    Family-addressed predicts with a latency objective keep answering
    through the router, degraded from B's ``rn_lite``; after A's restart no
    acknowledged job is lost and every resubmit dedupes."""
    _need_platform(platform)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    p1, p2, pr = _free_port(), _free_port(), _free_port()
    cfg_path = workdir / "variantcrash.json"
    _fleet_config(cfg_path, workdir, VARIANT_MODELS, lazy_load=True, brownout="auto",
                  faults={"rn_full": {"latency_ms": latency_ms}})
    urls = [f"http://127.0.0.1:{p1}", f"http://127.0.0.1:{p2}"]
    base = f"http://127.0.0.1:{pr}"
    payloads = payloads_for("resnet18", n_jobs)
    objective = {"X-Objective-Max-Latency-Ms": "2000"}
    out: dict = {"n_jobs": n_jobs, "family": "rn", "platform": platform, "replicas": 2}
    t_spawn = time.monotonic()
    ra = _spawn_replica(cfg_path, workdir, p1, "1", platform)
    rb = _spawn_replica(cfg_path, workdir, p2, "2", platform)
    router = rab = None
    try:
        out["replica_boot_s"] = _boots(((p1, ra), (p2, rb)), t_spawn, boot_timeout_s)
        for port, name in ((p1, "rn_full"), (p2, "rn_lite")):
            status, body = _http("POST", f"http://127.0.0.1:{port}/admin/models/{name}",
                                 {"action": "activate"}, timeout=300.0)
            assert status == 200, f"{name} activation failed: {status} {body}"
        router = _spawn_router(cfg_path, workdir, pr, urls)
        _wait_ready(pr, router, 60.0)
        _wait_fleet_state(base, "r0", {"healthy"}, 30.0)
        _wait_fleet_state(base, "r1", {"healthy"}, 30.0)
        acked, bodies = {}, {}
        for i, body in enumerate(payloads):
            key = f"variant-crash-{i}"
            status, ack, _ = _http_h("POST", f"{base}/v1/models/rn_full:submit", body,
                                     headers={"Idempotency-Key": key}, timeout=60.0)
            assert status == 202, f"submit {i} not acked: {status} {ack}"
            acked[key], bodies[key] = ack["job"]["id"], body
        backlog = _wait_backlog(p1)
        assert backlog >= 1, "no backlog on A; a kill proves nothing"
        out["backlog_at_kill"] = backlog
        launches = {"r0": _kernels(p1)}
        t_kill = time.monotonic()
        os.kill(ra.pid, signal.SIGKILL)
        ra.wait(timeout=30)
        degraded, served = 0, []
        for _ in range(4):
            status, body, headers = _http_h("POST", f"{base}/v1/models/rn:predict", payloads[0],
                                            headers=objective, timeout=60.0)
            assert status == 200, f"family predict after the kill SHED: {status} {body}"
            served.append(headers.get("X-Served-Variant"))
            assert served[-1] == "rn_lite", f"expected rn_lite to serve, got {headers}"
            degraded += bool(headers.get("X-Degraded"))
        assert degraded >= 1, "no degraded serve recorded"
        out["degraded_predicts_ok"], out["served_variants"] = degraded, served
        out["first_degraded_serve_s"] = round(time.monotonic() - t_kill, 3)
        out["quarantined_state"] = _wait_fleet_state(base, "r0", {"quarantined"}, 30.0)
        out["kill_to_quarantine_s"] = round(time.monotonic() - t_kill, 3)
        t_restart = time.monotonic()
        rab = _spawn_replica(cfg_path, workdir, p1, "1-restart", platform)
        out["restart_boot_s"] = round(_wait_ready(p1, rab, boot_timeout_s), 3)
        out["readmitted_state"] = _wait_fleet_state(base, "r0", {"healthy"}, 60.0)
        out["restart_to_readmit_s"] = round(time.monotonic() - t_restart, 3)
        _zero_loss(base, "rn_full", acked, bodies, finish_timeout_s, out)
        _, m = _http("GET", f"{base}/metrics")
        out["fleet_degraded"] = m.get("fleet", {}).get("degraded", {})
        assert sum(out["fleet_degraded"].values()) >= 1, "the router recorded no degraded serve"
        launches["r1"] = _kernels(p2)
        launches["r0-restart"] = _kernels(p1)
        out["launches"] = launches
    finally:
        _reap((router, ra, rb, rab))
    return out


class SSEStream:
    """One SSE request over http.client, read event by event."""

    def __init__(self, port: int, path: str, body: dict, timeout: float = 120.0):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        self.conn.request("POST", path, body=json.dumps(body),
                          headers={"Content-Type": "application/json"})
        self.resp = self.conn.getresponse()

    def next_event(self) -> dict | None:
        """One parsed data event, or None at the end or a severed stream."""
        while True:
            try:
                line = self.resp.readline()
            except Exception:
                return None
            if not line:
                return None
            if line.startswith(b"data: "):
                return json.loads(line[6:])

    def close(self):
        self.conn.close()


def _drain_stream(stream: SSEStream, tokens: list, stamps: list) -> dict:
    """Read to the terminal event, stamping each token's arrival; raises on
    an error event or a severed stream."""
    while True:
        ev = stream.next_event()
        assert ev is not None, "stream severed (no resume, no error event)"
        assert "error" not in ev, f"stream errored: {ev}"
        if "token" in ev:
            tokens.append(ev["token"])
            stamps.append(time.monotonic())
        if ev.get("done"):
            return ev


def run_disagg_crashtest(workdir: str | Path, platform: str = "cuda",
                         latency_ms: float = 150.0, model_extra: dict | None = None,
                         boot_timeout_s: float = 300.0) -> dict:
    """The disaggregated kill -9 scenario: three paged GPT-2 replicas behind
    a disaggregated router, r0 tagged prefill.  A greedy stream prefills on
    r0, moves to a decode replica at its first token and streams from there;
    mid-stream the decode replica is killed, and the router resumes the
    stream on the third from the journaled pages and the watermark: the
    client's tokens equal an undisturbed run of the same prompt through the
    router.  Returns that reference's tokens (``reference``) and the same
    prompt's on one replica undisturbed (``direct``, for the caller's own
    check), the cutover and kill-to-resume milliseconds as the client saw
    them, and each replica's kernel launches."""
    _need_platform(platform)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ports = [_free_port() for _ in range(3)]
    pr = _free_port()
    entry = {**DISAGG_MODEL, "extra": {**DISAGG_MODEL["extra"], **(model_extra or {})}}
    cfg_path = workdir / "disaggcrash.json"
    _fleet_config(cfg_path, workdir, [entry], faults={"gpt2": {"latency_ms": latency_ms}})
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    base = f"http://127.0.0.1:{pr}"
    n_new = entry["extra"]["max_new_tokens"]
    body = {"input_ids": DISAGG_PROMPT, "max_new_tokens": n_new}
    out: dict = {"replicas": 3, "model": "gpt2", "platform": platform}
    t_spawn = time.monotonic()
    procs = {f"r{i}": _spawn_replica(cfg_path, workdir, p, str(i + 1), platform)
             for i, p in enumerate(ports)}
    port_of = {f"r{i}": p for i, p in enumerate(ports)}
    router = stream = None
    try:
        out["replica_boot_s"] = _boots([(port_of[rid], proc) for rid, proc in procs.items()],
                                       t_spawn, boot_timeout_s)
        # The same prompt undisturbed on one replica (same pool geometry):
        # what the caller holds the moved streams against.
        direct = SSEStream(port_of["r2"], "/v1/models/gpt2:generate", body)
        out["direct"] = []
        _drain_stream(direct, out["direct"], [])
        direct.close()
        router = _spawn_router(cfg_path, workdir, pr, urls,
                               extra=("--disagg", "--prefill-replicas", urls[0]))
        _wait_ready(pr, router, 60.0)
        for rid in procs:
            _wait_fleet_state(base, rid, {"healthy"}, 30.0)
        # The reference: the same prompt undisturbed (it moves too).
        ref = SSEStream(pr, "/v1/models/gpt2:generate", body)
        assert ref.resp.status == 200, ref.resp.status
        ref_tokens, ref_stamps = [], []
        ref_done = _drain_stream(ref, ref_tokens, ref_stamps)
        ref.close()
        assert len(ref_tokens) == n_new, f"reference short: {len(ref_tokens)}"
        assert ref_done["tokens"] == ref_tokens
        gaps = [b - a for a, b in zip(ref_stamps, ref_stamps[1:])]
        out["reference"] = ref_tokens
        out["cutover_ms"] = round(gaps[0] * 1e3, 3)  # first token -> second: the move
        out["token_gap_ms_median"] = round(sorted(gaps[1:])[len(gaps[1:]) // 2] * 1e3, 3)
        _, fleet = _http("GET", f"{base}/admin/fleet", timeout=10.0)
        assert fleet["metrics"]["migrations"].get("prefill", 0) >= 1, \
            "the reference recorded no prefill-to-decode move"
        stream = SSEStream(pr, "/v1/models/gpt2:generate", body)
        assert stream.resp.status == 200, stream.resp.status
        sid = stream.resp.headers.get("X-Stream-Id")
        assert sid, "the router exposed no X-Stream-Id"
        tokens, stamps = [], []
        while len(tokens) < 4:
            ev = stream.next_event()
            assert ev is not None and "error" not in ev, f"early end: {ev}"
            if "token" in ev:
                tokens.append(ev["token"])
                stamps.append(time.monotonic())
        deadline = time.monotonic() + 20.0
        decode = None
        while time.monotonic() < deadline and decode is None:
            _, fleet = _http("GET", f"{base}/admin/fleet", timeout=10.0)
            decode = (fleet.get("streams", {}).get(sid) or {}).get("replica")
            if decode is None:
                time.sleep(0.05)
        assert decode and decode != "r0", f"stream not on a decode replica: {decode}"
        out["decode_replica"] = decode
        launches = {rid: _kernels(port_of[rid]) for rid in procs}
        t_kill = time.monotonic()
        os.kill(procs[decode].pid, signal.SIGKILL)
        procs[decode].wait(timeout=30)
        n_before = len(tokens)
        done = _drain_stream(stream, tokens, stamps)
        out["kill_to_resume_ms"] = round((stamps[n_before] - t_kill) * 1e3, 3) \
            if len(stamps) > n_before else None
        out["kill_to_done_s"] = round(time.monotonic() - t_kill, 3)
        out["tokens"] = tokens
        out["tokens_after_kill"] = len(tokens)
        assert tokens == ref_tokens, (f"tokens diverged after the failover (lost or repeated): "
                                      f"got {tokens} want {ref_tokens}")
        assert done["tokens"] == ref_tokens
        out["duplicates"] = out["lost"] = 0
        # The prefill replica hands every stream on: none ends there.
        _, streams = _http("GET", f"http://127.0.0.1:{port_of['r0']}/admin/streams")
        out["prefill_streams"] = {k: (v["state"], v["tokens"])
                                  for k, v in streams["streams"].items()}
        assert len(out["prefill_streams"]) == 2 and all(
            st == "migrated" for st, _ in out["prefill_streams"].values()), \
            f"the prefill replica kept a stream: {out['prefill_streams']}"
        _, fleet = _http("GET", f"{base}/admin/fleet", timeout=10.0)
        out["migrations"] = fleet["metrics"]["migrations"]
        out["failovers"] = fleet["metrics"]["failovers"]
        assert out["migrations"].get("failover", 0) >= 1, "no failover move recorded"
        assert out["failovers"].get("kv_failover", 0) >= 1, "no kv_failover recorded"
        resumed = (fleet.get("streams", {}).get(sid) or {}).get("replica")
        assert resumed and resumed not in (decode, "r0"), \
            f"the stream journal points at {resumed}"
        out["resumed_on"] = resumed
        for rid in procs:
            if rid != decode:
                launches[rid] = _kernels(port_of[rid])
        out["launches"] = launches
    finally:
        if stream is not None:
            stream.close()
        _reap([router, *procs.values()])
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--platform", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--model", choices=sorted(MODELS), default="resnet18")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--latency-ms", type=float, default=None,
                    help="the injected dispatch latency (default 600, 150 with --disagg)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fleet", action="store_true",
                      help="two replicas behind the router, one killed with a backlog")
    mode.add_argument("--variants", action="store_true",
                      help="kill the only replica with the preferred rung warm")
    mode.add_argument("--disagg", action="store_true",
                      help="kill the decode replica of a disaggregated stream")
    args = ap.parse_args(argv)
    lat = args.latency_ms
    if args.disagg:
        out = run_disagg_crashtest(args.workdir, platform=args.platform,
                                   latency_ms=150.0 if lat is None else lat)
    elif args.variants:
        out = run_variant_crashtest(args.workdir, n_jobs=max(args.jobs, 4),
                                    platform=args.platform,
                                    latency_ms=600.0 if lat is None else lat)
    elif args.fleet:
        out = run_fleet_crashtest(args.workdir, n_jobs=max(args.jobs, 4), model=args.model,
                                  platform=args.platform,
                                  latency_ms=600.0 if lat is None else lat)
    else:
        out = run_crashtest(args.workdir, n_jobs=args.jobs, model=args.model,
                            platform=args.platform, latency_ms=600.0 if lat is None else lat)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
