"""Does a replica the router asked to warm up stay routable while it warms?

Boots ``cli fleet --spawn 2`` with BERT-base int8 (warm at boot) and a lazy
GPT-2 small int8 on the paged lane (JSON config; on the card unless
``--platform cpu``), quarantines r0 on the router, and sends a GPT-2
``:predict`` with ``X-Deadline-Ms: 50`` through it: r1 answers 503
``cold_start``, the router sheds ``all_cold`` and starts r1's activation in
the background.  Then it reads r1's state on the router's ``/admin/fleet``
every 0.1 s until r1's GPT-2 is active, and r1's own ``/healthz`` beside
it, and prints one JSON line: the activation's milliseconds (the replica's
``last_activation_ms``), the states read, the reads that found r1
quarantined and the first such second, the most consecutive poll failures,
and the holds ``/healthz`` named::

    python -m pytorch_zappa_serverless_tpu_torch.tools.warm_probe --workdir /tmp/wp

The router polls every 0.4 s with a 2 s budget and quarantines after 2
missed polls.  Every wait has a timeout, and the fleet (with its
replicas) is stopped at the end.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

from .crashtest import _free_port

MODELS = [
    {"name": "bert_int8", "builder": "bert_base", "dtype": "bfloat16", "batch_buckets": [1, 8],
     "seq_buckets": [128], "extra": {"params_dtype": "int8"}},
    {"name": "gpt2", "dtype": "bfloat16", "batch_buckets": [1], "seq_buckets": [16, 64, 128],
     "kv_cache": "paged", "kv_block_size": 16, "prefill_chunk_tokens": 64, "lazy_load": True,
     "extra": {"params_dtype": "int8", "gen_slots": 8, "segment_tokens": 8,
               "max_new_tokens": 64}}]


def _http(method: str, url: str, body=None, headers=None, timeout: float = 30.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode() if body is not None else None,
                                 method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def spill_and_watch(router: str, replica: str, rid: str = "r1", model: str = "gpt2",
                    watch_s: float = 120.0) -> dict:
    """Send ``model`` a ``:predict`` with ``X-Deadline-Ms: 50`` through
    ``router`` (base URLs) while ``rid`` (at ``replica``) is the one
    routable replica and its model is cold, then read ``rid``'s state on the
    router every 0.1 s until the model is active, and ``/healthz``'s hold
    beside it: the evidence dict."""
    st, body = _http("POST", router + f"/v1/models/{model}:predict", {"input_ids": [5, 6, 7]},
                     {"X-Deadline-Ms": "50"})
    out: dict = {"spill": [st, body.get("fleet_shed")]}
    t1 = time.monotonic()
    rows, holds = [], set()
    while time.monotonic() - t1 < watch_s:
        _, fleet = _http("GET", router + "/admin/fleet", timeout=10.0)
        r = fleet["replicas"][rid]
        state = r["residency"].get(model, {}).get("state")
        rows.append((round(time.monotonic() - t1, 2), r["state"], r["consecutive_failures"],
                     state))
        try:
            _, health = _http("GET", replica + "/healthz", timeout=0.2)
            if "dispatch_held" in health:
                holds.add(health["dispatch_held"]["by"])
        except OSError:
            pass  # a replica that cannot answer in time says nothing here
        if state == "active" and rows[-1][0] > 3.0:
            break
        time.sleep(0.1)
    _, snap = _http("GET", replica + f"/admin/models/{model}")
    quarantined = [row[0] for row in rows if row[1] == "quarantined"]
    out.update(activation_ms=snap["model"]["last_activation_ms"],
               states=sorted({row[1] for row in rows}), reads=len(rows),
               reads_quarantined=len(quarantined),
               first_quarantined_s=quarantined[0] if quarantined else None,
               last_quarantined_s=quarantined[-1] if quarantined else None,
               max_consecutive_failures=max(row[2] for row in rows),
               holds_named=sorted(holds), active=rows[-1][3] == "active")
    return out


def run_probe(workdir: str | Path, platform: str = "cuda", models: list | None = None,
              boot_timeout_s: float = 300.0, watch_s: float = 120.0) -> dict:
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    base_port, rport = _free_port(), _free_port()
    cfg = {"host": "127.0.0.1", "warmup_at_boot": True, "trace_dir": str(workdir / "traces"),
           "fleet": {"poll_interval_s": 0.4, "connect_timeout_s": 1.0, "quarantine_after": 2,
                     "spawn_base_port": base_port},
           "models": models or MODELS}
    path = workdir / "fleet.json"
    path.write_text(json.dumps(cfg))
    router = f"http://127.0.0.1:{rport}"
    with open(workdir / "fleet.log", "ab") as logf:
        proc = subprocess.Popen([sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli",
                                 "fleet", "--config", str(path), "--spawn", "2", "--port",
                                 str(rport), "--platform", platform], stdout=logf, stderr=logf)
    out: dict = {"platform": platform}
    try:
        t0 = time.monotonic()
        states: dict = {}
        while time.monotonic() - t0 < boot_timeout_s:
            try:
                _, fleet = _http("GET", router + "/admin/fleet", timeout=5.0)
                states = {k: v["state"] for k, v in fleet["replicas"].items()}
                if len(states) == 2 and set(states.values()) == {"healthy"}:
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.25)
        else:
            raise TimeoutError(f"the fleet never came up healthy: {states}")
        out["fleet_ready_s"] = round(time.monotonic() - t0, 3)
        _http("POST", router + "/admin/fleet", {"action": "quarantine", "replica": "r0"})
        out.update(spill_and_watch(router, f"http://127.0.0.1:{base_port + 1}",
                                   watch_s=watch_s))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--platform", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    if args.platform == "cuda":
        from ..engine.loader import resolve_device

        resolve_device("cuda")
    print(json.dumps(run_probe(args.workdir, args.platform)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
