"""Live migration between two servers: a ``:generate`` stream moves mid-decode.

Boots two ``cli serve`` processes with the same paged GPT-2 deploy (JSON
configs, which the port reads without PyYAML), then drives the export and
import routes as a router would, on the card unless ``--platform cpu``
(with ``--arch``, a narrow float32 GPT-2) asks for the CPU::

    python -m pytorch_zappa_serverless_tpu_torch.tools.streammove --workdir /tmp/mv

For each case a stream is opened on the source with SSE and, once its first
tokens arrived, moved: ``export {"phase": "snapshot"}`` (the complete pages
while it decodes on), ``export {"phase": "cutover", "have": [...]}`` (the
pause, the manifest and the pages the importer lacks), ``import`` on the
target (answering 409 ``"need"`` for pages to fetch again through ``export
{"phase": "pages"}``), ``export {"phase": "commit"}``; the source's SSE ends
with a ``migrated`` event, and ``GET /admin/streams/{id}/attach?from=N`` on
the target streams the rest.  The cases:

1. ``fresh``: a prompt the target has never seen (no page deduped);
2. ``dedup``: the same prompt again, whose prompt pages the target's prefix
   tree now holds (adopted, not copied);
3. ``corrupt``: a ``migration`` fault on the source flips the first page's
   bytes after its hash; the importer's verify refuses it and the page is
   fetched again;
4. ``drop``: the fault's ``drop`` mode answers 503 with ``Retry-After``;
   then a cutover and an ``abort`` resume the stream in place on the
   source.

Each stream is compared with a control, the same request answered by the
source unmigrated (``"stream": false``).  A latency rule on the source's
dispatches stretches its ticks, so each step lands between two ticks.
Returns the evidence (tokens, the control's, watermark, pages deduped and
copied, import attempts, the client's ms for the move, both servers'
``/metrics`` migration block and kernel launches).  Every wait has a
timeout, and both processes are killed at the end.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import time
from pathlib import Path

from .crashtest import _free_port, _http, _spawn, _stop, _wait_ready

# GPT-2 small int8 on the paged lane (the card); ``arch`` and
# ``params_dtype`` are replaced for a CPU run.
MODEL = {"name": "gpt2", "dtype": "bfloat16", "batch_buckets": [1],
         "seq_buckets": [16, 64, 128], "kv_cache": "paged", "kv_block_size": 16,
         "prefill_chunk_tokens": 64,
         "extra": {"params_dtype": "int8", "gen_slots": 8, "segment_tokens": 8,
                   "max_new_tokens": 64}}


def write_config(path: Path, port: int, workdir: Path, model: dict, profile: str) -> None:
    path.write_text(json.dumps({"default_profile": profile, "profiles": {profile: {
        "host": "127.0.0.1", "port": port, "warmup_at_boot": False,
        "trace_dir": str(workdir / "traces"), "models": [model]}}}, indent=1))


class SSE:
    """One SSE request over its own connection; :meth:`events` reads until
    ``n`` tokens (or the stream's end) arrived."""

    def __init__(self, port: int, method: str, path: str, body: dict | None = None,
                 timeout: float = 120.0):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        self.conn.request(method, path,
                          body=json.dumps(body).encode() if body is not None else None,
                          headers={"Content-Type": "application/json"})
        self.resp = self.conn.getresponse()
        self.status = self.resp.status
        self.headers = dict(self.resp.getheaders())
        self.tokens: list[int] = []
        self.last: dict | None = None

    def events(self, n: int | None = None) -> None:
        while n is None or len(self.tokens) < n:
            line = self.resp.readline()
            if not line:
                return
            if line.startswith(b"data: "):
                ev = json.loads(line[6:])
                if "token" in ev:
                    self.tokens.append(ev["token"])
                else:
                    self.last = ev
                    return

    def close(self) -> None:
        self.conn.close()


def _post(port: int, path: str, body: dict):
    return _http("POST", f"http://127.0.0.1:{port}{path}", body, timeout=60.0)


def migrate(src: int, dst: int, sid: str, new_sid: str, cause: str = "admin") -> dict:
    """snapshot → cutover → import (fetching named pages again) → commit;
    returns the watermark, the import's answer and attempts, and the
    client's ms from the cutover to the commit."""
    status, snap = _post(src, f"/admin/streams/{sid}/export", {"phase": "snapshot"})
    assert status == 200, f"snapshot: {status} {snap}"
    pages = {p["i"]: p for p in snap["pages"]}
    t0 = time.perf_counter()
    status, cut = _post(src, f"/admin/streams/{sid}/export",
                        {"phase": "cutover", "have": sorted(pages)})
    assert status == 200, f"cutover: {status} {cut}"
    pages.update({p["i"]: p for p in cut["pages"]})
    for attempt in range(1, 4):
        status, imp = _post(dst, f"/admin/streams/{new_sid}/import",
                            {"manifest": cut["manifest"], "pages": list(pages.values()),
                             "cause": cause})
        if status == 200:
            break
        assert status == 409 and imp.get("need"), f"import: {status} {imp}"
        status, again = _post(src, f"/admin/streams/{sid}/export",
                              {"phase": "pages", "indices": imp["need"]})
        assert status == 200, f"pages: {status} {again}"
        pages.update({p["i"]: p for p in again["pages"]})
    else:
        raise AssertionError(f"the import never succeeded: {imp}")
    status, commit = _post(src, f"/admin/streams/{sid}/export",
                           {"phase": "commit", "cause": cause})
    assert status == 200, f"commit: {status} {commit}"
    return {"watermark": commit["watermark"], "import": imp, "attempts": attempt,
            "move_ms": (time.perf_counter() - t0) * 1e3, "snapshot_pages": len(snap["pages"]),
            "cutover_pages": len(cut["pages"]), "npages": cut["manifest"]["npages"]}


def _moved(src: int, dst: int, body: dict, name: str, first: int, rule: dict | None) -> dict:
    """One stream opened on ``src``, moved to ``dst`` after ``first``
    tokens, and attached there: the tokens as the client saw them."""
    s = SSE(src, "POST", "/v1/models/gpt2:generate", body)
    assert s.status == 200, f"{name}: generate {s.status}"
    sid = s.headers["X-Stream-Id"]
    s.events(first)
    if rule:
        status, ans = _post(src, "/admin/faults", {"model": "gpt2", "fail_every_n": 1,
                                                    "count": 1, "kind": "migration", **rule})
        assert status == 200, f"{name}: fault rule {status} {ans}"
    mv = migrate(src, dst, sid, f"{name}-moved")
    s.events()
    s.close()
    a = SSE(dst, "GET", f"/admin/streams/{name}-moved/attach?from={len(s.tokens)}")
    assert a.status == 200, f"{name}: attach {a.status}"
    a.events()
    a.close()
    return {**mv, "source_tokens": s.tokens, "source_end": s.last, "attached": a.tokens,
            "tokens": s.tokens + a.tokens, "attach_end": a.last,
            "dedup_pages": mv["import"]["dedup_pages"],
            "copied_pages": mv["import"]["copied_pages"]}


def run_streammove(workdir: str | Path, platform: str = "cuda", model: dict | None = None,
                   prompt_len: int = 40, first: int = 8, latency_ms: float = 40.0,
                   boot_timeout_s: float = 300.0, seed: int = 21) -> dict:
    """Boot the two servers, run the four cases; returns the evidence."""
    import numpy as np

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    model = model or MODEL
    vocab = int(model["extra"].get("arch", {}).get("vocab_size", 50257))
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, vocab - 1, prompt_len).tolist()
    other = rng.integers(0, vocab - 1, prompt_len).tolist()
    ports = [_free_port(), _free_port()]
    procs = []
    out: dict = {"platform": platform, "prompt_len": prompt_len}
    try:
        for role, port in zip(("source", "target"), ports):
            cfg = workdir / f"{role}.json"
            write_config(cfg, port, workdir, model, role)
            procs.append(_spawn(cfg, role, workdir, platform))
        out["boot_s"] = [round(_wait_ready(p, proc, boot_timeout_s), 3)
                         for p, proc in zip(ports, procs)]
        src, dst = ports
        bodies = {"fresh": {"input_ids": prompt}, "dedup": {"input_ids": prompt},
                  "corrupt": {"input_ids": other, "temperature": 0.8, "top_k": 40, "seed": 5},
                  "drop": {"input_ids": other}}
        out["bodies"] = bodies
        control = {}
        for name, body in bodies.items():
            status, ans = _post(src, "/v1/models/gpt2:generate", {**body, "stream": False})
            assert status == 200, f"control {name}: {status} {ans}"
            control[name] = ans["predictions"]["tokens"]
        out["control"] = control
        status, ans = _post(src, "/admin/faults", {"model": "gpt2", "latency_ms": latency_ms})
        assert status == 200, f"pacing rule: {status} {ans}"
        out["fresh"] = _moved(src, dst, bodies["fresh"], "fresh", first, None)
        out["dedup"] = _moved(src, dst, bodies["dedup"], "dedup", first, None)
        out["corrupt"] = _moved(src, dst, bodies["corrupt"], "corrupt", first,
                                {"mode": "corrupt"})
        # The drop: a retryable 503, then a cutover and an abort.
        s = SSE(src, "POST", "/v1/models/gpt2:generate", bodies["drop"])
        sid = s.headers["X-Stream-Id"]
        s.events(first)
        _post(src, "/admin/faults", {"model": "gpt2", "fail_every_n": 1, "count": 1,
                                     "kind": "migration", "mode": "drop"})
        conn = http.client.HTTPConnection("127.0.0.1", src, timeout=60)
        conn.request("POST", f"/admin/streams/{sid}/export",
                      body=json.dumps({"phase": "snapshot"}).encode(),
                      headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        drop = {"status": r.status, "retry_after": r.getheader("Retry-After"),
                "body": json.loads(r.read())}
        conn.close()
        status, cut = _post(src, f"/admin/streams/{sid}/export", {"phase": "cutover"})
        drop["cutover"] = status
        status, ab = _post(src, f"/admin/streams/{sid}/export", {"phase": "abort"})
        drop["abort"] = status
        s.events()
        s.close()
        out["drop"] = {**drop, "tokens": s.tokens, "end": s.last}
        for role, port in zip(("source", "target"), ports):
            _, m = _http("GET", f"http://127.0.0.1:{port}/metrics", timeout=30.0)
            out[role] = {"migration": m["generation"]["gpt2"]["migration"],
                         "kernels": m.get("kernels", {})}
            _, streams = _http("GET", f"http://127.0.0.1:{port}/admin/streams", timeout=30.0)
            out[role]["streams"] = streams["streams"]
    finally:
        for proc in procs:
            _stop(proc)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--platform", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--arch", default=None,
                    help="a GPT-2 arch as JSON (a narrow one on the CPU), float32 weights")
    args = ap.parse_args(argv)
    model = None
    if args.arch:
        model = {**MODEL, "dtype": "float32",
                 "extra": {**MODEL["extra"], "params_dtype": "", "arch": json.loads(args.arch)}}
    print(json.dumps(run_streammove(args.workdir, args.platform, model)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
