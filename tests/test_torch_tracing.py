"""The port's request tracing (``serving/tracing.py``) and the routes on it.

- Unit: ``tests/test_tracing.py``'s cases against the port's tracer
  (``traceparent`` round trip, span parenting, span budgets, ring eviction
  against the flight recorder, list filters), the JAX tracer beside it on
  the same calls where the answer is deterministic.
- HTTP, on the port's server (CPU, tiny models): ids on every answer and on
  errors (logged with them), a client's ``traceparent`` joining its trace,
  a ``:predict`` trace whose stages tile the request (the JAX package's
  ``tools/tracedump.py`` reads it), the exemplars on the histograms, a
  job's trace from submit to done, a ``:generate`` stream's spans and its
  id, ``/admin/trace`` filters, and ``/admin/profile`` and
  ``/debug/trace`` on the CPU.
"""

import importlib.util
import io
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pytorch_zappa_serverless_tpu.serving import tracing as jtracing
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer
from pytorch_zappa_serverless_tpu_torch.serving.tracing import (Tracer, format_traceparent,
                                                                 parse_traceparent)

ROOT = Path(__file__).resolve().parents[1]


def _tracedump():
    spec = importlib.util.spec_from_file_location("tpuserve_tracedump",
                                                  ROOT / "tools" / "tracedump.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- unit: traceparent ------------------------------------------------------------

def test_traceparent_round_trip():
    tid, sid = "a" * 32, "b" * 16
    header = format_traceparent(tid, sid)
    assert header == f"00-{tid}-{sid}-01" == jtracing.format_traceparent(tid, sid)
    assert parse_traceparent(header) == (tid, sid)
    assert parse_traceparent(f"  00-{tid.upper()}-{sid}-01 ") == (tid, sid)


@pytest.mark.parametrize("bad", [
    None, "", "garbage", "00-zz-bb-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
])
def test_traceparent_invalid_headers_restart_the_trace(bad):
    assert parse_traceparent(bad) is None and jtracing.parse_traceparent(bad) is None


def test_traceparent_ingest_joins_callers_trace():
    tracer = Tracer()
    tid, sid = "c" * 32, "d" * 16
    root = tracer.start("predict", model="m", traceparent=format_traceparent(tid, sid))
    assert root.trace.trace_id == tid and root.trace.remote_parent == sid
    tracer.finish(root.trace, "ok")
    assert tracer.get(tid).tree()["remote_parent"] == sid
    other = tracer.start("predict", traceparent="00-bogus")
    assert other.trace.trace_id != tid and other.trace.remote_parent is None


# -- unit: parenting and budgets ------------------------------------------------------

def _shape(node: dict) -> tuple:
    """A span tree without its ids and times: names, statuses, attrs."""
    return (node["name"], node["status"], json.dumps(node.get("attrs", {}), sort_keys=True),
            tuple(_shape(c) for c in node.get("children", [])))


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_span_parenting_builds_the_tree(mod):
    tracer = Tracer() if mod == "port" else jtracing.Tracer()
    root = tracer.start("predict", model="m", request_id="r1")
    root.child("admission").end()
    dev = root.child("device", batch_size=3)
    dev.child("exec", lane="latency").end()
    dev.end()
    root.point("retry", attempt=1)
    tracer.finish(root.trace, "ok")
    tree = tracer.get(root.trace.trace_id).tree()
    assert tree["status"] == "ok"
    top = tree["tree"]
    assert [c["name"] for c in top["children"]] == ["admission", "device", "retry"]
    assert top["children"][1]["attrs"]["batch_size"] == 3
    assert top["children"][1]["children"][0]["name"] == "exec"
    assert top["children"][2]["duration_ms"] == 0.0


def test_the_same_calls_build_the_same_tree_in_both():
    trees = []
    for tracer in (Tracer(), jtracing.Tracer()):
        root = tracer.start("submit", model="sd15", request_id="r")
        q = root.child("job_queue")
        q.end()
        run = root.child("run", batched=1)
        run.child("device", batch_size=1).child("chunk[0]", lane="throughput").end()
        run.end(status="error", error="boom")
        tracer.finish(root.trace, "error")
        trees.append(tracer.get(root.trace.trace_id).tree())
    assert _shape(trees[0]["tree"]) == _shape(trees[1]["tree"])
    assert {k: trees[0][k] for k in ("name", "model", "status", "spans", "dropped_spans")} == \
        {k: trees[1][k] for k in ("name", "model", "status", "spans", "dropped_spans")}


def test_span_context_manager_records_errors():
    tracer = Tracer()
    root = tracer.start("predict", model="m")
    with pytest.raises(ValueError):
        with root.child("device"):
            raise ValueError("boom")
    tracer.finish(root.trace, "error")
    dev = tracer.get(root.trace.trace_id).tree()["tree"]["children"][0]
    assert dev["status"] == "error" and "boom" in dev["attrs"]["error"]


def test_span_budget_drops_are_counted_not_raised():
    tracer = Tracer(max_spans=8)
    root = tracer.start("predict", model="m")
    for i in range(20):
        root.child(f"s{i}").end()
    tracer.finish(root.trace, "ok")
    trace = tracer.get(root.trace.trace_id)
    assert len(trace.spans) == 8 and trace.dropped_spans == 13
    assert tracer.snapshot()["dropped_spans"] == 13


def test_finish_closes_abandoned_spans():
    tracer = Tracer()
    root = tracer.start("predict", model="m")
    root.child("device")
    tracer.finish(root.trace, "error")
    t1 = tracer.get(root.trace.trace_id).tree()
    time.sleep(0.02)
    t2 = tracer.get(root.trace.trace_id).tree()
    assert t1["tree"]["children"][0]["duration_ms"] == t2["tree"]["children"][0]["duration_ms"]
    assert t1["duration_ms"] == t2["duration_ms"]


def test_spans_append_from_another_thread_under_the_lock():
    """The dispatch thread's exec spans and the loop's spans land in one
    tree, none lost."""
    tracer = Tracer(max_spans=4096)
    root = tracer.start("predict", model="m")

    def worker(tag):
        for i in range(300):
            root.child(f"{tag}{i}").end()

    threads = [threading.Thread(target=worker, args=(t,)) for t in "abcd"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    tracer.finish(root.trace, "ok")
    assert len(tracer.get(root.trace.trace_id).spans) == 1 + 4 * 300


def _finished(tracer, model, status="ok", sleep=0.0):
    root = tracer.start("predict", model=model)
    if sleep:
        time.sleep(sleep)
    tracer.finish(root.trace, status)
    return root.trace


def test_ring_eviction_and_flight_recorder_pinning():
    tracer = Tracer(ring=4, flight_slow=1, flight_errors=2)
    slow = _finished(tracer, "m", sleep=0.03)
    errored = _finished(tracer, "m", status="error")
    churn = [_finished(tracer, "m") for _ in range(16)]
    assert {t.trace_id for t in tracer._ring}.isdisjoint({slow.trace_id, errored.trace_id})
    assert tracer.get(slow.trace_id) is slow and tracer.get(errored.trace_id) is errored
    assert tracer.get(churn[0].trace_id) is None
    snap = tracer.snapshot()
    assert snap["ring"] == 4 and snap["finished"] == 18
    assert snap["pinned_slow"] == 1 and snap["pinned_errored"] == 1
    e2 = _finished(tracer, "m", status="error")
    e3 = _finished(tracer, "m", status="error")
    assert tracer.snapshot()["pinned_errored"] == 2
    assert {t.trace_id for t in tracer._errored["m"]} == {e2.trace_id, e3.trace_id}


def test_trace_list_filters():
    tracer = Tracer()
    _finished(tracer, "a")
    _finished(tracer, "b", status="error")
    slow = _finished(tracer, "a", sleep=0.03)
    assert {t["model"] for t in tracer.list()} == {"a", "b"}
    assert all(t["model"] == "a" for t in tracer.list(model="a"))
    errs = tracer.list(status="error")
    assert len(errs) == 1 and errs[0]["model"] == "b"
    assert [t["trace_id"] for t in tracer.list(model="a", min_ms=20.0)] == [slow.trace_id]
    assert len(tracer.list(limit=2)) == 2


# -- HTTP on the port's server ----------------------------------------------------------

GPT2_ARCH = {"d_model": 32, "layers": 1, "heads": 2, "ffn_dim": 64, "vocab_size": 512,
             "max_positions": 32}


def _cfg(tmp, **kw):
    return ServeConfig(
        trace_dir=str(Path(tmp) / "traces"), warmup_at_boot=True,
        models=[ModelConfig(name="resnet18", batch_buckets=(1, 4), dtype="float32",
                            coalesce_ms=5.0, extra={"image_size": 64, "resize_to": 72}),
                ModelConfig(name="gpt2", batch_buckets=(1, 2), seq_buckets=(8,),
                            dtype="float32", coalesce_ms=5.0,
                            extra={"max_new_tokens": 4, "arch": GPT2_ARCH, "gen_slots": 2,
                                   "segment_tokens": 2})],
        **kw)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    eng = build_engine(_cfg(tmp_path_factory.mktemp("boot")), device="cpu")
    yield eng
    eng.shutdown()


@pytest.fixture
def srv(engine, tmp_path):
    with BackgroundServer(_cfg(tmp_path), engine) as s:
        yield s
    engine.runner.faults.clear()


def _png(seed=0) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 255, (80, 100, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _req(port, method, path, body=None, headers=None, timeout=60.0):
    """(status, headers, decoded JSON or raw bytes)."""
    data = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
    hdrs = {"Content-Type": "application/json"} if isinstance(body, (dict, list)) else {}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={**hdrs, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, h, raw = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, h, raw = e.code, dict(e.headers), e.read()
    try:
        return status, h, json.loads(raw)
    except ValueError:
        return status, h, raw


def _find(node, name):
    if node["name"] == name:
        return node
    for c in node.get("children", []):
        hit = _find(c, name)
        if hit is not None:
            return hit
    return None


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        from pytorch_zappa_serverless_tpu_torch.utils.logging import JsonFormatter

        self.setFormatter(JsonFormatter())
        self.records: list[dict] = []

    def emit(self, record):
        self.records.append(json.loads(self.format(record)))


@pytest.fixture
def server_logs():
    handler = _Capture()
    loggers = [logging.getLogger(n) for n in ("serving.server", "serving.jobs")]
    for lg in loggers:
        lg.addHandler(handler)
    yield handler.records
    for lg in loggers:
        lg.removeHandler(handler)


def test_slow_request_reconstructs_from_its_trace(srv):
    status, _, out = _req(srv.port, "POST", "/admin/faults",
                          {"model": "resnet18", "latency_ms": 80})
    assert status == 200, out
    t0 = time.perf_counter()
    status, h, body = _req(srv.port, "POST", "/v1/models/resnet18:predict", _png(),
                           {"Content-Type": "image/png", "X-Request-Id": "req-abc"})
    wall_ms = (time.perf_counter() - t0) * 1000
    assert status == 200, body
    assert h["X-Request-Id"] == "req-abc"
    trace_id = h["X-Trace-Id"]
    status, _, payload = _req(srv.port, "GET", f"/admin/trace/{trace_id}")
    assert status == 200, payload
    trace = payload["trace"]
    assert trace["status"] == "ok" and trace["model"] == "resnet18"
    att = _tracedump().stage_attribution(payload)
    assert att["coverage_pct"] >= 95.0, att
    assert {"admission", "queue", "device", "respond"} <= set(att["stages"])
    assert att["stages"]["device"] >= 80.0
    assert att["total_ms"] <= wall_ms * 1.05
    assert att["total_ms"] >= body["timing"]["total_ms"] * 0.95
    # The device stage nests the dispatch thread's exec span, which holds
    # the injected latency, and the device span is the answer's device ms.
    dev = _find(trace["tree"], "device")
    ex = _find(dev, "exec")
    assert ex is not None and ex["attrs"]["lane"] == "latency" and ex["duration_ms"] >= 80.0
    assert ex["duration_ms"] <= dev["duration_ms"] + 0.01
    assert abs(dev["duration_ms"] - float(h["X-Device-Ms"])) <= 0.01
    assert _find(trace["tree"], "batch_form") is not None
    text = _tracedump().render(payload)
    assert trace_id in text and "coverage=" in text
    # The same id rides the latency histograms as an exemplar.
    _, _, prom = _req(srv.port, "GET", "/metrics?format=prometheus")
    prom = prom.decode() if isinstance(prom, bytes) else prom
    assert "tpuserve_device_ms_bucket" in prom
    assert f'# {{trace_id="{trace_id}"}}' in prom
    status, _, listed = _req(srv.port, "GET", "/admin/trace?min_ms=50&limit=5")
    assert any(t["trace_id"] == trace_id for t in listed["traces"])
    assert listed["finished"] >= 1 and "pinned" in listed


def test_error_answers_carry_ids_and_log_them(srv, server_logs):
    status, h, body = _req(srv.port, "POST", "/v1/models/nope:predict", b"x")
    assert status == 404 and body["request_id"] and body["trace_id"]
    assert h["X-Trace-Id"] == body["trace_id"] and h["X-Request-Id"] == body["request_id"]
    status, _, bad = _req(srv.port, "POST", "/v1/models/resnet18:predict", b"not an image",
                          {"Content-Type": "image/png"})
    assert status == 400 and bad["request_id"] and bad["trace_id"]
    logged = {rec.get("trace_id") for rec in server_logs if rec.get("msg") == "request error"}
    assert {body["trace_id"], bad["trace_id"]} <= logged
    for tid in (body["trace_id"], bad["trace_id"]):
        status, _, t = _req(srv.port, "GET", f"/admin/trace/{tid}")
        assert status == 200 and t["trace"]["status"] == "error"
    _, _, errs = _req(srv.port, "GET", "/admin/trace?status=error")
    assert {body["trace_id"], bad["trace_id"]} <= {t["trace_id"] for t in errs["traces"]}
    # Untraced routes still echo or mint the request id.
    _, h, _ = _req(srv.port, "GET", "/healthz", headers={"X-Request-Id": "hz-1"})
    assert h["X-Request-Id"] == "hz-1"
    status, _, gone = _req(srv.port, "GET", "/admin/trace/" + "0" * 32)
    assert status == 404


def test_client_traceparent_round_trips(srv):
    tid, sid = "f" * 32, "1234567890abcdef"
    status, h, _ = _req(srv.port, "POST", "/v1/models/resnet18:predict", _png(1),
                        {"Content-Type": "image/png",
                         "traceparent": format_traceparent(tid, sid)})
    assert status == 200 and h["X-Trace-Id"] == tid
    _, _, t = _req(srv.port, "GET", f"/admin/trace/{tid}")
    assert t["trace"]["remote_parent"] == sid


def test_job_trace_spans_submit_to_done(srv, server_logs):
    status, h, sub = _req(srv.port, "POST", "/v1/models/resnet18:submit", _png(2),
                          {"Content-Type": "image/png"})
    assert status == 202, sub
    trace_id = h["X-Trace-Id"]
    assert sub["job"]["trace_id"] == trace_id
    deadline = time.monotonic() + 60
    while True:
        _, ph, poll = _req(srv.port, "GET", f"/v1/jobs/{sub['job']['id']}",
                           headers={"X-Request-Id": "poll-1"})
        if poll["job"]["status"] in ("done", "error") or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert poll["job"]["status"] == "done", poll
    assert poll["trace_id"] == trace_id and poll["request_id"] == "poll-1"
    assert ph["X-Trace-Id"] == trace_id
    _, _, payload = _req(srv.port, "GET", f"/admin/trace/{trace_id}")
    tree = payload["trace"]["tree"]
    names = [c["name"] for c in tree["children"]]
    assert {"admission", "job_queue", "run"} <= set(names)
    run = next(c for c in tree["children"] if c["name"] == "run")
    dev = next(c for c in run["children"] if c["name"] == "device")
    assert _find(dev, "exec") is not None
    assert payload["trace"]["status"] == "ok"
    assert any(rec.get("trace_id") == trace_id and rec.get("msg") == "job finished"
               for rec in server_logs)


@pytest.mark.parametrize("stream", [False, True])
def test_generation_trace_spans_and_stream_id(srv, stream):
    body = {"input_ids": [5, 6, 7], "stream": stream}
    status, h, out = _req(srv.port, "POST", "/v1/models/gpt2:generate", body,
                          {"X-Request-Id": f"gen-{int(stream)}"})
    assert status == 200
    assert h["X-Stream-Id"] == f"gen-{int(stream)}" == h["X-Request-Id"]
    trace_id = h["X-Trace-Id"]
    if stream:
        events = [json.loads(line[6:]) for line in out.decode().splitlines()
                  if line.startswith("data: ")]
        final = events[-1]
    else:
        final = out["predictions"]
    assert final["stats"]["trace_id"] == trace_id
    _, _, payload = _req(srv.port, "GET", f"/admin/trace/{trace_id}")
    names = [c["name"] for c in payload["trace"]["tree"]["children"]]
    for want in ("admission", "queue", "prefill", "first_segment", "decode", "finish"):
        assert want in names, names
    assert payload["trace"]["status"] == "ok"


def test_admin_trace_filters_over_http(srv):
    _req(srv.port, "POST", "/v1/models/resnet18:predict", _png(3), {"Content-Type": "image/png"})
    _req(srv.port, "POST", "/v1/models/nope:predict", b"x")
    _, _, ok = _req(srv.port, "GET", "/admin/trace?model=resnet18&status=ok")
    assert ok["traces"] and all(t["model"] == "resnet18" and t["status"] == "ok"
                                for t in ok["traces"])
    started = [t["started"] for t in ok["traces"]]
    assert started == sorted(started, reverse=True)
    _, _, one = _req(srv.port, "GET", "/admin/trace?limit=1")
    assert len(one["traces"]) == 1
    status, _, bad = _req(srv.port, "GET", "/admin/trace?min_ms=abc")
    assert status == 400


def test_admin_profile_and_debug_trace_on_the_cpu(srv):
    for body in ({"seconds": "nope"}, {"seconds": 1e9}, {"seconds": 0.01}, [1]):
        status, _, _ = _req(srv.port, "POST", "/admin/profile", body)
        assert status == 400
    results = {}
    stop = threading.Event()

    def profile():
        results["profile"] = _req(srv.port, "POST", "/admin/profile",
                                  {"seconds": 1.0, "top": 5})

    def traffic():
        i = 0
        while not stop.is_set():
            _req(srv.port, "POST", "/v1/models/resnet18:predict", _png(i % 3),
                 {"Content-Type": "image/png"})
            i += 1

    threads = [threading.Thread(target=profile), threading.Thread(target=traffic)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 30
        while not srv.server._tracing and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.server._tracing
        # One profiler a process: a second capture meanwhile is 409.
        status, _, busy = _req(srv.port, "POST", "/debug/trace", {"seconds": 0.1})
        assert status == 409, busy
        threads[0].join(60)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    status, _, body = results["profile"]
    assert status == 200, body
    assert body["seconds"] == 1.0 and 1 <= len(body["ops"]) <= 5
    assert body["device_compute_ms"] > 0 and Path(body["dir"]).is_dir()
    assert all({"op", "ms", "count"} <= set(op) for op in body["ops"])
    # /debug/trace writes a Chrome trace.
    status, _, tr = _req(srv.port, "POST", "/debug/trace", {"seconds": 0.1})
    assert status == 200 and "trace.json" in tr["files"]
    json.loads((Path(tr["dir"]) / "trace.json").read_text())


def test_admin_profile_with_no_work_is_not_an_empty_success(srv):
    status, _, body = _req(srv.port, "POST", "/admin/profile", {"seconds": 0.05})
    assert status == 500 and "no op" in body["error"]


def test_activation_is_traced(tmp_path):
    cfg = ServeConfig(trace_dir=str(tmp_path), lazy_load=True, models=[ModelConfig(
        name="resnet18", batch_buckets=(1,), dtype="float32",
        extra={"image_size": 48, "resize_to": 56})])
    with BackgroundServer(cfg, device="cpu") as s:
        status, _, _ = _req(s.port, "POST", "/v1/models/resnet18:predict", _png(4),
                            {"Content-Type": "image/png"})
        assert status == 200
        _, _, listed = _req(s.port, "GET", "/admin/trace?model=resnet18")
        acts = [t for t in listed["traces"] if t["name"] == "activate"]
        assert len(acts) == 1 and acts[0]["status"] == "ok"
        _, _, t = _req(s.port, "GET", f"/admin/trace/{acts[0]['trace_id']}")
        names = [c["name"] for c in t["trace"]["tree"].get("children", [])]
        assert {"load_weights", "compile"} <= set(names)
        assert t["trace"]["tree"]["attrs"]["cause"] == "request"
