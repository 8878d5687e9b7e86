"""The port's async job lane on the CPU: ``:submit`` → poll ``/v1/jobs/{id}``.

A TINY sd15 (64x64, 20 steps in five 4-step chunks) is served beside a tiny
BERT, so the job lane shares the device lane with a latency-class model, as
the JAX package's ``tests/test_sd15.py``, ``tests/test_qos.py`` and
``tests/test_batcher_jobs.py`` drive it.  The queue's own contracts
(coalescing, per-job failure isolation, retention) are held on the port's
``JobQueue`` with stand-in run functions, as the JAX tests hold them.
"""

import asyncio
import base64
import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.serving.jobs import JobQueue
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer, Server

SD15 = ModelConfig(name="sd15", dtype="float32", batch_buckets=(1,),
                   extra={"variant": "tiny", "height": 64, "width": 64, "num_steps": 20,
                          "chunk_steps": 4})
BERT = ModelConfig(name="bert_base", dtype="float32", seq_buckets=(8,), batch_buckets=(1,),
                   extra={"arch": {"num_layers": 1, "num_heads": 2, "head_dim": 8,
                                   "mlp_dim": 32, "vocab_size": 128, "max_position": 16}})


@pytest.fixture(scope="module")
def cfg():
    return ServeConfig(models=[SD15, BERT], job_max_backlog=2)


@pytest.fixture(scope="module")
def engine(cfg):
    eng = build_engine(cfg, device="cpu")
    # One whole job through the engine before any test starts a clock: the
    # first job's one-time costs are paid here, so a test's 60 s wait times
    # its own job alone, however loaded the machine.
    cm = eng.model("sd15")
    [warm] = asyncio.run(eng.runner.run_chunked(
        cm, [cm.servable.preprocess({"prompt": "warm-up", "seed": 0})]))
    assert warm["pixels"].shape == (64, 64, 3)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def server(cfg, engine):
    with BackgroundServer(cfg, engine) as s:
        yield s


def _http(port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _wait_done(port, job_id, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status, body, _ = _http(port, f"/v1/jobs/{job_id}")
        if body["job"]["status"] in ("done", "error"):
            return status, body["job"]
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} did not finish")


def test_submit_poll_png(server):
    status, body, _ = _http(server.port, "/v1/models/sd15:submit",
                            {"prompt": "a red fox", "seed": 7})
    assert status == 202 and body["job"]["status"] in ("queued", "running")
    status, job = _wait_done(server.port, body["job"]["id"])
    assert status == 200 and job["status"] == "done", job
    result = job["result"]
    assert result["format"] == "png" and (result["height"], result["width"]) == (64, 64)
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(result["image_b64"])))
    assert img.size == (64, 64) and img.mode == "RGB"
    assert np.asarray(img).std() > 1.0


def test_predict_on_async_model_is_405_and_unknown_job_404(server):
    status, body, _ = _http(server.port, "/v1/models/sd15:predict", {"prompt": "x"})
    assert status == 405 and ":submit" in body["error"] and "async-only" in body["error"]
    status, body, _ = _http(server.port, "/v1/jobs/no-such-job")
    assert status == 404 and body["error"] == "unknown job id"
    status, _, _ = _http(server.port, "/v1/models/nope:submit", {"prompt": "x"})
    assert status == 404


def test_models_healthz_metrics_show_the_job_lane(server):
    _, body, _ = _http(server.port, "/v1/models")
    assert body["models"]["sd15"]["async_only"] is True
    assert body["models"]["sd15"]["endpoint"] == "/v1/models/sd15:submit"
    assert body["models"]["bert_base"]["endpoint"] == "/v1/models/bert_base:predict"
    _, body, _ = _http(server.port, "/healthz")
    assert body["jobs_backlog"] == 0 and "sd15" not in body["queue_depths"]
    _, body, _ = _http(server.port, "/metrics")
    assert {"backlog", "active", "backlog_by_model"} <= set(body["jobs"])


def test_idempotent_resubmit_returns_the_same_job(server):
    key = {"Idempotency-Key": "fox-1"}
    status, first, _ = _http(server.port, "/v1/models/sd15:submit",
                             {"prompt": "a fox", "seed": 1}, key)
    assert status == 202
    status, again, _ = _http(server.port, "/v1/models/sd15:submit",
                             {"prompt": "a fox", "seed": 1}, key)
    assert status == 200 and again["deduped"] is True
    assert again["job"]["id"] == first["job"]["id"]
    _wait_done(server.port, first["job"]["id"])


def test_full_backlog_is_429_and_expired_is_410(server, engine):
    gate = threading.Event()
    blocker = engine.runner._pool.submit(gate.wait)  # hold the device lane
    accepted, refused = [], None
    try:
        for i in range(6):
            status, body, headers = _http(server.port, "/v1/models/sd15:submit",
                                          {"prompt": f"fox {i}"})
            if status == 429:
                refused = (body, headers)
                break
            assert status == 202
            accepted.append(body["job"]["id"])
            time.sleep(0.05)  # let the worker pop the head of the lane
    finally:
        gate.set()
        blocker.result(30)
    assert refused is not None and len(accepted) <= 3  # one running + a backlog of 2
    body, headers = refused
    assert int(headers["Retry-After"]) >= 1 and body["max_backlog"] == 2
    for jid in accepted:
        assert _wait_done(server.port, jid)[1]["status"] == "done"
    job = server.server.jobs.get(accepted[0])
    job.result, job.status = None, "expired"  # as the retention budget leaves it
    status, body, _ = _http(server.port, f"/v1/jobs/{accepted[0]}")
    assert status == 410 and "resubmit" in body["job"]["error"]
    assert "result_ttl_s" in body["expired"]


def test_latency_request_preempts_between_chunks(engine):
    """A latency dispatch submitted while the image is in its first chunk
    runs after that chunk, not after the remaining four."""
    cm = engine.model("sd15")
    runner = engine.runner
    ch = cm.servable.meta["chunked"]
    orig_chunk = ch["chunk"]
    order: list[str] = []  # appended only from the dispatch thread
    started, release = threading.Event(), threading.Event()

    def gated(p, state, rows):
        first = not started.is_set()
        started.set()
        if first:
            assert release.wait(timeout=30)
        out = orig_chunk(p, state, rows)
        order.append("chunk")
        return out

    async def drive():
        sample = cm.servable.preprocess({"prompt": "a gpu", "seed": 1})
        image_task = asyncio.ensure_future(runner.run_chunked(cm, [sample]))
        await asyncio.get_running_loop().run_in_executor(None, started.wait)
        latency_task = asyncio.wrap_future(runner._pool.submit(order.append, "latency"))
        await asyncio.sleep(0)  # let run_fn enqueue before opening the gate
        release.set()
        await latency_task
        assert not image_task.done(), "latency work waited for the whole image"
        return await image_task

    ch["chunk"] = gated
    try:
        [result] = asyncio.run(drive())
    finally:
        ch["chunk"] = orig_chunk
    assert result["pixels"].shape == (64, 64, 3)
    assert order.index("latency") == 1, order
    assert order.count("chunk") == 5, order


def _sd15_b4():
    return dataclasses.replace(SD15, batch_buckets=(1, 4), extra=dict(SD15.extra))


def test_job_coalescing_capped_when_latency_models_coresident():
    mixed = ServeConfig(models=[_sd15_b4(), BERT])
    eng = build_engine(mixed, device="cpu", warmup=False)
    try:
        s = Server(mixed, eng)
        assert s._job_batch_of("sd15") == 1
        eng.model("sd15").cfg.extra["job_batch_mixed_cap"] = 3
        assert s._job_batch_of("sd15") == 3
        assert s._job_batch_of("bert_base") == 1  # its own max_batch, never capped
    finally:
        eng.shutdown()
    solo = ServeConfig(models=[_sd15_b4()])
    eng = build_engine(solo, device="cpu", warmup=False)
    try:
        assert Server(solo, eng)._job_batch_of("sd15") == 4
    finally:
        eng.shutdown()


async def _until(jobs, statuses=("done", "error"), n=400):
    for _ in range(n):
        if all(j.status in statuses for j in jobs):
            return
        await asyncio.sleep(0.01)


def test_jobs_coalesce_into_one_batch():
    """With run_jobs + batch_of, backlogged same-model jobs share ONE batch;
    a lone job still takes the single-job path."""
    async def drive():
        release = asyncio.Event()
        calls = []

        async def run_job(job):
            calls.append(("single", [job.payload]))
            await release.wait()
            return {"n": job.payload}

        async def run_jobs(jobs):
            calls.append(("batch", [j.payload for j in jobs]))
            return [{"n": j.payload} for j in jobs]

        q = JobQueue(run_job, run_jobs=run_jobs, batch_of=lambda m: 4).start()
        try:
            first = q.submit("sd15", 0)
            await asyncio.sleep(0.05)  # the worker picks up the lone job
            backlog = [q.submit("sd15", i) for i in (1, 2, 3, 4, 5)]
            release.set()
            jobs = [first, *backlog]
            await _until(jobs)
            return calls, jobs
        finally:
            await q.stop()

    calls, jobs = asyncio.run(drive())
    assert [j.status for j in jobs] == ["done"] * 6
    assert [j.result["n"] for j in jobs] == [0, 1, 2, 3, 4, 5]
    assert calls[0] == ("single", [0])
    assert ("batch", [1, 2, 3, 4]) in calls


def test_job_batch_per_job_failure_isolated():
    """run_jobs may return an Exception entry: that job fails alone."""
    async def drive():
        gate = asyncio.Event()

        async def gated(job):
            await gate.wait()
            return {"ok": job.payload}

        async def run_jobs(jobs):
            return [ValueError("bad payload") if j.payload == "bad"
                    else {"ok": j.payload} for j in jobs]

        q = JobQueue(gated, run_jobs=run_jobs, batch_of=lambda m: 4).start()
        try:
            lone = q.submit("m", "warm")
            await asyncio.sleep(0.05)
            jobs = [lone, q.submit("m", "a"), q.submit("m", "bad"), q.submit("m", "b")]
            gate.set()
            await _until(jobs)
            return jobs
        finally:
            await q.stop()

    _, good1, bad, good2 = asyncio.run(drive())
    assert good1.status == "done" and good1.result == {"ok": "a"}
    assert good2.status == "done" and good2.result == {"ok": "b"}
    assert bad.status == "error" and "bad payload" in bad.error


def test_server_run_jobs_isolates_a_bad_payload(engine, cfg):
    """The server's batched lane: a payload that fails preprocess fails its
    own job; the batch-mate still gets its image."""
    s = Server(cfg, engine)

    class J:
        def __init__(self, payload):
            self.model, self.payload = "sd15", payload

    async def drive():
        return await s._run_jobs([J({"prompt": "a fox", "seed": 2}), J({"no": "prompt"})])

    good, bad = asyncio.run(drive())
    assert isinstance(bad, ValueError) and "prompt" in str(bad)
    assert good["format"] == "png" and good["height"] == 64


def test_job_result_retention_budget():
    async def drive():
        async def run_job(job):
            return {"image_b64": "x" * 1024}

        # 2.5 KB budget → two 1 KB results retained, older ones expired.
        q = JobQueue(run_job, max_result_mb=2.5 / 1024).start()
        try:
            jobs = [q.submit("m", i) for i in range(4)]
            await _until(jobs, ("done", "expired"))
            q.submit("m", 99)  # trigger gc
            await asyncio.sleep(0.05)
            return jobs
        finally:
            await q.stop()

    jobs = asyncio.run(drive())
    statuses = [j.status for j in jobs]
    assert statuses[-1] == "done" and "expired" in statuses
    expired = next(j for j in jobs if j.status == "expired")
    assert expired.result is None and "resubmit" in expired.public()["error"]


def test_stopped_queue_refuses_with_503(cfg, engine):
    async def drive():
        s = Server(cfg, engine)
        s.jobs = JobQueue(s._run_job).start()
        await s.jobs.stop()
        return await s.handle_submit("sd15", b'{"prompt": "x"}', {})

    status, body, headers = asyncio.run(drive())
    assert status == 503 and "shut down" in body["error"] and int(headers["Retry-After"]) >= 1


def test_drain_waits_for_queued_and_running_jobs():
    async def drive():
        gate = asyncio.Event()

        async def run_job(job):
            await gate.wait()
            return {"n": job.payload}

        q = JobQueue(run_job).start()
        try:
            jobs = [q.submit("m", i) for i in range(2)]
            timed_out = await q.drain(0.1)
            gate.set()
            drained = await q.drain(5.0)
            return timed_out, drained, jobs
        finally:
            await q.stop()

    timed_out, drained, jobs = asyncio.run(drive())
    assert timed_out is False and drained is True
    assert [j.status for j in jobs] == ["done", "done"]


def test_result_ttl_expires_then_drops_the_record():
    """Past result_ttl_s a result expires; past 4x it the record and its
    idempotency key go (the injectable clock stands in for wall time)."""
    now = [1000.0]

    async def drive():
        async def run_job(job):
            return {"image_b64": "x"}

        q = JobQueue(run_job, result_ttl_s=10.0, clock=lambda: now[0]).start()
        try:
            job = q.submit("m", 0, idempotency_key="k")
            await _until([job])
            now[0] += 11.0
            q._gc()
            expired = (job.status, job.result)
            now[0] += 40.0
            q._gc()
            return job, expired, q.get(job.id), q.dedupe("k")
        finally:
            await q.stop()

    job, expired, after, deduped = asyncio.run(drive())
    assert expired == ("expired", None)
    assert after is None and deduped is None


class _Replay:
    def __init__(self, jobs):
        self.jobs, self.dropped = jobs, 1


class _FakeJournal:
    """The JAX package's JobJournal interface, in memory."""

    def __init__(self, records):
        self.records, self.events, self.rewritten, self.closed = records, [], None, False

    def replay(self):
        return _Replay(self.records)

    def append(self, event):
        self.events.append(event)

    def rewrite(self, records):
        self.rewritten = records

    def close(self):
        self.closed = True


def test_journal_hook_replays_unfinished_and_restores_done_jobs():
    def rec(jid, status, **kw):
        return {"id": jid, "model": "m", "payload": jid, "created": 1.0, "key": f"key-{jid}",
                "status": status, "started": None, "finished": kw.get("finished"),
                "result": kw.get("result"), "error": None}

    journal = _FakeJournal([rec("a", "done", finished=time.time(), result={"n": "a"}),
                            rec("b", "queued")])

    async def drive():
        async def run_job(job):
            return {"n": job.payload}

        q = JobQueue(run_job, journal=journal).start()
        try:
            b = q.get("b")
            await _until([b])
            return q, q.get("a"), b, q.dedupe("key-a")
        finally:
            await q.stop()

    q, a, b, deduped = asyncio.run(drive())
    assert a.recovered and a.status == "done" and a.result == {"n": "a"}
    assert b.recovered and b.status == "done" and b.result == {"n": "b"}
    assert deduped is a and (q.recovered_jobs, q.restored_done, q.dropped_records) == (1, 1, 1)
    assert [r["ev"] for r in journal.rewritten] == ["submit", "done", "submit"]
    assert [(e["ev"], e["id"]) for e in journal.events] == [("run", "b"), ("done", "b")]
    assert journal.closed
