"""The port's durable job journal (``serving/durability.py``) and its
``JobQueue`` replay: ``tests/test_durability.py``'s cases against the port,
and the two packages' journals read by each other.

Unit level, no engine build: journal round trips (bytes payloads
included), replay order, a torn trailing record, compaction, the queue's
replay with Idempotency-Key dedupe across "restarts", the watchdog's
requeue hook and idempotent teardown.  A journal written by either
package must replay in the other to equal record dicts (exact: the
journal is plain JSON).  The real kill -9 proof is
``tests/test_torch_crash_recovery.py``.
"""

import asyncio

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu.serving.durability import JobJournal as JaxJournal
from pytorch_zappa_serverless_tpu_torch.engine.cache import CompileClock
from pytorch_zappa_serverless_tpu_torch.engine.loader import Engine
from pytorch_zappa_serverless_tpu_torch.engine.runner import DeviceRunner
from pytorch_zappa_serverless_tpu_torch.serving.durability import JobJournal, ReplayResult
from pytorch_zappa_serverless_tpu_torch.serving.jobs import JobQueue


# -- journal primitives ----------------------------------------------------------

def test_journal_round_trips_bytes_payloads(tmp_path):
    j = JobJournal(tmp_path, fsync="always")
    j.append({"ev": "submit", "id": "a", "model": "m", "payload": b"\x00raw\xffjpeg",
              "key": "k", "created": 1.0})
    j.append({"ev": "run", "id": "a", "ts": 1.5})
    j.append({"ev": "done", "id": "a", "ts": 2.0,
              "result": {"png_b64": "zz", "raw": b"bytes-in-result"}})
    res = JobJournal(tmp_path).replay()
    assert res.dropped == 0 and len(res.jobs) == 1
    job = res.jobs[0]
    assert job["payload"] == b"\x00raw\xffjpeg"
    assert job["status"] == "done" and job["result"]["raw"] == b"bytes-in-result"
    assert job["key"] == "k"


def test_journal_replay_preserves_submit_order(tmp_path):
    j = JobJournal(tmp_path, fsync="never")
    for i in range(5):
        j.append({"ev": "submit", "id": f"j{i}", "model": "m", "payload": i, "key": None,
                  "created": float(i)})
    j.append({"ev": "done", "id": "j1", "ts": 9.0, "result": {"ok": 1}})
    j.append({"ev": "run", "id": "j2", "ts": 9.5})
    res = j.replay()
    assert [r["id"] for r in res.jobs] == ["j0", "j1", "j2", "j3", "j4"]
    assert {r["id"]: r["status"] for r in res.jobs} == {
        "j0": "queued", "j1": "done", "j2": "queued", "j3": "queued", "j4": "queued"}


def test_journal_tolerates_corrupt_trailing_record(tmp_path):
    j = JobJournal(tmp_path, fsync="never")
    j.append({"ev": "submit", "id": "a", "model": "m", "payload": 1, "key": None,
              "created": 1.0})
    j.append({"ev": "submit", "id": "b", "model": "m", "payload": 2, "key": None,
              "created": 2.0})
    j.close()
    with open(j.path, "a", encoding="utf-8") as f:
        f.write('{"ev": "done", "id": "b", "resu')
    res = JobJournal(tmp_path).replay()
    assert res.dropped == 1
    assert [r["id"] for r in res.jobs] == ["a", "b"]
    assert all(r["status"] == "queued" for r in res.jobs)


def test_journal_rewrite_is_a_compaction(tmp_path):
    j = JobJournal(tmp_path, fsync="never")
    for i in range(10):
        j.append({"ev": "submit", "id": f"j{i}", "model": "m", "payload": None, "key": None,
                  "created": float(i)})
        j.append({"ev": "done", "id": f"j{i}", "ts": float(i), "result": None})
    j.rewrite([{"ev": "submit", "id": "j9", "model": "m", "payload": None, "key": None,
                "created": 9.0},
               {"ev": "done", "id": "j9", "ts": 9.0, "result": None}])
    text = j.path.read_text()
    assert "j9" in text and "j0" not in text
    assert [r["id"] for r in j.replay().jobs] == ["j9"]
    j.append({"ev": "submit", "id": "j10", "model": "m", "payload": None, "key": None,
              "created": 10.0})
    assert len(JobJournal(tmp_path).replay().jobs) == 2


def test_journal_rejects_unknown_fsync_policy(tmp_path):
    with pytest.raises(ValueError, match="journal_fsync"):
        JobJournal(tmp_path, fsync="sometimes")


def test_journal_replay_empty_dir(tmp_path):
    res = JobJournal(tmp_path).replay()
    assert isinstance(res, ReplayResult)
    assert res.jobs == [] and res.dropped == 0


# -- the two packages' journals ----------------------------------------------------

def _records(seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [
        {"ev": "submit", "id": "a", "model": "sd15", "payload": {"prompt": "fox", "seed": 3},
         "key": "ka", "created": 1.25, "trace_id": "t" * 32, "request_id": "r1"},
        {"ev": "submit", "id": "b", "model": "resnet18", "payload": b"\x89PNG\x00\xff",
         "key": None, "created": 2.5},
        {"ev": "submit", "id": "c", "model": "resnet18",
         "payload": rng.integers(0, 255, (8, 8, 3)).astype(np.uint8), "key": "kc",
         "created": 3.0},
        {"ev": "submit", "id": "d", "model": "m",
         "payload": {"instances": [rng.random(4).astype(np.float32), {"x": 1}]}, "key": None,
         "created": 3.5},
        {"ev": "run", "id": "a", "ts": 4.0},
        {"ev": "done", "id": "a", "ts": 5.0, "result": {"image_b64": "aGk=", "raw": b"\x01"}},
        {"ev": "run", "id": "b", "ts": 5.5},
        {"ev": "fail", "id": "b", "ts": 6.0, "error": "RuntimeError: boom"},
        {"ev": "requeue", "id": "b", "ts": 7.0},
        {"ev": "run", "id": "c", "ts": 8.0},
        {"ev": "done", "id": "zz", "ts": 9.0, "result": None},  # an orphan
    ]


def _same(a, b) -> bool:
    """Equal record values, arrays by dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("writer,reader", [(JaxJournal, JobJournal), (JobJournal, JaxJournal)],
                         ids=["jax_writes_port_replays", "port_writes_jax_replays"])
def test_journals_replay_across_packages(tmp_path, writer, reader):
    w = writer(tmp_path / "w", fsync="always")
    for rec in _records():
        w.append(rec)
    w.close()
    own = writer(tmp_path / "w").replay()
    other = reader(tmp_path / "w").replay()
    assert (other.records, other.dropped, other.orphans) == (own.records, own.dropped, own.orphans)
    assert own.orphans == 1 and len(own.jobs) == 4
    assert _same(other.jobs, own.jobs)
    # The compacted form too: each package's rewrite replays in the other.
    snap = [{"ev": "submit", **{k: v for k, v in j.items()
                                if k in ("id", "model", "payload", "key", "created")}}
            for j in own.jobs]
    reader(tmp_path / "r").rewrite(snap)
    assert _same(writer(tmp_path / "r").replay().jobs, reader(tmp_path / "r").replay().jobs)


def test_journal_files_are_byte_identical_across_packages(tmp_path):
    for cls, sub in ((JaxJournal, "jax"), (JobJournal, "port")):
        j = cls(tmp_path / sub, fsync="never")
        for rec in _records(1):
            j.append(rec)
        j.close()
    assert (tmp_path / "port" / "journal.jsonl").read_bytes() == \
        (tmp_path / "jax" / "journal.jsonl").read_bytes()


# -- JobQueue replay and idempotency ----------------------------------------------

async def _drain_until_done(q, ids, timeout_s=5.0):
    deadline = asyncio.get_running_loop().time() + timeout_s
    while asyncio.get_running_loop().time() < deadline:
        if all(q.get(i) and q.get(i).status == "done" for i in ids):
            return True
        await asyncio.sleep(0.01)
    return False


def test_jobqueue_replays_unfinished_jobs_in_order(tmp_path):
    async def main():
        stall = asyncio.Event()

        async def stuck_run_job(job):
            await stall.wait()
            return {"ok": job.payload}

        q1 = JobQueue(stuck_run_job, journal=JobJournal(tmp_path, fsync="always")).start()
        ids = [q1.submit("m", i, idempotency_key=f"k{i}").id for i in range(4)]
        await asyncio.sleep(0.02)
        await q1.stop()  # the "crash": no terminal state journaled
        ran = []

        async def run_job(job):
            ran.append(job.id)
            return {"ok": job.payload}

        q2 = JobQueue(run_job, journal=JobJournal(tmp_path, fsync="always")).start()
        try:
            assert q2.recovered_jobs == 4 and q2.replay_ms >= 0.0
            assert await _drain_until_done(q2, ids)
            assert ran == ids
            for i, jid in enumerate(ids):
                job = q2.get(jid)
                assert job.recovered and job.result == {"ok": i}
                assert q2.dedupe(f"k{i}") is job
                assert q2.submit("m", i, idempotency_key=f"k{i}") is job
            assert len(ran) == 4
            assert q2.deduped_submits == 8
        finally:
            await q2.stop()

    asyncio.run(asyncio.wait_for(main(), 30))


def test_jobqueue_restores_done_results_across_restart(tmp_path):
    async def main():
        async def run_job(job):
            return {"png_b64": f"img-{job.payload}"}

        q1 = JobQueue(run_job, journal=JobJournal(tmp_path, fsync="always")).start()
        jid = q1.submit("m", 7, idempotency_key="done-key").id
        assert await _drain_until_done(q1, [jid])
        await q1.stop()

        async def must_not_run(job):  # noqa: ARG001
            raise AssertionError("a done job must not run again")

        q2 = JobQueue(must_not_run, journal=JobJournal(tmp_path, fsync="always")).start()
        try:
            assert q2.recovered_jobs == 0 and q2.restored_done == 1
            job = q2.get(jid)
            assert job.status == "done" and job.result == {"png_b64": "img-7"}
            assert q2.dedupe("done-key") is job
            snap = q2.durability_snapshot()
            assert snap["restored_done"] == 1 and snap["append_failures"] == 0
        finally:
            await q2.stop()

    asyncio.run(asyncio.wait_for(main(), 30))


def test_jobqueue_concurrent_same_key_submits_create_one_job(tmp_path):
    async def main():
        async def run_job(job):
            return {"ok": 1}

        q = JobQueue(run_job, journal=JobJournal(tmp_path, fsync="never")).start()
        try:
            jobs = [q.submit("m", i, idempotency_key="K") for i in range(8)]
            assert len({j.id for j in jobs}) == 1
            assert q.deduped_submits == 7
        finally:
            await q.stop()

    asyncio.run(asyncio.wait_for(main(), 30))


def test_watchdog_requeue_failed_since(tmp_path):
    async def main():
        fail = [True]

        async def run_job(job):
            if fail[0]:
                raise RuntimeError("injected fatal device fault")
            return {"ok": job.payload}

        q = JobQueue(run_job, journal=JobJournal(tmp_path, fsync="never")).start()
        try:
            old = q.submit("m", 0)
            await asyncio.sleep(0.05)
            assert q.get(old.id).status == "error"
            q.get(old.id).finished -= 500.0
            victim = q.submit("m", 1)
            await asyncio.sleep(0.05)
            assert q.get(victim.id).status == "error"
            fail[0] = False
            assert q.requeue_failed_since(q.get(victim.id).finished - 1.0) == 1
            assert await _drain_until_done(q, [victim.id])
            assert q.get(victim.id).result == {"ok": 1}
            assert q.get(old.id).status == "error"
        finally:
            await q.stop()
        # The requeue is journaled between the failure and the rerun.
        evs = [ln for ln in (tmp_path / "journal.jsonl").read_text().splitlines()
               if victim.id in ln]
        assert [__import__("json").loads(ln)["ev"] for ln in evs] == \
            ["submit", "run", "fail", "requeue", "run", "done"]

    asyncio.run(asyncio.wait_for(main(), 30))


def test_journal_append_failure_is_counted_not_raised(tmp_path):
    class Broken(JobJournal):
        def append(self, record):
            raise OSError("disk full")

    async def main():
        async def run_job(job):
            return {"ok": 1}

        q = JobQueue(run_job, journal=Broken(tmp_path, fsync="never")).start()
        try:
            job = q.submit("m", 1)
            assert await _drain_until_done(q, [job.id])
            # submit, run, done: each failed, each counted; serving went on.
            assert q.durability_snapshot()["append_failures"] == 3
        finally:
            await q.stop()

    asyncio.run(asyncio.wait_for(main(), 30))


# -- idempotent teardown ----------------------------------------------------------

def test_jobqueue_stop_is_idempotent(tmp_path):
    async def main():
        async def run_job(job):
            return {"ok": 1}

        q = JobQueue(run_job, journal=JobJournal(tmp_path, fsync="never")).start()
        q.submit("m", 1)
        await q.stop()
        await q.stop()
        with pytest.raises(RuntimeError):
            q.submit("m", 2)

    asyncio.run(asyncio.wait_for(main(), 30))


def test_device_runner_shutdown_is_idempotent():
    r = DeviceRunner("cpu")
    r.shutdown()
    r.shutdown()
    assert r.closed
    assert r.probe() is False
    with pytest.raises(RuntimeError):
        r.run_fn_sync(lambda: 1)


def test_engine_shutdown_is_idempotent():
    import torch

    eng = Engine(models={}, runner=DeviceRunner("cpu"), clock=CompileClock(),
                 device=torch.device("cpu"))
    eng.shutdown()
    eng.shutdown()
    assert eng.runner.closed


# -- the journal behind the port's server ---------------------------------------------

def _server_cfg(journal):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    return ServeConfig(journal_dir=str(journal), journal_fsync="always", models=[ModelConfig(
        name="resnet18", batch_buckets=(1,), dtype="float32",
        extra={"image_size": 48, "resize_to": 56})])


def _http(port, method, path, body=None, headers=None):
    import json
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_journal_dedupes_across_a_restart_and_reports_the_replay(tmp_path):
    """Two server lifetimes on one journal: the second replays the first's
    jobs, ``/healthz`` and ``/metrics`` report the replay under the
    reference's names, a resubmit with the header or the body key answers
    the original job before any work, and the journal's Prometheus families
    fit the manifest."""
    import base64
    import importlib.util
    import time
    from pathlib import Path

    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    arr = np.random.default_rng(0).integers(0, 255, (48, 48, 3)).astype(np.uint8).tolist()
    cfg = _server_cfg(tmp_path / "journal")
    with BackgroundServer(cfg, device="cpu") as s:
        status, health = _http(s.port, "GET", "/healthz")
        assert status == 200 and health["durability"]["recovered_jobs"] == 0
        status, a = _http(s.port, "POST", "/v1/models/resnet18:submit", arr,
                          {"Idempotency-Key": "k-head"})
        assert status == 202
        status, b = _http(s.port, "POST", "/v1/models/resnet18:submit",
                          {"b64": base64.b64encode(b"not an image").decode(),
                           "idempotency_key": "k-body"})
        assert status == 202
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            jobs = [_http(s.port, "GET", f"/v1/jobs/{j['job']['id']}")[1]["job"] for j in (a, b)]
            if all(j["status"] in ("done", "error") for j in jobs):
                break
            time.sleep(0.02)
        assert [j["status"] for j in jobs] == ["done", "error"]
    with BackgroundServer(_server_cfg(tmp_path / "journal"), device="cpu") as s:
        status, health = _http(s.port, "GET", "/healthz")
        dur = health["durability"]
        assert dur["restored_done"] == 2 and dur["recovered_jobs"] == 0
        assert dur["replay_ms"] >= 0 and dur["journal"]["fsync"] == "always"
        status, again = _http(s.port, "POST", "/v1/models/resnet18:submit", arr,
                              {"Idempotency-Key": "k-head"})
        assert status == 200 and again["deduped"] and again["job"]["id"] == a["job"]["id"]
        assert again["job"]["status"] == "done" and again["job"]["recovered"]
        status, again = _http(s.port, "POST", "/v1/models/resnet18:submit",
                              {"b64": "", "idempotency_key": "k-body"})
        assert status == 200 and again["job"]["id"] == b["job"]["id"]
        m = _http(s.port, "GET", "/metrics")[1]
        assert m["durability"]["deduped_submits"] == 2 and m["durability"]["restored_done"] == 2
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/metrics?format=prometheus",
                                    timeout=60) as r:
            text = r.read().decode()
    for family in ("tpuserve_journal_records_appended_total", "tpuserve_journal_replay_ms",
                   "tpuserve_restored_done_jobs", "tpuserve_idempotent_dedupes_total"):
        assert f"# TYPE {family} " in text
    spec = importlib.util.spec_from_file_location(
        "tpuserve_check_metrics", Path(__file__).resolve().parents[1] / "tools" / "check_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.check(text, mod.load_manifest()) == []
