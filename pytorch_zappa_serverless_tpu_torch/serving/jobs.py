"""Async job queue for latency-tolerant endpoints (SD-1.5 txt2img).

The port's copy of the JAX package's ``serving/jobs.py`` (standard library
only).  A multi-second denoise loop must not occupy an HTTP connection or
block the batcher: submit returns a job id at once, a per-model worker lane
drains jobs through the device runner, and clients poll
``GET /v1/jobs/{id}``.

Durability: with a :class:`~.durability.JobJournal` (``journal_dir``)
every state transition is journaled, so a 202-acknowledged submit survives
a ``kill -9``.  ``start()`` replays it: submitted and running jobs
re-enqueue in their submit order, done results come back from disk (then
bounded by the same retention knobs as live ones), and the idempotency-key
map is rebuilt, so a client that retries ``:submit`` with its
``Idempotency-Key`` after the crash gets its original job id back.  A
journal append that fails is logged and counted: durability never fails
serving.  Tracing: a job carries its submit request's root span; the
worker adds ``job_queue``, ``run`` and ``journal`` spans and finishes the
trace at the job's terminal state.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

from ..utils.logging import get_logger, log_event

log = get_logger("serving.jobs")


@dataclass
class Job:
    id: str
    model: str
    payload: Any
    status: str = "queued"  # queued | running | done | error
    created: float = field(default_factory=time.time)
    started: float | None = None
    finished: float | None = None
    result: Any = None
    error: str | None = None
    # Client-supplied Idempotency-Key: dedupes resubmits (across restarts,
    # via the journal) back to this job instead of double-running it.
    key: str | None = None
    # True when this job was restored from the journal at boot.
    recovered: bool = False
    # Observability (docs/OBSERVABILITY.md): the submit request's ids —
    # journaled, so a recovered job still answers polls with the trace that
    # acknowledged it.  ``span`` is the live root span (never journaled);
    # the worker parents queue/run/journal spans under it and finishes the
    # trace at the job's terminal transition.
    trace_id: str | None = None
    request_id: str | None = None
    span: Any = None
    run_span: Any = None
    # perf_counter at (re-)enqueue: the queue-wait span's start anchor.
    t_enq: float = field(default_factory=time.perf_counter)

    def public(self) -> dict:
        out = {"id": self.id, "model": self.model, "status": self.status,
               "created": self.created}
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.request_id:
            out["request_id"] = self.request_id
        if self.key:
            out["idempotency_key"] = self.key
        if self.recovered:
            out["recovered"] = True
        if self.started:
            out["started"] = self.started
        if self.finished:
            out["finished"] = self.finished
            out["seconds"] = round(self.finished - (self.started or self.created), 3)
        if self.status == "done":
            out["result"] = self.result
        if self.status == "expired":
            out["error"] = "result evicted from the retention budget; resubmit"
        if self.error:
            out["error"] = self.error
        return out

    def result_bytes(self) -> int:
        """Rough retained-heap estimate — dominated by base64 image payloads."""
        if not isinstance(self.result, dict):
            return 0
        return sum(len(v) for v in self.result.values() if isinstance(v, (str, bytes)))


class JobQueue:
    """Async job executor with one worker lane per model.

    Per-model lanes (not one global worker): a 900 ms SD-1.5 denoise must not
    head-of-line-block a fast async job on another model.  Within a model,
    jobs still run strictly FIFO one-at-a-time — the device runner serializes
    dispatch anyway, and per-model FIFO keeps submit→finish ordering the
    property clients can rely on.  Lanes spawn lazily on the first submit for
    a model and share the sweeper/retention machinery.
    """

    def __init__(self, run_job: Callable, max_backlog: int = 64, keep_done: int = 256,
                 max_result_mb: float = 64.0, result_ttl_s: float = 900.0,
                 clock: Callable[[], float] = time.time,
                 run_jobs: Callable | None = None,
                 batch_of: Callable[[str], int] | None = None,
                 journal=None, tracer=None):
        self._run_job = run_job  # async (job) -> result
        # Optional batch lane: ``run_jobs`` (async (list[Job]) -> list[result])
        # plus ``batch_of(model)`` (max jobs to coalesce, 1 = off).  Queued
        # same-model jobs then share ONE device batch, which raises a
        # backlogged lane's throughput with no API change.  QoS caveat:
        # coalescing multiplies every dispatch's uninterruptible occupancy,
        # so the server CAPS batch_of when latency-class models share the
        # engine (server._job_batch_of).
        self._run_jobs = run_jobs
        self._batch_of = batch_of or (lambda model: 1)
        self._max_backlog = max_backlog  # per-model lane bound
        self._queues: dict[str, asyncio.Queue[Job]] = {}  # guarded-by: event-loop
        self._workers: dict[str, asyncio.Task] = {}  # guarded-by: event-loop
        self._jobs: dict[str, Job] = {}  # guarded-by: event-loop
        self._keep_done = keep_done
        # Retained-result heap budget: SD-1.5 results are ~0.5 MB of base64
        # each, so a count-only cap would pin hundreds of MB on the host.
        self._max_result_bytes = int(max_result_mb * 1024 * 1024)
        # Wall-clock retention: a dead client's results must not pin host RAM
        # until keep_done newer jobs displace them.  Results expire after
        # result_ttl_s; the record itself (status/timing) lingers 4x longer
        # for late pollers, then drops.  clock is injectable for tests.
        self._result_ttl_s = result_ttl_s
        self._clock = clock
        self._stopped = False  # guarded-by: event-loop
        self._sweeper: asyncio.Task | None = None  # guarded-by: event-loop
        # Job groups currently executing (not just queued): what drain waits
        # on after the backlog empties.
        self._active = 0  # guarded-by: event-loop
        # Durability: journal + idempotency map + the recovery stats.
        self._journal = journal
        # Tracer: finishing a job trace through the tracer lands it in its
        # ring; None = trace-less.
        self._tracer = tracer
        self._by_key: dict[str, str] = {}  # guarded-by: event-loop
        self._replayed = False  # guarded-by: event-loop
        # Replay/dedupe counters (all event-loop-confined):
        self.recovered_jobs = 0   # guarded-by: event-loop
        self.restored_done = 0    # guarded-by: event-loop
        self.dropped_records = 0  # guarded-by: event-loop
        self.replay_ms = 0.0      # guarded-by: event-loop
        self.deduped_submits = 0  # guarded-by: event-loop
        self.journal_append_failures = 0  # guarded-by: event-loop

    def start(self):
        if self._sweeper is None:
            self._stopped = False
            loop = asyncio.get_running_loop()
            self._sweeper = loop.create_task(self._sweep(), name="jobs-ttl")
            if self._journal is not None and not self._replayed:
                self._replayed = True
                try:
                    self._replay()
                except Exception:
                    # A broken journal must not brick boot: serve fresh and
                    # loudly — the operator still has the file on disk.
                    log.exception("journal replay failed; starting empty")
        return self

    def _journal_event(self, ev: str, job: Job, **extra):
        """Best-effort journal append: durability must never fail serving.

        Traced: each append (an fsync under ``journal_fsync: always``) is a
        ``journal`` span on the job's trace — persistence cost is part of
        the request's story, not invisible overhead.
        """
        if self._journal is None:
            return
        sp = (job.span.child("journal", ev=ev)
              if job.span is not None else None)
        try:
            self._journal.append({"ev": ev, "id": job.id,
                                  "ts": self._clock(), **extra})
        except Exception:
            self.journal_append_failures += 1
            log.exception("journal append failed (ev=%s job=%s)", ev, job.id)
            if sp is not None:
                sp.end(status="error")
            return
        if sp is not None:
            sp.end()

    def _replay(self):
        """Rebuild queue state from the journal (crash recovery).

        Unfinished (submitted/running-at-crash) jobs re-enqueue in original
        submit order; done/error jobs are restored — results included — then
        bounded by the normal retention knobs; the idempotency map covers
        every surviving job.  Finishes by compacting the journal to a
        snapshot of the survivors so it cannot grow without bound.
        """
        t0 = time.perf_counter()
        res = self._journal.replay()
        requeue: list[Job] = []
        for rec in res.jobs:
            job = Job(id=rec["id"], model=rec["model"], payload=rec["payload"],
                      created=rec["created"], key=rec["key"], recovered=True,
                      status=rec["status"], started=rec["started"],
                      finished=rec["finished"], result=rec["result"],
                      error=rec["error"], trace_id=rec.get("trace_id"),
                      request_id=rec.get("request_id"))
            self._jobs[job.id] = job
            if job.key:
                self._by_key[job.key] = job.id
            if job.status == "queued":
                job.started = None
                requeue.append(job)
            else:
                self.restored_done += 1
        # Retention first: restored done results obey the same byte/TTL/count
        # budgets as live ones (a huge pre-crash backlog must not pin RAM).
        try:
            self._gc()
        except Exception:
            log.exception("job gc failed during replay")
        for job in requeue:
            try:
                self._lane(job.model).put_nowait(job)
            except asyncio.QueueFull:
                job.status, job.error = "error", "replay: job backlog full"
                job.finished = self._clock()
                continue
            self.recovered_jobs += 1
        self.dropped_records = res.dropped
        self.replay_ms = round((time.perf_counter() - t0) * 1000.0, 3)
        try:
            self._compact()
        except Exception:
            log.exception("journal compaction failed; journal keeps growing")
        if res.jobs or res.dropped:
            log_event(log, "journal replayed",
                      recovered=self.recovered_jobs,
                      restored_done=self.restored_done,
                      dropped_records=res.dropped,
                      replay_ms=self.replay_ms)

    def _compact(self):
        """Rewrite the journal as a snapshot of the surviving jobs."""
        records: list[dict] = []
        for job in self._jobs.values():  # dict preserves submit order
            records.append({"ev": "submit", "id": job.id, "model": job.model,
                            "payload": job.payload, "key": job.key,
                            "created": job.created, "trace_id": job.trace_id,
                            "request_id": job.request_id})
            if job.status == "done":
                records.append({"ev": "done", "id": job.id,
                                "ts": job.finished, "result": job.result})
            elif job.status in ("error", "expired"):
                records.append({"ev": "fail", "id": job.id,
                                "ts": job.finished, "error": job.error})
        self._journal.rewrite(records)

    async def stop(self):
        """Stop workers + sweeper; terminal-fail whatever cannot finish.

        Idempotent: a second (or
        concurrent) call finds no live tasks and changes nothing.  Journal
        note: shutdown-stranded jobs are NOT journaled as failures — their
        journal state stays submitted/running, which is exactly what makes
        the next boot re-enqueue them (the in-memory "error" status below
        only informs pollers of *this* process's lifetime).
        """
        self._stopped = True
        tasks = list(self._workers.values())
        if self._sweeper is not None:
            tasks.append(self._sweeper)
            self._sweeper = None
        self._workers.clear()
        for task in tasks:
            task.cancel()
        for task in tasks:
            try:
                await task
            except asyncio.CancelledError:
                pass
        # Jobs still queued OR mid-run will never finish in this lifecycle
        # (worker cancellation aborts the in-flight _run_job): fail them
        # loudly so pollers see a terminal status, not an eternal
        # "queued"/"running", and drop the queues so a later start()
        # respawns fresh lanes with workers.
        for q in self._queues.values():
            while not q.empty():
                q.get_nowait()
        for job in self._jobs.values():
            if job.status in ("queued", "running"):
                job.status, job.error = "error", "job queue shut down before finish"
                job.finished = self._clock()
                self._finish_trace(job)
        self._queues.clear()
        if self._journal is not None:
            self._journal.close()

    def _finish_trace(self, job: Job):
        """Close the job's trace at a terminal transition (idempotent).

        Through the tracer when wired (ring + flight-recorder pinning);
        directly otherwise.
        """
        if job.span is None:
            return
        status = "ok" if job.status == "done" else "error"
        if self._tracer is not None:
            self._tracer.finish(job.span.trace, status)
        else:
            job.span.trace.finish(status)

    def _lane(self, model: str) -> asyncio.Queue:
        """Per-model queue + worker, spawned on first submit for the model."""
        q = self._queues.get(model)
        if q is None:
            q = self._queues[model] = asyncio.Queue(maxsize=self._max_backlog)
            self._workers[model] = asyncio.get_running_loop().create_task(
                self._worker(q), name=f"jobs-{model}")
        return q

    def dedupe(self, idempotency_key: str | None) -> Job | None:
        """The job a prior submit with this key created, if still known.

        A hit counts toward ``deduped_submits``; a stale map entry (the job
        fell out of retention) is scrubbed and misses — after that the key
        is genuinely new again, which is the documented retention bound on
        idempotency (docs/RESILIENCE.md).
        """
        if not idempotency_key:
            return None
        jid = self._by_key.get(idempotency_key)
        job = self._jobs.get(jid) if jid else None
        if job is None:
            if jid:
                self._by_key.pop(idempotency_key, None)
            return None
        self.deduped_submits += 1
        return job

    def submit(self, model: str, payload: Any,
               idempotency_key: str | None = None, span=None,
               request_id: str | None = None) -> Job:
        if self._stopped:
            # Distinct from the backlog-full OverflowError: full → 429 (retry
            # later); shut down → 503 (fail over, don't retry this process).
            raise RuntimeError("job queue is shut down")
        if idempotency_key:
            # Defensive atomic dedupe (no awaits since any caller-side
            # check): two same-key submits racing on the loop can never both
            # create — the second gets the first's job back.
            jid = self._by_key.get(idempotency_key)
            prior = self._jobs.get(jid) if jid else None
            if prior is not None:
                self.deduped_submits += 1
                return prior
        job = Job(id=uuid.uuid4().hex[:16], model=model, payload=payload,
                  created=self._clock(), key=idempotency_key, span=span,
                  trace_id=(span.trace.trace_id if span is not None else None),
                  request_id=request_id)
        try:
            self._lane(model).put_nowait(job)
        except asyncio.QueueFull:
            raise OverflowError(
                f"job backlog full for {model!r} ({self._max_backlog})") from None
        self._jobs[job.id] = job
        if idempotency_key:
            self._by_key[idempotency_key] = job.id
        # Journal BEFORE returning: with fsync "always" the 202 the caller
        # sends means "this job is on disk" — the crashtest contract.
        self._journal_event("submit", job, model=job.model, payload=job.payload,
                            key=job.key, created=job.created,
                            trace_id=job.trace_id, request_id=job.request_id)
        try:
            self._gc()
        except Exception:
            # Retention is best-effort bookkeeping: a scan bug must not fail
            # the (already enqueued) submit; the sweeper retries anyway.
            log.exception("job gc failed at submit")
        return job

    def requeue_failed_since(self, ts: float) -> int:
        """Re-enqueue the jobs that failed terminally at or after ``ts``.

        The watchdog's heal step: jobs the fatal outage killed get a fresh
        run on the rebuilt engine under their original ids, journaled as a
        ``requeue`` transition.  Returns how many were requeued.
        """
        n = 0
        for job in list(self._jobs.values()):
            if job.status != "error" or job.finished is None or job.finished < ts:
                continue
            job.status, job.error, job.started, job.finished = "queued", None, None, None
            job.t_enq = time.perf_counter()
            try:
                self._lane(job.model).put_nowait(job)
            except asyncio.QueueFull:
                job.status, job.error = "error", "recovery requeue: backlog full"
                job.finished = self._clock()
                continue
            self._journal_event("requeue", job)
            if job.span is not None:
                # The trace finished with the outage's error; the requeue and
                # the rerun's spans still land on its tree.
                job.span.point("watchdog_requeue")
            n += 1
        if n:
            log_event(log, "failed jobs requeued after recovery", count=n)
        return n

    def get(self, job_id: str) -> Job | None:
        return self._jobs.get(job_id)

    def durability_snapshot(self) -> dict | None:
        """The journal's and the replay's numbers for /metrics and /healthz
        (None with durability off)."""
        if self._journal is None:
            return None
        return {"journal": self._journal.snapshot(),
                "recovered_jobs": self.recovered_jobs,
                "restored_done": self.restored_done,
                "dropped_records": self.dropped_records,
                "replay_ms": self.replay_ms,
                "deduped_submits": self.deduped_submits,
                "append_failures": self.journal_append_failures}

    @property
    def depth(self) -> int:
        return sum(q.qsize() for q in self._queues.values())

    @property
    def depths(self) -> dict[str, int]:
        """Per-model backlog (the /healthz jobs_backlog breakdown)."""
        return {m: q.qsize() for m, q in self._queues.items()}

    @property
    def active(self) -> int:
        """Job groups currently executing on a worker lane."""
        return self._active

    @property
    def max_backlog(self) -> int:
        return self._max_backlog

    @property
    def result_ttl_s(self) -> float:
        return self._result_ttl_s

    async def drain(self, timeout_s: float) -> bool:
        """Wait until every queued AND running job finishes (graceful drain).

        The server flips to draining first (new submits 503), so the backlog
        only shrinks; True = fully drained within the budget, False = the
        budget expired with work still in flight (the caller shuts down
        anyway — stop() marks the stragglers as errors so pollers see a
        terminal status).
        """
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.depth == 0 and self._active == 0:
                return True
            await asyncio.sleep(0.02)
        return self.depth == 0 and self._active == 0

    def _drop(self, job: Job):
        """Forget a job record — and its idempotency-key mapping with it."""
        self._jobs.pop(job.id, None)
        if job.key and self._by_key.get(job.key) == job.id:
            self._by_key.pop(job.key, None)

    def _gc(self):
        now = self._clock()
        done = [j for j in self._jobs.values()
                if j.status in ("done", "error", "expired")]
        # Wall-clock TTL first: expire stale results, drop very stale records.
        for j in list(done):
            age = now - j.finished if j.finished is not None else 0.0
            if age > 4 * self._result_ttl_s:
                self._drop(j)
                done.remove(j)
            elif age > self._result_ttl_s and j.status == "done":
                j.result, j.status = None, "expired"
        if len(done) > self._keep_done:
            for j in sorted(done, key=lambda j: j.finished or 0)[:-self._keep_done]:
                self._drop(j)
                done.remove(j)
        # Enforce the byte budget newest-first: older results expire first
        # but their status/timing metadata stays pollable.
        total = 0
        for j in sorted(done, key=lambda j: j.finished or 0, reverse=True):
            total += j.result_bytes()
            if total > self._max_result_bytes and j.status == "done":
                j.result, j.status = None, "expired"

    async def _sweep(self):
        """Periodic TTL enforcement — submit-time _gc alone never fires for a
        queue that has gone quiet, which is exactly when stale results linger.

        Each tick is guarded: an exception out of ``_gc`` (e.g. a record
        mutated mid-scan) must not kill the loop and silently disable TTL
        expiry for the rest of the process — log it and keep sweeping.
        """
        interval = max(min(self._result_ttl_s / 4, 60.0), 0.05)
        while True:
            await asyncio.sleep(interval)
            try:
                self._gc()
            except Exception:
                log.exception("job TTL sweep failed; retrying next interval")

    async def _worker(self, queue: asyncio.Queue):
        while True:
            job = await queue.get()
            group = [job]
            # Coalesce: whatever same-model backlog exists NOW joins this
            # batch (bounded by batch_of).  No waiting — an idle lane must
            # not add latency to a lone job.
            limit = max(int(self._batch_of(job.model)), 1) \
                if self._run_jobs is not None else 1
            while len(group) < limit and not queue.empty():
                group.append(queue.get_nowait())
            now = self._clock()
            t_run = time.perf_counter()
            self._active += 1
            for j in group:
                j.status, j.started = "running", now
                if j.span is not None:
                    # Queue-wait span (submit→worker pop), then the run span
                    # the device/finalize spans nest under (server._run_job).
                    j.span.child("job_queue", start=j.t_enq).end(end=t_run)
                    j.run_span = j.span.child("run", start=t_run,
                                              batched=len(group))
                self._journal_event("run", j)
            try:
                if len(group) > 1:
                    # Contract: one result per job, in order; a per-job
                    # Exception instance fails THAT job only (bad payloads
                    # must not take down batch-mates).  strict=True turns a
                    # contract slip into the whole-group error path instead
                    # of stranding unmatched jobs in "running" forever.
                    results = await self._run_jobs(group)
                    for j, r in zip(group, results, strict=True):
                        if isinstance(r, BaseException):
                            j.status = "error"
                            j.error = f"{type(r).__name__}: {r}"
                        else:
                            j.result, j.status = r, "done"
                else:
                    job.result = await self._run_job(job)
                    job.status = "done"
            except Exception as e:
                for j in group:
                    j.status, j.error = "error", f"{type(e).__name__}: {e}"
                log.exception("job batch %s failed", [j.id for j in group])
            finally:
                self._active -= 1
            now = self._clock()
            for j in group:
                j.finished = now
                if j.run_span is not None:
                    j.run_span.end(
                        status="ok" if j.status == "done" else "error")
                    j.run_span = None
                if j.status == "done":
                    self._journal_event("done", j, result=j.result)
                else:
                    self._journal_event("fail", j, error=j.error)
                self._finish_trace(j)
                log_event(log, "job finished", id=j.id, model=j.model,
                          status=j.status, batched=len(group),
                          seconds=round(j.finished - j.started, 3),
                          **({"trace_id": j.trace_id, "request_id": j.request_id}
                             if j.trace_id else {}))
