"""The durable job journal: an acknowledged ``:submit`` survives a ``kill -9``.

The port's copy of the JAX package's ``serving/durability.py`` (standard
library and numpy).  Without it the job queue lives only in the event
loop's memory, and a 202-acknowledged SD-1.5 job dies with the process.
With ``ServeConfig.journal_dir`` set, ``serving/jobs.py`` appends one JSON
line a state transition under it; at boot the queue replays the journal,
re-enqueues submitted and running jobs in their submit order, restores
done jobs' results, and rebuilds the idempotency-key map, so a client that
retries ``:submit`` with its key after a crash gets its original job id
back instead of a second run.

Record grammar (one JSON object a line)::

    {"ev": "submit", "id", "model", "payload", "key", "created"}
    {"ev": "run",    "id", "ts"}
    {"ev": "requeue","id", "ts"}          # the watchdog re-ran an outage victim
    {"ev": "done",   "id", "ts", "result"}
    {"ev": "fail",   "id", "ts", "error"}

Binary payloads (raw image bodies) are wrapped as ``{"__b64__": ...}``;
arrays (the binary tensor lane) as ``{"__tensor__": ...}``, one frame of
the port's own ``serving/wire.py``, byte-identical to the JAX package's, so
a journal either package writes replays in the other to the same records.
A corrupt or truncated trailing record (the normal shape of a crash in the
middle of a write) is skipped and counted, never fatal to the replay.
After the replay the journal is compacted (a temp file, fsynced, renamed
over it) to a snapshot of the surviving jobs, so it cannot grow without
bound.

The fsync policy is the durability/throughput dial: ``always`` fsyncs
every append (the 202 means "on disk"), ``interval`` at most every
~250 ms, ``never`` leaves it to the OS page cache.

This module knows nothing of ``Job`` or ``JobQueue``: it folds records into
plain dicts, so it stays testable on its own.
"""

from __future__ import annotations

import base64
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..utils.logging import get_logger

log = get_logger("serving.durability")

FSYNC_POLICIES = ("always", "interval", "never")


def _json_default(obj):
    """Bytes in JSON for journal records: the wire's ``{"b64": ...}`` idea.

    An array payload (a binary-lane submit) rides one ``__tensor__`` frame,
    which keeps its dtype and shape through the crash and the replay, as
    plain bytes would not."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return {"__b64__": base64.b64encode(bytes(obj)).decode("ascii")}
    import numpy as np

    from . import wire

    if isinstance(obj, np.ndarray) or wire._is_bf16_tensor(obj):
        return {"__tensor__": base64.b64encode(
            bytes(wire.pack([obj]))).decode("ascii")}
    raise TypeError(f"journal record field of type {type(obj).__name__} "
                    "is not JSON-serializable")


def _revive(obj):
    """Inverse of :func:`_json_default`: restore wrapped bytes/arrays
    recursively."""
    if isinstance(obj, dict):
        if set(obj) == {"__b64__"}:
            return base64.b64decode(obj["__b64__"])
        if set(obj) == {"__tensor__"}:
            from . import wire

            items, _ = wire.unpack(base64.b64decode(obj["__tensor__"]))
            return items[0]
        return {k: _revive(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_revive(v) for v in obj]
    return obj


@dataclass
class ReplayResult:
    """Parsed journal state: one dict per job, in original submit order.

    Each entry carries ``id/model/payload/key/created/status/started/
    finished/result/error`` with status already folded across records:
    ``queued`` (submitted or running at crash — must re-run), ``done``
    (result restored), ``error`` (terminal failure).
    """

    jobs: list[dict] = field(default_factory=list)
    records: int = 0          # parseable records consumed
    dropped: int = 0          # corrupt/truncated lines skipped
    orphans: int = 0          # transitions for ids with no submit record


class JobJournal:
    """Append-only JSONL journal with configurable fsync + atomic compaction."""

    def __init__(self, journal_dir: str | Path, fsync: str = "always",
                 fsync_interval_s: float = 0.25):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"journal_fsync must be one of {FSYNC_POLICIES}, "
                             f"got {fsync!r}")
        self.dir = Path(journal_dir).expanduser()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "journal.jsonl"
        self.fsync_policy = fsync
        self._fsync_interval_s = fsync_interval_s
        self._last_fsync = 0.0
        self._fh = None
        self.appended = 0

    # -- write side ----------------------------------------------------------
    def append(self, record: dict) -> None:
        """Append one record; durability per the fsync policy."""
        line = json.dumps(record, default=_json_default,
                          separators=(",", ":")) + "\n"
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(line)
        self._fh.flush()
        if self.fsync_policy == "always":
            os.fsync(self._fh.fileno())
        elif self.fsync_policy == "interval":
            now = time.monotonic()
            if now - self._last_fsync >= self._fsync_interval_s:
                os.fsync(self._fh.fileno())
                self._last_fsync = now
        self.appended += 1

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except OSError:
                pass
            self._fh.close()
            self._fh = None

    # -- replay side ---------------------------------------------------------
    def replay(self) -> ReplayResult:
        """Fold the journal into per-job state, tolerating a torn tail.

        Any unparseable line is skipped and counted (``dropped``) — the
        expected corruption is a half-written trailing record from the
        crash itself, and losing the *tail* transition only means a done
        job re-runs, which the idempotent submit path makes safe.
        """
        res = ReplayResult()
        if not self.path.exists():
            return res
        jobs: dict[str, dict] = {}
        order: list[str] = []
        with open(self.path, encoding="utf-8", errors="replace") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict):
                        raise ValueError("record is not an object")
                    ev, jid = rec["ev"], rec["id"]
                except (ValueError, KeyError, TypeError):
                    res.dropped += 1
                    log.warning("journal %s: skipping corrupt record at line "
                                "%d", self.path, lineno)
                    continue
                res.records += 1
                if ev == "submit":
                    jobs[jid] = {
                        "id": jid,
                        "model": rec.get("model", ""),
                        "payload": _revive(rec.get("payload")),
                        "key": rec.get("key"),
                        "created": rec.get("created", 0.0),
                        "status": "queued",
                        "started": None, "finished": None,
                        "result": None, "error": None,
                    }
                    order.append(jid)
                    continue
                job = jobs.get(jid)
                if job is None:
                    # Transition for a job whose submit was compacted away
                    # (or lost to the torn tail): nothing to attach it to.
                    res.orphans += 1
                    continue
                if ev == "run":
                    job["status"], job["started"] = "queued", rec.get("ts")
                elif ev == "requeue":
                    job.update(status="queued", error=None, finished=None)
                elif ev == "done":
                    job.update(status="done", result=_revive(rec.get("result")),
                               finished=rec.get("ts"))
                elif ev == "fail":
                    job.update(status="error", error=rec.get("error"),
                               finished=rec.get("ts"))
                else:
                    res.orphans += 1
        res.jobs = [jobs[jid] for jid in order]
        return res

    def rewrite(self, records: list[dict]) -> None:
        """Atomically replace the journal with a compacted record list.

        Written to a tmp file, fsynced, then ``os.replace``d over the
        journal — a crash mid-compaction leaves either the old or the new
        journal, never a torn hybrid.  The append handle is reopened lazily
        on the next write.
        """
        self.close()
        tmp = self.path.with_suffix(".jsonl.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, default=_json_default,
                                   separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def snapshot(self) -> dict:
        return {"dir": str(self.dir), "fsync": self.fsync_policy,
                "appended": self.appended}
