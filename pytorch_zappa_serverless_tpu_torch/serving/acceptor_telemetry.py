"""Telemetry that crosses the process boundary of the acceptor fast lane.

The port of the JAX package's ``serving/acceptor_telemetry.py``, byte for
byte in its layouts (a block one package writes, the other reads), two
halves:

- **The telemetry header** (:func:`pack_telem` / :func:`unpack_telem`): a
  compact block the worker puts in front of every ring request: the request
  id, the client's optional W3C ``traceparent``, and ``time.perf_counter()``
  stamps at accept, socket read, frame validate and ring push.  The pump
  turns them into the ``sock_read``, ``frame_validate`` and ``ring_wait``
  substages.  On Linux ``perf_counter`` is CLOCK_MONOTONIC, which is
  system-wide, so a worker's stamps subtract from the dispatch process's.
- **The per-worker stats block** (:class:`WorkerStatsBlock`): a small
  shared-memory block each worker writes alone (accepts, sheds by HTTP
  code, bytes in and out, an accept → ring-push histogram, a liveness
  heartbeat), read by the dispatch process into the ``tpuserve_acceptor_*``
  families.  Reads are uncoordinated: an aligned u64 store is atomic on the
  hosts the port runs on, so a torn read shows at worst one counter one
  increment stale.

Standard library only: the worker processes import it, and their import
closure stays free of torch.
"""

from __future__ import annotations

import contextlib
import struct
import time

# -- telemetry header ---------------------------------------------------------

# version | request_id (16 ascii bytes) | t_accept | t_read | t_validate |
# t_push (f64 perf_counter seconds) | traceparent length, then the
# traceparent bytes (the JAX package's layout, byte for byte).
TELEM_VERSION = 1
_TELEM_HDR = struct.Struct("<B16sddddB")
_TELEM_MAX_TP = 255          # traceparent is 55 bytes in W3C level 1


def pack_telem(request_id: str, t_accept: float, t_read: float,
               t_validate: float, t_push: float,
               traceparent: str = "") -> bytes:
    """The wire form of one request's worker-side telemetry."""
    rid = request_id.encode()[:16].ljust(16, b"\x00")
    tp = traceparent.encode()[:_TELEM_MAX_TP]
    return _TELEM_HDR.pack(TELEM_VERSION, rid, t_accept, t_read,
                           t_validate, t_push, len(tp)) + tp


def unpack_telem(buf: bytes) -> dict | None:
    """Decode a telemetry block; None for empty/garbage/unknown versions.

    Robustness over strictness: a missing or corrupt header downgrades the
    request to untimed (the pump falls back to pop-time anchors), it never
    fails the request.
    """
    if len(buf) < _TELEM_HDR.size:
        return None
    try:
        ver, rid, t_accept, t_read, t_validate, t_push, tp_len = \
            _TELEM_HDR.unpack_from(buf, 0)
    except struct.error:
        return None
    if ver != TELEM_VERSION or len(buf) < _TELEM_HDR.size + tp_len:
        return None
    try:
        request_id = rid.rstrip(b"\x00").decode("ascii")
        traceparent = buf[_TELEM_HDR.size:
                          _TELEM_HDR.size + tp_len].decode("ascii")
    except UnicodeDecodeError:
        return None
    return {"request_id": request_id, "t_accept": t_accept,
            "t_read": t_read, "t_validate": t_validate, "t_push": t_push,
            "traceparent": traceparent}


# -- fixed-bucket histogram (stdlib twin of serving/metrics.Histogram) --------

class StatHist:
    """A fixed-bucket histogram with the JSON snapshot shape /metrics
    renders (cumulative buckets keyed by upper bound, then ``+Inf``).

    serving/metrics.py has a Histogram already, but this module must not
    import it (the worker processes import this file; keeping the import
    closure stdlib-only is the fast lane's spawn-cost contract).  Only the
    snapshot shape is shared, and ``MetricsHub.render_prometheus`` renders it.
    """

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = tuple(float(b) for b in bounds)
        # Pump-owned instances (ring-wait/occupancy) live on the dispatch
        # event loop; snapshot() is called from the same loop by scrapes.
        # The extra slot is the +Inf bucket.
        self.counts = [0] * (len(self.bounds) + 1)   # guarded-by: event-loop
        self.sum = 0.0                               # guarded-by: event-loop
        self.count = 0                               # guarded-by: event-loop

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):
            if value <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def snapshot(self) -> dict:
        acc, buckets = 0, {}
        for b, c in zip(self.bounds, self.counts):
            acc += c
            buckets[f"{b:g}"] = acc
        buckets["+Inf"] = self.count
        return {"buckets": buckets, "sum": round(self.sum, 3),
                "count": self.count}


# -- per-worker shared-memory stats block -------------------------------------

# Cumulative u64 counters, single-writer (the worker).  Shed counters are
# keyed by the HTTP code the worker answered locally; pump-side sheds are
# accounted in the dispatch process (SLO plane), not here.
STATS_FIELDS = ("accepts", "shed_400", "shed_413", "shed_415", "shed_429",
                "shed_504", "responses_ok", "responses_err", "bytes_in",
                "bytes_out")

# In-worker latency (accept → ring push) bucket bounds, ms.  Sub-ms is the
# healthy regime; anything over ~10 ms means the worker itself is the
# bottleneck (validate cost or event-loop pressure inside the worker).
INWORKER_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                       50.0, 100.0, 250.0)

# Ring wait (worker push → pump pop), ms: the cross-process hop itself.
# Healthy is one pump poll interval (~2 ms); sustained tens of ms means the
# dispatch loop is saturated and the rings are queueing.
RING_WAIT_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                        100.0, 250.0, 1000.0)

# Ring occupancy (% of slots in use), sampled by the pump each busy cycle —
# the histogram form of the old point-in-time depth gauge: a ring that
# spikes to 90% between scrapes now leaves evidence.
OCCUPANCY_BUCKETS_PCT = (1.0, 5.0, 10.0, 25.0, 50.0, 75.0, 90.0, 100.0)

_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")
_N_HIST = len(INWORKER_BUCKETS_MS) + 1            # +Inf bucket
_OFF_HIST = len(STATS_FIELDS) * 8
_OFF_HIST_COUNT = _OFF_HIST + _N_HIST * 8
_OFF_HIST_SUM = _OFF_HIST_COUNT + 8
_OFF_HEARTBEAT = _OFF_HIST_SUM + 8
STATS_BLOCK_BYTES = _OFF_HEARTBEAT + 8


class WorkerStatsBlock:
    """One worker's stats over ``multiprocessing.shared_memory``.

    Layout (all little-endian, offsets in bytes)::

        0                  u64 x len(STATS_FIELDS)   cumulative counters
        _OFF_HIST          u64 x (buckets+1)         in-worker ms histogram
        _OFF_HIST_COUNT    u64                       histogram count
        _OFF_HIST_SUM      f64                       histogram sum (ms)
        _OFF_HEARTBEAT     f64                       time.monotonic() stamp

    Single-writer (the owning worker), torn-read-tolerant readers (the
    dispatch process); see the module docstring for the memory model.
    """

    def __init__(self, name: str | None = None, create: bool = False):
        from multiprocessing import shared_memory
        if create:
            self.shm = shared_memory.SharedMemory(
                create=True, size=STATS_BLOCK_BYTES, name=name)
            self.shm.buf[:STATS_BLOCK_BYTES] = bytes(STATS_BLOCK_BYTES)
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self._created = create

    @property
    def name(self) -> str:
        return self.shm.name

    # -- writer side (the worker) --------------------------------------------
    def inc(self, field: str, n: int = 1) -> None:
        off = STATS_FIELDS.index(field) * 8
        _U64.pack_into(self.shm.buf, off,
                       _U64.unpack_from(self.shm.buf, off)[0] + n)

    def note_shed(self, status: int) -> None:
        """One worker-local shed, by HTTP code (untracked codes no-op)."""
        field = f"shed_{status}"
        if field in STATS_FIELDS:
            self.inc(field)

    def observe_ms(self, ms: float) -> None:
        i = 0
        for i, b in enumerate(INWORKER_BUCKETS_MS):
            if ms <= b:
                break
        else:
            i = len(INWORKER_BUCKETS_MS)
        off = _OFF_HIST + i * 8
        _U64.pack_into(self.shm.buf, off,
                       _U64.unpack_from(self.shm.buf, off)[0] + 1)
        _U64.pack_into(self.shm.buf, _OFF_HIST_COUNT,
                       _U64.unpack_from(self.shm.buf, _OFF_HIST_COUNT)[0] + 1)
        _F64.pack_into(self.shm.buf, _OFF_HIST_SUM,
                       _F64.unpack_from(self.shm.buf, _OFF_HIST_SUM)[0] + ms)

    def heartbeat(self, now: float | None = None) -> None:
        _F64.pack_into(self.shm.buf, _OFF_HEARTBEAT,
                       time.monotonic() if now is None else now)

    # -- reader side (the dispatch process) ----------------------------------
    def heartbeat_age_s(self, now: float | None = None) -> float | None:
        """Seconds since the worker's last heartbeat; None before the first
        one (a worker that never came up has no age, it has an absence)."""
        beat = _F64.unpack_from(self.shm.buf, _OFF_HEARTBEAT)[0]
        if beat == 0.0:
            return None
        now = time.monotonic() if now is None else now
        return max(now - beat, 0.0)

    def snapshot(self) -> dict:
        out = {f: _U64.unpack_from(self.shm.buf, i * 8)[0]
               for i, f in enumerate(STATS_FIELDS)}
        acc, buckets = 0, {}
        for i, b in enumerate(INWORKER_BUCKETS_MS):
            acc += _U64.unpack_from(self.shm.buf, _OFF_HIST + i * 8)[0]
            buckets[f"{b:g}"] = acc
        count = _U64.unpack_from(self.shm.buf, _OFF_HIST_COUNT)[0]
        buckets["+Inf"] = count
        out["inworker_ms"] = {
            "buckets": buckets,
            "sum": round(_F64.unpack_from(self.shm.buf, _OFF_HIST_SUM)[0], 3),
            "count": count}
        age = self.heartbeat_age_s()
        out["heartbeat_age_s"] = round(age, 3) if age is not None else None
        return out

    def close(self) -> None:
        with contextlib.suppress(Exception):
            self.shm.close()

    def unlink(self) -> None:
        if self._created:
            with contextlib.suppress(Exception):
                self.shm.unlink()
