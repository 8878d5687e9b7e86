"""SO_REUSEPORT acceptor worker processes for the binary tensor lane.

The port of the JAX package's ``serving/acceptors.py``.  With
``ServeConfig.ingest_workers`` = N, N worker processes bind one more port
(``ingest_port``; 0: the main port + 1, or an ephemeral port when the main
port is ephemeral) with ``SO_REUSEPORT``, so the kernel spreads accepts
over them.  Each speaks only the tensor lane (``serving/wire.py``),
validates the frame, and hands it to the dispatch process over a
shared-memory ring; the dispatch process's pump serves it through the same
batchers as the main port and fans the answers back, one ring message a
worker a drain cycle::

    client ─► :ingest_port ─► worker 0..N-1  (stdlib, numpy, no torch)
                                 │  request ring (SPSC shm, one a worker)
                                 ▼
                          pump (the server's event loop): residency,
                          quarantine, breaker, decode, deadline,
                          preprocess, batcher.submit_many
                                 │  response ring (SPSC shm, one a worker)
                                 ▼
                          the worker answers the waiting connection

A ring has one producer and one consumer (a worker and the pump), so its
two cursors need no lock: each side writes only its own.  A full request
ring is back-pressure (429 + Retry-After at the worker).

The workers are started with ``python -m`` on this module, never through
``multiprocessing``'s spawn, which would import the parent's ``__main__``
(and with it torch) in every child: a worker's import closure is the
standard library, numpy and the port's wire, tracing, logging, telemetry,
framing and acceptors modules, whatever the parent runs.  A worker's crash
takes no model state with it; the pump answers its queued requests 503 and
the worker is respawned on its rings.

Boot refuses, with the reason, what would fail later in silence: a host
that is not x86-64 (the rings publish a cursor after the payload with no
fence, which only a total-store-order CPU keeps in order), rings that do
not fit ``/dev/shm`` (a write past a tmpfs's size is a SIGBUS, not an
exception), an ingest port that cannot be bound, and a worker that exits
before it serves.  Only a platform without ``SO_REUSEPORT`` degrades, with
a warning, to the main port alone (the reference's rule).

Fast-lane scope: ``:predict`` with the main lane's admission (404,
quarantine and breaker 503, 413/400, deadline 504, overload 429).  A
configured model that is not resident answers 503 ``cold_start`` with
Retry-After and its activation starts: the pump never waits for a restore
(every request of the drain cycle would wait with it) and never dispatches
to a demoted model's released graphs.  Families, adapters, ``:generate`` and
``:submit`` stay on the main port.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import platform
import re
import socket
import struct
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

from ..utils.logging import get_logger, log_event
from . import wire
from .acceptor_telemetry import (OCCUPANCY_BUCKETS_PCT, RING_WAIT_BUCKETS_MS,
                                 STATS_BLOCK_BYTES, StatHist, WorkerStatsBlock, pack_telem,
                                 unpack_telem)
from .httpframe import MAX_BODY_BYTES, HttpError, RawBody, encode, keep_alive, read_request
from .tracing import new_request_id, new_trace_id, parse_traceparent

log = get_logger("serving.acceptors")

HAVE_REUSEPORT = hasattr(socket, "SO_REUSEPORT")
# What a worker runs (``python -m``), as this module's import name.
_MODULE = (__spec__.name if __spec__ is not None
           else "pytorch_zappa_serverless_tpu_torch.serving.acceptors")
_PREDICT = re.compile(r"^/v1/models/([^:/]+):predict$")
# CPUs whose stores are seen by another core in program order (TSO): the
# rings' correctness argument (see ShmRing).
TSO_MACHINES = ("x86_64", "amd64", "i386", "i686")

# Ring header: head (consumer cursor) | tail (producer cursor), both
# free-running u64 slot counters (slot = counter % slots).
_RING_HDR = struct.Struct("<QQ")
_U64 = struct.Struct("<Q")
_SLOT_HDR = struct.Struct("<I")          # payload length within the slot
# One message: request id, HTTP status (0 on requests), routing length,
# telemetry-block length, body length.  Responses echo the telemetry block,
# so a degraded answer still carries the request's ids.
_MSG_HDR = struct.Struct("<IHHHI")
_BATCH_HDR = struct.Struct("<H")         # messages in one batch frame

_PUMP_MAX_DRAIN = 64        # requests consumed a pump cycle
_PUMP_IDLE_S = 0.002        # poll backoff when every ring is empty
_WORKER_IDLE_S = 0.002      # the worker's response poll backoff
_HEARTBEAT_S = 0.25         # worker liveness stamp cadence
_REAP_INTERVAL_S = 0.5      # pump-side worker-death check cadence
_SPAWN_TIMEOUT_S = 60.0     # a worker must serve within this at boot
# The worker's last backstop: a congested response ring degrades to queued
# 503s (AcceptorSupervisor._fan_out), so a client waits this long only when
# the pump itself is gone.
_RESP_TIMEOUT_S = 30.0
_RESP_RETRY_TICKS = 200     # ~2 s of 10 ms full-ring retries a chunk


# -- shared-memory ring -------------------------------------------------------

class ShmRing:
    """Fixed-slot SPSC byte ring over ``multiprocessing.shared_memory``.

    Layout: a 16-byte header (head, tail), then ``slots`` fixed-size slots,
    each a u32 length and the payload.  The producer advances only
    ``tail``, the consumer only ``head``; depth is ``tail - head``.  A
    message longer than a slot is refused at push (the caller answers 413);
    it never tears across slots.  The JAX package's layout, byte for byte.

    Memory order: correctness rests on the peer process seeing the payload
    stores before the cursor store, in program order.  Python emits no
    fence, so that holds on total-store-order CPUs (x86-64) only; the
    supervisor refuses to start the workers on any other host.
    """

    def __init__(self, name: str | None = None, slots: int = 256,
                 slot_bytes: int = 1 << 20, create: bool = False):
        from multiprocessing import shared_memory
        if slots < 2 or slot_bytes <= _SLOT_HDR.size:
            raise ValueError(f"ring needs >=2 slots and slot_bytes > "
                             f"{_SLOT_HDR.size}, got {slots}x{slot_bytes}")
        size = ring_bytes(slots, slot_bytes)
        if create:
            self.shm = shared_memory.SharedMemory(create=True, size=size, name=name)
            _RING_HDR.pack_into(self.shm.buf, 0, 0, 0)
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self.slots = slots
        self.slot_bytes = slot_bytes
        self.max_payload = slot_bytes - _SLOT_HDR.size
        self._created = create

    @property
    def name(self) -> str:
        return self.shm.name

    def _cursors(self) -> tuple[int, int]:
        return _RING_HDR.unpack_from(self.shm.buf, 0)

    def depth(self) -> int:
        head, tail = self._cursors()
        return tail - head

    def try_push(self, data: bytes | bytearray | memoryview) -> bool:
        """Producer side; False when the ring is full (back-pressure)."""
        n = len(data)
        if n > self.max_payload:
            raise ValueError(f"message of {n} bytes exceeds the "
                             f"{self.max_payload}-byte ring slot")
        head, tail = self._cursors()
        if tail - head >= self.slots:
            return False
        off = _RING_HDR.size + (tail % self.slots) * self.slot_bytes
        _SLOT_HDR.pack_into(self.shm.buf, off, n)
        self.shm.buf[off + _SLOT_HDR.size: off + _SLOT_HDR.size + n] = data
        # Publish after the payload: the consumer reads only slots below
        # tail (TSO keeps the two stores in order; see the class docstring).
        _U64.pack_into(self.shm.buf, 8, tail + 1)
        return True

    def try_pop(self) -> bytes | None:
        """Consumer side; None when the ring is empty."""
        head, tail = self._cursors()
        if head == tail:
            return None
        off = _RING_HDR.size + (head % self.slots) * self.slot_bytes
        n = _SLOT_HDR.unpack_from(self.shm.buf, off)[0]
        data = bytes(self.shm.buf[off + _SLOT_HDR.size: off + _SLOT_HDR.size + n])
        _U64.pack_into(self.shm.buf, 0, head + 1)
        return data

    def close(self) -> None:
        with contextlib.suppress(Exception):
            self.shm.close()

    def unlink(self) -> None:
        if self._created:
            with contextlib.suppress(Exception):
                self.shm.unlink()


def ring_bytes(slots: int, slot_bytes: int) -> int:
    """The shared-memory bytes one ring takes."""
    return _RING_HDR.size + slots * slot_bytes


def untrack(shm) -> None:
    """Take an attached segment off this process's resource tracker.  A
    worker attaches segments its supervisor owns; left tracked, the
    worker's own tracker would unlink them when the worker dies, and its
    respawn would find no rings."""
    from multiprocessing import resource_tracker
    with contextlib.suppress(Exception):
        resource_tracker.unregister(shm._name, "shared_memory")


def shm_free_bytes(path: str = "/dev/shm") -> int | None:
    """Free bytes of the tmpfs that holds ``multiprocessing.shared_memory``
    (None where there is none to read)."""
    try:
        st = os.statvfs(path)
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


# -- message framing ----------------------------------------------------------

def pack_msg(req_id: int, status: int, name: str, body: bytes,
             telem: bytes = b"") -> bytes:
    nb = name.encode()
    return _MSG_HDR.pack(req_id, status, len(nb), len(telem), len(body)) + nb + telem + body


def unpack_msg(buf: bytes, off: int = 0) -> tuple[int, int, str, bytes, bytes, int]:
    """``(req_id, status, name, telem, body, next_off)``, bounds-checked."""
    if len(buf) - off < _MSG_HDR.size:
        raise ValueError("truncated ring message header")
    req_id, status, name_len, telem_len, body_len = _MSG_HDR.unpack_from(buf, off)
    off += _MSG_HDR.size
    if len(buf) - off < name_len + telem_len + body_len:
        raise ValueError("truncated ring message payload")
    name = buf[off: off + name_len].decode()
    off += name_len
    telem = buf[off: off + telem_len]
    off += telem_len
    body = buf[off: off + body_len]
    return req_id, status, name, telem, body, off + body_len


def pack_batch(msgs: list[bytes]) -> bytes:
    """One ring push a drain cycle: a count, then the messages."""
    return _BATCH_HDR.pack(len(msgs)) + b"".join(msgs)


def unpack_batch(buf: bytes) -> list[tuple[int, int, str, bytes, bytes]]:
    if len(buf) < _BATCH_HDR.size:
        raise ValueError("truncated ring batch header")
    count = _BATCH_HDR.unpack_from(buf, 0)[0]
    off, out = _BATCH_HDR.size, []
    for _ in range(count):
        req_id, status, name, telem, body, off = unpack_msg(buf, off)
        out.append((req_id, status, name, telem, body))
    if off != len(buf):
        raise ValueError("trailing bytes after the last batch message")
    return out


def reuseport_socket(host: str, port: int) -> socket.socket:
    """A bound socket with SO_REUSEPORT, so N processes share one port."""
    if not HAVE_REUSEPORT:
        raise OSError("SO_REUSEPORT is unavailable on this platform")
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    return sock


# -- worker process -----------------------------------------------------------

def worker_main(idx: int, host: str, port: int, req_ring_name: str,
                resp_ring_name: str, slots: int, slot_bytes: int,
                tensor_max_bytes: int, stats_name: str | None = None,
                parent_pid: int | None = None) -> None:
    """Acceptor worker entry point (never imports torch).

    Serves ``POST /v1/models/{model}:predict`` on the shared ingest port,
    tensor frames only (anything else is 415 naming the main port), and
    ``GET /healthz``.  The worker validates the frame (the main lane's 400
    and 413), forwards the original body over its request ring, parks the
    connection on a future, and a drain task resolves the futures from the
    batches the pump sends back.  Every answer carries ``X-Request-Id`` and
    ``X-Trace-Id``, every error body ``request_id`` and ``trace_id``.  The
    worker exits when ``parent_pid`` is no longer its parent.
    """
    try:
        asyncio.run(_worker_async(idx, host, port, req_ring_name, resp_ring_name, slots,
                                  slot_bytes, tensor_max_bytes, stats_name, parent_pid))
    except KeyboardInterrupt:  # pragma: no cover - parent-driven shutdown
        pass


async def _worker_async(idx, host, port, req_ring_name, resp_ring_name, slots, slot_bytes,
                        tensor_max_bytes, stats_name=None, parent_pid=None):
    req_ring = ShmRing(req_ring_name, slots, slot_bytes)
    resp_ring = ShmRing(resp_ring_name, slots, slot_bytes)
    # Supervisor-made; a standalone worker (a test) makes its own, so the
    # counting paths are the same either way.
    stats = WorkerStatsBlock(stats_name) if stats_name else WorkerStatsBlock(create=True)
    for shm in (req_ring.shm, resp_ring.shm) + ((stats.shm,) if stats_name else ()):
        untrack(shm)
    # req id -> (future, the request id the answer must echo).
    pending: dict[int, tuple[asyncio.Future, str]] = {}  # guarded-by: event-loop
    next_id = [1]                             # guarded-by: event-loop
    conns: set = set()                        # guarded-by: event-loop
    max_body = max(tensor_max_bytes, MAX_BODY_BYTES)

    def ids(rid, tid):
        return {"X-Request-Id": rid, "X-Trace-Id": tid}

    def err(status, message, rid, tid, keep, **extra) -> bytes:
        body = {"error": message, "worker": idx, **extra}
        body.setdefault("request_id", rid)
        body.setdefault("trace_id", tid)
        stats.inc("responses_err")
        heads = ids(body["request_id"], body["trace_id"])
        retry = extra.get("retry_after_s")
        if retry is not None:
            heads["Retry-After"] = str(max(int(retry + 0.999), 1))
        return encode(status, body, heads, keep)

    async def predict(name, headers, body, t_accept, t_read, keep) -> bytes:
        stats.inc("bytes_in", len(body))
        # The ids exist from the first byte: the request id rides the
        # telemetry block into the dispatch process, and a valid client
        # traceparent makes the pump's trace join the caller's trace id.
        rid = headers.get("x-request-id") or new_request_id()
        traceparent = headers.get("traceparent", "")
        parsed = parse_traceparent(traceparent)
        tid = parsed[0] if parsed else new_trace_id()
        if parsed is None:
            traceparent = ""      # never ship an invalid header over the ring
        ctype = headers.get("content-type", "").split(";")[0].strip().lower()
        if ctype != wire.TENSOR_CONTENT_TYPE:
            stats.note_shed(415)
            return err(415, f"acceptor workers speak only {wire.TENSOR_CONTENT_TYPE}; use "
                            "the main port for JSON and raw lanes", rid, tid, keep)
        try:
            # Validate only: a malformed or oversized frame ends here, in the
            # worker, and never crosses into the dispatch process.
            _items, flags = wire.unpack(body, max_bytes=tensor_max_bytes, bf16_as_bits=True)
            if flags & wire.FLAG_META:
                raise wire.FrameError("FLAG_META frames are response-only")
        except wire.FrameTooLarge as e:
            stats.note_shed(413)
            return err(413, f"tensor frame too large: {e}", rid, tid, keep)
        except wire.FrameError as e:
            stats.note_shed(400)
            return err(400, f"bad tensor frame: {e}", rid, tid, keep)
        t_validate = time.perf_counter()
        deadline_ms = headers.get("x-deadline-ms", "")
        req_id = next_id[0]
        t_push = time.perf_counter()
        telem = pack_telem(rid, t_accept, t_read, t_validate, t_push, traceparent)
        try:
            pushed = req_ring.try_push(pack_msg(req_id, 0, f"{name}|{deadline_ms}", body, telem))
        except ValueError as e:
            stats.note_shed(413)
            return err(413, str(e), rid, tid, keep)
        if not pushed:
            # A full ring is the shed signal: the dispatch process is not
            # draining this worker's offered load.
            stats.note_shed(429)
            return err(429, "ingest ring full; back off and retry", rid, tid, keep,
                       retry_after_s=1.0)
        stats.observe_ms((t_push - t_accept) * 1000.0)
        next_id[0] = next_id[0] % 0xFFFFFFFF + 1   # a u32 on the ring
        fut = asyncio.get_running_loop().create_future()
        pending[req_id] = (fut, rid.encode()[:16].decode("ascii", "replace"))
        try:
            status, rtelem, rbody = await asyncio.wait_for(fut, _RESP_TIMEOUT_S)
        except (asyncio.TimeoutError, TimeoutError):
            stats.note_shed(504)
            return err(504, "dispatch process did not answer in time", rid, tid, keep)
        finally:
            pending.pop(req_id, None)
        # The pump echoes its trace's traceparent: the trace id to quote.
        t = unpack_telem(rtelem)
        p = parse_traceparent(t["traceparent"]) if t else None
        tid = p[0] if p else tid
        if status == 200:
            stats.inc("responses_ok")
            stats.inc("bytes_out", len(rbody))
            return encode(200, RawBody(bytes(rbody), wire.TENSOR_CONTENT_TYPE), ids(rid, tid),
                          keep)
        try:
            payload = json.loads(rbody)
        except ValueError:
            payload = {"error": bytes(rbody).decode(errors="replace")}
        # The pump's errors carry their ids; the worker's are the fallback.
        return err(status, payload.pop("error", "upstream error"), rid, tid, keep, **payload)

    def health(keep) -> bytes:
        return encode(200, {"ok": True, "worker": idx, "pid": os.getpid(),
                            "pending": len(pending), "ring_depth": req_ring.depth(),
                            "torch_loaded": "torch" in sys.modules}, {}, keep)

    async def handle_conn(reader, writer):
        conns.add(writer)
        try:
            while True:
                stamps: dict = {}
                try:
                    req = await read_request(reader, max_body, stamps)
                except HttpError as e:
                    stats.inc("accepts")
                    stats.note_shed(e.status)
                    writer.write(err(e.status, str(e), new_request_id(), new_trace_id(), False))
                    await writer.drain()
                    break
                if req is None:
                    break
                t_read = time.perf_counter()
                method, path, _query, version, headers, body = req
                keep = keep_alive(version, headers)
                m = _PREDICT.match(path)
                if method == "POST" and m is not None:
                    stats.inc("accepts")
                    out = await predict(m.group(1), headers, body, stamps.get("t_head", t_read),
                                        t_read, keep)
                elif method == "GET" and path == "/healthz":
                    out = health(keep)
                else:
                    out = encode(404, {"error": f"no route {method} {path} on an acceptor "
                                                "worker (POST /v1/models/{name}:predict)",
                                       "worker": idx}, {}, keep)
                writer.write(out)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass  # the client went away or sent an over-long line
        finally:
            conns.discard(writer)
            writer.close()

    async def drain():
        # Resolve the pending futures from batch frames; an idle worker
        # polls every _WORKER_IDLE_S.
        while True:
            raw = resp_ring.try_pop()
            if raw is None:
                await asyncio.sleep(_WORKER_IDLE_S)
                continue
            try:
                msgs = unpack_batch(raw)
            except ValueError:
                log.warning("worker %d: corrupt response batch dropped", idx)
                continue
            for req_id, status, _name, telem, body in msgs:
                fut, rid = pending.get(req_id, (None, None))
                if fut is None or fut.done():
                    continue
                # A respawned worker numbers its requests from 1 again: an
                # answer its predecessor never read names another request.
                t = unpack_telem(telem)
                if t is not None and t["request_id"] != rid:
                    continue
                fut.set_result((status, telem, body))

    sock = reuseport_socket(host, port)
    server = await asyncio.start_server(handle_conn, sock=sock, backlog=1024)
    drain_task = asyncio.create_task(drain())
    stats.heartbeat()
    log_event(log, "acceptor worker ready", worker=idx, port=port, pid=os.getpid())
    try:
        while parent_pid is None or os.getppid() == parent_pid:
            # The heartbeat is the liveness evidence the supervisor reads: a
            # wedged worker stops stamping it.
            stats.heartbeat()
            await asyncio.sleep(_HEARTBEAT_S)
    finally:
        drain_task.cancel()
        server.close()
        for w in list(conns):
            w.close()
        req_ring.close()
        resp_ring.close()
        stats.close()


class WorkerProcess:
    """One worker, started with ``python -m`` on this module so that its
    import closure holds no torch whatever the parent's ``__main__`` is.
    The ``multiprocessing.Process`` surface the supervisor reads: ``pid``,
    ``is_alive``, ``exitcode``, ``terminate``, ``kill``, ``join``."""

    def __init__(self, args: dict):
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [sys.executable, "-m", _MODULE, json.dumps(args)],
            env=env, stdin=subprocess.DEVNULL)
        # What the start held its caller (the server's loop, at a respawn).
        self.start_ms = (time.perf_counter() - t0) * 1000.0
        self.pid = self._proc.pid

    def is_alive(self) -> bool:
        return self._proc.poll() is None

    @property
    def exitcode(self) -> int | None:
        return self._proc.poll()

    def terminate(self) -> None:
        if self.is_alive():
            self._proc.terminate()

    def kill(self) -> None:
        if self.is_alive():
            self._proc.kill()

    def join(self, timeout: float | None = None) -> None:
        try:
            self._proc.wait(timeout)
        except subprocess.TimeoutExpired:
            pass


# -- supervisor (the dispatch process) ---------------------------------------

class AcceptorSupervisor:
    """Owns the rings, the worker processes and the pump on the server's
    event loop."""

    def __init__(self, cfg, pool=None):
        self.cfg = cfg
        self.ingest_port = cfg.ingest_port
        self.workers: list = []                # guarded-by: event-loop
        self.req_rings: list[ShmRing] = []     # guarded-by: event-loop
        self.resp_rings: list[ShmRing] = []    # guarded-by: event-loop
        self._pump_task = None                 # guarded-by: event-loop
        self._stopping = False                 # guarded-by: event-loop
        self.degraded_reason: str | None = None  # guarded-by: event-loop
        self.served = 0                        # guarded-by: event-loop
        self.resp_drops = 0                    # guarded-by: event-loop
        self.resp_oversize = 0                 # guarded-by: event-loop
        # Per-worker deferred error answers for congested response rings.
        self._resp_backlog: list = []          # guarded-by: event-loop
        self._rr = 0                           # guarded-by: event-loop
        self._pool = pool if pool is not None else wire.BufferPool()  # guarded-by: event-loop
        self.stats_blocks: list[WorkerStatsBlock] = []  # guarded-by: event-loop
        self.worker_up: list[bool] = []        # guarded-by: event-loop
        self.restarts = 0                      # guarded-by: event-loop
        self.spawn_seconds: list[float | None] = []  # guarded-by: event-loop
        self.ring_wait_hist = StatHist(RING_WAIT_BUCKETS_MS)  # guarded-by: event-loop
        self.occupancy_hists: dict[str, StatHist] = {}  # guarded-by: event-loop
        self._respawn_pending: set[int] = set()  # guarded-by: event-loop
        self._next_reap = 0.0                  # guarded-by: event-loop
        self._reserve: socket.socket | None = None  # guarded-by: event-loop
        self._tensor_cap = cfg.tensor_max_bytes or MAX_BODY_BYTES

    async def start(self, server, bound_port: int | None = None) -> None:
        """Reserve the ingest port (``ingest_port``, else ``bound_port`` + 1,
        else an ephemeral one), create the rings, start the workers and
        wait until each serves, then start the pump.  Raises
        ``RuntimeError`` with the reason on anything that would not serve
        (see the module docstring); the caller fails the boot."""
        n = self.cfg.ingest_workers
        if not HAVE_REUSEPORT:
            self.degraded_reason = "SO_REUSEPORT unavailable"
            log.warning("ingest_workers=%d requested but SO_REUSEPORT is unavailable; "
                        "the main port serves alone", n)
            return
        if platform.machine().lower() not in TSO_MACHINES:
            raise RuntimeError(
                f"ingest_workers={n} refused on a {platform.machine()!r} host: the shared-"
                "memory rings publish a cursor after the payload with no fence, which only "
                "a total-store-order CPU (x86-64) keeps in order")
        need = n * (2 * ring_bytes(self.cfg.shm_ring_slots, self.cfg.shm_ring_slot_bytes)
                    + STATS_BLOCK_BYTES)
        free = shm_free_bytes()
        if free is not None and need > free:
            raise RuntimeError(
                f"ingest_workers={n} with {self.cfg.shm_ring_slots} x "
                f"{self.cfg.shm_ring_slot_bytes}-byte ring slots need {need} bytes of "
                f"/dev/shm; {free} are free (shrink shm_ring_slots or shm_ring_slot_bytes)")
        port = self.cfg.ingest_port or (bound_port + 1 if bound_port else 0)
        try:
            # A bound, never-listening member of the port's SO_REUSEPORT
            # group: it holds the port (an ephemeral one too) across worker
            # respawns and takes no connection.
            self._reserve = reuseport_socket(self.cfg.host, port)
        except OSError as e:
            raise RuntimeError(f"ingest port {port} cannot be bound: {e}") from None
        self.ingest_port = self._reserve.getsockname()[1]
        try:
            for _ in range(n):
                self.req_rings.append(ShmRing(slots=self.cfg.shm_ring_slots,
                                              slot_bytes=self.cfg.shm_ring_slot_bytes,
                                              create=True))
                self.resp_rings.append(ShmRing(slots=self.cfg.shm_ring_slots,
                                               slot_bytes=self.cfg.shm_ring_slot_bytes,
                                               create=True))
                self.stats_blocks.append(WorkerStatsBlock(create=True))
        except Exception as e:
            self._teardown()
            raise RuntimeError(f"acceptor rings cannot be created: {e}") from None
        self._resp_backlog = [deque(maxlen=4 * self.cfg.shm_ring_slots) for _ in range(n)]
        self.worker_up = [True] * n
        self.workers = [None] * n
        self.spawn_seconds = [None] * n
        t0 = time.perf_counter()
        for i in range(n):
            self._spawn_worker(i)
        try:
            await self._wait_ready(t0)
        except Exception:
            await self.stop()
            raise
        self._pump_task = asyncio.get_running_loop().create_task(self._pump(server),
                                                                 name="acceptor-pump")
        log_event(log, "acceptors started", workers=n, ingest_port=self.ingest_port,
                  ring_slots=self.cfg.shm_ring_slots,
                  ring_slot_bytes=self.cfg.shm_ring_slot_bytes,
                  spawn_seconds=self.spawn_seconds)

    async def _wait_ready(self, t0: float) -> None:
        """Until every worker's first heartbeat (stamped once it listens);
        a worker that exits first, or none in time, fails the start."""
        while True:
            waiting = 0
            for i, p in enumerate(self.workers):
                if self.spawn_seconds[i] is not None:
                    continue
                if self.stats_blocks[i].heartbeat_age_s() is not None:
                    self.spawn_seconds[i] = round(time.perf_counter() - t0, 3)
                    continue
                if not p.is_alive():
                    raise RuntimeError(f"acceptor worker {i} exited with code {p.exitcode} "
                                       f"before it served on port {self.ingest_port}")
                waiting += 1
            if not waiting:
                return
            if time.perf_counter() - t0 > _SPAWN_TIMEOUT_S:
                raise RuntimeError(f"{waiting} acceptor worker(s) not serving after "
                                   f"{_SPAWN_TIMEOUT_S:g} s")
            await asyncio.sleep(0.01)

    def _spawn_worker(self, i: int) -> None:
        """(Re)start worker ``i`` on its existing rings and stats block.  Its
        heartbeat is cleared first: the next stamp says the new process
        serves."""
        self.stats_blocks[i].heartbeat(now=0.0)
        self.workers[i] = WorkerProcess({
            "idx": i, "host": self.cfg.host, "port": self.ingest_port,
            "req_ring_name": self.req_rings[i].name, "resp_ring_name": self.resp_rings[i].name,
            "slots": self.cfg.shm_ring_slots, "slot_bytes": self.cfg.shm_ring_slot_bytes,
            "tensor_max_bytes": self._tensor_cap, "stats_name": self.stats_blocks[i].name,
            "parent_pid": os.getpid()})

    async def stop(self) -> None:
        self._stopping = True
        if self._pump_task is not None:
            self._pump_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._pump_task
            self._pump_task = None
        for p in self.workers:
            if p is not None:
                p.terminate()
        loop = asyncio.get_running_loop()
        for p in self.workers:
            if p is not None:
                await loop.run_in_executor(None, p.join, 5.0)
                p.kill()
        self.workers = []
        self.worker_up = []
        self._respawn_pending.clear()
        self._resp_backlog = []
        self._teardown()

    def _teardown(self) -> None:
        for ring in self.req_rings + self.resp_rings:
            ring.close()
            ring.unlink()
        self.req_rings.clear()
        self.resp_rings.clear()
        for blk in self.stats_blocks:
            blk.close()
            blk.unlink()
        self.stats_blocks.clear()
        if self._reserve is not None:
            self._reserve.close()
            self._reserve = None

    def alive_workers(self) -> int:
        return sum(1 for p in self.workers if p is not None and p.is_alive())

    def ring_depths(self) -> dict[str, int]:
        out = {f"req:{i}": ring.depth() for i, ring in enumerate(self.req_rings)}
        out.update({f"resp:{i}": ring.depth() for i, ring in enumerate(self.resp_rings)})
        return out

    # -- the pump: ring ingest on the dispatch loop ---------------------------

    async def _pump(self, server) -> None:
        """Drain the request rings, serve, fan the answers out.  Every cycle
        is guarded: an escaped error here would strand every worker's
        pending requests."""
        while not self._stopping:
            try:
                busy = await self._pump_cycle(server)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("pump cycle failed; pump continues")
                busy = False
            if not busy:
                await asyncio.sleep(_PUMP_IDLE_S)

    async def _pump_cycle(self, server) -> bool:
        """One drain / serve / fan-out round; False when there was no work."""
        self._flush_backlog()
        self._reap_dead_workers()
        msgs = self._drain_requests()
        if not msgs:
            return False
        t_pop = time.perf_counter()
        self._note_occupancy()
        results = await asyncio.gather(*[self._serve_one(server, raw, t_pop) for _, raw in msgs],
                                       return_exceptions=True)
        by_worker: dict[int, list[bytes]] = {}
        for (widx, _), res in zip(msgs, results):
            if isinstance(res, BaseException):
                log.error("ring request failed", exc_info=res)
                continue
            by_worker.setdefault(widx, []).append(res)
            self.served += 1
        for widx, batch in by_worker.items():
            await self._fan_out(widx, batch)
        return True

    def _drain_requests(self) -> list[tuple[int, bytes]]:
        """Fair drain: each ring capped at ceil(budget / N), the starting
        ring rotating, so one busy worker cannot starve the others into
        429s."""
        msgs: list[tuple[int, bytes]] = []
        n = len(self.req_rings)
        if n == 0:
            return msgs
        per_ring = -(-_PUMP_MAX_DRAIN // n)
        start = self._rr
        self._rr = (start + 1) % n
        for k in range(n):
            widx = (start + k) % n
            ring = self.req_rings[widx]
            taken = 0
            while taken < per_ring and len(msgs) < _PUMP_MAX_DRAIN:
                raw = ring.try_pop()
                if raw is None:
                    break
                msgs.append((widx, raw))
                taken += 1
        return msgs

    # -- worker liveness -------------------------------------------------------

    def _reap_dead_workers(self, server=None) -> None:
        """Detect deaths, fail their queued requests, respawn.  The cycle
        that detects a death flips ``worker_up`` and answers the queued
        messages 503; the next reap (one interval later) respawns, so the
        down state is observable."""
        now = time.monotonic()
        if now < self._next_reap or not self.workers:
            return
        self._next_reap = now + _REAP_INTERVAL_S
        for i in sorted(self._respawn_pending):
            self._respawn_pending.discard(i)
            self._spawn_worker(i)
            self.worker_up[i] = True
            log_event(log, "acceptor worker respawned", worker=i, pid=self.workers[i].pid)
        for i, p in enumerate(self.workers):
            if p is None or p.is_alive() or not self.worker_up[i]:
                continue
            self.worker_up[i] = False
            self.restarts += 1
            log_event(log, "acceptor worker died", worker=i, exitcode=p.exitcode,
                      restarts=self.restarts)
            self._fail_inflight(i)
            self._respawn_pending.add(i)

    def _fail_inflight(self, widx: int) -> None:
        """A dead worker's queued requests become 503s that keep their ids,
        queued for whichever process serves the slot next (the respawn
        inherits the rings; a client whose connection died with the worker
        never reads it)."""
        ring = self.req_rings[widx]
        while True:
            raw = ring.try_pop()
            if raw is None:
                break
            try:
                req_id, _st, routing, telem_raw, _body, _ = unpack_msg(raw)
            except ValueError:
                continue
            t = unpack_telem(telem_raw)
            parsed = parse_traceparent(t["traceparent"]) if t else None
            body = wire._json_bytes({
                "error": "acceptor worker died; request abandoned before dispatch",
                "request_id": t["request_id"] if t and t["request_id"] else new_request_id(),
                "trace_id": parsed[0] if parsed else new_trace_id(),
                "retry_after_s": 1.0})
            self._resp_backlog[widx].append(
                pack_msg(req_id, 503, routing.partition("|")[0], body, telem_raw))
        self._flush_backlog()

    def _note_occupancy(self) -> None:
        """Ring occupancy (% of slots) into per-ring histograms, on busy
        cycles only."""
        slots = float(self.cfg.shm_ring_slots)
        for kind, rings in (("req", self.req_rings), ("resp", self.resp_rings)):
            for i, ring in enumerate(rings):
                self.occupancy_hists.setdefault(
                    f"{kind}:{i}", StatHist(OCCUPANCY_BUCKETS_PCT)).observe(
                    100.0 * ring.depth() / slots)

    @staticmethod
    def _error_msg(msg: bytes, status: int, message: str, **extra) -> bytes:
        """Re-address a packed response as a small JSON error that keeps
        the request's ids (from the echoed telemetry block)."""
        req_id, _status, name, telem_raw, _body, _ = unpack_msg(msg)
        t = unpack_telem(telem_raw)
        parsed = parse_traceparent(t["traceparent"]) if t else None
        body = {"error": message, **extra}
        body.setdefault("request_id", t["request_id"] if t and t["request_id"]
                        else new_request_id())
        body.setdefault("trace_id", parsed[0] if parsed else new_trace_id())
        return pack_msg(req_id, status, name, wire._json_bytes(body), telem_raw)

    async def _fan_out(self, widx: int, batch: list[bytes]) -> None:
        """Push one worker's answers in slot-sized chunks.  A message that
        cannot fit a slot becomes a small 500; a chunk the ring will not
        take after ~2 s of retries degrades to queued 503s: the client
        always gets an answer."""
        ring = self.resp_rings[widx]
        cap = ring.max_payload - _BATCH_HDR.size
        chunks: list[list[bytes]] = []
        chunk: list[bytes] = []
        size = 0
        for m in batch:
            if len(m) > cap:
                self.resp_oversize += 1
                log.warning("response of %d bytes exceeds the %d-byte ring slot for worker "
                            "%d; answering 500 (raise shm_ring_slot_bytes)", len(m), cap, widx)
                m = self._error_msg(m, 500, f"response of {len(m)} bytes exceeds the {cap}-"
                                            "byte shm ring slot; raise shm_ring_slot_bytes "
                                            "or shrink the request")
            if chunk and size + len(m) > cap:
                chunks.append(chunk)
                chunk, size = [], 0
            chunk.append(m)
            size += len(m)
        if chunk:
            chunks.append(chunk)
        for chunk in chunks:
            frame = pack_batch(chunk)
            for _ in range(_RESP_RETRY_TICKS):
                if ring.try_push(frame):
                    break
                await asyncio.sleep(0.01)
            else:
                self.resp_drops += 1
                log.warning("response ring %d full for 2 s; degrading a %d-message batch "
                            "to queued 503s", widx, len(chunk))
                dq = self._resp_backlog[widx]
                for m in chunk:
                    dq.append(self._error_msg(m, 503, "response ring congested; result "
                                                      "dropped", retry_after_s=1.0))

    def _flush_backlog(self) -> None:
        """Deliver deferred 503s as ring space frees (the deque is bounded;
        past it the worker's own timeout answers)."""
        for widx, dq in enumerate(self._resp_backlog):
            ring = self.resp_rings[widx]
            cap = ring.max_payload - _BATCH_HDR.size
            while dq:
                chunk: list[bytes] = []
                size = 0
                for m in dq:
                    if chunk and (len(chunk) >= 32 or size + len(m) > cap):
                        break
                    chunk.append(m)
                    size += len(m)
                if size > cap:              # a lone unsendable message
                    dq.popleft()
                    continue
                if not ring.try_push(pack_batch(chunk)):
                    break
                for _ in range(len(chunk)):
                    dq.popleft()

    async def _serve_one(self, server, raw: bytes, t_pop: float | None = None) -> bytes:
        """One ring request → one packed answer, through the server's
        binary-lane path (:meth:`Server.serve_frame`)."""
        if t_pop is None:
            t_pop = time.perf_counter()
        req_id, _status, routing, telem_raw, body, _ = unpack_msg(raw)
        name, _, deadline_raw = routing.partition("|")
        telem = unpack_telem(telem_raw)
        if telem is not None:
            self.ring_wait_hist.observe((t_pop - telem["t_push"]) * 1000.0)
        status, out, tp = await server.serve_frame(name, body, deadline_raw, telem, t_pop,
                                                  self._tensor_cap)
        t = telem or {"request_id": "", "t_accept": t_pop, "t_read": t_pop,
                      "t_validate": t_pop, "t_push": t_pop}
        reply_telem = pack_telem(t["request_id"], t["t_accept"], t["t_read"], t["t_validate"],
                                 t["t_push"], tp)
        return pack_msg(req_id, status, name, out, reply_telem)

    def snapshot(self) -> dict:
        return {
            "workers": self.alive_workers(),
            "ingest_port": self.ingest_port,
            "ring_depth": self.ring_depths(),
            "served": self.served,
            "resp_drops": self.resp_drops,
            "resp_oversize": self.resp_oversize,
            "resp_backlog": sum(len(d) for d in self._resp_backlog),
            "degraded_reason": self.degraded_reason,
            "spawn_seconds": list(self.spawn_seconds),
            "pool": self._pool.snapshot(),
        }

    def telemetry_snapshot(self) -> dict:
        """Per-worker counters from the stats blocks, liveness and restarts,
        and the pump's ring-wait and occupancy histograms: the JSON behind
        the ``tpuserve_acceptor_*`` families."""
        workers = []
        for i, blk in enumerate(self.stats_blocks):
            row = {"worker": i, "up": bool(self.worker_up[i]) if i < len(self.worker_up)
                   else False}
            row.update(blk.snapshot())
            workers.append(row)
        return {
            "workers": workers,
            "restarts": self.restarts,
            "ring_wait_ms": self.ring_wait_hist.snapshot(),
            "ring_occupancy_pct": {k: h.snapshot()
                                   for k, h in sorted(self.occupancy_hists.items())},
        }


if __name__ == "__main__":
    worker_main(**json.loads(sys.argv[1]))
