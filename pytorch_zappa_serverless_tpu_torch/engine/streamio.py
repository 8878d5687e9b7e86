"""Chunked checkpoint format and the overlapped read → stage → device loader.

The port's own copy of the JAX package's ``engine/streamio.py``: the same
byte format, so either package reads what the other writes.  Serverless
cold starts are dominated by loading, and the fix is a loading-ordered
format: fixed-size chunks laid out in the model's layer execution order,
streamed through a bounded pipeline so the device copy of tensor N
overlaps the disk read of tensor N+1.  This module is the pure half: the
byte format and the pipeline.  The content-addressed store that dedups
chunks lives in ``serving/ckptstore.py`` and builds on these primitives.

Single-file layout (``*.tpu.ckpt``, ``engine/weights.py save_stream``)::

    magic    8 B   b"TPUCKPT1" (the version byte is part of the magic)
    hdr_len  4 B   u32 LE
    payload        chunks back to back, chunk i = logical bytes
                   [i*chunk_bytes, i*chunk_bytes + nbytes_i)
    header   JSON  {"version": 1, "chunk_bytes": N,
                    "tensors": [{"name", "dtype", "shape",
                                 "offset", "nbytes"}, ...],   # exec order
                    "chunks":  [{"hash", "nbytes"}, ...]}

The logical stream is every tensor's C-contiguous bytes in execution
order; a tensor's ``offset`` indexes into it.  Chunks are fixed-size slices
of it, each hashed (blake2b-128) so a torn read names its chunk.

Where the port differs: leaves are torch tensors.  A loaded tensor is a CPU
tensor over the bytes read (``place_fn`` receives it), and ``bfloat16``,
which numpy has no dtype for without ``ml_dtypes``, is carried as raw bytes
and restored through ``torch.frombuffer`` under the same dtype name, so a
bf16 stream loads on a machine without ``ml_dtypes``.  The writer takes
torch tensors or numpy arrays (a JAX tree's ``ml_dtypes`` bfloat16 array
is written by its dtype name too).  :func:`device_placer` is the
``place_fn`` that stages each finished tensor through pinned memory onto
the card on one copy stream.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from queue import Full, Queue
from typing import Any, Callable, Mapping

import numpy as np
import torch

MAGIC = b"TPUCKPT1"
STREAM_VERSION = 1
# 1 MiB chunks: large enough that per-chunk hash and queue overhead is noise,
# small enough that the device copies start after one disk read and the
# staging ring stays a few MB.
DEFAULT_CHUNK_BYTES = 1 << 20
# The bounded staging ring between the reader thread and the consumer: at
# most this many chunks wait in host memory, so streaming a 10 GB
# checkpoint needs ~depth x chunk_bytes of staging, not 10 GB.
DEFAULT_PIPELINE_DEPTH = 4
# Chunks read and hashed at once ahead of the ring (hashlib and file reads
# release the GIL, and the hash is most of a chunk's cost); staging is at
# most depth + this many chunks.
VERIFY_WORKERS = 4

# The dtype names a stream may carry (numpy's names; torch's for bfloat16).
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


class StreamFormatError(ValueError):
    """The file is not a valid stream checkpoint (bad magic or header)."""


class ChunkIntegrityError(RuntimeError):
    """A chunk failed its integrity hash after the one permitted re-read;
    ``chunk_index`` names it."""

    def __init__(self, chunk_index: int, detail: str = ""):
        super().__init__(
            f"chunk {chunk_index} failed integrity verification after "
            f"re-read{': ' + detail if detail else ''}")
        self.chunk_index = chunk_index


def chunk_hash(data: bytes) -> str:
    """Content hash of one chunk (blake2b-128 hex): its integrity check and
    the address ``serving/ckptstore.py`` dedups on."""
    return hashlib.blake2b(bytes(data), digest_size=16).hexdigest()


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a stream's dtype name."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise StreamFormatError(f"unsupported tensor dtype {name!r}") from None


def leaf_bytes(value: Any) -> tuple[str, tuple[int, ...], np.ndarray]:
    """(dtype name, shape, flat uint8 view of the C-contiguous bytes) of a
    torch tensor or numpy array, without a copy where the leaf is already
    contiguous on the host."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise StreamFormatError(f"unsupported tensor dtype {t.dtype}")
        flat = t.reshape(-1).view(torch.uint8) if t.numel() else torch.empty(0, dtype=torch.uint8)
        return _DTYPE_NAMES[t.dtype], tuple(t.shape), flat.numpy()
    arr = np.ascontiguousarray(value)
    # reshape(-1).view(uint8) is buffer-safe even for ml_dtypes' bfloat16.
    return arr.dtype.name, tuple(arr.shape), arr.reshape(-1).view(np.uint8)


# -- layer execution order ----------------------------------------------------
#
# Flat names ("layer3/attention/q/kernel") sort into the order the forward
# pass consumes them: embeddings and stem first, numbered blocks by index,
# final norms and heads last.  The order only has to be deterministic and
# front-load the early layers.

_LAYER_IDX = re.compile(r"(?:^|/)(?:layer|block|down|up|res|h)(\d+)(?:_\d+)?(?:/|$)")
_EARLY = ("embed", "wte", "wpe", "pos_embed", "pos_embedding", "cls_token",
          "token_embedding", "patch_embed", "stem", "conv1", "bn1",
          "conv_in", "time_mlp")
_LATE = ("final_ln", "ln_f", "classifier", "fc", "pooler", "head",
         "norm_out", "conv_out", "top_conv", "top_bn", "post_quant")


def execution_order_key(name: str) -> tuple:
    """Sort key placing ``name`` at its layer-execution position."""
    head = name.split("/", 1)[0]
    m = _LAYER_IDX.search(name)
    if m is not None:
        return (1, int(m.group(1)), name)
    if any(head.startswith(e) for e in _EARLY):
        return (0, 0, name)
    if any(head.startswith(t) for t in _LATE):
        return (2, 0, name)
    return (1, 0, name)


def order_tensors(flat: Mapping[str, Any]) -> list[str]:
    """Flat names in layer execution order (stable)."""
    return sorted(flat, key=execution_order_key)


def layer_of(name: str) -> str:
    """The layer grouping key the readiness callbacks fire on."""
    m = _LAYER_IDX.search(name)
    if m is not None:
        return m.group(0).strip("/")
    return name.split("/", 1)[0]


# -- index --------------------------------------------------------------------

@dataclass(frozen=True)
class TensorEntry:
    name: str
    dtype: str
    shape: tuple[int, ...]
    offset: int  # into the logical stream
    nbytes: int

    def public(self) -> dict:
        return {"name": self.name, "dtype": self.dtype,
                "shape": list(self.shape), "offset": self.offset,
                "nbytes": self.nbytes}


@dataclass(frozen=True)
class ChunkEntry:
    hash: str
    nbytes: int

    def public(self) -> dict:
        return {"hash": self.hash, "nbytes": self.nbytes}


@dataclass
class StreamIndex:
    """The parsed header: what is in the stream and where."""

    chunk_bytes: int
    tensors: list[TensorEntry]
    chunks: list[ChunkEntry]
    version: int = STREAM_VERSION

    @property
    def total_bytes(self) -> int:
        return sum(t.nbytes for t in self.tensors)

    def header_json(self) -> dict:
        return {"version": self.version, "chunk_bytes": self.chunk_bytes,
                "tensors": [t.public() for t in self.tensors],
                "chunks": [c.public() for c in self.chunks]}

    @classmethod
    def from_header(cls, header: dict) -> "StreamIndex":
        if int(header.get("version", -1)) != STREAM_VERSION:
            raise StreamFormatError(
                f"unsupported stream version {header.get('version')!r}")
        return cls(
            chunk_bytes=int(header["chunk_bytes"]),
            tensors=[TensorEntry(t["name"], t["dtype"], tuple(t["shape"]),
                                 int(t["offset"]), int(t["nbytes"]))
                     for t in header["tensors"]],
            chunks=[ChunkEntry(c["hash"], int(c["nbytes"]))
                    for c in header["chunks"]])


def build_index(flat: Mapping[str, Any], chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                order: list[str] | None = None) -> StreamIndex:
    """Lay the flat tree out as a logical stream in execution order."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    names = order if order is not None else order_tensors(flat)
    tensors, offset = [], 0
    for name in names:
        dtype, shape, data = leaf_bytes(flat[name])
        tensors.append(TensorEntry(name, dtype, shape, offset, data.nbytes))
        offset += data.nbytes
    n_chunks = (offset + chunk_bytes - 1) // chunk_bytes
    chunks = [ChunkEntry("", min(chunk_bytes, offset - i * chunk_bytes))
              for i in range(n_chunks)]
    return StreamIndex(chunk_bytes=chunk_bytes, tensors=tensors, chunks=chunks)


def iter_logical_chunks(flat: Mapping[str, Any], index: StreamIndex):
    """Yield ``(chunk_idx, bytes)`` of the logical stream without ever
    materializing it whole: the writer's twin of the read pipeline."""
    buf = bytearray()
    idx = 0
    for t in index.tensors:
        data = memoryview(leaf_bytes(flat[t.name])[2])
        pos = 0
        while pos < len(data):
            take = min(index.chunk_bytes - len(buf), len(data) - pos)
            buf += data[pos:pos + take]
            pos += take
            if len(buf) == index.chunk_bytes:
                yield idx, bytes(buf)
                idx += 1
                buf.clear()
    if buf:
        yield idx, bytes(buf)


# -- single-file writer / reader ----------------------------------------------

def write_stream_file(flat: Mapping[str, Any], path: str | Path,
                      chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> StreamIndex:
    """Write the single-file ``*.tpu.ckpt`` form (weights.save_stream)."""
    index = build_index(flat, chunk_bytes)
    hashes: list[str] = []
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", 0))  # the header's length, patched below
        header_pos = f.tell()
        for _, data in iter_logical_chunks(flat, index):
            hashes.append(chunk_hash(data))
            f.write(data)
        payload = f.tell() - header_pos
        index.chunks = [ChunkEntry(h, c.nbytes) for h, c in zip(hashes, index.chunks)]
        header = json.dumps(index.header_json(), separators=(",", ":")).encode()
        f.write(header)
        f.seek(len(MAGIC))
        f.write(struct.pack("<I", len(header)))
        # The header goes AFTER the payload (one pass over the tensor bytes),
        # its length patched into the fixed slot; readers seek from the end.
        f.seek(0, 2)
        assert f.tell() == header_pos + payload + len(header)
    tmp.replace(path)
    return index


def read_stream_header(path: str | Path) -> tuple[StreamIndex, int]:
    """Parse the header; returns (index, payload_offset).  Shapes and dtypes
    are known before one payload byte is read."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise StreamFormatError(f"{path}: bad magic {magic!r}")
        (hdr_len,) = struct.unpack("<I", f.read(4))
        payload_off = f.tell()
        f.seek(-hdr_len, 2)
        header = json.loads(f.read(hdr_len).decode())
    return StreamIndex.from_header(header), payload_off


@dataclass
class StreamStats:
    """What one streamed load did."""

    chunks_streamed: int = 0
    bytes_read: int = 0
    torn_retries: int = 0
    load_ms: float = 0.0
    tensors: int = 0
    layers_ready: list[str] = field(default_factory=list)

    def public(self) -> dict:
        return {"chunks_streamed": self.chunks_streamed,
                "bytes_read": self.bytes_read,
                "torn_retries": self.torn_retries,
                "load_ms": round(self.load_ms, 3),
                "tensors": self.tensors,
                "layers": len(self.layers_ready)}


class ChunkSource:
    """Chunk supplier for the pipeline: the single-file form and the
    content-addressed store both implement ``read_chunk``."""

    index: StreamIndex

    def read_chunk(self, i: int) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError


class FileChunkSource(ChunkSource):
    """Chunks out of one ``*.tpu.ckpt`` file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.index, self._payload_off = read_stream_header(self.path)
        # Positional reads: the pipeline's verify workers share the one
        # descriptor without a seek.
        self._fd = os.open(self.path, os.O_RDONLY)

    def read_chunk(self, i: int) -> bytes:
        return os.pread(self._fd, self.index.chunks[i].nbytes,
                        self._payload_off + i * self.index.chunk_bytes)

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


def _verified_chunk(source: ChunkSource, i: int, stats: StreamStats, lock: threading.Lock,
                    chaos_fn: Callable[[int, bytes], bytes] | None) -> bytes:
    """One chunk, hash-verified, with exactly one re-read on a torn read.
    ``chaos_fn`` (the ckpt fault hook) may corrupt or delay the bytes; the
    retry reads through it again, so a persistent fault fails naming the
    chunk.  Runs on a verify worker; ``lock`` guards ``stats``."""
    want = source.index.chunks[i].hash
    for _ in (0, 1):
        data = source.read_chunk(i)
        if chaos_fn is not None:
            data = chaos_fn(i, data)
        ok = len(data) == source.index.chunks[i].nbytes and chunk_hash(data) == want
        with lock:
            stats.bytes_read += len(data)
            stats.torn_retries += int(not ok)
        if ok:
            return data
    raise ChunkIntegrityError(i, f"expected {want}")


def stream_load(source: ChunkSource, *,
                place_fn: Callable[[torch.Tensor], Any] | None = None,
                on_layer: Callable[[str], None] | None = None,
                depth: int = DEFAULT_PIPELINE_DEPTH,
                chaos_fn: Callable[[int, bytes], bytes] | None = None,
                ) -> tuple[dict[str, Any], StreamStats]:
    """The overlapped pipeline: disk read → staging ring → per-tensor place.

    A reader thread pulls verified chunks, in order, into a bounded queue
    (up to ``VERIFY_WORKERS`` chunks read and hashed at once ahead of it,
    so a persistent tear still fails at the first torn chunk); this thread
    assembles tensors in execution order and hands each finished one (a CPU
    tensor over its bytes) to ``place_fn`` at once (:func:`device_placer`
    on the card: an asynchronous copy, so the copy of tensor N overlaps the
    read of N+1).  ``on_layer`` fires when the last tensor of a layer has
    been placed.  Returns ``(flat_tree, stats)``; the leaves are what
    ``place_fn`` returned (the CPU tensors when None).
    """
    index = source.index
    t0 = time.perf_counter()
    stats = StreamStats(tensors=len(index.tensors))
    q: Queue = Queue(maxsize=max(depth, 1))
    err: list[BaseException] = []
    cancel = threading.Event()

    def _ring_put(item) -> bool:
        # A bounded put that observes cancellation: if the consumer dies
        # (place_fn out of memory, on_layer raising, a format error) while
        # the ring is full, a plain put would block forever, and the
        # consumer's join with it.
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except Full:
                continue
        return False

    stats_lock = threading.Lock()

    def reader():
        try:
            with ThreadPoolExecutor(VERIFY_WORKERS, thread_name_prefix="ckpt-verify") as pool:
                ahead: deque = deque()  # (chunk index, its verify future), in order

                def deliver() -> bool:
                    i, fut = ahead.popleft()
                    if _ring_put((i, fut.result())):
                        return True
                    for _, f in ahead:  # the consumer gave up
                        f.cancel()
                    return False

                for i in range(len(index.chunks)):
                    ahead.append((i, pool.submit(_verified_chunk, source, i, stats, stats_lock,
                                                 chaos_fn)))
                    if len(ahead) == VERIFY_WORKERS and not deliver():
                        return
                while ahead:
                    if not deliver():
                        return
        except BaseException as e:  # surfaced on the consumer's side
            err.append(e)
        finally:
            _ring_put(None)

    th = threading.Thread(target=reader, name="ckpt-stream-reader", daemon=True)
    th.start()

    out: dict[str, Any] = {}
    tensors = index.tensors
    pending_by_layer: dict[str, int] = {}
    for t in tensors:
        lay = layer_of(t.name)
        pending_by_layer[lay] = pending_by_layer.get(lay, 0) + 1

    ti = 0  # the next tensor to start
    cur: bytearray | None = None  # the bytes of the tensor in flight
    cur_pos = 0
    logical = 0  # logical-stream offset consumed so far

    def finish(entry: TensorEntry, data: bytearray):
        dtype = torch_dtype(entry.dtype)
        if entry.nbytes:
            # bfloat16 too: the raw bytes under the index's dtype name.
            t = torch.frombuffer(data, dtype=dtype).reshape(entry.shape)
        else:
            t = torch.empty(entry.shape, dtype=dtype)
        out[entry.name] = place_fn(t) if place_fn is not None else t
        lay = layer_of(entry.name)
        pending_by_layer[lay] -= 1
        if pending_by_layer[lay] == 0:
            stats.layers_ready.append(lay)
            if on_layer is not None:
                on_layer(lay)

    def skip_empty():
        nonlocal ti
        while ti < len(tensors) and tensors[ti].nbytes == 0:
            finish(tensors[ti], bytearray())
            ti += 1

    try:
        skip_empty()
        while True:
            item = q.get()
            if item is None:
                break
            _, data = item
            stats.chunks_streamed += 1
            view = memoryview(data)
            pos = 0
            while pos < len(view):
                if cur is None:
                    if ti >= len(tensors):
                        raise StreamFormatError("payload longer than the tensor index")
                    entry = tensors[ti]
                    assert entry.offset == logical, (entry, logical)
                    cur = bytearray(entry.nbytes)
                    cur_pos = 0
                take = min(tensors[ti].nbytes - cur_pos, len(view) - pos)
                cur[cur_pos:cur_pos + take] = view[pos:pos + take]
                cur_pos += take
                pos += take
                logical += take
                if cur_pos == tensors[ti].nbytes:
                    finish(tensors[ti], cur)
                    cur = None
                    ti += 1
                    skip_empty()
    finally:
        # Release a reader blocked on the bounded ring before joining.
        cancel.set()
        th.join()
    if err:
        raise err[0]
    if ti != len(tensors):
        raise StreamFormatError(f"stream ended early: {ti}/{len(tensors)} tensors landed")
    stats.load_ms = (time.perf_counter() - t0) * 1000.0
    return out, stats


def load_stream_file(path: str | Path, **kw) -> tuple[dict[str, Any], StreamStats]:
    """Streamed load of a single-file checkpoint (weights.open_stream)."""
    source = FileChunkSource(path)
    try:
        return stream_load(source, **kw)
    finally:
        source.close()


# -- placement on the card ------------------------------------------------------

@functools.cache
def copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream every streamed tensor's host-to-device copy runs on."""
    return torch.cuda.Stream(device)


def device_placer(device: str | torch.device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ``place_fn`` that puts each finished tensor on ``device``.

    On the card: the tensor is copied into a pinned staging buffer, then to
    the device with ``non_blocking=True`` on :func:`copy_stream`, so the
    copy overlaps the next read (the caching host allocator keeps the
    staging block until its copy is done).  The tensor it returns was made
    on the copy stream: a consumer must :func:`adopt` it onto its own stream
    before any launch reads it.  Each tensor's device calls hold
    ``engine.compiled.CAPTURE_LOCK``: a stream may place tensors from
    another thread while the dispatch thread captures a CUDA graph, and no
    other thread may allocate or copy while a capture is open.  On the CPU
    the tensor is returned as it is (it owns its bytes).
    """
    from .compiled import CAPTURE_LOCK

    dev = torch.device(device)
    if dev.type == "cpu":
        return lambda t: t

    def place(t: torch.Tensor) -> torch.Tensor:
        with CAPTURE_LOCK:
            side = copy_stream(dev)
            staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            staged.copy_(t)
            with torch.cuda.stream(side):
                return staged.to(dev, non_blocking=True)

    return place


def adopt(tensors, device: str | torch.device) -> None:
    """Make tensors from :func:`device_placer` safe on the current stream:
    it waits for the copy stream's queued copies, and each tensor records
    the current stream, so the caching allocator does not hand its block
    to the copy stream's next allocation while a launch here still reads
    it.  Call on the thread (and stream) that will read them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    cur = torch.cuda.current_stream(dev)
    cur.wait_stream(copy_stream(dev))
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(cur)
