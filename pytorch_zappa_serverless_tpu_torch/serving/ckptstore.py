"""Content-addressed streaming checkpoint store (the serving half).

The port's own copy of the JAX package's ``serving/ckptstore.py``: the same
layout and manifests, holding the port's own tensors (a model's parameters
and buffers by module path, ``/``-joined).  The two packages' stores are
not shared: point each at its own directory.

``engine/streamio.py`` owns the pure byte format and the overlapped
read → stage → device pipeline; this module owns *policy*: where checkpoints
live on disk, how they dedup against each other, and how the chaos /
metrics planes see them.  Layering rule (faults.py): ``engine`` never
imports ``serving`` — so the store imports streamio, not the reverse.

Layout under ``root``::

    chunks/<hh>/<hash>        content-addressed chunk files (hh = hash[:2])
    manifests/<digest>.json   one manifest per (base, adapter) key

A manifest is a :class:`streamio.StreamIndex` header plus its key: the
per-tensor dtype/shape/offset index and the ordered chunk-hash list.
Chunks are shared by content: two variants of a family whose early
layers are byte-identical share that entire chunk prefix, and an
adapter manifest (keyed ``(base, adapter)``) holds only the tenant's delta
tree.  ``put`` is
write-once per key AND source checkpoint: re-staging an unchanged
checkpoint costs one hash pass and zero writes, while a manifest whose
recorded :func:`checkpoint_fingerprint` no longer matches the source
file reads as a miss and is re-staged (a swapped checkpoint must never
silently serve its predecessor's bytes across a restart).

Chaos: a :class:`faults.FaultInjector` rule ``kind="ckpt"`` with
``mode="torn"`` corrupts a chunk's read (the pipeline re-reads once, then
fails naming the chunk index) and ``mode="slow"`` injects per-chunk read
latency.  The lifecycle degrades a failed stream load to the full rebuild,
never a dead activation.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from pathlib import Path
from typing import Any, Callable

from ..engine import streamio
from ..engine.streamio import (ChunkEntry, ChunkIntegrityError,  # noqa: F401
                               StreamFormatError, StreamIndex, StreamStats)
from .metrics import Histogram

_MANIFEST_VERSION = 1

# Streamed-load wall times span tmpfs microseconds to cold-NFS seconds.
CKPT_LOAD_BUCKETS_MS = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                        1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def store_key(base: str, adapter: str = "") -> str:
    """Human-readable ``(base, adapter)`` key for logs/labels."""
    return f"{base}+{adapter}" if adapter else base


def _key_digest(base: str, adapter: str) -> str:
    # Model/adapter names are operator input (possibly hostile as file
    # names); the manifest FILE name is a digest, the real key lives in
    # the manifest body.
    return hashlib.sha1(f"{base}\x00{adapter}".encode()).hexdigest()


def checkpoint_fingerprint(path: str | None) -> str:
    """Identity of the SOURCE checkpoint behind a manifest.

    ``(path, size, mtime_ns)`` — cheap to compute, and any checkpoint
    swap an operator can make changes it.  The lifecycle hands it to :meth:`CheckpointStore.has` /
    :meth:`CheckpointStore.put` so a manifest staged from an older
    checkpoint reads as a MISS (forcing a re-seed) instead of silently
    streaming stale weights over a fresh build across a server restart.
    ``""`` for models with no checkpoint (deterministic random-init dev
    mode), which matches only manifests seeded the same way.
    """
    if not path:
        return ""
    p = Path(path).expanduser()
    try:
        st = p.stat()
    except OSError:
        return f"missing:{p}"
    return f"{p}:{st.st_size}:{st.st_mtime_ns}"


class StoreChunkSource(streamio.ChunkSource):
    """Feed the stream pipeline from content-addressed chunk files."""

    def __init__(self, store: "CheckpointStore", index: StreamIndex):
        self.store = store
        self.index = index

    def read_chunk(self, i: int) -> bytes:
        return self.store._chunk_path(self.index.chunks[i].hash).read_bytes()


class CheckpointStore:
    """Chunk-dedup'd checkpoint store rooted at one local directory."""

    def __init__(self, root: str | Path,
                 chunk_bytes: int = streamio.DEFAULT_CHUNK_BYTES,
                 faults: Any = None):
        self.root = Path(root).expanduser()
        self.chunk_bytes = int(chunk_bytes)
        self.faults = faults  # FaultInjector or None; set late by server
        self._chunks_dir = self.root / "chunks"
        self._manifests_dir = self.root / "manifests"
        self._chunks_dir.mkdir(parents=True, exist_ok=True)
        self._manifests_dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        # Lifetime counters the metrics plane scrapes; loads run on
        # executor threads, so every mutation holds the lock.
        self._chunks_streamed: dict[str, int] = {}  # guarded-by: _lock
        self._dedup_hits: dict[str, int] = {}       # guarded-by: _lock
        self._load_ms: dict[str, list] = {}         # guarded-by: _lock
        self._degraded = 0                          # guarded-by: _lock
        # Lifetime per-key load histograms for tpuserve_ckpt_load_ms.
        self.load_hists: dict[str, Histogram] = {}  # guarded-by: _lock

    # -- paths ---------------------------------------------------------------

    def _chunk_path(self, h: str) -> Path:
        return self._chunks_dir / h[:2] / h

    def _manifest_path(self, base: str, adapter: str) -> Path:
        return self._manifests_dir / (_key_digest(base, adapter) + ".json")

    # -- manifest index ------------------------------------------------------

    def has(self, base: str, adapter: str = "",
            fingerprint: str | None = None) -> bool:
        """True when a manifest exists for the key — and, when the caller
        supplies the source checkpoint's ``fingerprint``, was staged from
        that same checkpoint.  A mismatch (operator swapped the file,
        then restarted onto the same store dir) is a MISS: streaming it
        would serve stale weights."""
        if fingerprint is None:
            return self._manifest_path(base, adapter).exists()
        try:
            raw = self._read_manifest(base, adapter)
        except (OSError, ValueError, KeyError):
            return False
        return raw.get("fingerprint", "") == fingerprint

    def _read_manifest(self, base: str, adapter: str) -> dict:
        raw = json.loads(self._manifest_path(base, adapter).read_text())
        if int(raw.get("manifest_version", -1)) != _MANIFEST_VERSION:
            raise StreamFormatError(
                f"unsupported manifest version for {store_key(base, adapter)}")
        return raw

    def index_for(self, base: str, adapter: str = "") -> StreamIndex:
        """Shape/dtype metadata without touching one payload byte — what
        the loader compiles against while weights stream."""
        return StreamIndex.from_header(self._read_manifest(base, adapter))

    def manifest_nbytes(self, base: str, adapter: str = "") -> int:
        """Logical (pre-dedup) bytes of one manifest; 0 when absent OR
        unreadable — one corrupt/version-bumped manifest file must not
        take down the whole snapshot()/admin/models surface."""
        try:
            return self.index_for(base, adapter).total_bytes
        except (OSError, ValueError, KeyError):
            return 0

    def keys(self) -> list[tuple[str, str]]:
        out = []
        for p in sorted(self._manifests_dir.glob("*.json")):
            try:
                raw = json.loads(p.read_text())
                out.append((raw["base"], raw.get("adapter", "")))
            except (ValueError, KeyError):
                continue
        return out

    # -- write path ----------------------------------------------------------

    def put(self, base: str, params: Any, adapter: str = "",
            force: bool = False, fingerprint: str | None = None) -> dict:
        """Stage a param tree under ``(base, adapter)``; dedup by chunk.

        Returns put stats.  Write-once PER SOURCE CHECKPOINT: an existing
        manifest short-circuits unless ``force`` or its recorded
        ``fingerprint`` (:func:`checkpoint_fingerprint` of the source
        file) no longer matches — staging is idempotent, so every cold
        build can call this unconditionally, and a swapped checkpoint
        re-stages instead of leaving stale chunks live.
        """
        from ..engine import weights as W

        key = store_key(base, adapter)
        if not force and self.has(base, adapter, fingerprint=fingerprint):
            return {"key": key, "skipped": True, "chunks_written": 0,
                    "dedup_hits": 0, "nbytes": self.manifest_nbytes(base, adapter)}
        flat = W.flatten_tree(params)
        index = streamio.build_index(flat, self.chunk_bytes)
        written = dedup = 0
        hashes: list[str] = []
        for _, data in streamio.iter_logical_chunks(flat, index):
            h = streamio.chunk_hash(data)
            hashes.append(h)
            path = self._chunk_path(h)
            if path.exists():
                dedup += 1
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(data)
            tmp.replace(path)
            written += 1
        index.chunks = [ChunkEntry(h, c.nbytes)
                        for h, c in zip(hashes, index.chunks)]
        manifest = dict(index.header_json(),
                        manifest_version=_MANIFEST_VERSION,
                        base=base, adapter=adapter,
                        fingerprint=fingerprint or "")
        mpath = self._manifest_path(base, adapter)
        tmp = mpath.with_suffix(".tmp")
        tmp.write_text(json.dumps(manifest, separators=(",", ":")))
        tmp.replace(mpath)
        with self._lock:
            self._dedup_hits[key] = self._dedup_hits.get(key, 0) + dedup
        return {"key": key, "skipped": False, "chunks_written": written,
                "dedup_hits": dedup, "nbytes": index.total_bytes}

    # -- read path -----------------------------------------------------------

    def _chaos_fn(self, base: str) -> Callable[[int, bytes], bytes] | None:
        faults = self.faults
        if faults is None or not hasattr(faults, "on_ckpt"):
            return None

        def fn(i: int, data: bytes) -> bytes:
            mode, latency_s = faults.on_ckpt(base)
            if mode is None:
                return data
            if latency_s:
                time.sleep(latency_s)
            if mode == "torn" and data:
                # Flip one byte: the integrity hash catches it, the
                # pipeline re-reads once, and the error names chunk i.
                return bytes([data[0] ^ 0xFF]) + data[1:]
            return data

        return fn

    def load(self, base: str, adapter: str = "", *,
             place_fn: Callable[[Any], Any] | None = None,
             on_layer: Callable[[str], None] | None = None,
             ) -> tuple[dict[str, Any], StreamStats]:
        """Streamed load of ``(base, adapter)`` through the overlap
        pipeline; returns ``(param_tree, stats)``, the leaves CPU tensors or
        what ``place_fn`` made of them (``streamio.device_placer``).

        Raises :class:`ChunkIntegrityError` / :class:`StreamFormatError` /
        ``FileNotFoundError`` on a broken stream: callers take the full
        rebuild and call :meth:`note_degraded`.
        """
        from ..engine import weights as W

        key = store_key(base, adapter)
        source = StoreChunkSource(self, self.index_for(base, adapter))
        flat, stats = streamio.stream_load(
            source, place_fn=place_fn, on_layer=on_layer,
            chaos_fn=self._chaos_fn(base))
        with self._lock:
            self._chunks_streamed[key] = (
                self._chunks_streamed.get(key, 0) + stats.chunks_streamed)
            self._load_ms.setdefault(key, []).append(stats.load_ms)
            del self._load_ms[key][:-64]
            hist = self.load_hists.get(key)
            if hist is None:
                hist = self.load_hists[key] = Histogram(CKPT_LOAD_BUCKETS_MS)
            hist.observe(stats.load_ms)
        return W.unflatten_tree(flat), stats

    def load_hists_snapshot(self) -> dict[str, Histogram]:
        """Stable view for the /metrics scrape (loads mutate the dict on
        executor threads)."""
        with self._lock:
            return dict(self.load_hists)

    def note_degraded(self):
        """A stream load failed and the caller took the full rebuild."""
        with self._lock:
            self._degraded += 1

    def delete(self, base: str, adapter: str = "") -> bool:
        """Drop one manifest (chunks stay; they may be shared)."""
        mpath = self._manifest_path(base, adapter)
        if not mpath.exists():
            return False
        mpath.unlink()
        return True

    # -- accounting ----------------------------------------------------------

    def physical_bytes(self) -> int:
        """Actual on-disk chunk bytes (post-dedup)."""
        return sum(p.stat().st_size
                   for p in self._chunks_dir.glob("*/*") if p.is_file())

    def snapshot(self) -> dict:
        """Store-wide accounting for /admin/models, CLI, and metrics."""
        logical = 0
        manifests = 0
        for base, adapter in self.keys():
            logical += self.manifest_nbytes(base, adapter)
            manifests += 1
        physical = self.physical_bytes()
        with self._lock:
            chunks_streamed = dict(self._chunks_streamed)
            dedup_hits = dict(self._dedup_hits)
            load_ms = {k: list(v) for k, v in self._load_ms.items()}
            degraded = self._degraded
        return {
            "root": str(self.root),
            "chunk_bytes": self.chunk_bytes,
            "manifests": manifests,
            "logical_bytes": logical,
            "physical_bytes": physical,
            "dedup_ratio": round(logical / physical, 4) if physical else 1.0,
            "chunks_streamed_total": chunks_streamed,
            "dedup_hits_total": dedup_hits,
            "load_ms": load_ms,
            "degraded_loads_total": degraded,
        }
