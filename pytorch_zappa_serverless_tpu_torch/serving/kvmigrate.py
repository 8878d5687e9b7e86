"""Live KV migration: the wire format and the accounting of moving a stream.

The port's own copy of the JAX package's ``serving/kvmigrate.py`` (the port
imports nothing of that package).  The paged pool (``serving/kvcache.py``)
makes a stream's device state a bounded list of pages plus a few scalars,
so moving a generation is a resumable page copy.  This module owns what of
that copy is not scheduler state:

- **Wire format** (``FORMAT_VERSION``): a JSON manifest (prompt ids, emitted
  tokens, the sampler scalars tok/pos/step/prev/temp/seed/top-k/top-p, the
  page geometry) and one record per KV page: its logical index, a sha256
  over the raw K then V bytes, and the bytes in base64.  Block indices are
  logical page positions, re-mapped on import.  A record and a manifest are
  byte-identical to the JAX package's for the same page bytes.
- **bfloat16 pages.** The pool is bf16 on the card and numpy has no
  bfloat16 without ``ml_dtypes``, which the port does not import: a page is
  packed from and unpacked to a CPU ``torch.bfloat16`` tensor viewed as
  ``int16`` (the wire lane's code-12 block does the same).  The manifest's
  ``dtype`` string is numpy's name, ``"bfloat16"`` or ``"float32"``, as the
  JAX package writes it.
- **Integrity**: :func:`pack_page` hashes before encoding and
  :func:`unpack_page` verifies after decoding, so a corrupted page (the
  ``migration`` fault's ``corrupt`` mode, or a real bit flip) raises
  :class:`PageIntegrityError` naming the pages to fetch again.
- **Accounting** (:class:`MigrationStats`): migrations by cause
  (``pressure``: swapped to host under KV pressure; ``failover``: resumed
  after a replica died; ``admin``: operator or router driven), pages by
  dedup outcome and a wall-time histogram, the ``tpuserve_migration*``
  families.

The protocol that moves these records (snapshot → cutover → import →
commit over ``/admin/streams``) lives in ``serving/server.py``, the pause
and resume primitives in ``serving/generation.py``.  ``MigrationStats`` is
owned by the paged scheduler's asyncio task.
"""

from __future__ import annotations

import base64
import hashlib

import numpy as np
import torch

from .metrics import Histogram

# Bumped on any incompatible manifest or page change; an importer refuses
# an unknown version.
FORMAT_VERSION = 1

# Migration wall-time histogram bounds (ms): a swap to host is sub-ms on a
# small pool; a copy between servers pays HTTP and base64.
MIGRATION_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                        250.0, 500.0, 1000.0, 2500.0)

CAUSES = ("pressure", "failover", "admin")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class MigrationError(RuntimeError):
    """A migration step failed cleanly: the stream is not lost (the source
    keeps or restores it, or the caller retries)."""


class PageIntegrityError(MigrationError):
    """A page's bytes do not match its hash; carries the logical page
    indices to fetch again."""

    def __init__(self, msg: str, indices: list[int]):
        super().__init__(msg)
        self.indices = list(indices)


class MigrationNeedsPages(MigrationError):
    """An import lacks page values (sent by reference that the local prefix
    tree cannot resolve, or arrived corrupt); carries the logical indices
    to fetch by value.  The stream is untouched."""

    def __init__(self, msg: str, indices: list[int]):
        super().__init__(msg)
        self.indices = list(indices)


def dtype_name(dtype) -> str:
    """The manifest's name of a pool dtype (numpy's: "bfloat16", "float32")."""
    for name, dt in _DTYPES.items():
        if dtype in (dt, name):
            return name
    raise MigrationError(f"no wire name for the pool dtype {dtype!r}")


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a manifest's ``dtype`` string."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise MigrationError(f"unsupported page dtype {name!r}") from None


def page_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of one page half (a CPU tensor), C order; bf16 through
    an int16 view."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def page_hash(k_bytes: bytes, v_bytes: bytes) -> str:
    """Integrity hash over one page's raw K then V bytes."""
    h = hashlib.sha256()
    h.update(k_bytes)
    h.update(v_bytes)
    return h.hexdigest()


def pack_page(index: int, k, v, corrupt: bool = False) -> dict:
    """One wire page record: logical index, integrity hash, base64 K/V.

    ``corrupt=True`` is the ``migration`` fault's ``corrupt`` hook: the hash
    is taken over the true bytes, then the payload's first byte is flipped,
    the in-flight corruption the importer's verify must catch."""
    kb, vb = page_bytes(k), page_bytes(v)
    h = page_hash(kb, vb)
    if corrupt and kb:
        kb = bytes([kb[0] ^ 0xFF]) + kb[1:]
    return {"i": int(index), "hash": h,
            "k": base64.b64encode(kb).decode("ascii"),
            "v": base64.b64encode(vb).decode("ascii")}


def _from_bytes(data: bytes, shape, dtype: torch.dtype) -> torch.Tensor:
    view = torch.int16 if dtype == torch.bfloat16 else dtype
    arr = np.frombuffer(data, torch.empty(0, dtype=view).numpy().dtype).copy()
    t = torch.from_numpy(arr)
    return (t.view(torch.bfloat16) if dtype == torch.bfloat16 else t).reshape(tuple(shape))


def unpack_page(rec: dict, shape, dtype) -> tuple[int, torch.Tensor, torch.Tensor]:
    """Decode and verify one wire page: (index, K, V) as CPU tensors of
    ``dtype``; raises :class:`PageIntegrityError` on a hash mismatch, so
    corrupt KV never reaches the pool."""
    kb = base64.b64decode(rec["k"])
    vb = base64.b64decode(rec["v"])
    if page_hash(kb, vb) != rec["hash"]:
        raise PageIntegrityError(f"page {rec.get('i')} failed its integrity check", [rec["i"]])
    dt = torch_dtype(dtype)
    return int(rec["i"]), _from_bytes(kb, shape, dt), _from_bytes(vb, shape, dt)


def check_manifest(manifest: dict) -> None:
    """Refuse a malformed or foreign manifest before any pool mutation."""
    if not isinstance(manifest, dict):
        raise MigrationError("manifest must be a JSON object")
    if manifest.get("version") != FORMAT_VERSION:
        raise MigrationError(
            f"unsupported migration format version {manifest.get('version')!r} (this build "
            f"speaks {FORMAT_VERSION})")
    for field in ("prompt", "emitted", "state", "page_shape", "dtype", "max_new", "npages"):
        if field not in manifest:
            raise MigrationError(f"manifest missing field {field!r}")


class MigrationStats:
    """Per-lane migration counters (owned by the scheduler's asyncio task)."""

    def __init__(self):
        self.by_cause = dict.fromkeys(CAUSES, 0)  # guarded-by: event-loop
        self.pages_hit = 0     # guarded-by: event-loop (dedup: adopted)
        self.pages_copied = 0  # guarded-by: event-loop (dedup: by value)
        self.failed = 0        # guarded-by: event-loop (clean failures)
        self.ms = Histogram(MIGRATION_BUCKETS_MS)

    def note(self, cause: str, dedup_hits: int, copied: int, wall_ms: float):
        self.by_cause[cause] = self.by_cause.get(cause, 0) + 1
        self.pages_hit += int(dedup_hits)
        self.pages_copied += int(copied)
        self.ms.observe(float(wall_ms))

    def snapshot(self) -> dict:
        return {
            "by_cause": dict(self.by_cause),
            "total": sum(self.by_cause.values()),
            "pages": {"hit": self.pages_hit, "copied": self.pages_copied},
            "failed": self.failed,
            "ms": self.ms.snapshot(),
        }
