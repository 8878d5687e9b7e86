"""The binary tensor lane: the ``application/x-tpuserve-tensor`` codec.

The port's copy of the JAX package's ``serving/wire.py`` (numpy and the
standard library; torch only for bfloat16 blocks).  The JSON lane pays
three host costs a request that have nothing to do with inference: a JSON
parse over a body that is mostly base64 text, the base64 decode itself,
and, for an image, its decode.  A tensor frame carries a compact dtype and
shape header and the raw row-major bytes, and :func:`unpack` hands the
server ``np.frombuffer`` views over the request body: no base64, no JSON
parse, no copy per instance.

Frame layout (every integer little-endian)::

    frame  := header block*
    header := magic "TPUT" | version u8 (=1) | flags u8 | count u16
    block  := dtype u8 | ndim u8 | reserved u16 (=0)
              | dim u32 * ndim | data (row-major bytes)

Flags: ``FLAG_LIST`` marks instances-list semantics (the body twin of
``{"instances": [...]}``; a single-block frame without it is one bare
payload); ``FLAG_META`` marks block 0 as a JSON meta object (answers carry
``{"model", "timing", ...}`` there).  A block whose dtype code is
:data:`DTYPE_JSON` holds compact UTF-8 JSON instead of tensor bytes: how
structured predictions (a classifier's top-k dicts) ride a binary answer,
decoding to the values the JSON lane returns.

Frames are byte-identical to the JAX package's for every dtype code.  The
one difference is bfloat16 (code 12): numpy has no such dtype here (the
port does not use ``ml_dtypes``), so a bfloat16 block packs from a CPU
``torch.bfloat16`` tensor and unpacks to a fresh one (the only block that
is decoded by copy; every other tensor block is a read-only view).

A malformed frame raises :class:`FrameError` (the server answers 400 with
the request and trace ids); a frame whose *declared* payload exceeds the
cap raises :class:`FrameTooLarge` (413) before any allocation, so a hostile
header cannot make the server allocate what it claims.
"""

from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np

TENSOR_CONTENT_TYPE = "application/x-tpuserve-tensor"

MAGIC = b"TPUT"
VERSION = 1

FLAG_LIST = 0x01   # instances-list semantics (even when count == 1)
FLAG_META = 0x02   # block 0 is a JSON meta object (answer frames)

_DTYPE_NAMES = {
    0: "uint8", 1: "int8", 2: "uint16", 3: "int16", 4: "uint32",
    5: "int32", 6: "uint64", 7: "int64", 8: "float16", 9: "float32",
    10: "float64", 11: "bool",
}
BF16_CODE = 12     # a CPU torch.bfloat16 tensor on this side of the wire
DTYPE_JSON = 0xF0  # block data is compact UTF-8 JSON, not tensor bytes

_CODE_TO_DTYPE: dict[int, np.dtype] = {c: np.dtype(n) for c, n in _DTYPE_NAMES.items()}
_DTYPE_TO_CODE: dict[np.dtype, int] = {d: c for c, d in _CODE_TO_DTYPE.items()}

_MAX_NDIM = 8
_MAX_COUNT = 4096

_HDR = struct.Struct("<4sBBH")   # magic, version, flags, count
_BLK = struct.Struct("<BBH")     # dtype, ndim, reserved
_DIM = struct.Struct("<I")


class FrameError(ValueError):
    """A malformed tensor frame (magic, version, dtype, shape, truncation)."""


class FrameTooLarge(FrameError):
    """The declared payload exceeds the frame cap (HTTP 413)."""


def _json_bytes(obj: Any) -> bytes:
    """Compact one-pass JSON encode (one encoder walk a block)."""
    return json.dumps(obj, separators=(",", ":")).encode()


def _is_bf16_tensor(item: Any) -> bool:
    import sys

    torch = sys.modules.get("torch")  # a bf16 tensor implies torch is loaded
    return torch is not None and isinstance(item, torch.Tensor) and item.dtype == torch.bfloat16


# -- pack ---------------------------------------------------------------------

def _block_parts(item: Any) -> tuple[int, tuple[int, ...], bytes | np.ndarray]:
    """(dtype code, dims, data source) of one block."""
    if _is_bf16_tensor(item):
        if item.ndim > _MAX_NDIM:
            raise FrameError(f"ndim {item.ndim} exceeds the wire cap ({_MAX_NDIM})")
        import torch

        bits = item.detach().cpu().contiguous().view(torch.int16).numpy()
        return BF16_CODE, tuple(item.shape), bits
    if isinstance(item, np.ndarray):
        code = _DTYPE_TO_CODE.get(item.dtype)
        if code is None:
            raise FrameError(f"dtype {item.dtype} has no wire code")
        if item.ndim > _MAX_NDIM:
            raise FrameError(f"ndim {item.ndim} exceeds the wire cap ({_MAX_NDIM})")
        return code, item.shape, np.ascontiguousarray(item)
    data = _json_bytes(item)
    return DTYPE_JSON, (len(data),), data


def pack(items: list[Any], flags: int = 0, pool: "BufferPool | None" = None) -> bytearray:
    """Serialize blocks into ONE frame buffer of the exact size.

    ndarray items (and bfloat16 tensors) become tensor blocks; anything else
    a compact JSON block.  The frame is sized up front and filled through
    one memoryview: one allocation (or a pooled scratch buffer when ``pool``
    is given and the caller owns its lifetime), no intermediate copies.
    """
    if not items:
        raise FrameError("a frame must carry at least one block")
    if len(items) > _MAX_COUNT:
        raise FrameError(f"count {len(items)} exceeds the wire cap ({_MAX_COUNT})")
    parts = [_block_parts(it) for it in items]
    total = _HDR.size + sum(
        _BLK.size + _DIM.size * len(dims)
        + (src.nbytes if isinstance(src, np.ndarray) else len(src))
        for _, dims, src in parts)
    buf = pool.acquire(total) if pool is not None else bytearray(total)
    mv = memoryview(buf)
    _HDR.pack_into(buf, 0, MAGIC, VERSION, flags, len(items))
    off = _HDR.size
    for code, dims, src in parts:
        _BLK.pack_into(buf, off, code, len(dims), 0)
        off += _BLK.size
        for d in dims:
            _DIM.pack_into(buf, off, d)
            off += _DIM.size
        if isinstance(src, np.ndarray):
            n = src.nbytes
            mv[off:off + n] = src.reshape(-1).view(np.uint8).data
        else:
            n = len(src)
            mv[off:off + n] = src
        off += n
    return buf


def pack_response(meta: dict, predictions: list[Any], list_frame: bool) -> bytearray:
    """An answer frame: the JSON meta block, then one block a prediction,
    the whole batch serialized in one pass."""
    flags = FLAG_META | (FLAG_LIST if list_frame else 0)
    return pack([meta] + list(predictions), flags=flags)


# -- unpack -------------------------------------------------------------------

def unpack(body: bytes | bytearray | memoryview, max_bytes: int = 0,
           bf16_as_bits: bool = False) -> tuple[list[Any], int]:
    """Decode a frame into ``([block, ...], flags)``.

    Tensor blocks come back as read-only ``np.frombuffer`` views over
    ``body`` (bfloat16: a fresh ``torch.bfloat16`` tensor, or with
    ``bf16_as_bits`` an int16 view of its bits, which needs no torch: the
    acceptor workers validate frames so); JSON blocks decoded.  Every bound
    is checked against the *declared* sizes before any allocation: truncated
    or oversized data, trailing bytes, unknown dtype codes and dimension
    overflow raise :class:`FrameError` / :class:`FrameTooLarge`.
    """
    mv = memoryview(body)
    if max_bytes and len(mv) > max_bytes:
        raise FrameTooLarge(f"frame is {len(mv)} bytes; cap is {max_bytes}")
    if len(mv) < _HDR.size:
        raise FrameError(f"frame shorter than the {_HDR.size}-byte header")
    magic, version, flags, count = _HDR.unpack_from(mv, 0)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise FrameError(f"unsupported frame version {version} (this server speaks {VERSION})")
    if not 1 <= count <= _MAX_COUNT:
        raise FrameError(f"block count {count} outside [1, {_MAX_COUNT}]")
    items: list[Any] = []
    off = _HDR.size
    for i in range(count):
        if len(mv) - off < _BLK.size:
            raise FrameError(f"truncated frame: block {i} header missing")
        code, ndim, reserved = _BLK.unpack_from(mv, off)
        off += _BLK.size
        if reserved != 0:
            raise FrameError(f"block {i}: reserved field must be 0")
        if ndim > _MAX_NDIM:
            raise FrameError(f"block {i}: ndim {ndim} exceeds the wire cap ({_MAX_NDIM})")
        if len(mv) - off < _DIM.size * ndim:
            raise FrameError(f"truncated frame: block {i} shape missing")
        dims = tuple(_DIM.unpack_from(mv, off + _DIM.size * j)[0] for j in range(ndim))
        off += _DIM.size * ndim
        if code == DTYPE_JSON:
            if ndim != 1:
                raise FrameError(f"block {i}: JSON blocks are 1-D")
            nbytes = dims[0]
        else:
            if code == BF16_CODE:
                itemsize = 2
            else:
                dt = _CODE_TO_DTYPE.get(code)
                if dt is None:
                    raise FrameError(f"block {i}: unknown dtype code {code}")
                itemsize = dt.itemsize
            nbytes = itemsize
            for d in dims:
                nbytes *= d
        if max_bytes and nbytes > max_bytes:
            raise FrameTooLarge(f"block {i} declares {nbytes} bytes; cap is {max_bytes}")
        if len(mv) - off < nbytes:
            raise FrameError(f"truncated frame: block {i} declares {nbytes} data bytes, "
                             f"{len(mv) - off} remain")
        data = mv[off:off + nbytes]
        off += nbytes
        if code == DTYPE_JSON:
            try:
                items.append(json.loads(bytes(data)))
            except ValueError as e:
                raise FrameError(f"block {i}: bad JSON block: {e}") from None
        elif code == BF16_CODE and bf16_as_bits:
            items.append(np.frombuffer(data, dtype=np.int16).reshape(dims))
        elif code == BF16_CODE:
            import torch

            bits = np.frombuffer(data, dtype=np.int16).reshape(dims).copy()
            items.append(torch.from_numpy(bits).view(torch.bfloat16))
        else:
            items.append(np.frombuffer(data, dtype=dt).reshape(dims))
    if off != len(mv):
        raise FrameError(f"{len(mv) - off} trailing bytes after the last declared block")
    return items, flags


def unpack_response(body: bytes) -> tuple[dict, list[Any]]:
    """The client's twin of :func:`pack_response`: ``(meta, predictions)``."""
    items, flags = unpack(body)
    if not flags & FLAG_META:
        raise FrameError("response frame is missing the meta block")
    return items[0], items[1:]


# -- pooled buffers -----------------------------------------------------------

class BufferPool:
    """A free list of serialization scratch buffers.

    Owned by one task (the server's event loop), so acquisition and release
    need no lock: the pool saves the ``bytearray`` churn of paths that
    serialize, hand the bytes off at once, and release in the same tick.
    ``hits`` and ``misses`` make its sizing observable.
    """

    def __init__(self, max_buffers: int = 32, max_bytes: int = 1 << 22):
        self.max_buffers = max_buffers
        self.max_bytes = max_bytes
        self._free: list[bytearray] = []   # guarded-by: event-loop
        self.hits = 0                      # guarded-by: event-loop
        self.misses = 0                    # guarded-by: event-loop

    def acquire(self, n: int) -> bytearray:
        """A buffer of exactly ``n`` bytes, reusing a pooled one that is
        large enough (shrunk in place: a ``bytearray`` keeps its capacity)."""
        for i, buf in enumerate(self._free):
            if len(buf) >= n:
                del self._free[i]
                del buf[n:]
                self.hits += 1
                return buf
        self.misses += 1
        return bytearray(n)

    def release(self, buf: bytearray) -> None:
        if len(self._free) < self.max_buffers and len(buf) <= self.max_bytes:
            self._free.append(buf)

    def snapshot(self) -> dict:
        return {"free": len(self._free), "hits": self.hits, "misses": self.misses}
