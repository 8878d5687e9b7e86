"""The safetensors file format, read and written with numpy and the standard
library alone: the port needs no ``safetensors`` package, so a machine that
serves it need not have one.

A file is an 8-byte little-endian header length, a JSON header naming each
tensor's ``dtype``, ``shape`` and ``data_offsets`` (``[begin, end)`` in the
data section) with an optional ``__metadata__`` of strings (read past; the
port writes none), then the raw little-endian data.  :func:`save` writes
tensors in descending item size, then by name, so each one starts aligned
to its item size, and pads the header with spaces to a multiple of 8, as
the package's writer does; the package reads what :func:`save` writes and
:func:`load` reads what the package writes.

:func:`load` refuses a header that does not describe its file: an unknown
dtype, a tensor whose byte count disagrees with its shape, tensors that
overlap or leave a gap, or a data section shorter or longer than they
cover.  A ``BF16`` tensor is read as float32 (numpy has no bfloat16; the
upcast is exact), so it does not round-trip as BF16.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Mapping

import numpy as np

# safetensors dtype name → little-endian numpy dtype.
DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U64": np.dtype("<u8"), "U32": np.dtype("<u4"),
    "U16": np.dtype("<u2"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
_BF16 = "BF16"
# The package refuses a header past 100 MB; so does this reader.
MAX_HEADER_BYTES = 100_000_000


def _dtype_name(arr: np.ndarray) -> str:
    name = _NAMES.get(arr.dtype)
    if name is None:
        raise ValueError(f"no safetensors dtype for numpy {arr.dtype}")
    return name


def save(tensors: Mapping[str, np.ndarray], path: str | Path) -> None:
    """Write ``{name: array}`` (any numpy layout: strided, 0-d or empty
    arrays included) as one safetensors file."""
    arrays = {name: np.asarray(value) for name, value in tensors.items()}
    order = sorted(arrays, key=lambda n: (-arrays[n].dtype.itemsize, n))
    header: dict = {}
    offset = 0
    for name in order:
        arr = arrays[name]
        header[name] = {"dtype": _dtype_name(arr), "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % 8)
    with open(Path(path).expanduser(), "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            arr = arrays[name]
            if arr.size:
                f.write(np.ascontiguousarray(arr).reshape(-1).data)


def read_header(path: str | Path) -> tuple[dict, int, int]:
    """``(header, data_start, file_size)`` of a safetensors file, the header
    checked against the file (see the module's docstring)."""
    path = Path(path).expanduser()
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > min(MAX_HEADER_BYTES, size - 8):
            raise ValueError(f"{path}: header length {n} past the file's {size} bytes")
        header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    spans = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info.get("dtype")
        if dtype != _BF16 and dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {dtype!r}")
        shape = info.get("shape")
        if not isinstance(shape, list) or not all(isinstance(d, int) and d >= 0 for d in shape):
            raise ValueError(f"{path}: tensor {name!r} has shape {shape!r}")
        begin, end = info.get("data_offsets", (None, None))
        item = 2 if dtype == _BF16 else DTYPES[dtype].itemsize
        if not (isinstance(begin, int) and isinstance(end, int)
                and end - begin == item * int(np.prod(shape, dtype=np.int64))):
            raise ValueError(f"{path}: tensor {name!r}'s offsets {[begin, end]} do not hold "
                             f"{dtype} {shape}")
        spans.append((begin, end, name))
    covered = 0
    for begin, end, name in sorted(spans):
        if begin != covered:
            raise ValueError(f"{path}: tensor {name!r} starts at {begin}, not at {covered}: "
                             f"{'an overlap' if begin < covered else 'a gap'} in the data")
        covered = end
    if 8 + n + covered != size:
        raise ValueError(f"{path}: the tensors cover {covered} data bytes, the file holds "
                         f"{size - 8 - n}")
    return header, 8 + n, size


def load(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file as a writable numpy array (views
    of one buffer read in a single pass), in the header's order."""
    header, start, size = read_header(path)
    buf = bytearray(size - start)
    with open(Path(path).expanduser(), "rb") as f:
        f.seek(start)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: the file shrank while it was read")
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if info["dtype"] == _BF16:
            bits = np.frombuffer(buf, np.dtype("<u2"), (end - begin) // 2, begin)
            arr = (bits.astype(np.uint32) << 16).view(np.float32)
        else:
            dt = DTYPES[info["dtype"]]
            arr = np.frombuffer(buf, dt, (end - begin) // dt.itemsize, begin)
        out[name] = arr.reshape(info["shape"])
    return out
