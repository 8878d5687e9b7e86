"""ctypes loader for the native host-ops library (``native/hostops.cpp``).

The per-request resize + center crop is the host's hot loop, and the C++
version fuses the crop into the resampler (it never computes a discarded
pixel); ``pack_batch_u8`` packs a bucket batch with one memcpy per image.
The library is a host library, not a GPU kernel: ``g++ -O3 -shared -fPIC``
builds it at first use into ``build/torch_host/`` at the repository root,
under a per-process temporary name renamed into place, so concurrent
workers never load half a file.  Without a toolchain :func:`get_lib` is
None and the callers say what they do then (``ops/preprocessing.py``).

Numerics: the triangle-filter (antialiased bilinear) semantics of
PIL/torchvision with float32 accumulation, where PIL quantizes to uint8
between its two passes, so outputs may differ from PIL's by ±1 LSB on real
images.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None  # guarded-by: _LOCK
_TRIED = False  # guarded-by: _LOCK


def _build_and_load() -> ctypes.CDLL | None:
    so_path = BUILD_DIR / "_hostops.so"
    if not so_path.exists() or so_path.stat().st_mtime < _SRC.stat().st_mtime:
        # Build to a per-pid temp name, then atomically rename: concurrent
        # workers racing the first build can never dlopen a half-written .so.
        # Plain -O3 (no -march=native): the build directory may be shared
        # across hosts.
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp_path = so_path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp_path), str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp_path, so_path)
        except (OSError, subprocess.SubprocessError):
            tmp_path.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    lib.resize_center_crop_u8.restype = ctypes.c_int
    lib.resize_center_crop_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    lib.pack_batch_u8.restype = ctypes.c_int
    lib.pack_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.resample_f32.restype = ctypes.c_int
    lib.resample_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None (no toolchain)."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            _LIB = _build_and_load()
    return _LIB


def native_available() -> bool:
    return get_lib() is not None


def resize_center_crop_u8(img: np.ndarray, resize_to: int, crop: int) -> np.ndarray:
    """Fused shorter-side resize + center crop. img: uint8 HWC RGB."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native hostops unavailable")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected RGB HWC, got {img.shape}")
    out = np.empty((crop, crop, 3), np.uint8)
    rc = lib.resize_center_crop_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), resize_to, crop)
    if rc != 0:
        raise ValueError(f"resize_center_crop_u8 failed rc={rc} "
                         f"(src {h}x{w}, resize_to={resize_to}, crop={crop})")
    return out


def pack_batch_u8(samples: list[np.ndarray], capacity: int) -> np.ndarray:
    """Pack per-request HWC images into a zero-padded [capacity, ...] batch.

    All samples must share one shape (image servables resize and crop every
    request to the model's input size before packing); the native memcpy
    reads exactly first.nbytes per sample, so a smaller sample would be an
    out-of-bounds read.  Validated here, as the numpy path raises too.
    """
    lib = get_lib()
    first = np.ascontiguousarray(samples[0], dtype=np.uint8)
    for i, s in enumerate(samples[1:], 1):
        if np.asarray(s).shape != first.shape:
            raise ValueError(f"pack_batch_u8: sample {i} shape "
                             f"{np.asarray(s).shape} != {first.shape}")
    if len(samples) > capacity:
        raise ValueError(f"pack_batch_u8: {len(samples)} samples exceed capacity {capacity}")
    out = np.zeros((capacity,) + first.shape, np.uint8)
    if lib is None:
        for i, s in enumerate(samples):
            out[i] = s
        return out
    arrs = [first] + [np.ascontiguousarray(s, dtype=np.uint8) for s in samples[1:]]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * len(arrs))(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for a in arrs])
    rc = lib.pack_batch_u8(ptrs, len(arrs), first.nbytes,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           capacity)
    if rc != 0:
        raise ValueError(f"pack_batch_u8 failed rc={rc}")
    return out
