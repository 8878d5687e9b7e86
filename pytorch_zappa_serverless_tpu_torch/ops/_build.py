"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``ops/csrc/`` compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers: seconds to build, not minutes).
The library lands in ``build/torch_kernels/`` at the repository root, named
after a hash of its source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused within the checkout.  A failed build raises with
nvcc's own output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# One lock per source, so different kernels build in parallel threads and
# one kernel builds once.
_lock = threading.Lock()
_source_locks: dict[str, threading.Lock] = {}  # guarded-by: _lock
_loaded: dict[str, ctypes.CDLL] = {}  # guarded-by: the source's lock


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels build on a machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where ``source``'s library is built: its name carries a hash of the
    source bytes, every ``csrc/*.cuh`` header (a source may include any of
    them) and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def load(source: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """Build ``ops/csrc/<source>`` if its library is missing, then load it
    (once per process).  ``signatures`` maps each C function to
    ``(restype, argtypes)``; every pointer and the stream must be
    ``c_void_p``, or ctypes would pass them as 32-bit ints."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        out = library_path(source)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source} "
                                   f"(exit {proc.returncode}):\n{proc.stderr}"
                                   f"{proc.stdout}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[source] = lib
        return lib
