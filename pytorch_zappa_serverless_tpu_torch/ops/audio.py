"""Sample-rate conversion for the Whisper front end, on the host: the JAX
package's ``ops/audio.py``.

The log-mel front end (``ops/logmel.py``) takes 16 kHz; clients send 44.1
or 48 kHz.  Decimating alone would fold content above 8 kHz into the mel
band, so :func:`resample` is a windowed-sinc low-pass interpolator: the
native ``resample_f32`` of ``native/hostops.cpp`` where the host library
builds, else :func:`_resample_numpy`, which gives the same output (chunked,
so its weight matrix never exists at full length).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import hostops
from .logmel import SAMPLE_RATE as TARGET_RATE

_SUPPORT_STEPS = 16.0  # filter radius in source steps (the C++ one)


def _resample_numpy(src: np.ndarray, ratio: float, n_dst: int) -> np.ndarray:
    """Chunked windowed-sinc resample (Hann-windowed sinc, cutoff at the
    lower Nyquist rate, normalised by the taps' sum)."""
    step = 1.0 / ratio
    cutoff = min(ratio, 1.0)
    support = _SUPPORT_STEPS * max(step, 1.0)
    out = np.empty(n_dst, np.float32)
    chunk = 8192
    n_src = src.shape[0]
    for start in range(0, n_dst, chunk):
        idx = np.arange(start, min(start + chunk, n_dst))
        centers = idx * step
        lo = np.maximum(np.ceil(centers - support).astype(np.int64), 0)
        # One tap window per chunk keeps this a dense [chunk, taps] product.
        taps = int(2 * support) + 2
        j = lo[:, None] + np.arange(taps)[None, :]
        valid = j <= np.minimum(np.floor(centers + support), n_src - 1)[:, None]
        x = j - centers[:, None]
        s = np.sinc(x * cutoff)
        w = s * (0.5 + 0.5 * np.cos(np.pi * x / support)) * valid
        vals = src[np.clip(j, 0, n_src - 1)] * valid
        wsum = w.sum(axis=1)
        acc = (w * vals).sum(axis=1)
        out[idx] = np.where(wsum != 0, acc / np.where(wsum == 0, 1, wsum), 0.0)
    return out


def resample(audio: np.ndarray, src_rate: int, dst_rate: int = TARGET_RATE) -> np.ndarray:
    """float32 mono waveform at ``src_rate`` → ``dst_rate``, anti-aliased."""
    audio = np.ascontiguousarray(audio, dtype=np.float32).reshape(-1)
    if src_rate == dst_rate or audio.shape[0] == 0:
        return audio
    if src_rate <= 0 or dst_rate <= 0:
        raise ValueError(f"invalid rates {src_rate}->{dst_rate}")
    ratio = dst_rate / src_rate
    n_dst = int(audio.shape[0] * ratio)
    lib = hostops.get_lib()
    if lib is None:
        return _resample_numpy(audio, ratio, n_dst)
    out = np.empty(n_dst, np.float32)
    rc = lib.resample_f32(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), audio.shape[0],
        ctypes.c_double(ratio), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_dst)
    if rc != 0:
        raise ValueError(f"resample_f32 failed rc={rc} ({audio.shape[0]} samples, "
                         f"ratio {ratio:.4f})")
    return out
