"""Op-time aggregation of a profiler capture: the one classifier.

The counterpart of the JAX package's ``utils/xplane.py``, under the same
name so that a reader finds it.  Where the JAX module reads XLA's
``.xplane.pb`` files, this one reads ``torch.profiler`` events: the rows of
``profile.key_averages()``, which include the kernels that run inside
replayed CUDA graphs (CUPTI traces the device, whatever host thread
launched the work).  ``POST /admin/profile`` and ``POST /debug/trace``
(``serving/server.py``) capture through :class:`Capture`.

Rules:

- On the card only device-side events count (``DeviceType.CUDA`` rows, by
  ``self_device_time_total``): a host op's device time repeats its kernels'.
- A device event whose name starts ``Memcpy`` is a copy, ``Memset`` a
  memset: each has its own bucket, never compute.
- Every other device event is compute, keyed by its kernel name.
- On the CPU (no device events at all) the host ops are the compute, by
  ``self_cpu_time_total``, so the route answers the same shape there.

One profiler runs per process: :func:`busy` says whether any (this
module's, or one a script opened with ``torch.profiler`` directly) is on.
"""

from __future__ import annotations

import collections
import threading

_lock = threading.Lock()
_active = False  # guarded-by: _lock


def busy() -> bool:
    """True while a capture of this module, or any other torch profiler of
    the process, is running."""
    import torch

    with _lock:
        if _active:
            return True
    return bool(torch.autograd.profiler._is_profiler_enabled)


class ProfilerBusy(RuntimeError):
    """Another capture is running (one profiler a process)."""


class Capture:
    """One ``torch.profiler`` window.  :meth:`start` and :meth:`stop` must
    run on the thread that issues the device work (the dispatch thread): a
    CUDA graph capture refuses other threads' CUDA calls, and residency may
    capture there at any time."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None

    def start(self) -> None:
        global _active
        import torch
        from torch.profiler import ProfilerActivity, profile

        with _lock:
            if _active or torch.autograd.profiler._is_profiler_enabled:
                raise ProfilerBusy("a profiler capture is already running in this process")
            _active = True
        try:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.start()
        except BaseException:
            self.prof = None
            with _lock:
                _active = False
            raise

    def stop(self) -> None:
        global _active
        try:
            if self.cuda:
                import torch

                torch.cuda.synchronize()
            self.prof.stop()
        finally:
            with _lock:
                _active = False

    def export_chrome_trace(self, path: str) -> None:
        self.prof.export_chrome_trace(path)


def op_time_breakdown(prof) -> tuple[collections.Counter, collections.Counter,
                                     collections.Counter, collections.Counter]:
    """Aggregate a finished ``torch.profiler.profile`` into ``(compute_us,
    counts, copies_us, memsets_us)`` Counters keyed by event name."""
    from torch.autograd import DeviceType

    compute: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    copies: collections.Counter = collections.Counter()
    memsets: collections.Counter = collections.Counter()
    rows = prof.key_averages()
    device = [e for e in rows
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if device:
        for e in device:
            if e.key.startswith("Memcpy"):
                copies[e.key] += e.self_device_time_total
            elif e.key.startswith("Memset"):
                memsets[e.key] += e.self_device_time_total
            else:
                compute[e.key] += e.self_device_time_total
                counts[e.key] += e.count
        return compute, counts, copies, memsets
    for e in rows:
        if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            compute[e.key] += e.self_cpu_time_total
            counts[e.key] += e.count
    return compute, counts, copies, memsets


def top_ops(prof, top: int = 15) -> dict:
    """The ``/admin/profile`` body: the ``top`` compute ops by time over the
    window, the compute, copy and memset totals (ms)."""
    compute, counts, copies, memsets = op_time_breakdown(prof)
    return {"ops": [{"op": name, "ms": round(us / 1e3, 4), "count": counts.get(name, 0)}
                    for name, us in compute.most_common(max(int(top), 1))],
            "device_compute_ms": round(sum(compute.values()) / 1e3, 4),
            "copy_ms": round(sum(copies.values()) / 1e3, 4),
            "memset_ms": round(sum(memsets.values()) / 1e3, 4)}


def device_compute_ms(prof, iters: int) -> float | None:
    """Device compute ms an iteration of a finished window that ran
    ``iters`` iterations: the device events' compute time (copies and
    memsets apart), divided by ``iters``.  None where the window holds no
    device event (the CPU, or a profiler that saw no kernel)."""
    from torch.autograd import DeviceType

    if not any(e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               for e in prof.key_averages()):
        return None
    compute = op_time_breakdown(prof)[0]
    return round(sum(compute.values()) / 1e3 / max(int(iters), 1), 4)
