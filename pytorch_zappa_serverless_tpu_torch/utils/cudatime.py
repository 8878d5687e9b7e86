"""Device time of queued work, by CUDA events behind a spin kernel.

Plain CUDA events around a short launch time the host: the Python checks
and ctypes of a wrapper (~40 us), or a graph replay's own call, leave the
stream idle between launches.  Here a spin kernel (``torch.cuda._sleep``)
holds the stream while the host queues the work, so the events bracket
the device's time alone: the start event waits behind the spin, then the
work runs back to back, then the end event.

:func:`device_times` gives every trial's milliseconds, :func:`device_ms`
their median, :func:`device_trials` the milliseconds and the SM clock
each trial's spin ran at.  All need the card; nothing here runs on the CPU.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable


def device_trials(fn: Callable[[], object], reps: int = 15) -> tuple[list[float], list[float]]:
    """Milliseconds of ``fn``'s device work in each of ``reps`` trials, and
    the SM clock (MHz) of each trial's spin: its cycles over its own
    elapsed time, the clock the card ran at just before the work.

    ``fn`` must queue its work without a host read of the device.  One
    untimed call warms it; a second, timed on the host, sizes the spin to
    about three times the host's time, so the queue never runs dry."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(3 * host_s * 2e9) + 2_000_000  # ~3x the host's time at ~2 GHz
    times, mhz = [], []
    for _ in range(reps):
        es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        es.record()
        torch.cuda._sleep(cycles)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
        mhz.append(cycles / es.elapsed_time(e0) / 1e3)
    return times, mhz


def device_times(fn: Callable[[], object], reps: int = 15) -> list[float]:
    """Milliseconds of ``fn``'s device work in each of ``reps`` trials
    (:func:`device_trials`)."""
    return device_trials(fn, reps)[0]


def device_ms(fn: Callable[[], object], reps: int = 15) -> float:
    """Median device time of ``fn``'s launches (:func:`device_times`)."""
    return statistics.median(device_times(fn, reps))
