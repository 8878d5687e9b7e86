"""The launch counters of the port's kernels, in one registry.

Each kernel wrapper counts its launches in an integer attribute of its own
function (``int8_matmul.launches``, ``flash_attention.launches``, the four
``fused_*.launches``), and ``models.sd_unet.unet_apply.calls`` counts UNet
calls; a run reads them to show that its path went through the kernels.
A count means executions on the device.  An eager call counts as it runs;
under a captured CUDA graph (``engine.compiled.capture``) the capture runs
nothing, so the engine takes a :func:`snapshot` before it, reads the
graph's :func:`delta` after it, :func:`restore`\\ s the snapshot, and
:func:`add`\\ s the delta at every replay.  :func:`graphed` holds the
launches the captured graphs account for (each capture's eager warm-up run
and each replay): a path whose counts exceed it launched a kernel outside
any graph.
"""

from __future__ import annotations

from typing import Callable

# name -> (function, attribute)
_REGISTRY: dict[str, tuple[Callable, str]] = {}
# name -> launches run by captured graphs and their warm-up runs.
_GRAPHED: dict[str, int] = {}


def register(fn: Callable, attr: str = "launches") -> Callable:
    """Count on ``fn.<attr>``, starting from 0."""
    setattr(fn, attr, 0)
    _REGISTRY[fn.__name__] = (fn, attr)
    return fn


def snapshot() -> dict[str, int]:
    """Every count, by function name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _REGISTRY.items()}


def delta(since: dict[str, int]) -> dict[str, int]:
    """What each count gained since ``since`` (counts registered after it
    gained all they hold)."""
    return {name: n - since.get(name, 0) for name, n in snapshot().items()}


def restore(snap: dict[str, int]) -> None:
    for name, n in snap.items():
        fn, attr = _REGISTRY[name]
        setattr(fn, attr, n)


def add(d: dict[str, int]) -> None:
    for name, n in d.items():
        fn, attr = _REGISTRY[name]
        setattr(fn, attr, getattr(fn, attr) + n)


def add_graphed(d: dict[str, int]) -> None:
    for name, n in d.items():
        _GRAPHED[name] = _GRAPHED.get(name, 0) + n


def graphed() -> dict[str, int]:
    """The launches captured graphs ran since the last :func:`reset`."""
    return {name: _GRAPHED.get(name, 0) for name in _REGISTRY}


def reset() -> None:
    """Every count, and the graphs' ledger, to 0."""
    restore(dict.fromkeys(_REGISTRY, 0))
    _GRAPHED.clear()
