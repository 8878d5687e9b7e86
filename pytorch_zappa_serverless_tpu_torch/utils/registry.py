"""Model registry: builders keyed by name, each with its latency class.

- ``"latency"``: interactive endpoints; their dispatches jump ahead of
  queued throughput work between device calls.
- ``"throughput"``: latency-tolerant work; runs whenever the latency lane
  is empty.
"""

from __future__ import annotations

from typing import Callable

LATENCY_CLASSES = ("latency", "throughput")

_REGISTRY: dict[str, Callable] = {}
_LATENCY_CLASS: dict[str, str] = {}


def register_model(name: str, *, latency_class: str):
    if latency_class not in LATENCY_CLASSES:
        raise ValueError(f"{name}: latency_class must be one of "
                         f"{LATENCY_CLASSES}, got {latency_class!r}")

    def deco(builder: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"duplicate model registration: {name}")
        _REGISTRY[name] = builder
        _LATENCY_CLASS[name] = latency_class
        return builder
    return deco


def get_model_builder(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None


def list_models() -> list[str]:
    """Every registered model name, sorted."""
    return sorted(_REGISTRY)


def get_latency_class(name: str) -> str:
    """The registered latency class; "" for unregistered names."""
    return _LATENCY_CLASS.get(name, "")
