"""Model registry: builders keyed by name, each with its latency class, and
each family's float param tree.

- ``"latency"``: interactive endpoints; their dispatches jump ahead of
  queued throughput work between device calls.
- ``"throughput"``: latency-tolerant work; runs whenever the latency lane
  is empty.

A tree function (:func:`register_tree`) maps a ``ModelConfig`` to ``(tree,
reference)``: the param tree in the JAX package's layout that the builder
loads, before any int8 rewrite (a checkpoint through its converter, a staged
or stream file as it is, else the seeded init), and what the tree must fit:
the family's module on the ``meta`` device, or, for a model written over a
param dict, its seeded tree's shapes (``weights.ShapeDraws``).  The builder
and ``deploy/stage.py`` share it, so a staged tree is the one the builder
would have loaded.
"""

from __future__ import annotations

from typing import Callable

LATENCY_CLASSES = ("latency", "throughput")

_REGISTRY: dict[str, Callable] = {}
_LATENCY_CLASS: dict[str, str] = {}
_TREES: dict[str, Callable] = {}


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


def register_tree(*names: str):
    def deco(fn: Callable) -> Callable:
        for name in names:
            if name in _TREES:
                raise ValueError(f"duplicate tree registration: {name}")
            _TREES[name] = fn
        return fn
    return deco


def get_tree_fn(name: str) -> Callable:
    try:
        return _TREES[name]
    except KeyError:
        raise KeyError(f"no param tree registered for {name!r}; known: {sorted(_TREES)}") from None
