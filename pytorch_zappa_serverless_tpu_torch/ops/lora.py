"""Batched multi-adapter LoRA: one base model, many tenants in one dispatch.

The JAX package's ``ops/lora.py`` as torch functions.  Each tenant's LoRA
adapter is a pair of low-rank factors per target projection, ``A [K, r]``
and ``B [r, N]`` with ``delta_W = A @ B * (alpha / rank)``.  The adapters
that are attached live stacked on the device, ``a [S, K, r]`` and ``b [S,
r, N]`` (slot 0 is the reserved all-zero adapter: the base itself), and
every request row carries its adapter's slot index into the batch::

    h     = x @ a[idx]                        # gather + down, per row
    delta = h @ b[idx]                        # up
    y     = where(idx > 0, y_base + delta, y_base)

so requests for different adapters co-batch into one program, and the
same program (one captured graph) serves any mix of adapters.

- batched == sequential: a co-batched row's delta is computed in the same
  order as a single-adapter call's, so it is the same bits.
- slot 0 == base: rows at slot 0 get ``y_base`` back through
  ``torch.where`` (a select, never ``y + 0``), byte for byte the plain base.

No hand-written kernel: the JAX package computes the delta with two small
einsums outside any Pallas kernel, so the port gathers and runs two batched
products (``torch.bmm``/``einsum``) as well.  The scaling ``alpha / rank``
is folded into ``b`` when an adapter is installed (:func:`install_adapter`).

On the device the stacks are written in place (:func:`write_slot`): a
captured graph holds their addresses, so an attach or a detach changes the
values under them and never recaptures.
"""

from __future__ import annotations

import numpy as np
import torch


def lora_delta(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Per-row low-rank delta of ``x`` [B, K] or [B, T, K] with ``idx`` [B].

    ``a_stack`` [S, K, r], ``b_stack`` [S, r, N] (scaling folded into ``b``).
    Returns the delta with x's leading shape and N trailing, in x's dtype.
    Rank columns beyond an adapter's own rank are zero and add nothing."""
    i = idx.long()
    a = a_stack[i].to(x.dtype)              # [B, K, r]
    b = b_stack[i].to(x.dtype)              # [B, r, N]
    if x.ndim == 2:                          # [B, K] (one decode position)
        return torch.bmm(torch.bmm(x[:, None, :], a), b)[:, 0]
    return torch.bmm(torch.bmm(x, a), b)     # [B, T, K] -> [B, T, N]


def lora_apply(y: torch.Tensor, x: torch.Tensor, node: dict, idx: torch.Tensor) -> torch.Tensor:
    """Add the adapter delta to a base projection ``y`` of ``x``.

    ``node`` is one target's stacks ``{"a": [S, K, r], "b": [S, r, N]}``.
    Rows with ``idx == 0`` get ``y`` back selected, not ``y + 0``."""
    delta = lora_delta(x, node["a"], node["b"], idx)
    mask = (idx > 0).reshape((-1,) + (1,) * (y.ndim - 1))
    return torch.where(mask, y + delta.to(y.dtype), y)


def zero_stacks(slots: int, rank: int, dims: dict[str, tuple[int, int]],
                dtype=np.float32) -> dict:
    """The all-zero slot pool of one layer: {target: {"a", "b"}} host arrays.

    ``slots`` counts the reserved slot 0; ``dims`` maps each target
    projection to its (K, N).  The shapes are fixed for the model's life:
    an attach or a detach writes values, never shapes."""
    return {t: {"a": np.zeros((slots, k, rank), dtype),
                "b": np.zeros((slots, rank, n), dtype)}
            for t, (k, n) in dims.items()}


def validate_adapter(tree: dict, dims: dict[str, tuple[int, int]], rank: int, *,
                     name: str = "adapter", layers: int | None = None) -> int:
    """Check one adapter tree against the pool's layout; returns its rank.

    ``tree`` is {layer{i}: {target: {"a" [K, r_a], "b" [r_a, N]}}}.  Every
    target must be in ``dims`` (the configured ``adapter_targets``) and
    every rank at most the pool's ``rank``; raises ValueError otherwise."""
    ranks = set()
    for lname, layer in tree.items():
        for t, node in layer.items():
            if t not in dims:
                raise ValueError(f"{name}: target {t!r} in {lname} is not in the configured "
                                 f"adapter_targets {sorted(dims)}")
            a, b = np.asarray(node["a"]), np.asarray(node["b"])
            k, n = dims[t]
            if a.shape[0] != k or b.shape[1] != n:
                raise ValueError(f"{name}: {lname}/{t} factors {a.shape}x{b.shape} do not "
                                 f"match the base projection [{k}, {n}]")
            if a.shape[1] != b.shape[0]:
                raise ValueError(f"{name}: {lname}/{t} rank mismatch a{a.shape} b{b.shape}")
            ranks.add(int(a.shape[1]))
    if not ranks:
        raise ValueError(f"{name}: adapter tree carries no factors")
    r = max(ranks)
    if r > rank:
        raise ValueError(f"{name}: rank {r} exceeds the configured adapter_rank {rank}")
    if layers is not None:
        for i in range(layers):
            if f"layer{i}" not in tree:
                raise ValueError(f"{name}: missing layer{i} (base model has {layers} layers)")
    return r


def install_adapter(stacks: dict, slot: int, tree: dict, scaling: float = 1.0) -> None:
    """Write one adapter's factors into slot ``slot`` of the host stacks.

    ``stacks`` is the per-layer pool ({layer{i}: :func:`zero_stacks`}),
    ``tree`` the adapter.  Factors zero-pad up to the pool's rank and
    ``scaling`` (alpha / the adapter's rank) folds into ``b``; targets the
    adapter lacks stay zero.  :func:`clear_slot` is the inverse."""
    clear_slot(stacks, slot)
    for lname, layer in tree.items():
        for t, node in layer.items():
            a = np.asarray(node["a"], np.float32)
            b = np.asarray(node["b"], np.float32) * float(scaling)
            dst = stacks[lname][t]
            r = a.shape[1]
            dst["a"][slot, :, :r] = a
            dst["b"][slot, :r, :] = b


def clear_slot(stacks: dict, slot: int) -> None:
    """Zero one slot across every layer and target (detach, idle unload)."""
    for layer in stacks.values():
        for node in layer.values():
            node["a"][slot] = 0.0
            node["b"][slot] = 0.0


def adapter_nbytes(tree: dict) -> int:
    """Host bytes of one adapter's factors: what the runner's residency
    ledger tracks under ``{base}:{adapter}``."""
    total = 0
    for layer in tree.values():
        for node in layer.values():
            total += np.asarray(node["a"]).nbytes
            total += np.asarray(node["b"]).nbytes
    return total


def write_slot(device_stacks: dict, host_stacks: dict, slot: int) -> None:
    """Copy one slot of the host stacks into the device stacks, in place.

    ``device_stacks`` is the module's {layer{i}: {target: {"a", "b"}}} of
    tensors; each slice is cast to the stack's dtype (the model's leaf
    dtype) and copied under the tensor's address, so a captured graph reads
    the new values at its next replay and nothing is recaptured."""
    slot = int(slot)
    with torch.no_grad():
        for lname, layer in host_stacks.items():
            for t, node in layer.items():
                for half in ("a", "b"):
                    dst = device_stacks[lname][t][half]
                    if not 0 <= slot < dst.shape[0]:
                        raise IndexError(f"adapter slot {slot} outside the pool of "
                                         f"{dst.shape[0]}")
                    src = torch.from_numpy(np.ascontiguousarray(node[half][slot]))
                    dst[slot].copy_(src.to(dst.dtype))
