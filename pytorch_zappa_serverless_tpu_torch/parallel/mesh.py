"""Device mesh and sharding: one process per GPU on ``torch.distributed``.

The JAX package's mesh is single-controller: one process holds every chip
and XLA inserts the collectives.  On GPUs the idiomatic form is one process
per device, so the port's mesh IS a process group: ``ServeConfig.mesh``
(``{"data": 4, "model": 2}``) is served by prod(mesh) ranks, each one
process on one device (``cuda:{local_rank}``, or the CPU when the caller
asks for it), over ``nccl`` on CUDA and ``gloo`` on the CPU.  Ranks are
row-major over the mesh axes, as ``make_mesh`` lays devices out in the JAX
package, and each axis gets a group of its own (:class:`AxisGroup`).

Axes:

- ``data``  the batch dimension (DP): a bucket whose rows divide the axis
  splits them over it, and the outputs are all-gathered back;
- ``model`` weight sharding (TP): attention heads, MLP hidden units and
  classifier classes split over the axis, Megatron-style.  The collectives
  XLA inserts for the reference are written here: one all-reduce after
  each row-parallel product (before its bias), and an all-gather of a
  column-parallel head that has no row-parallel partner.

A mesh of one is still a process group of one, and its collectives run:
nothing is skipped because a group has one rank.
"""

from __future__ import annotations

import datetime
import re
import socket
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops import counters
from ..utils.logging import get_logger, log_event

log = get_logger("parallel.mesh")

# Every process group's timeout.  An idle follower waits inside the lockstep
# header broadcast; past this a gloo collective raises and NCCL's watchdog
# aborts the process, so a world that idles longer needs
# ``heartbeat_interval_s`` set below it (checked at boot).
COLLECTIVE_TIMEOUT_S = 600.0


def backend_for(device: torch.device) -> str:
    """``nccl`` on CUDA, ``gloo`` on the CPU: chosen by the device."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on the loopback interface (the rendezvous of a world
    that names no coordinator)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_layout(mesh: dict[str, int] | None, num_processes: int) -> tuple[int, int]:
    """(world size, ranks a process): a mesh's prod(mesh) ranks split over
    ``num_processes`` hosts, or one rank a process without a mesh."""
    procs = max(int(num_processes), 1)
    if not mesh:
        return procs, 1
    world = int(np.prod([int(v) for v in mesh.values()]))
    if world % procs:
        raise ValueError(f"mesh {dict(mesh)} ({world} ranks) does not split over "
                         f"num_processes={procs}")
    return world, world // procs


def check_devices(axis_sizes: dict[str, int], have: int) -> int:
    """The reference's device check: an error when the mesh needs more
    devices than the pool holds, a warning when it uses fewer."""
    need = int(np.prod([int(v) for v in axis_sizes.values()]))
    if need > have:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {need} devices, have {have}")
    if need < have:
        # Loud, because a typo'd mesh (e.g. {"data": 4} on an 8-GPU host)
        # otherwise silently serves on half the capacity.
        log.warning("mesh %s uses %d of %d visible devices", dict(axis_sizes), need, have)
    return need


def device_pool(device: torch.device, num_processes: int = 1) -> int:
    """The devices a mesh may span: every process's visible GPUs on CUDA;
    on the CPU each rank is a process, and the pool is the world's."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count() * max(int(num_processes), 1)
    return dist.get_world_size() if dist.is_initialized() else 0


def init_distributed(coordinator_address: str, num_processes: int, process_id: int, *,
                     local_ranks: int = 1, local_rank: int = 0,
                     device: torch.device | str = "cuda") -> bool:
    """Join the world: ``num_processes`` hosts of ``local_ranks`` ranks, this
    process rank ``process_id * local_ranks + local_rank``, rendezvous on
    ``coordinator_address`` ("host:port" of process 0's rank 0; a loopback
    port when empty, which only a one-host world can use).

    Must run before the engine builds.  Idempotent: re-entry (a second
    engine in the process) is a no-op once the process is in a world.
    Returns True when running in a world.
    """
    world = max(int(num_processes), 1) * max(int(local_ranks), 1)
    if dist.is_initialized():
        return True
    rank = int(process_id) * int(local_ranks) + int(local_rank)
    addr = coordinator_address
    if not addr:
        if world > 1:
            raise ValueError("a world of several ranks needs coordinator_address")
        addr = f"127.0.0.1:{free_port()}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else torch.cuda.current_device())
    dist.init_process_group(backend_for(dev), init_method=f"tcp://{addr}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    log_event(log, "distributed initialized", backend=dist.get_backend(), rank=rank,
              world_size=world, device=str(dev), coordinator=addr)
    return True


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (``ops.counters.collectives``)."""
    dist.all_reduce(t, group=group)
    counters.note_collective("all_reduce")
    return t


def all_gather(t: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim``, in rank order
    (``ops.counters.collectives``)."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    counters.note_collective("all_gather")
    return torch.cat(parts, dim=dim)


@dataclass
class AxisGroup:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it, and the process group of the ranks that differ only on it."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: Any = field(repr=False, default=None)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.group)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return all_gather(t, self.group, self.size, dim)


@dataclass
class Mesh:
    """The named mesh of a world: axis names and sizes (``shape``), this
    rank's coordinates and its axis groups."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]
    rank: int
    coords: dict[str, int]
    axes: dict[str, AxisGroup]
    device: torch.device

    def axis(self, name: str) -> AxisGroup:
        return self.axes[name]


def make_mesh(axis_sizes: dict[str, int] | None = None, devices: Sequence | None = None,
              device: torch.device | str | None = None, num_processes: int = 1) -> Mesh:
    """The named mesh over the world (every rank calls it, in the same
    order: each axis group is a ``dist.new_group``); the default is every
    rank on the ``data`` axis.  ``devices`` (the pool) defaults to
    :func:`device_pool` of ``num_processes`` hosts; the world must hold
    exactly prod(mesh) ranks.

    On CUDA each group's communicator is made here by one eager collective,
    so that no graph capture meets a lazy NCCL init.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: init_distributed first")
    dev = torch.device(device if device is not None
                       else ("cuda" if dist.get_backend() == "nccl" else "cpu"))
    world = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = {"data": world, "model": 1}
    axis_sizes = {str(k): int(v) for k, v in axis_sizes.items()}
    have = len(devices) if devices is not None else device_pool(dev, num_processes)
    need = check_devices(axis_sizes, have)
    if need != world:
        raise ValueError(f"mesh {axis_sizes} needs {need} ranks; the world holds {world}")
    names = tuple(axis_sizes)
    shape = tuple(axis_sizes.values())
    grid = np.arange(world).reshape(shape)  # row-major, as the JAX package lays devices out
    rank = dist.get_rank()
    where = tuple(int(i) for i in np.argwhere(grid == rank)[0])
    axes: dict[str, AxisGroup] = {}
    for ax, name in enumerate(names):
        # Every rank makes every group of this axis, in the same order.
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            ranks = tuple(int(r) for r in line)
            g = dist.new_group(list(ranks),
                               timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
            if rank in ranks:
                axes[name] = AxisGroup(name, shape[ax], where[ax], ranks, g)
    if dev.type == "cuda":
        for ax in axes.values():
            dist.all_reduce(torch.zeros(1, device=dev), group=ax.group)
        dist.broadcast(torch.zeros(1, device=dev), 0)
        torch.cuda.synchronize(dev)
    return Mesh(names, dict(axis_sizes), rank, dict(zip(names, where)), axes, dev)


# -- placement policy (JAX ``batch_sharding`` / ``replicated``) -------------

def batch_sharding(mesh: Mesh, rows: int, axis: str = "data") -> slice | None:
    """This rank's rows of a batch of ``rows`` when ``rows`` divides the
    ``axis`` size (DP split), else None: the batch replicates.  Buckets are
    never padded up for the mesh."""
    n = mesh.shape.get(axis, 0)
    if not n or not rows or rows % n:
        return None
    per = rows // n
    i = mesh.coords[axis]
    return slice(i * per, (i + 1) * per)


def replicated(mesh: Mesh, rows: int, axis: str = "data") -> bool:
    """Whether a batch of ``rows`` replicates (serves TP-only)."""
    return batch_sharding(mesh, rows, axis) is None


# -- parameter sharding -----------------------------------------------------

# Rules: (path regex, spec), first match wins, unmatched leaves replicate.
# A spec names the mesh axis each dim of the leaf shards over (None:
# whole), as a PartitionSpec does.  Paths are the module path and the leaf
# name joined by "/" ("layer0/attention/query/weight").  A torch ``weight``
# is [out, in]; a ``kernel`` (the param-dict models, the JAX layout) is
# [in, out].  A leaf sharded on its contracting dim marks its owner
# row-parallel (``tp_reduce``: the all-reduce before the bias); on its
# output dim column-parallel (``tp_cols``: a head that gathers its outputs).
RuleSet = Sequence[tuple[str, tuple]]


def _contracting_dim(leaf: str, ndim: int) -> int | None:
    if ndim != 2:
        return None
    return {"weight": 1, "kernel": 0}.get(leaf)


def shard_params(mesh: Mesh, module: torch.nn.Module, rules: RuleSet) -> dict[str, tuple]:
    """Slice every leaf of ``module`` a rule matches to this rank's shard, in
    place, and mark the owning submodules with the axis group their
    collectives run on.  Returns {path: pruned spec} of the matched leaves.

    Rule axes absent from the mesh degrade to replication on that dim, with
    a warning: the family TP rules all name ``model``, and a DP-only mesh
    must serve with them as no-ops.  A dim the axis does not divide is an
    error naming the leaf.
    """
    dropped: set[str] = set()

    def prune(spec: tuple) -> tuple:
        kept = []
        for axis in spec:
            if axis is None or axis in mesh.shape:
                kept.append(axis)
            else:
                dropped.add(str(axis))
                kept.append(None)
        return tuple(kept)

    compiled = [(re.compile(pat), prune(tuple(spec))) for pat, spec in rules]
    if dropped:
        # Loud, mirroring make_mesh's under-use warning: intended for the
        # DP-only mesh, but a typo'd axis name would otherwise silently
        # serve unsharded at full per-device memory.
        log.warning("TP rule axes %s not in mesh %s; affected dims replicate",
                    sorted(dropped), list(mesh.axis_names))
    matched: dict[str, tuple] = {}
    for mod_name, owner in module.named_modules():
        for store in (owner._parameters, owner._buffers):
            for key, t in list(store.items()):
                if t is None:
                    continue
                path = f"{mod_name}/{key}".replace(".", "/").lstrip("/")
                spec = next((s for pat, s in compiled if pat.search(path)), None)
                if spec is None:
                    continue
                matched[path] = spec
                new = t
                for dim, axis in enumerate(spec):
                    if axis is None:
                        continue
                    ax = mesh.axis(axis)
                    if new.shape[dim] % ax.size:
                        raise ValueError(f"{path}: dim {dim} of {list(new.shape)} does not "
                                         f"divide over {axis}={ax.size}")
                    per = new.shape[dim] // ax.size
                    new = new.narrow(dim, ax.index * per, per)
                    contracting = _contracting_dim(key, t.ndim)
                    if dim == contracting:
                        owner.tp_reduce = ax
                    elif contracting is not None:
                        owner.tp_cols = ax
                if new is not t:  # a copy of the shard, so that the whole leaf is freed
                    new = new.clone(memory_format=torch.contiguous_format)
                    store[key] = (torch.nn.Parameter(new, t.requires_grad)
                                  if isinstance(t, torch.nn.Parameter) else new)
    return matched


def check_heads(name: str, heads: int | None, mesh: Mesh, axis: str = "model") -> None:
    """Refuse a model whose attention heads do not divide over ``axis``: a
    rank holds heads / size whole heads."""
    n = mesh.shape.get(axis, 1)
    if heads and heads % n:
        raise ValueError(f"{name}: {heads} attention heads do not divide over {axis}={n}")


# TP rules for the zoo's families, on the port's parameter names, carried in
# each servable's ``meta["tp_rules"]``.  Transformers shard the standard
# Megatron way: QKV + MLP-in column-parallel (output features over
# ``model``, so the head reshape stays local), attention-out + MLP-out
# row-parallel (contracting dim over ``model``, one all-reduce each before
# the bias).  Column-parallel biases shard with their features;
# row-parallel biases stay whole (they add after the all-reduce).

# CNN classifier heads (ResNet's "fc", EfficientNet's and ViT's
# "classifier"): column-parallel, the logits gathered before the softmax.
CNN_HEAD_TP_RULES: RuleSet = [
    (r"(fc|classifier)/weight$", ("model", None)),
    (r"(fc|classifier)/bias$", ("model",)),
]

# BERT (models/bert.py: layer{i}.attention.{query,key,value},
# attention_output, intermediate, output; torch weights [out, in]).
BERT_TP_RULES: RuleSet = [
    (r"attention/(query|key|value)/weight$", ("model", None)),
    (r"attention/(query|key|value)/bias$", ("model",)),
    (r"attention_output/weight$", (None, "model")),
    (r"intermediate/weight$", ("model", None)),
    (r"intermediate/bias$", ("model",)),
    (r"/output/weight$", (None, "model")),
]

# CLIP text tower (models/clip_text.py: layer{i}.{q,k,v,out,fc1,fc2}, torch
# weights [out, in]).
CLIP_TP_RULES: RuleSet = [
    (r"layer\d+/(q|k|v)/weight$", ("model", None)),
    (r"layer\d+/(q|k|v)/bias$", ("model",)),
    (r"layer\d+/out/weight$", (None, "model")),
    (r"layer\d+/fc1/weight$", ("model", None)),
    (r"layer\d+/fc1/bias$", ("model",)),
    (r"layer\d+/fc2/weight$", (None, "model")),
]

# GPT-2 (models/gpt2.py: layer{i}.{q,k,v,out,fc1,fc2}, JAX-layout kernels
# [in, out]): the fused HF c_attn is split into q/k/v at conversion, so
# whole heads shard.
GPT2_TP_RULES: RuleSet = [
    (r"layer\d+/(q|k|v)/kernel$", (None, "model")),
    (r"layer\d+/(q|k|v)/bias$", ("model",)),
    (r"layer\d+/out/kernel$", ("model", None)),
    (r"layer\d+/fc1/kernel$", (None, "model")),
    (r"layer\d+/fc1/bias$", ("model",)),
    (r"layer\d+/fc2/kernel$", ("model", None)),
]

# Whisper (models/whisper.py: encoder.layer{i}.{q,k,v,out,fc1,fc2} and
# decoder.layer{i}.{...,cq,ck,cv,cout}, kernels [in, out]): Megatron on
# both towers, self- and cross-attention column-parallel, out/cout and fc2
# row-parallel.  Conv stem, embeddings and LNs replicate.
WHISPER_TP_RULES: RuleSet = [
    (r"layer\d+/(q|k|v|cq|ck|cv)/kernel$", (None, "model")),
    (r"layer\d+/(q|k|v|cq|ck|cv)/bias$", ("model",)),
    (r"layer\d+/(out|cout)/kernel$", ("model", None)),
    (r"layer\d+/fc1/kernel$", (None, "model")),
    (r"layer\d+/fc1/bias$", ("model",)),
    (r"layer\d+/fc2/kernel$", ("model", None)),
]

