"""Cold-start assembly: config → placed, warm engine on one device.

``build_engine`` builds every configured servable (checkpoint import or
seed init), places it on the device, captures each bucket's CUDA graph (on
the CPU: runs its first dispatch) when ``warmup_at_boot`` is set, and
reports cold-start timing, the captures included.  A lazy model
(:func:`lazy_effective`) is skipped: ``serving/lifecycle.py`` builds it on
first demand through :func:`build_model` and :meth:`Engine.attach`.

With a ``mesh`` or ``num_processes > 1`` the process is one rank of a
world (``parallel/mesh.py``): it joins the process group first, builds every
model eagerly on its own device (``cuda:{local_rank}``), shards it over the
mesh, and carries the ``LockstepDriver`` (``parallel/lockstep.py``) that rank
0 leads through once :meth:`Engine.enable_lockstep_lead` is called (the
server does) and every other rank follows.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .. import models as _zoo  # noqa: F401  (imports register the model builders)
from ..config import ModelConfig, ServeConfig
from ..utils.logging import get_logger, log_event
from ..utils.registry import get_model_builder
from .cache import CompileClock
from .compiled import CompiledModel
from .runner import DeviceRunner

log = get_logger("engine.loader")


@dataclass
class Engine:
    models: dict[str, CompiledModel]
    runner: DeviceRunner
    clock: CompileClock
    device: torch.device
    cold_start_seconds: float = 0.0
    build_seconds: dict[str, float] = field(default_factory=dict)
    mesh: object | None = None  # parallel.mesh.Mesh when ServeConfig.mesh is set
    # A world's LockstepDriver (parallel/lockstep.py): rank 0 leads once
    # enable_lockstep_lead() is called; the other ranks run
    # engine.lockstep.follow() instead of serving HTTP (cli serve does).
    lockstep: object | None = None

    def model(self, name: str) -> CompiledModel:
        try:
            return self.models[name]
        except KeyError:
            raise KeyError(f"model {name!r} not served; available: {sorted(self.models)}") from None

    # -- lifecycle attach/detach (serving/lifecycle.py) ----------------------
    def attach(self, name: str, cm: CompiledModel, nbytes: int | None = None):
        """Register an activated model and its device bytes (weights plus
        graph pools, :meth:`CompiledModel.resident_nbytes`) in the ledger."""
        self.models[name] = cm
        self.runner.track_model(name, cm.resident_nbytes() if nbytes is None else nbytes)

    def detach(self, name: str) -> CompiledModel | None:
        """Unregister a model (demotion); returns it, so the caller can keep
        the host copy."""
        self.runner.untrack_model(name)
        return self.models.pop(name, None)

    def mesh_rank(self) -> int:
        """This process's rank in its world (0 outside one)."""
        import torch.distributed as dist

        return dist.get_rank() if self.lockstep is not None else 0

    def world_snapshot(self) -> dict:
        """The world as /healthz reports it: backend (and NCCL's version),
        rank and size, the mesh, whether this rank leads, the leads broadcast
        by op, and the collectives captured in each bucket graph."""
        import torch.distributed as dist

        out = {"backend": dist.get_backend(), "rank": dist.get_rank(),
               "world_size": dist.get_world_size(),
               "mesh": dict(self.mesh.shape) if self.mesh is not None else None,
               "lead": bool(self.lockstep.lead_enabled), "leads": dict(self.lockstep.leads),
               # The collectives each captured graph holds (empty on the CPU).
               "graphs": {name: cm.graph_collectives for name, cm in self.models.items()}}
        if out["backend"] == "nccl":
            out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
        return out

    def enable_lockstep_lead(self):
        """Make this engine (rank 0 of a world) the leader: every run_batch,
        ``:generate`` admission and segment is broadcast to the followers
        first.  Off until called, so that a world whose ranks each drive
        run_batch themselves does not broadcast."""
        import torch.distributed as dist

        if self.lockstep is None or dist.get_rank() != 0:
            raise RuntimeError("lockstep lead is enabled on rank 0 of a world only")
        self.lockstep.lead_enabled = True
        for cm in self.models.values():
            cm.lockstep = self.lockstep

    def shutdown(self):
        """Stop the dispatch thread; a leader first releases its followers
        with ONE shutdown broadcast (on the dispatch thread, after the work
        queued there: a broadcast from another thread could pair with a
        follower's payload receive)."""
        if self.lockstep is not None and self.lockstep.lead_enabled and not self.runner.closed:
            try:
                self.runner.run_fn_within(60.0, self.lockstep.lead_shutdown)
            except Exception:
                log.exception("lockstep shutdown broadcast failed; the followers exit "
                              "through their collective-failure path")
        self.runner.shutdown()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  No CUDA and no explicit CPU request is an error, never a silent
    CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port serves on an NVIDIA "
                           "GPU; pass device='cpu' (--platform cpu) to run on "
                           "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


def in_world(cfg: ServeConfig) -> bool:
    """Whether the profile runs as a world of ranks: a mesh, or several
    processes."""
    return bool(cfg.mesh) or int(cfg.num_processes) > 1


def lazy_effective(cfg: ServeConfig, mc: ModelConfig) -> bool:
    """Whether this model defers its build to its first demand: its own
    ``lazy_load``, else the profile's.  A PINNED model and every model of a
    world (mesh or lockstep) build at boot: an attach or a detach cannot be
    mirrored across ranks or re-sharded on the fly."""
    if mc.pinned or in_world(cfg):
        return False
    return cfg.lazy_load if mc.lazy_load is None else bool(mc.lazy_load)


def build_servable(mc: ModelConfig):
    """The servable of ``mc`` on the host (checkpoint import or seed init,
    quantization): host work only, which may run off the dispatch thread."""
    servable = get_model_builder(mc.builder or mc.name)(mc)
    servable.name = mc.name  # the deploy name owns the serving identity
    return servable


def build_model(mc: ModelConfig, clock: CompileClock, device: torch.device, *,
                warmup: bool = True, servable=None, mesh=None) -> CompiledModel:
    """Build ONE servable (unless ``servable`` is handed in), place it
    (sharded over ``mesh``), and warm its buckets; on the dispatch thread."""
    if servable is None:
        servable = build_servable(mc)
    cm = CompiledModel(servable, mc, device, clock, mesh=mesh)
    if warmup:
        cm.warmup()
    return cm


def join_world(cfg: ServeConfig, dev: torch.device, local_rank: int):
    """Join the world of ``cfg`` as local rank ``local_rank`` and make its
    mesh (None without one).  Returns (device of this rank, mesh)."""
    from ..parallel import mesh as M

    world, local_ranks = M.world_layout(cfg.mesh, cfg.num_processes)
    if dev.type == "cuda":
        if cfg.mesh:
            M.check_devices(cfg.mesh, M.device_pool(dev, cfg.num_processes))
        dev = torch.device("cuda", int(local_rank))
    if cfg.heartbeat_interval_s and cfg.heartbeat_interval_s >= M.COLLECTIVE_TIMEOUT_S:
        raise ValueError(f"heartbeat_interval_s={cfg.heartbeat_interval_s:g} must stay below "
                         f"the process group's timeout ({M.COLLECTIVE_TIMEOUT_S:g} s)")
    if not cfg.heartbeat_interval_s and world > 1:
        log.warning("no heartbeat_interval_s in a world of %d ranks: a follower idle for "
                    "%g s aborts its collective", world, M.COLLECTIVE_TIMEOUT_S)
    M.init_distributed(cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                       local_ranks=local_ranks, local_rank=local_rank, device=dev)
    mesh = None
    if cfg.mesh:
        # One mesh shared by every servable: the family TP rules shard the
        # weights, DP splits the rows (CompiledModel).
        mesh = M.make_mesh(dict(cfg.mesh), device=dev, num_processes=cfg.num_processes)
        log_event(log, "mesh ready", axes=mesh.shape, rank=mesh.rank, coords=mesh.coords,
                  device=str(dev))
    return dev, mesh


def build_engine(cfg: ServeConfig, device: str | torch.device | None = None, *,
                 warmup: bool | None = None, local_rank: int = 0) -> Engine:
    """Build the engine of ``cfg`` on ``device`` (CUDA unless the caller asks
    for the CPU).  In a world (:func:`in_world`) the process is local rank
    ``local_rank`` of its host (``cli serve`` spawns the others) and serves
    on ``cuda:{local_rank}``."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    mesh = None
    if in_world(cfg):
        # Before any device use: the process group, then the mesh.
        dev, mesh = join_world(cfg, dev, local_rank)
    if dev.type == "cuda":
        # f32 products in full f32, as the JAX package computes them on the
        # CPU: no TF32 in cuBLAS or cuDNN.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    clock = CompileClock()
    runner = DeviceRunner(dev)
    runner.set_priority(cfg.priority_dispatch)
    if in_world(cfg) and dev.type == "cuda":
        # The dispatch thread's current device is this rank's (a new thread
        # starts on device 0): captures and NCCL calls use it.
        runner.run_fn_sync(torch.cuda.set_device, dev)
    warmup = cfg.warmup_at_boot if warmup is None else warmup
    compiled: dict[str, CompiledModel] = {}
    build_seconds: dict[str, float] = {}
    try:
        for mc in cfg.models:
            if lazy_effective(cfg, mc):
                # Scale-to-zero boot: the model starts COLD, and the
                # lifecycle activates it on its first demand.
                log_event(log, "model deferred (lazy_load)", model=mc.name)
                continue
            t1 = time.perf_counter()
            # Built and warmed on the dispatch thread: it owns all device work.
            cm = runner.run_fn_sync(build_model, mc, clock, dev, warmup=warmup, mesh=mesh)
            compiled[mc.name] = cm
            build_seconds[mc.name] = round(time.perf_counter() - t1, 3)
            runner.track_model(mc.name, cm.resident_nbytes())
            log_event(log, "model ready", model=mc.name, device=str(dev),
                      seconds=build_seconds[mc.name],
                      buckets=[list(b) for b in cm.buckets], graphs=cm.graphs)
    except BaseException:
        runner.shutdown()
        raise
    cold = time.perf_counter() - t0
    log_event(log, "engine ready", cold_start_seconds=round(cold, 3),
              first_dispatch_seconds=round(clock.total_seconds, 3),
              models=sorted(compiled))
    engine = Engine(models=compiled, runner=runner, clock=clock, device=dev,
                    cold_start_seconds=cold, build_seconds=build_seconds, mesh=mesh)
    if in_world(cfg):
        from ..parallel.lockstep import LockstepDriver

        engine.lockstep = LockstepDriver(engine)
    return engine
