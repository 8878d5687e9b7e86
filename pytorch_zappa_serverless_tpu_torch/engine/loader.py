"""Cold-start assembly: config → placed, warm engine on one device.

``build_engine`` builds every configured servable (checkpoint import or
seed init), places it on the device, captures each bucket's CUDA graph (on
the CPU: runs its first dispatch) when ``warmup_at_boot`` is set, and
reports cold-start timing, the captures included.  A lazy model
(:func:`lazy_effective`) is skipped: ``serving/lifecycle.py`` builds it on
first demand through :func:`build_model` and :meth:`Engine.attach`.
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

    def shutdown(self):
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


def lazy_effective(cfg: ServeConfig, mc: ModelConfig) -> bool:
    """Whether this model defers its build to its first demand: its own
    ``lazy_load``, else the profile's; a PINNED model always builds at
    boot."""
    if mc.pinned:
        return False
    return cfg.lazy_load if mc.lazy_load is None else bool(mc.lazy_load)


def build_servable(mc: ModelConfig):
    """The servable of ``mc`` on the host (checkpoint import or seed init,
    quantization): host work only, which may run off the dispatch thread."""
    servable = get_model_builder(mc.builder or mc.name)(mc)
    servable.name = mc.name  # the deploy name owns the serving identity
    return servable


def build_model(mc: ModelConfig, clock: CompileClock, device: torch.device, *,
                warmup: bool = True, servable=None) -> CompiledModel:
    """Build ONE servable (unless ``servable`` is handed in), place it, and
    warm its buckets; on the dispatch thread."""
    if servable is None:
        servable = build_servable(mc)
    cm = CompiledModel(servable, mc, device, clock)
    if warmup:
        cm.warmup()
    return cm


def build_engine(cfg: ServeConfig, device: str | torch.device | None = None, *,
                 warmup: bool | None = None) -> Engine:
    t0 = time.perf_counter()
    dev = resolve_device(device)
    if dev.type == "cuda":
        # f32 products in full f32, as the JAX package computes them on the
        # CPU: no TF32 in cuBLAS or cuDNN.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    clock = CompileClock()
    runner = DeviceRunner(dev)
    runner.set_priority(cfg.priority_dispatch)
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
            cm = runner.run_fn_sync(build_model, mc, clock, dev, warmup=warmup)
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
    return Engine(models=compiled, runner=runner, clock=clock, device=dev,
                  cold_start_seconds=cold, build_seconds=build_seconds)
