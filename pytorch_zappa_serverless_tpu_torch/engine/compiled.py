"""Bucketed batched execution on one device.

A fixed set of (batch[, seq]) buckets per model; requests pad up to the
smallest fitting bucket, so the device sees a few static shapes.  The JAX
package compiles one program per bucket (``jax.jit``); on the GPU the port
captures one CUDA graph per bucket (:class:`BucketGraph`) and replays it at
every dispatch: one ``cudaGraphLaunch`` in place of every kernel launch the
model's Python would issue.

- Warm-up runs each bucket once eagerly on a side stream (kernel builds,
  library handles, first-use attributes), then captures it on that stream;
  a bucket (or a servable's variant of one, ``meta["variant_of"]``) first
  met in traffic is captured then, "captured lazily".  Both go on the
  ``CompileClock``, as the JAX package's compiles do.
- The SD job lane's chunk step is captured once per state and row shape
  (:meth:`CompiledModel.chunk_step`), its prepare (the CLIP encode) once a
  bucket and its finalize (the VAE decode) once a latents shape; the host
  work around them (tokenizing, the PNG) stays outside the graphs, and
  :meth:`~CompiledModel.chunk_prepare_eager` and
  :meth:`~CompiledModel.chunk_finalize_eager` are what a check holds their
  replays against.
- On the CPU (``device="cpu"``, the caller's choice) every dispatch runs
  eagerly.  On CUDA a capture or a replay that fails raises: there is no
  eager fallback.  :meth:`CompiledModel.forward_eager` is what a check
  holds a replay against.
- Residency tiers (``serving/lifecycle.py``): :meth:`CompiledModel.host_offload`
  copies the weights into pinned host memory and frees the device copies,
  :meth:`~CompiledModel.disk_offload` hands them to the checkpoint store and
  frees the host copies, and the restores bring them back.  A captured graph
  holds the addresses of the weights it read, so a demotion releases every
  graph and its pool with the device weights (a released graph refuses to
  replay) and a restore captures every bucket again, on the dispatch thread,
  before the model serves.  :meth:`~CompiledModel.copy_in_place` is the
  other way to change weights: values copied under the captured addresses.
- On a mesh (``parallel/mesh.py``) the weights shard by the family's TP
  rules (``meta["tp_rules"]``) and the models run their collectives; a
  bucket whose rows divide the ``data`` axis runs this rank's rows and
  all-gathers the outputs, any other bucket replicates (buckets are never
  padded up for the mesh).  The collectives are captured in the bucket
  graphs with the kernels.  Rank 0 of a lockstep world announces each
  collated batch to the followers before it runs (``lockstep``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import counters
from ..utils.logging import get_logger, log_event
from .cache import CompileClock, timed
from .servable import Servable

log = get_logger("engine.compiled")

# Held around every CUDA graph capture, and by other threads' device work
# that may overlap one (``streamio.device_placer``, streaming weights while
# the dispatch thread builds and captures).  A capture in the default
# "global" mode fails if another thread allocates, copies or launches while
# it is open; the dispatch thread issues all other device work, so a lock
# on the one other source is enough, and captures keep the global mode.
CAPTURE_LOCK = threading.Lock()

# Long device work in progress, by thread: ident -> (label, monotonic start).
# The dispatch thread marks a restore, a build or a capture here, so that
# /healthz can say the thread is held by work that progresses instead of
# waiting behind it (``DeviceRunner.held``).
_HOLDS: dict[int, tuple[str, float]] = {}  # guarded-by: _HOLDS_LOCK
_HOLDS_LOCK = threading.Lock()


@contextlib.contextmanager
def holding(label: str):
    """Mark the current thread as held by ``label`` for the block; a nested
    hold keeps the outer label and start."""
    ident = threading.get_ident()
    with _HOLDS_LOCK:
        outer = ident in _HOLDS
        if not outer:
            _HOLDS[ident] = (label, time.monotonic())
    try:
        yield
    finally:
        if not outer:
            with _HOLDS_LOCK:
                _HOLDS.pop(ident, None)


def held_by(ident: int | None) -> tuple[str, float] | None:
    """The hold of thread ``ident``: (label, monotonic start), or None."""
    with _HOLDS_LOCK:
        return _HOLDS.get(ident)


class Captured(NamedTuple):
    """A captured CUDA graph, its static outputs, the counted launches
    (``ops.counters``) each replay runs, and the collectives captured in it
    (on a mesh: the TP all-reduces and gathers, the DP gather)."""

    graph: torch.cuda.CUDAGraph
    outputs: Any
    launches: dict[str, int]
    collectives: dict[str, int] = {}

    def replay(self):
        """Launch the graph on the current stream; returns the static outputs,
        valid until the next replay of any graph of the same pool."""
        self.graph.replay()
        counters.add(self.launches)
        counters.add_graphed(self.launches)
        return self.outputs


@functools.cache
def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream every capture of the process runs on.  cuBLAS
    keeps a workspace for each (handle, stream) pair for the life of the
    process, and a handle belongs to a thread: with a fresh stream per
    capture, each engine rebuilt on a new dispatch thread would leave its
    pairs' workspaces behind.  One stream bounds the pairs to the handles,
    which a new thread takes back from one that has exited."""
    return torch.cuda.Stream(device)


def capture(fn: Callable[[], Any], device: torch.device, pool=None) -> Captured:
    """Run ``fn()`` once eagerly on the capture stream (its first-use work:
    kernel builds, ``cudaFuncSetAttribute``, launch plans, cuBLAS and cuDNN
    handles of that stream), then capture a second call on the same stream
    into one graph of ``pool``.  The eager call counts its launches; the
    capture counts none (the counters are restored after it).  ``fn`` must
    not read the device on the host: such a read raises during capture."""
    with holding("capture"):
        side = capture_stream(torch.device(device))
        side.wait_stream(torch.cuda.current_stream(device))
        warm = counters.snapshot()
        with torch.cuda.stream(side):
            fn()
        counters.add_graphed(counters.delta(warm))
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before, coll = counters.snapshot(), counters.collectives()
        try:
            with CAPTURE_LOCK, torch.cuda.graph(graph, pool=pool, stream=side):
                outputs = fn()
        finally:
            launches = counters.delta(before)
            counters.restore(before)
    held = {k: n - coll.get(k, 0) for k, n in counters.collectives().items()
            if n - coll.get(k, 0)}
    return Captured(graph, outputs, launches, held)


def _source(v) -> torch.Tensor:
    """What a static input copies from: a tensor as it is, a host array
    through pinned memory (so that the copy is asynchronous)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v)).pin_memory()


class BucketGraph:
    """One bucket's captured program: the port's counterpart of the JAX
    package's per-bucket compiled program.

    ``inputs`` are static device buffers shaped like ``example`` (allocated
    outside the graph's pool, so no capture can hand their memory to
    another graph); :meth:`run` copies a batch into them, replays, and
    returns the static outputs.  The first call of ``fn`` (the warm-up) runs
    on ``example``'s values."""

    def __init__(self, fn: Callable[[dict[str, torch.Tensor]], Any],
                 example: dict[str, Any], device: torch.device, pool):
        self.inputs = {k: torch.empty(tuple(np.shape(v)), device=device,
                                      dtype=v.dtype if isinstance(v, torch.Tensor)
                                      else torch.from_numpy(np.asarray(v)).dtype)
                       for k, v in example.items()}
        self._fill(example)
        self.captured = capture(lambda: fn(self.inputs), device, pool)

    def _fill(self, values: dict[str, Any]) -> None:
        for k, v in values.items():
            dst = self.inputs[k]
            dst.copy_(_source(v), non_blocking=True)

    def run(self, values: dict[str, Any]):
        """Copy ``values`` into the static inputs, replay, and return the
        static outputs (read them before the next replay of the pool)."""
        if self.captured is None:
            raise RuntimeError("replay of a released CUDA graph: the weights it read "
                               "were demoted; the model captures new graphs when restored")
        self._fill(values)
        return self.captured.replay()

    def release(self) -> None:
        """Drop the graph, its static buffers and outputs (dispatch thread):
        a later :meth:`run` raises instead of reading freed memory."""
        self.captured = None
        self.inputs = {}

    @property
    def launches(self) -> dict[str, int]:
        return self.captured.launches


def _empty_as(t: torch.Tensor, device, pin_memory: bool = False) -> torch.Tensor:
    """An uninitialized tensor of ``t``'s shape, dtype and strides (its
    memory format: a channels_last weight stays channels_last)."""
    return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device=device,
                               pin_memory=pin_memory)


def graph_pool_bytes(device: torch.device, pools: list) -> int:
    """Bytes of the caching allocator's segments that belong to ``pools``
    (CUDA graph pool ids), from its snapshot; 0 on the CPU."""
    if torch.device(device).type != "cuda" or not pools:
        return 0
    want = {tuple(p) for p in pools}
    return sum(int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in want)


def _entry(key: tuple) -> list:
    """A graph's key as the clock's "bucket": [8, 64]; with a variant, the
    names of its gates that are on ([8, 64, "sampled+filtered"], [1, 64,
    "greedy"]); a chunk graph's latents and rows shapes (["chunk",
    "latents[1, 64, 64, 4]", "t[4]"]); SD's prepare by bucket (["prepare",
    "1"]) and finalize by latents (["finalize", "latents[1, 64, 64, 4]"])."""
    if key[0] == "chunk":
        return ["chunk", *(f"{k.split('.')[-1]}{list(shape)}" for k, shape in key[1]
                           if k in ("state.latents", "rows.t"))]
    if key[0] == "prepare":
        return ["prepare", *map(str, key[1])]
    if key[0] == "finalize":
        return ["finalize", *(f"{k}{list(shape)}" for k, shape in key[1] if k == "latents")]
    bucket, variant = key
    if variant is None:
        return list(bucket)
    return [*bucket, "+".join(f for f in variant._fields if getattr(variant, f)) or "greedy"]


def _label(key: tuple) -> str:
    """``_entry`` in words: "(8, 64) sampled+filtered", "chunk latents[1,
    64, 64, 4] t[4]"."""
    if key[0] in ("chunk", "prepare", "finalize"):
        return " ".join(_entry(key))
    return " ".join([str(key[0]), *map(str, _entry(key)[len(key[0]):])])


def default_collate(samples: Sequence[dict[str, np.ndarray]], bucket: tuple[int, ...],
                    input_spec: dict[str, tuple[tuple[int, ...], torch.dtype]]
                    ) -> dict[str, np.ndarray]:
    """Stack per-sample arrays and zero-pad every axis up to the bucket spec.

    Zero is the pad value on all axes (batch rows, token ids, masks).
    """
    from ..ops import hostops

    out = {}
    for key, (shape, dtype) in input_spec.items():
        per_sample = shape[1:]
        arrays = [np.asarray(s[key]) for s in samples]
        if dtype == torch.uint8 and all(a.shape == per_sample and a.dtype == np.uint8
                                        for a in arrays):
            # Uniform-shape uint8 (the image servables): the native batch
            # pack, one memcpy per sample into the zero-padded bucket buffer.
            out[key] = hostops.pack_batch_u8(arrays, shape[0])
            continue
        padded = []
        for a in arrays:
            pads = [(0, want - have) for want, have in zip(per_sample, a.shape)]
            padded.append(np.pad(a, pads) if any(p != (0, 0) for p in pads) else a)
        stacked = np.stack(padded).astype(torch.empty(0, dtype=dtype).numpy().dtype)
        rows = shape[0] - stacked.shape[0]
        if rows:
            stacked = np.pad(stacked, [(0, rows)] + [(0, 0)] * (stacked.ndim - 1))
        if stacked.shape != tuple(shape):
            raise ValueError(f"{key}: collated {stacked.shape}, bucket wants {shape}")
        out[key] = stacked
    return out


def _has_q(module: torch.nn.Module) -> bool:
    return any(name.endswith("kernel_q") for name, _ in module.named_buffers())


def cast_params_at_rest(module: torch.nn.Module, dtype: torch.dtype) -> None:
    """The at-rest weight cast of ``extra.params_dtype`` (e.g. "bfloat16"),
    in place: half the device memory of f32 weights, which the models cast
    to the compute dtype at every use.  Only f32 tensors of two or more dims
    convert; norm scales and biases stay f32 for the f32 norm paths."""
    for m in module.modules():
        for store in (m._parameters, m._buffers):
            for key, t in store.items():
                if t is not None and t.dtype == torch.float32 and t.ndim >= 2:
                    cast = t.detach().to(dtype)
                    store[key] = (torch.nn.Parameter(cast, t.requires_grad)
                                  if isinstance(t, torch.nn.Parameter) else cast)


class CompiledModel:
    """One servable, placed on ``device``, with its bucket set and, on CUDA,
    its captured graphs."""

    def __init__(self, servable: Servable, cfg: ModelConfig, device: torch.device,
                 clock: CompileClock | None = None, mesh=None):
        from ..utils.registry import LATENCY_CLASSES, get_latency_class

        self.servable = servable
        self.cfg = cfg
        self.device = torch.device(device)
        self.clock = clock or CompileClock()
        lc = (cfg.latency_class or get_latency_class(cfg.builder or cfg.name)
              or servable.meta.get("latency_class") or "latency")
        if lc not in LATENCY_CLASSES:
            raise ValueError(f"{cfg.name}: latency_class must be one of "
                             f"{LATENCY_CLASSES}, got {lc!r}")
        self.latency_class = lc
        self.mesh = mesh
        params_dtype = cfg.extra.get("params_dtype")
        if mesh is not None and str(params_dtype) in ("auto", "int8"):
            # The TP rules match float kernels: quantized ones would silently
            # replicate, and the W8A16 kernel is single-device.  Fail at boot,
            # not with a wrong-but-running config.
            half = "the int8 half is" if str(params_dtype) == "auto" else "quantized kernels are"
            raise ValueError(
                f"{cfg.name}: params_dtype={params_dtype} cannot be served on a mesh ({half} "
                f"invisible to the TP rules and the W8A16 kernel is single-device); drop the "
                f"mesh for this model or use params_dtype=bfloat16")
        if mesh is not None and "adapters" in servable.meta:
            # The TP rules cannot see the stacked low-rank factors: they would
            # replicate while the base kernels shard, wrong at the delta add.
            raise ValueError(f"{cfg.name}: adapter_slots cannot be served on a mesh; drop "
                             f"the mesh for this model or its adapters")
        if str(params_dtype) == "auto":
            # The regime-routed lane (models/gpt2.py) holds a bf16 and an int8
            # tree and each program reads one: the at-rest cast must not
            # touch them, and a builder without the lane must not serve.
            if not {"bf16", "int8"} <= set(servable.module._modules):
                raise ValueError(
                    f"{cfg.name}: params_dtype=auto requested but this model family has no "
                    f"regime-routed lane (the builder made no bf16/int8 tree pair); use "
                    f"params_dtype=bfloat16 or int8")
        elif str(params_dtype) == "int8":
            # The W8A16 lane is a param REWRITE (kernel -> kernel_q + scale)
            # done by the builder; a builder that ignored the flag must not
            # silently serve f32 weights the operator passed over.
            if not _has_q(servable.module):
                raise ValueError(
                    f"{cfg.name}: params_dtype=int8 requested but this model "
                    f"family has no int8 lane (no quantized kernels in the "
                    f"params); use params_dtype=bfloat16 or leave it unset")
        elif params_dtype:
            from ..models.bert import resolve_dtype

            cast_params_at_rest(servable.module, resolve_dtype(params_dtype))
        # The shards of the model axis a rank holds of each sharded leaf (the
        # :generate pools take the width of its heads), 1 off a mesh.
        self.tp_size = 1
        if mesh is not None:
            from ..parallel.mesh import check_heads, shard_params

            check_heads(cfg.name, servable.meta.get("tp_heads"), mesh)
            matched = shard_params(mesh, servable.module, servable.meta.get("tp_rules", ()))
            self.tp_size = max((mesh.shape[a] for spec in matched.values() for a in spec if a),
                               default=1)
        servable.module.to(self.device)
        if servable.bucket_axes == ("batch",):
            self.buckets = sorted((int(b),) for b in cfg.batch_buckets)
        elif servable.bucket_axes == ("batch", "seq"):
            self.buckets = sorted((int(b), int(s)) for b, s in
                                  itertools.product(cfg.batch_buckets, cfg.seq_buckets))
        else:
            raise ValueError(f"unsupported bucket axes {servable.bucket_axes}")
        self.max_batch = max(b[0] for b in self.buckets)
        self._warmed: set[tuple[int, ...]] = set()
        self.graphed = self.device.type == "cuda"
        self._warming = False
        # Where the weights are: "device", "host" (pinned copies) or "disk"
        # (the checkpoint store holds them; the module keeps meta tensors).
        self.tier = "device"
        # Graphs captured over the model's life: a restore adds one a bucket.
        self.captures = 0
        # The captured programs, by (bucket, variant) or chunk key; one pool:
        # the dispatch thread replays one graph at a time and every output is
        # copied out before the next replay.
        self._graphs: dict[tuple, BucketGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        # The :generate lanes' graph sets (engine/genkernels.LaneGraphs), in
        # the census beside the buckets'.
        self.lane_graphs: list = []
        self._chunk_rows = self._device_chunk_rows()
        # Rank 0 of a lockstep world: its ``LockstepDriver``, to which
        # run_batch announces each collated batch (``Engine.enable_lockstep_lead``).
        self.lockstep = None

    def _device_chunk_rows(self) -> list[dict[str, torch.Tensor]]:
        """One device copy of each chunk's schedule rows (their order is the
        job lane's), which a chunk graph's static rows copy from."""
        ch = self.servable.meta.get("chunked")
        return ([{k: torch.as_tensor(np.asarray(v), device=self.device)
                  for k, v in rows.items()} for rows in ch["chunk_rows"]]
                if ch and self.graphed else [])

    # -- bucket selection ---------------------------------------------------
    def bucket_for(self, batch: int, seq: int | None = None) -> tuple[int, ...]:
        for b in self.buckets:
            if b[0] >= batch and (seq is None or len(b) == 1 or b[1] >= seq):
                return b
        raise ValueError(
            f"{self.servable.name}: no bucket fits batch={batch} seq={seq} "
            f"(buckets={self.buckets})")

    # -- placement ----------------------------------------------------------
    def _place(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Host → device from pinned memory, asynchronous on the current
        stream (the caching host allocator keeps each pinned block alive
        until its copy is done)."""
        if self.device.type == "cpu":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                for k, v in batch.items()}

    @staticmethod
    def _fetch(out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """Device → host; ``.cpu()`` waits for the device."""
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _split(self, batch: dict[str, Any]) -> tuple[dict[str, Any], bool]:
        """(the rows this rank runs, whether they are a DP split): on a mesh
        a batch whose rows divide the ``data`` axis splits over it, any
        other replicates; off a mesh every row runs here."""
        if self.mesh is None:
            return batch, False
        from ..parallel.mesh import batch_sharding

        rows = batch_sharding(self.mesh, min((np.shape(v)[0] for v in batch.values()),
                                             default=0))
        if rows is None:
            return batch, False
        return {k: v[rows] for k, v in batch.items()}, True

    def _gathered(self, out: dict[str, torch.Tensor], split: bool) -> dict[str, torch.Tensor]:
        """A DP split's outputs all-gathered over ``data`` (every rank gets
        every row, in rank order: the batch's order)."""
        if not split:
            return out
        data = self.mesh.axis("data")
        return {k: data.all_gather(v, 0) for k, v in out.items()}

    def _bucket_of(self, batch: dict[str, np.ndarray]) -> tuple[int, ...]:
        for b in self.buckets:
            if all(np.shape(batch[k]) == tuple(shape)
                   for k, (shape, _) in self.servable.input_spec(b).items()):
                return b
        raise ValueError(f"{self.servable.name}: the batch fills no bucket "
                         f"({ {k: np.shape(v) for k, v in batch.items()} })")

    def _variant(self, batch: dict[str, np.ndarray]):
        """The servable's variant key of a collated host batch (None where it
        has one program per bucket)."""
        of = self.servable.meta.get("variant_of")
        return of(batch) if of else None

    def _apply(self, inputs: dict[str, torch.Tensor], variant):
        if variant is None:
            return self.servable.apply_fn(self.servable.module, inputs)
        return self.servable.apply_fn(self.servable.module, inputs, variant=variant)

    def forward_eager(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """One collated bucket batch through ``apply_fn`` eagerly, back on the
        host: the CPU's path, and on CUDA what a replay is held against."""
        local, split = self._split(batch)
        with torch.inference_mode():
            return self._fetch(self._gathered(self._apply(self._place(local),
                                                          self._variant(batch)), split))

    def forward(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """One collated bucket batch through the model, back on the host: on
        CUDA a replay of the bucket's graph (captured now if it is new)."""
        if not self.graphed:
            return self.forward_eager(batch)
        local, _ = self._split(batch)
        with torch.inference_mode():
            return self._fetch(self.bucket_graph(batch).run(local))

    def bucket_graph(self, batch: dict[str, np.ndarray]) -> BucketGraph:
        """The captured graph a :meth:`forward` of ``batch`` replays (its
        bucket's, of the servable's variant where it has variants), captured
        now if it is new."""
        variant = self._variant(batch)
        key = (self._bucket_of(batch), variant)
        local, split = self._split(batch)
        with torch.inference_mode():
            return self._graphs.get(key) or self._capture(
                key, self._bucket_fn(variant, split), local, record=True)

    def _bucket_fn(self, variant, split: bool = False):
        return lambda inputs: self._gathered(self._apply(inputs, variant), split)

    def _capture(self, key: tuple, fn, example, record: bool) -> BucketGraph:
        """Capture ``key``'s graph (its eager warm-up run included); with
        ``record``, its seconds go on the clock (the JAX package's compile
        seconds): "captured" at warm-up, "captured lazily" in traffic."""
        if self.tier != "device":
            raise RuntimeError(f"{self.servable.name}: capture with the weights on the "
                               f"{self.tier} tier")
        t0 = time.perf_counter()
        graph = BucketGraph(fn, example, self.device, self._pool)
        torch.cuda.current_stream(self.device).synchronize()
        secs = time.perf_counter() - t0
        self._graphs[key] = graph
        self.captures += 1
        if record:
            self.clock.record(self.servable.name, _entry(key), secs)
        log_event(log, "captured" if self._warming else "captured lazily",
                  model=self.servable.name, graph=_label(key), launches=graph.launches,
                  seconds=round(secs, 3))
        return graph

    @property
    def graph_collectives(self) -> dict[str, dict[str, int]]:
        """The collectives captured in each bucket graph, by its label (empty
        dicts off a mesh)."""
        return {_label(k): g.captured.collectives for k, g in self._graphs.items()
                if g.captured is not None}

    @property
    def graphs(self) -> list[str]:
        """The captured graphs' keys, in words, the lanes' after the buckets'."""
        return ([_label(k) for k in list(self._graphs)]
                + [label for lane in self.lane_graphs for label in lane.labels])

    # -- warmup -------------------------------------------------------------
    def _zeros(self, bucket: tuple[int, ...], per_sample: bool = False):
        spec = self.servable.input_spec(bucket)
        return {k: np.zeros(shape[1:] if per_sample else shape,
                            torch.empty(0, dtype=dt).numpy().dtype)
                for k, (shape, dt) in spec.items()}

    def _warm_bucket(self, bucket: tuple[int, ...]):
        dummy = self._zeros(bucket)
        if self.graphed:
            variant = self.servable.meta.get("default_variant")
            local, split = self._split(dummy)
            with torch.inference_mode():
                self._capture((bucket, variant), self._bucket_fn(variant, split), local,
                              record=True)
            self._warmed.add(bucket)
            return
        _, secs = timed(lambda: self.forward(dummy))
        self.clock.record(self.servable.name, bucket, secs)
        self._warmed.add(bucket)
        log_event(log, "warmed", model=self.servable.name, bucket=list(bucket),
                  seconds=round(secs, 3))

    def warmup(self):
        """First dispatch of every bucket, ahead of traffic: through the
        chunked path for a servable that declares one (the path its jobs
        take; on a mesh they run whole), else one forward."""
        chunked = "chunked" in self.servable.meta and self.mesh is None
        self._warming = True
        try:
            for b in self.buckets:
                if b not in self._warmed:
                    (self._warm_chunked if chunked else self._warm_bucket)(b)
        finally:
            self._warming = False

    def _warm_chunked(self, bucket: tuple[int, ...]):
        """prepare, one chunk per distinct row shape and finalize (on CUDA:
        each one's capture), on a batch of zeros that fills ``bucket``."""
        dummy = [self._zeros(bucket, per_sample=True) for _ in range(bucket[0])]
        _, secs = timed(lambda: self.chunk_finalize(self._warm_chunk_steps(dummy), dummy))
        self.clock.record(self.servable.name, (*bucket, "chunked"), secs)
        self._warmed.add(bucket)
        log_event(log, "warmed chunked", model=self.servable.name, bucket=list(bucket),
                  chunks=self.servable.meta["chunked"]["num_chunks"],
                  seconds=round(secs, 3))

    def _warm_chunk_steps(self, dummy):
        _, state = self.chunk_prepare(dummy)
        seen = set()
        for rows in self.servable.meta["chunked"]["chunk_rows"]:
            shape = tuple(sorted((k, np.shape(v)) for k, v in rows.items()))
            if shape not in seen:  # one chunk per row shape, not every chunk
                seen.add(shape)
                state = self.chunk_step(state, rows)
        return state

    # -- chunked execution (QoS preemption points; runner.run_chunked) -------
    def _sync(self):
        """Wait for the device's stream, so a slice's lane occupancy is its
        device time (the JAX package's ``block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _collate_chunked(self, samples: Sequence[dict]):
        bucket = self.bucket_for(len(samples))
        collate = self.servable.meta.get("collate") or default_collate
        return bucket, collate(samples, bucket, self.servable.input_spec(bucket))

    def chunk_prepare(self, samples: Sequence[dict]):
        """Collate one batch (on the host) and run the chunked ``prepare``
        (SD-1.5: the CLIP encode).  Returns (bucket, device state); the
        state (latents + conditioning) stays on the device between chunk
        dispatches.  On CUDA a replay of the bucket's prepare graph (captured
        now if it is new)."""
        if not self.graphed:
            return self.chunk_prepare_eager(samples)
        bucket, batch = self._collate_chunked(samples)
        with torch.inference_mode():
            state = self._prepare_replay(bucket, batch)
        self._sync()
        return bucket, state

    def chunk_prepare_eager(self, samples: Sequence[dict]):
        """:meth:`chunk_prepare` eagerly: the CPU's path, and on CUDA what
        the prepare graph's replay is held against."""
        bucket, batch = self._collate_chunked(samples)
        with torch.inference_mode():
            state = self.servable.meta["chunked"]["prepare"](self.servable.module.tree(),
                                                             self._place(batch))
        self._sync()
        return bucket, state

    def chunk_step(self, state, rows):
        """One chunk of the model's loop.  On CUDA a replay of the chunk graph
        of this state's and rows' shapes: the job's own state and rows are
        copied into the graph's static buffers and the new state copied back
        out, so two jobs whose chunks interleave on one bucket never share a
        buffer."""
        chunk = self.servable.meta["chunked"]["chunk"]
        with torch.inference_mode():
            if not self.graphed:
                state = chunk(self.servable.module.tree(), state, rows)
            else:
                rows = next((dev for dev, host in zip(self._chunk_rows,
                                                      self.servable.meta["chunked"]["chunk_rows"])
                             if host is rows), rows)
                state = self._chunk_replay(chunk, state, rows)
        self._sync()
        return state

    def chunk_finalize(self, state, samples: Sequence[dict]):
        """The chunked ``finalize`` (SD-1.5: the VAE decode), the fetch and
        each sample's postprocess (run_batch's tail; the PNG encode is the
        job worker's, off this thread).  On CUDA a replay of the finalize
        graph of this state's shapes (captured now if it is new)."""
        if not self.graphed:
            return self.chunk_finalize_eager(state, samples)
        with torch.inference_mode():
            out = self._fetch(self._finalize_replay(state))
        return [self.servable.postprocess(out, i) for i in range(len(samples))]

    def queue_job(self, samples: Sequence[dict]) -> dict[str, torch.Tensor]:
        """One job of ``samples`` on CUDA as the job lane runs it (prepare,
        each chunk in order, finalize: the replays and copies of
        :meth:`chunk_prepare`, :meth:`chunk_step` and :meth:`chunk_finalize`),
        queued with no host wait and no fetch.  Returns the finalize graph's
        static outputs.  What a device timing of one job replays."""
        if not self.graphed:
            raise RuntimeError(f"{self.servable.name}: queue_job replays CUDA graphs")
        bucket, batch = self._collate_chunked(samples)
        chunk = self.servable.meta["chunked"]["chunk"]
        with torch.inference_mode():
            state = self._prepare_replay(bucket, batch)
            for rows in self._chunk_rows:
                state = self._chunk_replay(chunk, state, rows)
            return self._finalize_replay(state)

    # The chunked graphs' keys: prepare by bucket, a chunk by its state's
    # and rows' shapes, finalize by the state's.
    def _prepare_replay(self, bucket: tuple[int, ...], batch: dict) -> dict:
        """The prepare graph's replay on a collated host batch; the state is
        copied out of the graph's pool, so that every job keeps its own."""
        prepare = self.servable.meta["chunked"]["prepare"]
        key = ("prepare", bucket)
        graph = self._graphs.get(key) or self._capture(
            key, lambda inputs: prepare(self.servable.module.tree(), inputs), batch,
            record=not self._warming)
        return {k: v.clone() for k, v in graph.run(batch).items()}

    def _chunk_replay(self, chunk, state: dict, rows: dict) -> dict:
        values = {**{f"state.{k}": v for k, v in state.items()},
                  **{f"rows.{k}": v for k, v in rows.items()}}
        key = ("chunk", tuple((k, tuple(v.shape)) for k, v in values.items()))
        graph = self._graphs.get(key)
        if graph is None:
            def fn(inputs):
                tree = self.servable.module.tree()
                return chunk(tree, {k: inputs[f"state.{k}"] for k in state},
                             {k: inputs[f"rows.{k}"] for k in rows})

            # At warm-up the chunked entry on the clock holds this capture.
            graph = self._capture(key, fn, values, record=not self._warming)
        out = graph.run(values)
        # The job keeps its own tensors: a state entry the chunk passes
        # through is the static input itself, the rest are fresh copies.
        return {k: state[k] if v is graph.inputs.get(f"state.{k}") else v.clone()
                for k, v in out.items()}

    def _finalize_replay(self, state: dict) -> dict:
        """The finalize graph's replay; its static outputs."""
        finalize = self.servable.meta["chunked"]["finalize"]
        key = ("finalize", tuple(sorted((k, tuple(v.shape)) for k, v in state.items())))
        graph = self._graphs.get(key) or self._capture(
            key, lambda inputs: finalize(self.servable.module.tree(), inputs), state,
            record=not self._warming)
        return graph.run(state)

    def chunk_finalize_eager(self, state, samples: Sequence[dict]):
        """:meth:`chunk_finalize` eagerly: the CPU's path, and on CUDA what
        the finalize graph's replay is held against."""
        with torch.inference_mode():
            out = self._fetch(self.servable.meta["chunked"]["finalize"](
                self.servable.module.tree(), state))
        return [self.servable.postprocess(out, i) for i in range(len(samples))]

    @property
    def warmed_buckets(self) -> set[tuple[int, ...]]:
        return set(self._warmed)

    def param_nbytes(self) -> int:
        """Parameter + buffer bytes, wherever they lie (device, or pinned
        host memory on the host tier)."""
        return sum(t.numel() * t.element_size() for t in self._tensors().values())

    def graph_pools(self) -> list:
        """The CUDA graph pools holding this model's captured graphs: the
        buckets' and each ``:generate`` lane's."""
        if not self.graphed:
            return []
        return [self._pool] + [lane._pool for lane in self.lane_graphs
                               if lane._pool is not None]

    def resident_nbytes(self) -> int:
        """What the model holds on the device: its weights plus the segments
        of its graph pools (a graph replays into its pool's memory, which no
        other allocation may take).  The runner's residency ledger and the
        HBM budget count this."""
        if self.tier != "device":
            return 0
        return self.param_nbytes() + graph_pool_bytes(self.device, self.graph_pools())

    # -- residency tiers (serving/lifecycle.py) ----------------------------
    def _slots(self):
        """(owner dict, key, flat name) of every parameter and buffer, module
        by module; the flat name is the module path joined with "/"."""
        for mod_name, m in self.servable.module.named_modules():
            for store in (m._parameters, m._buffers):
                for key, t in store.items():
                    if t is not None:
                        yield store, key, f"{mod_name}/{key}".replace(".", "/").lstrip("/")

    def _tensors(self) -> dict[str, torch.Tensor]:
        """Flat name → tensor, each distinct tensor once, under its first
        name (a tied weight's other names alias it)."""
        out: dict[str, torch.Tensor] = {}
        seen: set[int] = set()
        for store, key, name in self._slots():
            if id(store[key]) not in seen:
                seen.add(id(store[key]))
                out[name] = store[key]
        return out

    def _assign(self, flat: Mapping[str, torch.Tensor]) -> None:
        """Put ``flat``'s tensors in the module in place of its own, by flat
        name (an alias takes its first name's tensor); shapes and dtypes must
        match, and a tensor in another layout (a stream's contiguous bytes
        for a channels_last conv weight) is copied into the module's."""
        first: dict[int, str] = {}
        for store, key, name in list(self._slots()):
            old = store[key]
            canon = first.setdefault(id(old), name)
            new = flat.get(canon)
            if new is None:
                raise KeyError(f"{self.servable.name}: no tensor {canon!r} to restore")
            if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
                raise ValueError(f"{self.servable.name}: {canon} is {new.dtype}"
                                 f"{list(new.shape)}, the model holds {old.dtype}"
                                 f"{list(old.shape)}")
            if new.stride() != old.stride():
                new = _empty_as(old, new.device).copy_(new)
            store[key] = (torch.nn.Parameter(new, old.requires_grad)
                          if isinstance(old, torch.nn.Parameter) else new)

    def _drop_graphs(self) -> None:
        """Release every graph (the buckets', the chunks', the lanes') and
        forget the warmed buckets: the next capture starts a new pool."""
        for graph in self._graphs.values():
            graph.release()
        self._graphs.clear()
        for lane in list(self.lane_graphs):
            lane.release()
        self.lane_graphs.clear()
        self._warmed.clear()
        self._chunk_rows = []
        if self.graphed:
            self._pool = torch.cuda.graph_pool_handle()

    def _recapture(self) -> float:
        """Capture every bucket again after a restore (dispatch thread);
        returns the seconds.  The CPU has nothing to capture."""
        if not self.graphed:
            return 0.0
        t0 = time.perf_counter()
        self._chunk_rows = self._device_chunk_rows()
        self.warmup()
        return time.perf_counter() - t0

    def host_offload(self) -> dict:
        """Device → host tier (dispatch thread): every graph released, every
        parameter and buffer copied into pinned host memory (plain host
        memory on the CPU) and the device copies dropped.  Returns the
        copy's ms."""
        if self.tier != "device":
            raise RuntimeError(f"{self.servable.name}: host_offload from the {self.tier} tier")
        t0 = time.perf_counter()
        self._drop_graphs()
        pin = self.device.type == "cuda"
        host = {}
        with torch.no_grad():
            for name, t in self._tensors().items():
                host[name] = _empty_as(t, "cpu", pin_memory=pin)
                host[name].copy_(t, non_blocking=pin)
        self._sync()
        self._assign(host)
        self.tier = "host"
        return {"d2h_ms": (time.perf_counter() - t0) * 1e3}

    def device_restore(self) -> dict:
        """Host tier → device (dispatch thread): the pinned copies to the
        device, then every bucket captured again.  Returns ``h2d_ms`` and
        ``capture_ms``."""
        if self.tier != "host":
            raise RuntimeError(f"{self.servable.name}: device_restore from the {self.tier} tier")
        t0 = time.perf_counter()
        with torch.no_grad():
            dev = {name: t.to(self.device, non_blocking=True)
                   for name, t in self._tensors().items()}
        self._sync()
        self._assign(dev)
        self.tier = "device"
        h2d = time.perf_counter() - t0
        return {"h2d_ms": h2d * 1e3, "capture_ms": self._recapture() * 1e3}

    def release(self) -> None:
        """Drop everything (dispatch thread): every graph released and the
        weights replaced by meta tensors, so the device memory goes now and
        not when the last reference does."""
        self._drop_graphs()
        self._assign({name: _empty_as(t, "meta") for name, t in self._tensors().items()})
        self.tier = "none"

    def host_state(self) -> dict[str, Any]:
        """The weights as a tree of host tensors, nested by module path (a
        copy on the device tier, the pinned copies themselves on the host
        tier): what the checkpoint store holds."""
        from .weights import unflatten_tree

        if self.tier not in ("device", "host"):
            raise RuntimeError(f"{self.servable.name}: no weights on the {self.tier} tier")
        with torch.no_grad():
            return unflatten_tree({name: t.cpu() if self.tier == "device" else t
                                   for name, t in self._tensors().items()})

    def disk_offload(self, save_fn) -> None:
        """Host tier → disk tier: hand the host copies to ``save_fn`` (the
        checkpoint store's put), then drop them; the module keeps meta
        tensors of the same shapes.  Host work only, off the dispatch
        thread.  If ``save_fn`` raises, nothing is dropped: the model stays
        on the host tier."""
        if self.tier != "host":
            raise RuntimeError(f"{self.servable.name}: disk_offload from the {self.tier} tier "
                               "(host_offload first)")
        save_fn(self.host_state())
        self._assign({name: _empty_as(t, "meta") for name, t in self._tensors().items()})
        self.tier = "disk"

    def disk_restore(self, load_fn) -> dict:
        """Disk tier → device (dispatch thread): ``load_fn()`` returns the
        streamed tree (its leaves placed on the device by
        ``streamio.device_placer``), which is adopted onto this thread's
        stream and put in place; then every bucket is captured again.
        Returns ``capture_ms``."""
        from . import streamio
        from .weights import flatten_tree

        if self.tier != "disk":
            raise RuntimeError(f"{self.servable.name}: disk_restore from the {self.tier} tier")
        flat = flatten_tree(load_fn())
        streamio.adopt(flat.values(), self.device)
        flat = {k: v if v.device == self.device else v.to(self.device)
                for k, v in flat.items()}
        self._assign(flat)
        self.tier = "device"
        return {"capture_ms": self._recapture() * 1e3}

    def copy_in_place(self, flat: Mapping[str, torch.Tensor]) -> None:
        """Copy ``flat``'s values into the weights the module holds, under
        their addresses (dispatch thread): the captured graphs read the new
        values at their next replay.  Rebinding the tensors instead would
        leave the graphs reading the old ones."""
        from . import streamio

        streamio.adopt(flat.values(), self.device)
        with torch.no_grad():
            for name, t in self._tensors().items():
                src = flat.get(name)
                if src is None:
                    raise KeyError(f"{self.servable.name}: the streamed weights lack {name!r}")
                if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
                    raise ValueError(f"{self.servable.name}: streamed {name} is {src.dtype}"
                                     f"{list(src.shape)}, the model holds {t.dtype}"
                                     f"{list(t.shape)}")
                ptr = t.data_ptr()
                t.copy_(src)
                assert t.data_ptr() == ptr

    # -- execution ----------------------------------------------------------
    def run_batch(self, samples: Sequence[dict[str, np.ndarray]],
                  seq: int | None = None) -> tuple[list[Any], tuple[int, ...]]:
        """Pad samples into a bucket, run on the device, postprocess each.

        Returns (per-sample results, bucket used).
        """
        if seq is None and self.servable.bucket_axes == ("batch", "seq"):
            seq = max(self.servable.meta["seq_len_of"](s) for s in samples)
        bucket = self.bucket_for(len(samples), seq)
        spec = self.servable.input_spec(bucket)
        collate = self.servable.meta.get("collate") or default_collate
        batch = collate(samples, bucket, spec)
        if self.lockstep is not None:
            # Rank 0 of a lockstep world: the followers run this batch too
            # (the contract check raises before any broadcast).
            self.lockstep.lead(self, bucket, batch)
        first_dispatch = bucket not in self._warmed
        t0 = time.perf_counter()
        out = self.forward(batch)  # on CUDA: captures a new bucket or variant itself
        if first_dispatch:
            self._warmed.add(bucket)
            if not self.graphed:
                secs = time.perf_counter() - t0
                self.clock.record(self.servable.name, bucket, secs)
                log_event(log, "warmed lazily", model=self.servable.name,
                          bucket=list(bucket), seconds=round(secs, 3))
        return ([self.servable.postprocess(out, i) for i in range(len(samples))],
                bucket)
