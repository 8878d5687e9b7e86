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
  (:meth:`CompiledModel.chunk_step`); its prepare and finalize run eagerly.
- On the CPU (``device="cpu"``, the caller's choice) every dispatch runs
  eagerly.  On CUDA a capture or a replay that fails raises: there is no
  eager fallback.  :meth:`CompiledModel.forward_eager` is what a check
  holds a replay against.
"""

from __future__ import annotations

import functools
import itertools
import time
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import counters
from ..utils.logging import get_logger, log_event
from .cache import CompileClock, timed
from .servable import Servable

log = get_logger("engine.compiled")


class Captured(NamedTuple):
    """A captured CUDA graph, its static outputs, and the counted launches
    (``ops.counters``) each replay runs."""

    graph: torch.cuda.CUDAGraph
    outputs: Any
    launches: dict[str, int]

    def replay(self):
        """Launch the graph on the current stream; returns the static outputs,
        valid until the next replay of any graph of the same pool."""
        self.graph.replay()
        counters.add(self.launches)
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
    side = capture_stream(torch.device(device))
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = counters.snapshot()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=side):
            outputs = fn()
    finally:
        launches = counters.delta(before)
        counters.restore(before)
    return Captured(graph, outputs, launches)


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
        self._fill(values)
        return self.captured.replay()

    @property
    def launches(self) -> dict[str, int]:
        return self.captured.launches


def _entry(key: tuple) -> list:
    """A graph's key as the clock's "bucket": [8, 64]; with a variant, the
    names of its gates that are on ([8, 64, "sampled+filtered"], [1, 64,
    "greedy"]); a chunk graph's latents and rows shapes (["chunk",
    "latents[1, 64, 64, 4]", "t[4]"])."""
    if key[0] == "chunk":
        return ["chunk", *(f"{k.split('.')[-1]}{list(shape)}" for k, shape in key[1]
                           if k in ("state.latents", "rows.t"))]
    bucket, variant = key
    if variant is None:
        return list(bucket)
    return [*bucket, "+".join(f for f in variant._fields if getattr(variant, f)) or "greedy"]


def _label(key: tuple) -> str:
    """``_entry`` in words: "(8, 64) sampled+filtered", "chunk latents[1,
    64, 64, 4] t[4]"."""
    if key[0] == "chunk":
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
                 clock: CompileClock | None = None):
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
        params_dtype = cfg.extra.get("params_dtype")
        if str(params_dtype) == "int8":
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
        # The captured programs, by (bucket, variant) or chunk key; one pool:
        # the dispatch thread replays one graph at a time and every output is
        # copied out before the next replay.
        self._graphs: dict[tuple, BucketGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        # The :generate lanes' graph sets (engine/genkernels.LaneGraphs), in
        # the census beside the buckets'.
        self.lane_graphs: list = []
        ch = servable.meta.get("chunked")
        # One device copy of each chunk's schedule rows (their order is the
        # job lane's), which a chunk graph's static rows copy from.
        self._chunk_rows = ([{k: torch.as_tensor(np.asarray(v), device=self.device)
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
        with torch.inference_mode():
            return self._fetch(self._apply(self._place(batch), self._variant(batch)))

    def forward(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """One collated bucket batch through the model, back on the host: on
        CUDA a replay of the bucket's graph (captured now if it is new)."""
        if not self.graphed:
            return self.forward_eager(batch)
        variant = self._variant(batch)
        key = (self._bucket_of(batch), variant)
        with torch.inference_mode():
            graph = self._graphs.get(key) or self._capture(key, self._bucket_fn(variant), batch,
                                                           record=True)
            return self._fetch(graph.run(batch))

    def _bucket_fn(self, variant):
        return lambda inputs: self._apply(inputs, variant)

    def _capture(self, key: tuple, fn, example, record: bool) -> BucketGraph:
        """Capture ``key``'s graph (its eager warm-up run included); with
        ``record``, its seconds go on the clock (the JAX package's compile
        seconds): "captured" at warm-up, "captured lazily" in traffic."""
        t0 = time.perf_counter()
        graph = BucketGraph(fn, example, self.device, self._pool)
        torch.cuda.current_stream(self.device).synchronize()
        secs = time.perf_counter() - t0
        self._graphs[key] = graph
        if record:
            self.clock.record(self.servable.name, _entry(key), secs)
        log_event(log, "captured" if self._warming else "captured lazily",
                  model=self.servable.name, graph=_label(key), launches=graph.launches,
                  seconds=round(secs, 3))
        return graph

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
            with torch.inference_mode():
                self._capture((bucket, variant), self._bucket_fn(variant), dummy, record=True)
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
        take), else one forward."""
        chunked = "chunked" in self.servable.meta
        self._warming = True
        try:
            for b in self.buckets:
                if b not in self._warmed:
                    (self._warm_chunked if chunked else self._warm_bucket)(b)
        finally:
            self._warming = False

    def _warm_chunked(self, bucket: tuple[int, ...]):
        """prepare, one chunk per distinct row shape (on CUDA: its capture),
        and finalize, on a batch of zeros that fills ``bucket``."""
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

    def chunk_prepare(self, samples: Sequence[dict]):
        """Collate + place one batch and run the chunked ``prepare``.
        Returns (bucket, device state); the state (latents + conditioning
        for sd15) stays on the device between chunk dispatches."""
        ch = self.servable.meta["chunked"]
        bucket = self.bucket_for(len(samples))
        spec = self.servable.input_spec(bucket)
        collate = self.servable.meta.get("collate") or default_collate
        with torch.inference_mode():
            state = ch["prepare"](self.servable.module.tree(),
                                  self._place(collate(samples, bucket, spec)))
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

    def chunk_finalize(self, state, samples: Sequence[dict]):
        """Decode + fetch + per-sample postprocess (run_batch's tail)."""
        with torch.inference_mode():
            out = self._fetch(self.servable.meta["chunked"]["finalize"](
                self.servable.module.tree(), state))
        return [self.servable.postprocess(out, i) for i in range(len(samples))]

    @property
    def warmed_buckets(self) -> set[tuple[int, ...]]:
        return set(self._warmed)

    def param_nbytes(self) -> int:
        """Parameter + buffer bytes on the device (residency accounting)."""
        m = self.servable.module
        return sum(t.numel() * t.element_size()
                   for t in itertools.chain(m.parameters(), m.buffers()))

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
