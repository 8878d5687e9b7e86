"""Bucketed batched execution on one device.

A fixed set of (batch[, seq]) buckets per model; requests pad up to the
smallest fitting bucket, so the device sees a few static shapes (the JAX
package compiles one program per bucket; PyTorch runs eagerly, and a bucket's
first dispatch is what ``warmup`` pays ahead of traffic).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.logging import get_logger, log_event
from .cache import CompileClock, timed
from .servable import Servable

log = get_logger("engine.compiled")


def default_collate(samples: Sequence[dict[str, np.ndarray]], bucket: tuple[int, ...],
                    input_spec: dict[str, tuple[tuple[int, ...], torch.dtype]]
                    ) -> dict[str, np.ndarray]:
    """Stack per-sample arrays and zero-pad every axis up to the bucket spec.

    Zero is the pad value on all axes (batch rows, token ids, masks).
    """
    out = {}
    for key, (shape, dtype) in input_spec.items():
        per_sample = shape[1:]
        padded = []
        for s in samples:
            a = np.asarray(s[key])
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
    """One servable, placed on ``device``, with its bucket set."""

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

    def forward(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """One collated bucket batch through the model, back on the host."""
        with torch.inference_mode():
            return self._fetch(self.servable.apply_fn(self.servable.module,
                                                      self._place(batch)))

    # -- warmup -------------------------------------------------------------
    def _warm_bucket(self, bucket: tuple[int, ...]):
        spec = self.servable.input_spec(bucket)
        dummy = {k: np.zeros(shape, torch.empty(0, dtype=dt).numpy().dtype)
                 for k, (shape, dt) in spec.items()}
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
        for b in self.buckets:
            if b not in self._warmed:
                (self._warm_chunked if chunked else self._warm_bucket)(b)

    def _warm_chunked(self, bucket: tuple[int, ...]):
        """prepare, one chunk per distinct row shape, and finalize, on a
        batch of zeros that fills ``bucket``."""
        spec = self.servable.input_spec(bucket)
        dummy = [{k: np.zeros(shape[1:], torch.empty(0, dtype=dt).numpy().dtype)
                  for k, (shape, dt) in spec.items()} for _ in range(bucket[0])]
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
        """One chunk of the model's loop."""
        with torch.inference_mode():
            state = self.servable.meta["chunked"]["chunk"](
                self.servable.module.tree(), state, rows)
        self._sync()
        return state

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
        out = self.forward(batch)
        if first_dispatch:
            secs = time.perf_counter() - t0
            self.clock.record(self.servable.name, bucket, secs)
            self._warmed.add(bucket)
            log_event(log, "warmed lazily", model=self.servable.name,
                      bucket=list(bucket), seconds=round(secs, 3))
        return ([self.servable.postprocess(out, i) for i in range(len(samples))],
                bucket)
