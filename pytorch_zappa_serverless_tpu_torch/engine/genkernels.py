"""The generation lanes' device programs: one KV pool, captured graphs.

The port's counterpart of the JAX package's ``build_gen_kernels`` and
``build_paged_kernels`` (``serving/generation.py``), which jit a lane's
prefill, insert and segment programs and donate the pool through them:

- The pool is one pair of persistent device tensors per lane, allocated
  once on the dispatch thread and updated in place by every program.  It is
  never reallocated (a captured graph holds its address): a reset zeroes it.
- On CUDA each program is one captured graph (``engine.compiled.BucketGraph``:
  an eager warm-up run on a side stream, then the capture), keyed as the JAX
  package's compile census is: a segment per ``ops.sampling.Gates`` variant
  of the pool's knobs, a prefill per (prompt bucket, power-of-two batch), one
  insert, a paged chunk per (chunk length, power-of-two group), one page
  copy.  Before each replay the host arrays (the per-slot carries, the block
  table, the insert's ``j`` and ``slot``) are copied through pinned memory
  into the graph's static inputs: a Python int baked into a capture would
  replay the first call's value forever.  A segment returns its emits and
  carries packed in one int32 tensor, fetched in one copy to the host.
- Each row's adapter slot (``aidx``) is one more static input of the paged
  chunk and segment graphs: one graph serves any mix of tenants, and an
  attach or a detach (``ops.lora.write_slot``) changes the stacks' values
  under the captured addresses, never a graph.  The servable's functions
  pick the weights a program reads (the regime-routed lane's prefill and
  decode trees) from the one tree every graph is handed.
- Captures are lazy (the first call of a key), or ahead of traffic with
  ``warm()``.  A warm-up run of a program on the live pool is harmless: each
  program writes only what its replay then writes again, the same values.
- On the CPU, or with ``graphed=False`` on the card (what a check holds a
  replay against), every call runs eagerly.

All methods run on the runner's dispatch thread.  A program that writes the
pool and raises leaves ``torn`` set: the scheduler fails its in-flight
streams and resets the pool (the JAX lanes' donated-pool-lost rule).
``release()`` frees the pool and every graph when the lane stops for good
(the model's demotion): a restored model starts a new lane, which allocates
and captures again at first use.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from ..ops import counters
from ..ops.sampling import Gates, gates_of
from ..utils.logging import get_logger, log_event
from .compiled import BucketGraph

log = get_logger("engine.genkernels")

# Admission prefills and paged chunks draw each row's first token with
# every sampling gate on but the repetition penalty (which the lane does
# not take): right for every row, so one graph serves greedy and sampled
# admissions alike.
ADMIT_GATES = Gates(sampled=True, rep_on=False, filtered=True)


def _gate_label(g: Gates) -> str:
    return "+".join(f for f in g._fields if getattr(g, f)) or "greedy"


def knob_gates(temp: np.ndarray, topk: np.ndarray, topp: np.ndarray) -> Gates:
    """The pool's gates from its per-slot knobs (no repetition penalty)."""
    return gates_of(temp, topk, topp, np.ones_like(temp))


class LaneGraphs:
    """One lane's programs by key: a captured graph each on CUDA, eager calls
    on the CPU or with ``graphed=False``.  Counts, by key, the runs (replays
    and warm-up runs) and each graph's counted kernel launches a run, so a
    check can hold the path's launch count to them exactly."""

    def __init__(self, cm, graphed: bool | None = None):
        self.cm = cm
        self.device = cm.device
        self.graphed = cm.graphed if graphed is None else bool(graphed and cm.graphed)
        self.tree = cm.servable.module.tree()
        self._graphs: dict[tuple, BucketGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self.runs: dict[tuple, int] = {}
        self.per_run: dict[tuple, dict[str, int]] = {}
        # Every set joins the model's census (an eager one holds no graph or
        # pool), so the model's demotion releases it: its graphs read weights
        # that are gone, and a lane that outlives the demotion (a
        # speculative draft's) sees ``released`` and makes a new set.
        self.released = False
        cm.lane_graphs.append(self)

    def _place(self, values: dict[str, Any]) -> dict[str, torch.Tensor]:
        if self.device.type == "cpu":  # a copy: the caller mutates its arrays
            return {k: torch.from_numpy(np.array(v)) for k, v in values.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(self.device, non_blocking=True) for k, v in values.items()}

    def call(self, key: tuple, fn: Callable[[dict[str, torch.Tensor]], Any],
             values: dict[str, Any]):
        """``fn`` on ``values``: a replay of ``key``'s graph (captured now if
        it is new) or an eager call.  Returns ``fn``'s outputs (a replay's
        are its static outputs: read them before the next call)."""
        before = counters.snapshot()
        with torch.inference_mode():
            if not self.graphed:
                out = fn(self._place(values))
                self.per_run.setdefault(key, counters.delta(before))
            else:
                graph = self._graphs.get(key)
                if graph is None:
                    graph = self._capture(key, fn, values)
                    self.runs[key] = self.runs.get(key, 0) + 1  # its warm-up run
                out = graph.run(values)
        self.runs[key] = self.runs.get(key, 0) + 1
        return out

    def _capture(self, key: tuple, fn, values) -> BucketGraph:
        t0 = time.perf_counter()
        graph = BucketGraph(fn, values, self.device, self._pool)
        torch.cuda.current_stream(self.device).synchronize()
        secs = time.perf_counter() - t0
        self._graphs[key] = graph
        self.per_run[key] = graph.launches
        name = self.cm.servable.name
        self.cm.clock.record(name, self.label(key).split(), secs)
        log_event(log, "captured", model=name, graph=self.label(key),
                  launches=graph.launches, seconds=round(secs, 3))
        return graph

    def release(self) -> None:
        """Release every graph (a later replay raises) and leave the
        model's census."""
        for graph in self._graphs.values():
            graph.release()
        self._graphs.clear()
        self.released = True
        if self in self.cm.lane_graphs:
            self.cm.lane_graphs.remove(self)

    @staticmethod
    def label(key: tuple) -> str:
        return " ".join(["generate", *(_gate_label(k) if isinstance(k, Gates) else str(k)
                                       for k in key)])

    @property
    def labels(self) -> list[str]:
        return [self.label(k) for k in list(self._graphs)]

    def expected_launches(self) -> dict[str, int]:
        """Counted kernel launches of every run so far (runs times each
        key's launches a run)."""
        out: dict[str, int] = {}
        for key, n in self.runs.items():
            for name, per in self.per_run.get(key, {}).items():
                out[name] = out.get(name, 0) + n * per
        return out


class _PoolKernels:
    """What both lanes' kernel sets share: the pool pair, its lazy
    allocation and in-place reset, and the ``torn`` flag.  On a mesh the
    pool holds the width this rank's heads take (``cm.tp_size`` shards of
    the last dim)."""

    def __init__(self, cm, shape: tuple[int, ...], dtype: torch.dtype,
                 graphed: bool | None):
        self.cm = cm
        self.graphs = LaneGraphs(cm, graphed)
        self.shape = (*(int(d) for d in shape[:-1]), int(shape[-1]) // cm.tp_size)
        self.dtype = dtype
        self.cache_k: torch.Tensor | None = None
        self.cache_v: torch.Tensor | None = None
        self.cache_nbytes = 2 * int(np.prod(self.shape)) * torch.empty(0, dtype=dtype).element_size()
        self._dirty = False
        self.torn = False

    def _alloc_extra(self) -> None:
        """Buffers a lane needs besides the pool (allocated with it)."""

    def ensure(self) -> None:
        """Allocate the pool on first use; zero it in place after a reset."""
        if self.cache_k is None:
            with torch.inference_mode():
                self.cache_k = torch.zeros(self.shape, dtype=self.dtype, device=self.cm.device)
                self.cache_v = torch.zeros_like(self.cache_k)
                self._alloc_extra()
        elif self._dirty:
            with torch.inference_mode():
                self.cache_k.zero_()
                self.cache_v.zero_()
        self._dirty = self.torn = False

    def reset(self) -> None:
        """Mark the pool for zeroing at the next :meth:`ensure` (host only:
        the scheduler's event loop calls this)."""
        self._dirty = True

    def release(self) -> None:
        """Free the pool, the lane's other buffers and every graph (dispatch
        thread); the lane must not run again."""
        self.graphs.release()
        self.cache_k = self.cache_v = None
        self._release_extra()

    def _release_extra(self) -> None:
        """Drop what :meth:`_alloc_extra` made."""

    def _writes(self, key: tuple, fn, values):
        """A call of a program that writes the pool: ``torn`` if it raises."""
        try:
            return self.graphs.call(key, fn, values)
        except BaseException:
            self.torn = True
            raise


def _pow2s(n: int) -> list[int]:
    """1, 2, 4, ... up to ``n`` (a power of two)."""
    return [1 << i for i in range(n.bit_length())]


def _idle_carries(S: int) -> list[dict[str, np.ndarray]]:
    """The carries of an empty pool (every row finished), once for each
    segment gate variant: greedy, sampled, sampled and filtered."""
    out = []
    for temp, topk in ((0.0, 0), (1.0, 0), (1.0, 1)):
        out.append({"tok": np.zeros(S, np.int32), "pos": np.zeros(S, np.int32),
                    "step": np.zeros(S, np.int32), "fin": np.ones(S, bool),
                    "temp": np.full(S, temp, np.float32), "seed": np.zeros(S, np.int32),
                    "topk": np.full(S, topk, np.int32), "topp": np.ones(S, np.float32)})
    return out


def _pack(emits, tok, pos, step, fin) -> torch.Tensor:
    """emits [S, seg] and the four carries [S] as one int32 [S, seg + 4]."""
    return torch.cat([emits.to(torch.int32), tok[:, None].to(torch.int32),
                      pos[:, None].to(torch.int32), step[:, None].to(torch.int32),
                      fin[:, None].to(torch.int32)], dim=1)


def unpack(out: np.ndarray, seg: int) -> tuple[np.ndarray, ...]:
    """(emits, tok, pos, step, finished) from a segment's packed output."""
    return (out[:, :seg], out[:, seg].copy(), out[:, seg + 1].copy(),
            out[:, seg + 2].copy(), out[:, seg + 3].astype(bool))


class SlotKernels(_PoolKernels):
    """The slot pool's programs (JAX ``build_gen_kernels``): batched
    admission ``prefill`` into a staging pair, ``insert_from`` one staged row
    into a pool slot, and ``segment`` over the pool [L, S, total, D]."""

    def __init__(self, cm, graphed: bool | None = None):
        meta = cm.servable.meta["continuous"]
        super().__init__(cm, meta["cache_shape"], meta["cache_dtype"], graphed)
        self.meta = meta
        self.seg = int(meta["segment_tokens"])
        L, S, T, D = self.shape
        # Every prefill graph writes its rows into one staging pair, which
        # the one insert graph reads: [L, next pow2 >= S, total, D].
        self._stage_shape = (L, 1 << (S - 1).bit_length(), T, D)
        self.stage_k: torch.Tensor | None = None
        self.stage_v: torch.Tensor | None = None

    def _alloc_extra(self) -> None:
        self.stage_k = torch.zeros(self._stage_shape, dtype=self.dtype, device=self.cm.device)
        self.stage_v = torch.zeros_like(self.stage_k)

    def _release_extra(self) -> None:
        self.stage_k = self.stage_v = None

    def prefill(self, payload: dict[str, np.ndarray]) -> np.ndarray:
        """One batched admission prefill; returns each row's first token [B]
        and leaves its cache rows staged for :meth:`insert_from`."""
        B = int(np.shape(payload["length"])[0])
        # The prompt bucket: GPT-2's id width; Whisper has one (a mel window).
        bucket = int(np.shape(payload["input_ids"])[1]) if "input_ids" in payload else 1

        def fn(inp):
            first, k, v = self.meta["prefill"](self.graphs.tree, inp, gates=ADMIT_GATES)
            self.stage_k[:, :B].copy_(k)
            self.stage_v[:, :B].copy_(v)
            return first

        return self.graphs.call(("prefill", bucket, B), fn, payload).cpu().numpy()

    def insert_from(self, j: int, slot: int) -> None:
        """Staged row ``j`` into pool slot ``slot``, both device scalars."""
        def fn(inp):
            self.cache_k.index_copy_(1, inp["slot"], self.stage_k.index_select(1, inp["j"]))
            self.cache_v.index_copy_(1, inp["slot"], self.stage_v.index_select(1, inp["j"]))

        self._writes(("insert",), fn, {"j": np.asarray([j], np.int64),
                                       "slot": np.asarray([slot], np.int64)})

    def segment(self, carries: dict[str, np.ndarray]) -> np.ndarray:
        """One decode segment over the pool from the host carries (``tok``,
        ``pos``, ``step``, ``fin``, ``temp``, ``seed``, ``topk``,
        ``topp``); returns the packed [S, seg + 4] int32 (:func:`unpack`)."""
        gates = knob_gates(carries["temp"], carries["topk"], carries["topp"])

        def fn(inp):
            emits, _, _, tok, pos, step, fin = self.meta["segment"](
                self.graphs.tree, self.cache_k, self.cache_v, inp["tok"], inp["pos"],
                inp["step"], inp["fin"], inp["temp"], inp["seed"], inp["topk"], inp["topp"],
                gates=gates)
            return _pack(emits, tok, pos, step, fin)

        return self._writes(("segment", gates), fn, carries).cpu().numpy()

    def warm(self) -> None:
        """Capture, ahead of traffic, every graph the lane can run: a
        prefill per prompt bucket and power-of-two batch, the insert, and a
        segment per gate variant (on an empty pool: the warm-up runs write
        only free slots).  Eager sets have nothing to capture."""
        if not self.graphs.graphed:
            return
        self.ensure()
        for bucket in self.meta["prompt_buckets"]:
            spec = self.meta["admit_spec"](bucket)
            for B in _pow2s(self._stage_shape[1]):
                self.prefill({k: np.zeros((B, *shape[1:]),
                                          torch.empty(0, dtype=dt).numpy().dtype)
                              for k, (shape, dt) in spec.items()})
        self.insert_from(0, 0)
        for carries in _idle_carries(self.shape[1]):
            self.segment(carries)


class PagedKernels(_PoolKernels):
    """The paged pool's programs (JAX ``build_paged_kernels``) over a pool
    [L, num_blocks, block_size, D]: ``prefill_chunk`` for a group of
    prompts, ``segment`` over every slot through its block table,
    ``copy_page`` for copy-on-write, the speculative tick's ``propose`` (on
    a draft's set) and ``verify`` (on the target's, with
    ``ops.sampling.speculative_verify`` in its graph), and the migration's
    ``read_pages`` and ``write_pages``.

    Every write lands in the existing pool tensors, in place: a captured
    graph holds the pool's address, so a scatter, a swap-in or an import
    that rebound the pool would leave the next replay reading the old one.
    A draft's set outlives its model's demotion (the target's lane owns
    it): :meth:`rebind` makes a new graph set on the restored model and
    keeps the pool."""

    def __init__(self, cm, block_size: int, num_blocks: int, spec_k: int,
                 graphed: bool | None = None):
        meta = cm.servable.meta["continuous"]
        pg = meta["paged"]
        super().__init__(cm, pg["cache_shape"](num_blocks, block_size), meta["cache_dtype"],
                         graphed)
        self._graphed_arg = graphed
        self.fns = pg["make"](block_size, spec_k)
        self.seg = int(meta["segment_tokens"])
        self.spec_k = int(spec_k)
        self.vocab = int(pg["vocab"])
        self.slots = int(meta["slots"])
        # The draft's logits [S, k, V] f32 that a draft set's propose graph
        # writes and this set's verify graph reads (allocated once, on the
        # first speculative tick, so both graphs keep its address).
        self.draft_logits: torch.Tensor | None = None

    def _release_extra(self) -> None:
        self.draft_logits = None

    def rebind(self, cm) -> None:
        """Make a new graph set on ``cm`` (the same deploy, restored) when
        the old one was released or belongs to another model object; the
        pool stays where it is."""
        if self.graphs.released or self.cm is not cm:
            self.cm = cm
            self.graphs = LaneGraphs(cm, self._graphed_arg)

    def spec_buffer(self) -> torch.Tensor:
        """The draft-logits buffer the propose and verify graphs share."""
        if self.draft_logits is None:
            with torch.inference_mode():
                self.draft_logits = torch.zeros((self.slots, self.spec_k, self.vocab),
                                                dtype=torch.float32, device=self.cm.device)
        return self.draft_logits

    def prefill_chunk(self, payload: tuple) -> np.ndarray:
        """One chunk for a group: ``payload`` is (toks [G, C], start, length,
        temp, seed, topk, topp, table [G, MB], aidx); returns first [G]."""
        toks, start, length, temp, seed, topk, topp, table, aidx = payload
        values = {"toks": toks, "start": start, "length": length, "table": table,
                  "temp": temp, "seed": seed, "topk": topk, "topp": topp, "aidx": aidx}

        def fn(inp):
            first, _, _ = self.fns["prefill_chunk"](
                self.graphs.tree, inp["toks"], inp["start"], inp["length"], self.cache_k,
                self.cache_v, inp["table"], inp["temp"], inp["seed"], inp["topk"],
                inp["topp"], gates=ADMIT_GATES, aidx=inp["aidx"])
            return first

        G, C = toks.shape
        return self._writes(("chunk", int(C), int(G)), fn, values).cpu().numpy()

    def segment(self, table: np.ndarray, carries: dict[str, np.ndarray]) -> np.ndarray:
        """One decode segment over the pool through ``table`` [S, MB];
        carries and the packed result as :meth:`SlotKernels.segment`, and
        ``aidx`` among the carries (each slot's adapter; all 0 without)."""
        gates = knob_gates(carries["temp"], carries["topk"], carries["topp"])

        def fn(inp):
            emits, _, _, tok, pos, step, fin = self.fns["segment"](
                self.graphs.tree, self.cache_k, self.cache_v, inp["table"], inp["tok"],
                inp["pos"], inp["step"], inp["fin"], inp["temp"], inp["seed"], inp["topk"],
                inp["topp"], gates=gates, aidx=inp["aidx"])
            return _pack(emits, tok, pos, step, fin)

        values = {"table": table, "aidx": np.zeros(self.slots, np.int32), **carries}
        return self._writes(("segment", gates), fn, values).cpu().numpy()

    def copy_page(self, src: int, dst: int) -> None:
        """Page ``src`` into page ``dst`` at every layer (copy-on-write)."""
        def fn(inp):
            self.cache_k.index_copy_(1, inp["dst"], self.cache_k.index_select(1, inp["src"]))
            self.cache_v.index_copy_(1, inp["dst"], self.cache_v.index_select(1, inp["src"]))

        self._writes(("copy_page",), fn, {"src": np.asarray([src], np.int64),
                                          "dst": np.asarray([dst], np.int64)})

    def propose(self, table: np.ndarray, carries: dict[str, np.ndarray],
                out: torch.Tensor) -> np.ndarray:
        """A draft set's speculative proposals through ``table`` [S, MB]
        from the carries (those of :meth:`segment` and ``prev``, the chain
        token at ``pos - 1``): returns the proposals [S, k] and leaves the
        draft's logits in ``out`` (the target set's :meth:`spec_buffer`)."""
        gates = knob_gates(carries["temp"], carries["topk"], carries["topp"])

        def fn(inp):
            props, logits, _, _ = self.fns["propose"](
                self.graphs.tree, self.cache_k, self.cache_v, inp["table"], inp["prev"],
                inp["tok"], inp["pos"], inp["step"], inp["fin"], inp["temp"], inp["seed"],
                inp["topk"], inp["topp"], gates=gates)
            out.copy_(logits)
            return props

        return self._writes(("propose", gates), fn, {"table": table, **carries}).cpu().numpy()

    def verify(self, table: np.ndarray, toks: np.ndarray,
               carries: dict[str, np.ndarray]) -> np.ndarray:
        """The target's forward over ``toks`` [S, k+1] (each row's pending
        token and its proposals) at the rows' positions, and the rejection
        sampling against the draft's logits in :meth:`spec_buffer`, in one
        graph: returns [S, k+2] int32, the accepted count then the output
        tokens (``ops.sampling.speculative_verify``)."""
        from ..ops.sampling import speculative_verify

        gates = knob_gates(carries["temp"], carries["topk"], carries["topp"])
        dlogits = self.spec_buffer()

        def fn(inp):
            logits, _, _ = self.fns["verify"](self.graphs.tree, self.cache_k, self.cache_v,
                                              inp["table"], inp["toks"], inp["pos"])
            n, out = speculative_verify(logits, dlogits, inp["toks"][:, 1:], inp["temp"],
                                        inp["seed"], inp["step"], inp["topk"], inp["topp"],
                                        sampled=gates.sampled, filtered=gates.filtered)
            return torch.cat([n[:, None], out], dim=1)

        values = {"table": table, "toks": toks,
                  **{k: carries[k] for k in ("pos", "temp", "seed", "step", "topk", "topp")}}
        return self._writes(("verify", gates), fn, values).cpu().numpy()

    def read_pages(self, blocks: list[int]) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Pages ``blocks`` to the host, each (K, V) [L, block_size, D] (views
        of one pinned buffer on the card).  Read only: a read that fails
        leaves the pool whole."""
        dev = self.cm.device
        pin = dev.type == "cuda"
        with torch.inference_mode():
            idx = torch.tensor(list(blocks), dtype=torch.int64, device=dev)
            halves = []
            for cache in (self.cache_k, self.cache_v):
                src = cache.index_select(1, idx)
                host = torch.empty(tuple(src.shape), dtype=src.dtype, pin_memory=pin)
                host.copy_(src, non_blocking=pin)
                halves.append(host)
            if pin:
                torch.cuda.current_stream(dev).synchronize()
        return [(halves[0][:, i], halves[1][:, i]) for i in range(len(blocks))]

    def write_pages(self, pairs) -> None:
        """(block, K, V) host pages into the pool, in place (``torn`` if it
        raises part-way)."""
        try:
            with torch.inference_mode():
                dev = self.cm.device
                idx = torch.tensor([int(b) for b, _, _ in pairs], dtype=torch.int64, device=dev)
                for cache, j in ((self.cache_k, 1), (self.cache_v, 2)):
                    vals = torch.stack([torch.as_tensor(p[j]) for p in pairs], dim=1)
                    cache.index_copy_(1, idx, vals.to(dev, cache.dtype))
        except BaseException:
            self.torn = True
            raise

    def warm(self, chunk_buckets, max_blocks: int, segments: bool = True) -> None:
        """Capture, ahead of traffic, every graph the lane can run: a chunk
        per length in ``chunk_buckets`` and power-of-two group, the page
        copy, and a segment per gate variant (all-trash tables: the warm-up
        runs write only the trash page); a draft's set leaves out the
        segments.  Eager sets have nothing to capture."""
        if not self.graphs.graphed:
            return
        self.ensure()
        S = self.slots
        for C in chunk_buckets:
            for G in _pow2s(1 << (S - 1).bit_length()):
                self.prefill_chunk((np.zeros((G, C), np.int32), np.zeros(G, np.int32),
                                    np.ones(G, np.int32), np.zeros(G, np.float32),
                                    np.zeros(G, np.int32), np.zeros(G, np.int32),
                                    np.ones(G, np.float32), np.zeros((G, max_blocks), np.int32),
                                    np.zeros(G, np.int32)))
        self.copy_page(0, 0)
        if segments:
            for carries in _idle_carries(S):
                self.segment(np.zeros((S, max_blocks), np.int32), carries)

    def warm_spec(self, draft: "PagedKernels", max_blocks: int) -> None:
        """Capture the speculative tick's graphs ahead of traffic: the
        draft set's propose and this set's verify per gate variant, on an
        empty pool (the warm-up runs write only the trash page)."""
        if not self.graphs.graphed:
            return
        self.ensure()
        draft.ensure()
        S, k = self.slots, self.spec_k
        table = np.zeros((S, max_blocks), np.int32)
        for carries in _idle_carries(S):
            carries = {**carries, "prev": np.zeros(S, np.int32)}
            draft.propose(table, carries, self.spec_buffer())
            self.verify(table, np.zeros((S, k + 1), np.int32), carries)
