"""The lockstep world: ONE HTTP endpoint over every rank of a mesh.

A mesh is one process per device, and every rank must dispatch the same
programs in the same order (their collectives pair up).  Rank 0 serves HTTP
and leads; every other rank runs :meth:`LockstepDriver.follow`, a loop that
mirrors rank 0's dispatches, so a load balancer needs exactly one backend
and the followers need no request plumbing at all.

Protocol (all control flow rides ``dist.broadcast`` from rank 0 over the
world group; on NCCL the tensors are on the device, on gloo on the CPU):

1. header ``int32[4] = [op, model_idx, batch, seq]``; model_idx indexes
   ``sorted(engine.models)`` (the same config on every rank); seq is -1 for
   batch-only buckets.
2. the payload tensors follow in sorted key order, shaped on the followers
   from the servable's ``input_spec(bucket)`` (op 1), ``admit_spec(bucket)``
   (op 3) or the slot pool's carries (op 4); then every rank runs the same
   program, collectives included.

The lead side hooks ``CompiledModel.run_batch`` between collate and the
forward (``lockstep`` attribute, set by ``Engine.enable_lockstep_lead``), so
every lane (batcher, jobs, lazy captures) is mirrored without knowing of
the broadcasts; the slot pool's admissions and segments lead through
:meth:`lead_gen_admit` and :meth:`lead_gen_segment`.  Every lead runs on the
dispatch thread: a broadcast from another thread would interleave inside a
lead pair and deadlock.

Liveness: followers block in the header broadcast until rank 0 leads again,
up to the process group's timeout (``parallel.mesh.COLLECTIVE_TIMEOUT_S``);
the leader's heartbeat (``heartbeat_interval_s``) keeps an idle wait under
it.  A dead leader fails the header broadcast (gloo) or trips NCCL's
watchdog, and a spawned follower also exits when its parent is gone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import get_logger, log_event

log = get_logger("parallel.lockstep")

OP_RUN = 1
OP_SHUTDOWN = 2
OP_GEN_ADMIT = 3    # [op, model_idx, admit_bucket, slot] + admit_spec payload
OP_GEN_SEGMENT = 4  # [op, model_idx, 0, 0] + slot carries
#                     (tok, pos, step, fin, temp, seed, topk, topp)
OP_HEARTBEAT = 5    # [op, 0, 0, 0]: a liveness tick, no payload

# The slot pool's carries, as GenerationScheduler holds them.
SEGMENT_SPEC = {"tok": np.int32, "pos": np.int32, "step": np.int32, "fin": np.bool_,
                "temp": np.float32, "seed": np.int32, "topk": np.int32, "topp": np.float32}


class LockstepContractError(ValueError):
    """Collate output violated the broadcast spec: raised on the leader
    BEFORE any broadcast, so the world is still in lockstep and only the
    offending request fails (callers must NOT escalate it to the
    world-fatal path)."""


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _np_dtype(dt) -> np.dtype:
    if isinstance(dt, torch.dtype):
        return torch.empty(0, dtype=dt).numpy().dtype
    return np.dtype(dt)


def _check_payload(name: str, kind: str, payload: dict, spec: dict, bucket) -> None:
    """Keys, shapes and dtypes of ``payload`` must match ``spec`` ({key:
    (shape, dtype)}) exactly: followers rebuild the payload from the spec,
    so any drift desyncs the broadcast deep in a collective instead of
    failing loudly here."""
    if set(payload) != set(spec):
        raise LockstepContractError(
            f"{name}: {kind} keys {sorted(payload)} != spec keys {sorted(spec)} for bucket "
            f"{bucket}")
    for key, (shape, dt) in spec.items():
        arr = np.asarray(payload[key])
        want = _np_dtype(dt)
        if tuple(arr.shape) != tuple(shape) or arr.dtype != want:
            raise LockstepContractError(
                f"{name}.{key}: {kind} produced {arr.dtype}{list(arr.shape)} but the spec for "
                f"bucket {bucket} declares {want}{list(shape)}")


class LockstepDriver:
    """Broadcast-mirrored dispatch for one engine of a world."""

    def __init__(self, engine):
        self.engine = engine
        self.model_names = sorted(engine.models)
        self.device = engine.device
        self._down = False
        # False until Engine.enable_lockstep_lead(): a world whose ranks each
        # drive run_batch themselves must not broadcast.
        self.lead_enabled = False
        # Leads broadcast since start, by op (read by /healthz).
        self.leads: dict[str, int] = {}
        self._gen: dict[str, object] = {}

    # -- transport ----------------------------------------------------------
    def _send(self, arr: np.ndarray) -> None:
        a = np.ascontiguousarray(arr)
        wire = a.view(np.uint8) if a.dtype == np.bool_ else a  # bool rides as bytes
        dist.broadcast(torch.from_numpy(wire).to(self.device), 0)

    def _recv(self, shape, dtype) -> np.ndarray:
        want = _np_dtype(dtype)
        wire = np.uint8 if want == np.bool_ else want
        t = torch.empty(tuple(shape), dtype=torch.from_numpy(np.zeros(0, wire)).dtype,
                        device=self.device)
        dist.broadcast(t, 0)
        out = t.cpu().numpy()
        return out.view(np.bool_) if want == np.bool_ else out

    def _send_tree(self, payload: dict) -> None:
        for key in sorted(payload):
            self._send(np.asarray(payload[key]))

    def _recv_tree(self, spec: dict) -> dict:
        return {key: self._recv(*spec[key]) for key in sorted(spec)}

    def _header(self, op: int, mi: int = 0, b: int = 0, s: int = 0) -> None:
        self._send(np.asarray([op, mi, b, s], np.int32))
        name = {OP_RUN: "run", OP_SHUTDOWN: "shutdown", OP_GEN_ADMIT: "gen_admit",
                OP_GEN_SEGMENT: "gen_segment", OP_HEARTBEAT: "heartbeat"}[op]
        self.leads[name] = self.leads.get(name, 0) + 1

    def _live(self) -> None:
        if self._down:
            raise RuntimeError("the lockstep world is shut down")

    # -- rank 0 -------------------------------------------------------------
    def lead(self, cm, bucket: tuple[int, ...], batch: dict) -> None:
        """Announce and ship one collated batch (dispatch thread, rank 0)."""
        self._live()
        # The contract check runs BEFORE broadcasting: failing here fails
        # only this request, on the leader, and the world stays in lockstep.
        _check_payload(cm.servable.name, "collate", batch, cm.servable.input_spec(bucket),
                       bucket)
        mi = self.model_names.index(cm.servable.name)
        self._header(OP_RUN, mi, bucket[0], bucket[1] if len(bucket) > 1 else -1)
        self._send_tree(batch)

    def lead_gen_admit(self, model: str, slot: int, bucket: int, payload: dict) -> None:
        """Mirror one streaming admission (prefill + insert into ``slot``);
        dispatch thread.  ``payload`` is what the servable's
        ``collate_admit`` made; followers rebuild it from ``admit_spec``."""
        self._live()
        cm = self.engine.models[model]
        _check_payload(model, "collate_admit", payload,
                       cm.servable.meta["continuous"]["admit_spec"](bucket), bucket)
        self._header(OP_GEN_ADMIT, self.model_names.index(model), bucket, slot)
        self._send_tree(payload)

    def lead_gen_segment(self, model: str, carries: dict) -> None:
        """Mirror one decode segment over the slot pool; dispatch thread."""
        self._live()
        self._header(OP_GEN_SEGMENT, self.model_names.index(model))
        self._send_tree({k: np.asarray(carries[k], dt) for k, dt in SEGMENT_SPEC.items()})

    def lead_heartbeat(self) -> None:
        """A liveness tick (dispatch thread, rank 0): between requests the
        followers wait inside the header broadcast, and a periodic tick keeps
        that wait under ``heartbeat_interval_s``, well inside the group's
        timeout."""
        self._live()
        self._header(OP_HEARTBEAT)

    def lead_shutdown(self) -> None:
        """Release the follower loops (rank 0, once, at engine shutdown)."""
        if not self._down:
            self._down = True
            self._header(OP_SHUTDOWN)

    # -- followers ----------------------------------------------------------
    def _kernels(self, name: str):
        """The mirrored slot pool of ``name`` (made at its first admission,
        as the leader's lane makes its own)."""
        k = self._gen.get(name)
        if k is None:
            from ..engine.genkernels import SlotKernels

            k = self._gen[name] = SlotKernels(self.engine.models[name])
        return k

    def _follow_gen_admit(self, name: str, slot: int, payload: dict) -> None:
        k = self._kernels(name)
        k.ensure()
        k.prefill(payload)
        k.insert_from(0, slot)

    def _follow_gen_segment(self, name: str, carries: dict) -> None:
        self._kernels(name).segment(carries)

    def _follow_one(self, op: int, mi: int, b: int, s: int) -> None:
        name = self.model_names[mi]
        cm = self.engine.models[name]
        if op == OP_GEN_ADMIT:
            spec = cm.servable.meta["continuous"]["admit_spec"](b)
            self._follow_gen_admit(name, s, self._recv_tree(spec))
        elif op == OP_GEN_SEGMENT:
            S = cm.servable.meta["continuous"]["slots"]
            self._follow_gen_segment(name, self._recv_tree(
                {k: ((S,), dt) for k, dt in SEGMENT_SPEC.items()}))
        elif op == OP_RUN:
            bucket = (b,) if s < 0 else (b, s)
            batch = self._recv_tree(cm.servable.input_spec(bucket))
            cm.forward(batch)  # the same program as the leader's, its collectives paired
            cm._warmed.add(bucket)
        else:
            raise ValueError(f"unknown lockstep op {op}")

    def follow(self) -> None:
        """Mirror rank 0's dispatches until it shuts down (blocking; run it
        on the engine's dispatch thread, which owns the device)."""
        log_event(log, "follower ready", rank=_rank(), models=self.model_names)
        while True:
            try:
                op, mi, b, s = (int(x) for x in self._recv((4,), np.int32))
            except Exception:
                # A dead leader surfaces as a failed or timed-out collective
                # (rank 0 SIGKILLed before it could lead the shutdown): leave
                # the loop, so a supervisor restarts the whole world.
                log.exception("lockstep header broadcast failed; assuming leader loss")
                return
            if op == OP_HEARTBEAT:
                continue
            if op == OP_SHUTDOWN:
                log_event(log, "follower released", rank=_rank())
                return
            try:
                self._follow_one(op, mi, b, s)
            except Exception:
                # A mirrored dispatch failing on ONE side means the ranks have
                # diverged (half the collectives have no peer): there is no
                # half-alive recovery.  Exit like the leader-loss path; the
                # leader's next collective fails or times out.
                log.exception("mirrored dispatch failed on the follower; exiting for a "
                              "world restart")
                return
