"""Multi-rank worlds of the port on the CPU, for its mesh, ring and lockstep
tests: ``run_world(n, target, *args)`` spawns ``n`` ranks (``spawn``
processes joined in one ``gloo`` process group on a loopback port), runs
``target(rank, n, addr, *args)`` in each, and returns rank 0's result.  A
rank that raises sends its traceback, which fails the call; every rank
still alive at the end is killed, so no test leaves a rank behind.

This module imports torch and the port only (never JAX): the spawned ranks
import it by name.
"""

from __future__ import annotations

import queue
import traceback

import numpy as np
import torch.multiprocessing as mp


def run_world(n: int, target, *args, timeout: float = 240.0):
    from pytorch_zappa_serverless_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    addr = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_entry, args=(target, rank, n, addr, q, args), daemon=True)
             for rank in range(n)]
    for p in procs:
        p.start()
    try:
        try:
            status, rank, out = q.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"the world of {n} ranks gave no result in {timeout:g} s, "
                                 f"exit codes {[p.exitcode for p in procs]}") from None
        if status != "ok":
            raise AssertionError(f"rank {rank} failed:\n{out}")
        for p in procs:
            p.join(60)
        assert [p.exitcode for p in procs] == [0] * n, [p.exitcode for p in procs]
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def _entry(target, rank, n, addr, q, args):
    try:
        out = target(rank, n, addr, *args)
    except BaseException:
        q.put(("error", rank, traceback.format_exc()))
        raise
    if rank == 0:
        q.put(("ok", 0, out))


def engine_world(rank: int, n: int, addr: str, cfg, requests: dict, probes: dict):
    """Build ``cfg``'s engine as rank ``rank`` (``build_engine(cfg,
    device="cpu")``); rank 0 leads and serves ``requests`` ({model: [sample
    lists]}) through the runner, the others follow.  Rank 0 returns the
    answers, and for each model in ``probes`` ({model: [leaf paths]}) its
    leaves' shapes, the tp size, and the DP split of each bucket."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    cfg.coordinator_address = addr
    engine = build_engine(cfg, device="cpu", local_rank=rank)
    try:
        if rank != 0:
            engine.runner.run_fn_sync(engine.lockstep.follow)
            return None
        engine.enable_lockstep_lead()
        answers = {name: [engine.runner.run_sync(engine.model(name), s) for s in lists]
                   for name, lists in requests.items()}
        info = {}
        for name, paths in probes.items():
            cm = engine.model(name)
            leaves = {f"{m}/{k}".replace(".", "/").lstrip("/"): tuple(t.shape)
                      for m, mod in cm.servable.module.named_modules()
                      for store in (mod._parameters, mod._buffers)
                      for k, t in store.items() if t is not None}
            splits = {}
            for bucket in cm.buckets:
                zeros = cm._zeros(bucket)
                local, split = cm._split(zeros)
                splits[str(list(bucket))] = (split, int(np.shape(next(iter(local.values())))[0]))
            info[name] = {"leaves": {p: leaves[p] for p in paths}, "tp_size": cm.tp_size,
                          "splits": splits}
        return {"answers": answers, "info": info, "world": engine.world_snapshot(),
                "mesh": {"shape": engine.mesh.shape, "coords": engine.mesh.coords}}
    finally:
        engine.shutdown()


def ring_world(rank: int, n: int, addr: str, cases: list):
    """Each case ``(q, k, v, kwargs)`` through ``ring_attention`` over a
    ``{"seq": n}`` mesh (every rank holds the whole inputs); rank 0 returns
    the outputs (as f32 numpy) and, for a case that raises, the error."""
    import torch

    from pytorch_zappa_serverless_tpu_torch.parallel import mesh as PM
    from pytorch_zappa_serverless_tpu_torch.parallel.ring_attention import ring_attention

    PM.init_distributed(addr, 1, 0, local_ranks=n, local_rank=rank, device="cpu")
    mesh = PM.make_mesh({"seq": n}, device="cpu")
    outs = []
    for q, k, v, kw in cases:
        kw = dict(kw)
        dtype = getattr(torch, kw.pop("dtype", "float32"))
        if "kv_mask" in kw:
            kw["kv_mask"] = torch.from_numpy(kw["kv_mask"])
        try:
            out = ring_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), mesh,
                                 **kw)
            outs.append(("ok", str(out.dtype), out.float().numpy()))
        except ValueError as e:
            outs.append(("error", type(e).__name__, str(e)))
    return outs if rank == 0 else None
