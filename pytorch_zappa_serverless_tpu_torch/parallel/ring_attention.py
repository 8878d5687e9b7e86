"""Ring attention: sequence-parallel attention over a mesh axis.

When a sequence is too long for one device's memory (or one device's
attention FLOPs), its dimension is sharded over a mesh axis and attention
runs as a ring: each rank holds its Q shard resident and streams the K/V
shards around the ring, one ``dist.batch_isend_irecv`` a rotation to
(rank + 1) mod n from (rank - 1) mod n (NVLink peer-to-peer under NCCL),
combining partial results with the same online-softmax algebra the flash
kernel (``ops/flash_attention``) uses within a device:

    ring step s: rank d holds K/V chunk (d - s) mod n
      m_new = max(m, rowmax(S_s));  alpha = exp(m - m_new)
      l     = alpha*l + rowsum(exp(S_s - m_new))
      acc   = alpha*acc + exp(S_s - m_new) @ V_s

After n steps every Q row has seen every K/V chunk once; the rotation runs
at the entry of steps 1..n-1, so n-1 hops are issued.  The carry is f32.
Causality uses global positions (shard index x shard length + offset);
fully-future chunks still circulate (the ring is a fixed permutation) but
their scores are masked to -1e9, as everywhere in the package.

``ring_attention_local`` is the per-rank body over local shards;
``ring_attention`` takes the whole [B, T, H, D] on every rank, scatters T
over the axis, and all-gathers the result.  No serving route calls it: it
is a library function with its own tests, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

_NEG_INF = -1e9


def _rotate(tensors: list[torch.Tensor], group, rank: int, n: int) -> list[torch.Tensor]:
    """Each of ``tensors`` sent to the next rank of the ring and replaced by
    the previous rank's, in one ``batch_isend_irecv``."""
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    nxt, prv = ranks[(rank + 1) % n], ranks[(rank - 1) % n]
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention_local(q, k, v, kv_mask=None, *, group, causal: bool = False,
                         sm_scale: float | None = None) -> torch.Tensor:
    """Per-rank ring attention body over ``group`` (a process group whose
    rank order is the ring's).

    q [B, Tq_loc, H, D], k/v [B, Tk_loc, H, D]: this rank's shards of
    sequence-sharded arrays; kv_mask optional [B, Tk_loc] bool (True:
    attend).  Returns the local output shard [B, Tq_loc, H, D] in q.dtype.
    """
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    B, tq, H, D = q.shape
    tk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q32 = q.float()
    qpos = idx * tq + torch.arange(tq, device=q.device)  # global query rows
    if kv_mask is None:
        kv_mask = torch.ones((B, tk), dtype=torch.bool, device=q.device)

    def attend(s, k_c, v_c, mask_c, m, l, acc):
        chunk = (idx - s) % n  # whose K/V this rank holds at step s
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_c.float()) * scale
        scores = torch.where(mask_c[:, None, None, :], scores, _NEG_INF)
        if causal:
            kpos = chunk * tk + torch.arange(tk, device=q.device)  # global key cols
            scores = torch.where(qpos[None, None, :, None] >= kpos[None, None, None, :],
                                 scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, v_c.float())
        return m_new, l, acc

    m = torch.full((B, H, tq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, tq, D), dtype=torch.float32, device=q.device)
    m, l, acc = attend(0, k, v, kv_mask, m, l, acc)  # the home chunk: no hop
    k_c, v_c, mask_c = k, v, kv_mask.to(torch.uint8)  # the mask rides as bytes
    for s in range(1, n):
        k_c, v_c, mask_c = _rotate([k_c, v_c, mask_c], group, idx, n)
        m, l, acc = attend(s, k_c, v_c, mask_c.bool(), m, l, acc)
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q, k, v, mesh, *, axis: str = "seq", kv_mask=None, causal: bool = False,
                   sm_scale: float | None = None) -> torch.Tensor:
    """Sequence-parallel attention of [B, T, H, D] (the same on every rank of
    ``mesh``) over ``mesh``'s ``axis``: each rank takes its T / n rows, runs
    the ring, and the shards are all-gathered back.  T must divide by the
    axis size (pad upstream; serving buckets are padded to fixed shapes).
    kv_mask optional [B, T] bool."""
    T = q.shape[1]
    ax = mesh.axis(axis)
    if T % ax.size:
        raise ValueError(f"seq len {T} not divisible by {axis}={ax.size}")
    per = T // ax.size
    rows = slice(ax.index * per, (ax.index + 1) * per)
    local = ring_attention_local(
        q[:, rows].contiguous(), k[:, rows].contiguous(), v[:, rows].contiguous(),
        None if kv_mask is None else kv_mask[:, rows].contiguous(),
        group=ax.group, causal=causal, sm_scale=sm_scale)
    return ax.all_gather(local, dim=1)
