"""Token-sampling transforms of the generative lanes, in PyTorch.

``temperature`` [B] f32, ``seed`` [B] i32, ``top_k`` [B] i32 (0 = off) and
``top_p`` [B] f32 (>= 1.0 = off) are per-row tensors, as in the JAX
package's ``ops/sampling.py``, whose semantics these functions keep:

- top-k keeps the k largest logits per row; top-p keeps the smallest
  descending-probability prefix whose preceding cumulative mass is <= p;
  with both, top-p's nucleus is taken over the softmax of the top-k
  survivors (Hugging Face's warper order).  Both are value thresholds from
  one descending sort, so tied logits keep every tied copy.
- The repetition penalty divides a seen token's positive logit by the
  penalty and multiplies a negative one.
- A sampled row draws ``argmax(logits / T + g)`` with Gumbel noise ``g``:
  what ``jax.random.categorical`` computes.  The noise comes from
  :func:`gumbel_noise`, one explicit ``torch.Generator`` per row seeded
  from (seed, step), so a row's draw does not depend on its batch.  It
  does not give JAX's bits (the tests hand both packages the same noise).

The JAX package's ``lax.cond`` gates are plain ``if``s here.
"""

from __future__ import annotations

import torch


def filter_top_k_top_p(logits: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Mask logits outside the per-row top-k / nucleus sets to -inf.

    logits [B, V] (already temperature-scaled); top_k [B] i32 (0 disables);
    top_p [B] f32 (>= 1.0 disables).
    """
    V = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values           # [B, V]
    k = torch.where(top_k <= 0, V, top_k.clamp(1, V)).long()
    kth = desc.gather(1, (k - 1)[:, None])                               # [B, 1]
    keep = (top_k[:, None] <= 0) | (logits >= kth)
    in_k = torch.arange(V, device=logits.device)[None, :] < k[:, None]  # [B, V]
    probs = torch.softmax(torch.where(in_k, desc.float(), -torch.inf), dim=-1)
    cum_prev = torch.cumsum(probs, dim=-1) - probs                       # mass before i
    count = ((cum_prev <= top_p[:, None]) & in_k).sum(-1).clamp_min(1)
    pth = desc.gather(1, (count - 1)[:, None])
    keep &= (top_p[:, None] >= 1.0) | (logits >= pth)
    return torch.where(keep, logits, -torch.inf)


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty: torch.Tensor) -> torch.Tensor:
    """Hugging Face's ``RepetitionPenaltyLogitsProcessor``, batched: for
    tokens in ``presence`` [B, V] bool, positive logits divide by
    ``penalty`` [B] and negative ones multiply.  The penalty is clamped away
    from zero."""
    p = penalty.clamp_min(1e-3)[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(presence, penalized, logits)


_M64 = (1 << 64) - 1


def _row_seed(seed: int, step: int) -> int:
    """(seed, step) → one 64-bit generator seed, splitmix64-mixed so that
    its low 32 bits (all the CPU generator reads) depend on both."""
    z = (((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def gumbel_noise(seeds: torch.Tensor, t: torch.Tensor, V: int,
                 device: torch.device) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, V] f32: row b from its own generator seeded
    from (seeds[b], t[b]), on ``device``."""
    rows = []
    for seed, step in zip(seeds.tolist(), t.tolist()):
        g = torch.Generator(device=device)
        g.manual_seed(_row_seed(int(seed), int(step)))
        u = torch.rand(V, generator=g, device=device, dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def choose(logits: torch.Tensor, temperature: torch.Tensor, seeds: torch.Tensor,
           t: torch.Tensor, top_k: torch.Tensor | None = None,
           top_p: torch.Tensor | None = None) -> torch.Tensor:
    """Next token per row [B] int32: greedy where temperature == 0, else a
    filtered sample at per-row step ``t`` [B]."""
    greedy = logits.argmax(-1).to(torch.int32)
    hot = temperature > 0.0
    if not bool(hot.any()):
        return greedy
    scaled = logits / temperature.clamp_min(1e-3)[:, None]
    if top_k is not None or top_p is not None:
        B = logits.shape[0]
        if top_k is None:
            top_k = torch.zeros((B,), dtype=torch.int32, device=logits.device)
        if top_p is None:
            top_p = torch.ones((B,), dtype=torch.float32, device=logits.device)
        if bool((hot & ((top_k > 0) | (top_p < 1.0))).any()):
            scaled = filter_top_k_top_p(scaled, top_k, top_p)
    noise = gumbel_noise(seeds, t, logits.shape[-1], logits.device)
    sampled = (scaled + noise).argmax(-1).to(torch.int32)
    return torch.where(hot, sampled, greedy)
