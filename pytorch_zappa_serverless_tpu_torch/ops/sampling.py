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
  :func:`gumbel_noise`, a counter-based hash of (seed, step, column)
  computed on the device with integer tensor ops, so a row's draw depends
  on neither its batch nor the device, and the draw runs inside a captured
  CUDA graph (no host read, no generator state).  It does not give JAX's
  bits (the tests hand both packages the same noise).

The JAX package's ``lax.cond`` gates are host booleans here (``sampled``,
``filtered``), which the caller derives from the batch on the host: a gate
only skips work that would leave every row's result as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


_M32 = 0xFFFFFFFF
EULER_GAMMA = 0.5772156649015329  # the mean of Gumbel(0, 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, in two 16-bit halves so that no product leaves int64's range."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser (a bijection of [0, 2**32)), on int64
    tensors holding non-negative 32-bit values: every shift is logical."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform_bits(seeds: torch.Tensor, t: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] int64 in [0, 2**24): 24 hashed bits per (seeds[b], t[b],
    column).  Integer ops only, so the bits are the same on every device and
    in every batch."""
    s = seeds.long()[:, None] & _M32
    step = t.long()[:, None] & _M32
    row = _fmix32(_mul32(s, 0x9E3779B1) ^ _fmix32(step ^ 0x7F4A7C15))   # [B, 1]
    row2 = _fmix32(row ^ 0x68E31DA4)
    col = torch.arange(V, device=seeds.device, dtype=torch.int64)[None, :]
    return _fmix32(row ^ _fmix32(_mul32(col, 0xCC9E2D51) ^ row2)) >> 8


def gumbel_noise(seeds: torch.Tensor, t: torch.Tensor, V: int,
                 device: torch.device) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, V] f32 on ``device``: row b from (seeds[b],
    t[b]) alone.  ``u = (bits + 0.5) / 2**24`` lies in (0, 1), exact in f64,
    and the double log runs in f64 (in f32, u's top value would round to
    1.0 and give an infinite draw)."""
    bits = uniform_bits(seeds.to(device), t.to(device), V)
    u = (bits.double() + 0.5) * 2.0 ** -24
    return (-torch.log(-torch.log(u))).float()


def choose(logits: torch.Tensor, temperature: torch.Tensor, seeds: torch.Tensor,
           t: torch.Tensor, top_k: torch.Tensor | None = None,
           top_p: torch.Tensor | None = None, *, sampled: bool = True,
           filtered: bool = True) -> torch.Tensor:
    """Next token per row [B] int32: greedy where temperature == 0, else a
    filtered sample at per-row step ``t`` [B].

    ``sampled`` (some row has temperature > 0) and ``filtered`` (some hot row
    sets top-k or top-p) are the batch's gates, known on the host: with a
    gate off its work is skipped, with it on a row it does not concern is
    left as it is (the filter keeps every logit of a row with top_k = 0 and
    top_p >= 1), so the defaults give every batch its right result."""
    greedy = logits.argmax(-1).to(torch.int32)
    if not sampled:
        return greedy
    hot = temperature > 0.0
    scaled = logits / temperature.clamp_min(1e-3)[:, None]
    if filtered and (top_k is not None or top_p is not None):
        B = logits.shape[0]
        if top_k is None:
            top_k = torch.zeros((B,), dtype=torch.int32, device=logits.device)
        if top_p is None:
            top_p = torch.ones((B,), dtype=torch.float32, device=logits.device)
        scaled = filter_top_k_top_p(scaled, top_k, top_p)
    noise = gumbel_noise(seeds, t, logits.shape[-1], logits.device)
    sampled_tok = (scaled + noise).argmax(-1).to(torch.int32)
    return torch.where(hot, sampled_tok, greedy)


class Gates(NamedTuple):
    """A batch's three gates, the JAX package's ``lax.cond``s: some row
    samples, some row's repetition penalty is not 1, some sampled row sets
    top-k or top-p.  Hashable: the key of a batch's captured variant."""

    sampled: bool
    rep_on: bool
    filtered: bool


ALL_ON = Gates(True, True, True)  # right for every batch: each gate only skips work


def gates_of(temperature, top_k, top_p, repetition_penalty) -> Gates:
    """The gates of a collated host batch's per-row knobs (numpy arrays)."""
    temperature, top_k, top_p, rep = map(np.asarray, (temperature, top_k, top_p,
                                                      repetition_penalty))
    hot = temperature > 0.0
    return Gates(bool(hot.any()), bool((rep != 1.0).any()),
                 bool((hot & ((top_k > 0) | (top_p < 1.0))).any()))
