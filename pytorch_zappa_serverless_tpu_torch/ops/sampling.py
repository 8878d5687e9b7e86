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

Speculative decoding's verifier (:func:`speculative_verify`) keeps the JAX
package's rejection sampling; its acceptance, residual and bonus draws
come from the same hash on streams salted apart from the plain lane's and
from each other (:func:`spec_draws`), and the draft's proposals draw with
the seed XORed with ``DRAFT_SEED_SALT``.  :func:`speculative_verify_core`
takes the draws as tensors, so a test can hand it JAX's.
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


# Salts of the speculative streams (the JAX package's values): the draft's
# proposals XOR the seed with DRAFT_SEED_SALT; the verifier's acceptance,
# residual and bonus draws mix theirs into the hash, so that for a given
# seed and step no two of these streams, nor the plain lane's, share bits.
DRAFT_SEED_SALT = 0x5BEC
ACCEPT_SALT = 0x5ACC
RESIDUAL_SALT = 0x5E51
BONUS_SALT = 0x5B05

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


def uniform_bits(seeds: torch.Tensor, t: torch.Tensor, V: int,
                 salt: int | None = None) -> torch.Tensor:
    """[B, V] int64 in [0, 2**24): 24 hashed bits per (seeds[b], t[b],
    column), on a stream of their own for each ``salt`` (None: the plain
    lane's).  Integer ops only, so the bits are the same on every device and
    in every batch."""
    s = seeds.long()[:, None] & _M32
    step = t.long()[:, None] & _M32
    row = _fmix32(_mul32(s, 0x9E3779B1) ^ _fmix32(step ^ 0x7F4A7C15))   # [B, 1]
    if salt is not None:
        row = _fmix32(row ^ _fmix32(torch.full_like(row, salt & _M32)))
    row2 = _fmix32(row ^ 0x68E31DA4)
    col = torch.arange(V, device=seeds.device, dtype=torch.int64)[None, :]
    return _fmix32(row ^ _fmix32(_mul32(col, 0xCC9E2D51) ^ row2)) >> 8


def gumbel_noise(seeds: torch.Tensor, t: torch.Tensor, V: int,
                 device: torch.device, salt: int | None = None) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, V] f32 on ``device``: row b from (seeds[b],
    t[b]) alone, on ``salt``'s stream.  ``u = (bits + 0.5) / 2**24`` lies
    in (0, 1), exact in f64, and the double log runs in f64 (in f32, u's
    top value would round to 1.0 and give an infinite draw)."""
    seeds, t = seeds.to(device), t.to(device)
    bits = uniform_bits(seeds, t, V, salt)
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


def spec_draws(seeds: torch.Tensor, step: torch.Tensor, K: int, V: int,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The verifier's draws for a tick at per-row ``step`` [S]: acceptance
    uniforms u [S, K] in [0, 1), the residual draws' Gumbel noise [S, K, V]
    (proposal i on its own stream) and the bonus draw's [S, V]."""
    seeds, step = seeds.to(device), step.to(device)
    u = uniform_bits(seeds, step, K, ACCEPT_SALT).float() * 2.0 ** -24
    g_res = torch.stack([gumbel_noise(seeds, step, V, device, RESIDUAL_SALT ^ (i << 16))
                         for i in range(K)], dim=1)
    return u, g_res, gumbel_noise(seeds, step, V, device, BONUS_SALT)


def speculative_verify_core(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                            draft_toks: torch.Tensor, temperature: torch.Tensor,
                            top_k: torch.Tensor | None, top_p: torch.Tensor | None,
                            draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None,
                            *, sampled: bool = True,
                            filtered: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`speculative_verify` on given draws ``(u [S, K], g_res [S, K,
    V], g_bonus [S, V])``: a categorical draw from probabilities ``r`` is
    ``argmax(log r + g)``, as ``jax.random.categorical`` computes it, so
    JAX's Gumbel noise gives JAX's tokens.  ``draws`` may be None when no
    row samples (``sampled`` off)."""
    S, K1, V = target_logits.shape
    K = K1 - 1
    # Greedy verdicts: the target's argmax chain is both the test and the
    # output.
    tgt = target_logits.argmax(-1).to(torch.int32)                      # [S, K+1]
    match = (draft_toks.to(torch.int32) == tgt[:, :K]).long()
    n_greedy = match.cumprod(1).sum(1)
    if not sampled:
        return n_greedy.to(torch.int32), tgt
    dev = target_logits.device
    if top_k is None:
        top_k = torch.zeros((S,), dtype=torch.int32, device=dev)
    if top_p is None:
        top_p = torch.ones((S,), dtype=torch.float32, device=dev)
    temp = temperature.float().clamp_min(1e-3)[:, None, None]

    def dist(logits, n):
        scaled = logits.float() / temp
        if filtered:
            scaled = filter_top_k_top_p(scaled.reshape(S * n, V), top_k.repeat_interleave(n),
                                        top_p.repeat_interleave(n)).reshape(S, n, V)
        return torch.softmax(scaled, dim=-1)

    p = dist(target_logits, K1)                                          # [S, K+1, V]
    q = dist(draft_logits, K)                                            # [S, K, V]
    sel = draft_toks.long()[..., None]
    p_d = p[:, :K].gather(2, sel)[..., 0]
    q_d = q.gather(2, sel)[..., 0]
    u, g_res, g_bonus = draws
    # u < p/q without the division (q_d is 0 only for a derailed proposal,
    # which is then rejected unless p_d > 0 too).
    n_sampled = (u * q_d < p_d).long().cumprod(1).sum(1)
    # The rejection residual norm(max(p - q, 0)) at every position (p itself
    # where it vanishes), drawn at the rejection point.
    resid = (p[:, :K] - q).clamp_min(0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 1e-9, resid, p[:, :K])
    res = (resid.log() + g_res).argmax(-1)                               # [S, K]
    bonus = (p[:, K].log() + g_bonus).argmax(-1)                         # [S]
    fallback = torch.cat([res, bonus[:, None]], dim=1)                   # [S, K+1]
    nth = fallback.gather(1, n_sampled[:, None])
    idx = torch.arange(K1, device=dev)[None, :]
    accepted = torch.cat([draft_toks.long(), bonus[:, None]], dim=1)
    out_sampled = torch.where(idx < n_sampled[:, None], accepted, nth).to(torch.int32)
    hot = temperature > 0.0
    n = torch.where(hot, n_sampled, n_greedy).to(torch.int32)
    return n, torch.where(hot[:, None], out_sampled, tgt)


def speculative_verify(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                       draft_toks: torch.Tensor, temperature: torch.Tensor,
                       seeds: torch.Tensor, step: torch.Tensor,
                       top_k: torch.Tensor | None = None, top_p: torch.Tensor | None = None,
                       *, sampled: bool = True,
                       filtered: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Distribution-preserving speculative verification (Leviathan et al.,
    Chen et al.), batched over the pool: the JAX package's function.

    ``target_logits`` [S, K+1, V] are the target's raw logits at positions
    ``pos..pos+K`` (fed the pending token, then the K proposals),
    ``draft_logits`` [S, K, V] the draft's that the proposals ``draft_toks``
    [S, K] were drawn from; the knobs per row.  Returns ``(n_accept [S],
    out_toks [S, K+1])``: the row accepts its first ``n`` proposals and
    ``out_toks[:, n]`` is the next pending token (the residual draw at a
    rejection, the bonus draw from the (K+1)-th distribution when every
    proposal survived); entries past ``n`` are padding.

    - Greedy rows: accept while the proposal is the target's argmax;
      ``out_toks`` is the argmax chain, so the stream is plain greedy
      decoding's.
    - Sampled rows: proposal i survives with probability ``min(1, p_i(d_i)
      / q_i(d_i))``, p and q the softmax of the filtered target and draft
      logits (the temperature → top-k → top-p pipeline of :func:`choose`);
      a rejection at i draws from ``norm(max(p_i - q_i, 0))``.  The draws
      are :func:`spec_draws` at (seed, step).

    One program on the device, with no host read: it runs inside the verify
    graph."""
    draws = None
    if sampled:
        S, K1, V = target_logits.shape
        draws = spec_draws(seeds, step, K1 - 1, V, target_logits.device)
    return speculative_verify_core(target_logits, draft_logits, draft_toks, temperature,
                                   top_k, top_p, draws, sampled=sampled, filtered=filtered)
