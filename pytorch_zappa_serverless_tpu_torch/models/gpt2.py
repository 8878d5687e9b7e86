"""GPT-2 causal text generation in PyTorch, served on ``:predict``.

The JAX package's ``models/gpt2.py``, function for function, over a nested
dict of tensors in its layout (dense kernels ``[in, out]``):

- **Prefill + decode loop**: the whole prompt runs in one batched forward
  that fills the KV cache ``[L, B, P + max_new, D]``; each generated token
  is one decode step (a Python loop where the JAX package scans).
- **Ragged prompts in a bucket**: per-row ``length``; prefill masks keys at
  or past it, the first token reads position ``length - 1``, and step t
  writes its K/V at ``length + t`` per row.
- EOS pins a finished row's output to EOS; greedy or sampled per row
  (``ops/sampling``), with top-k, top-p and a repetition penalty.
- LayerNorm, softmax and logits in f32; products in the working dtype;
  the lm head is ``wte`` (tied).  The caches are updated in place.

With ``extra.params_dtype: int8`` the q/k/v kernels fuse into one
``[D, 3D]`` projection and every layer kernel plus a transposed copy of
``wte`` (the lm head) become int8 + per-column scales, run by
``ops/int8_matmul``: 49 launches per forward position step at 12 layers.
With ``params_dtype: auto`` the servable holds both trees and routes each
program (the JAX package's regime-routed lane): prefill runs the bf16 tree,
and decode the int8 tree at up to ``int8_crossover_batch`` rows, the bf16
tree above.  The embeddings and LayerNorms are held once, in the bf16
tree; the int8 tree holds only what it quantized (:func:`int8_view` puts
the two together for a program).

With ``adapter_slots`` (multi-tenant LoRA, ``ops/lora.py``,
``serving/adapters.py``) the tree holds a stack pool ``__adapters__`` and
every program takes a per-row ``adapter_idx``: each target projection of
a row gains its adapter's low-rank delta, and rows at slot 0 are the base.

The servable also carries the JAX package's continuous-batching contract
(``meta["continuous"]``, driven by ``serving/generation.py`` on
``:generate``): admission prefill into a slot pool ``[L, S, total, D]`` and
``segment_tokens``-step decode segments over it, and the block-paged
functions (:func:`prefill_chunk_paged`, :func:`decode_segment_paged`) over
a page pool ``[L, num_blocks, block_size, D]`` with per-row block tables,
and speculative decoding's draft steps and verify forward over that pool
(:func:`propose_paged`, :func:`verify_paged`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8_matmul import (dense_maybe_int8, int8_matmul, pad_weights, quantize_per_channel,
                               quantize_tree)
from ..ops.lora import lora_apply
from ..ops.paged_attention import gather_kv, scatter_kv
from ..ops.sampling import ALL_ON, Gates, apply_repetition_penalty, choose, gates_of

# The int8 product every quantized projection and the lm head go through; a
# check may set it to ``int8_matmul_reference`` to hold the served model
# against the plain version on the same weights.
int8_mm = int8_matmul

_NEG = -1e9


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    d_model: int = 768
    layers: int = 12
    heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 1024
    eos_id: int = 50256
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads


SMALL = GPT2Config()


def config_from_params(params: dict) -> GPT2Config:
    """A GPT2Config from a converted tree's shapes; ``heads = d_model // 64``
    (every published GPT-2 size has head_dim 64), ``extra.arch`` overrides."""
    vocab, d_model = (int(x) for x in np.asarray(params["wte"]).shape)
    return GPT2Config(
        vocab_size=vocab,
        d_model=d_model,
        layers=sum(1 for k in params if k.startswith("layer")),
        heads=max(d_model // 64, 1),
        ffn_dim=int(np.asarray(params["layer0"]["fc1"]["kernel"]).shape[1]),
        max_positions=int(np.asarray(params["wpe"]).shape[0]),
    )


# ---------------------------------------------------------------------------
# Core math (functions over the param dict; GPT-2's GELU is the tanh form)
# ---------------------------------------------------------------------------

def _ln(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain or W8A16 projection, keyed on the param node."""
    return dense_maybe_int8(p, x, matmul=int8_mm)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.view(B, T, heads, D // heads)


def _attn(q, k, v, mask_bias):
    """q [B,Tq,H,Dh], k/v [B,Tk,H,Dh], mask_bias [B,1,Tq,Tk] → [B,Tq,H*Dh].
    Products in the working dtype, scores in f32, P cast back before P·V."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    probs = torch.softmax(scores + mask_bias, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    B, Tq = out.shape[:2]
    return out.reshape(B, Tq, -1)


def _layer(p: dict, x, mask_bias, cfg: GPT2Config, write_kv, lora=None, lora_idx=None):
    """One pre-LN block, shared by prefill and decode.  ``write_kv(k, v)``
    stores this block's fresh keys/values and returns the head-split K/V the
    attention runs against (the prompt at prefill, the cache at decode).

    ``lora``/``lora_idx``: this layer's adapter stacks and the per-row slot
    indices; each target projection gains its row's delta
    (``ops.lora.lora_apply``), rows at slot 0 the base output unchanged.
    The fused int8 ``qkv`` never carries adapters (refused at build)."""
    def ad(name, y, inp):
        if lora is None or name not in lora:
            return y
        return lora_apply(y, inp, lora[name], lora_idx)

    h = _ln(p["ln1"], x, cfg.ln_eps)
    if "qkv" in p:  # int8 lane: one fused [D, 3D] projection
        q_, k_, v_ = _dense(p["qkv"], h).split(cfg.d_model, dim=-1)
    else:
        k_, v_ = ad("k", _dense(p["k"], h), h), ad("v", _dense(p["v"], h), h)
        q_ = ad("q", _dense(p["q"], h), h)
    k_heads, v_heads = write_kv(k_, v_)
    ao = _attn(_split_heads(q_, cfg.heads), k_heads, v_heads, mask_bias)
    x = x + ad("out", _dense(p["out"], ao), ao)
    h = _ln(p["ln2"], x, cfg.ln_eps)
    h2 = F.gelu(ad("fc1", _dense(p["fc1"], h), h), approximate="tanh")
    return x + ad("fc2", _dense(p["fc2"], h2), h2)


def _lora_of(params: dict, layer: int, adapter_idx):
    """This layer's adapter stacks, or None."""
    if adapter_idx is None:
        return None
    stacks = params.get("__adapters__")
    return None if stacks is None else stacks.get(f"layer{layer}")


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied lm head = wte, f32 logits.  Int8 lane: the padded transposed
    int8 copy (``lm_q`` [D, Vp] + ``lm_scale``) through the int8 product with
    an f32 output, pad columns sliced off.  Float lane: ``x`` cast to the
    table's dtype, products in that dtype and the f32 accumulator returned,
    never rounded to a bf16 table's dtype (the JAX package's
    ``preferred_element_type=f32``).  On the card cuBLAS writes the f32
    accumulator; on the CPU both operands go to f32, whose products of bf16
    values are exact, so only the summation order differs."""
    vocab = params["wte"].shape[0]
    if "lm_q" in params:
        return int8_mm(x.to(torch.bfloat16).contiguous(), params["lm_q"], params["lm_scale"],
                       out_dtype=torch.float32)[:, :vocab]
    w = params["wte"]
    x = x.to(w.dtype)
    if w.dtype == torch.float32:
        return x @ w.t()
    if x.is_cuda:
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return x.float() @ w.t().float()


def _embed(params: dict, tok, wpos, cfg: GPT2Config, dtype):
    return (params["wte"].to(dtype)[tok.long()]
            + params["wpe"].to(dtype)[wpos.clamp(max=cfg.max_positions - 1).long()])


def prefill(params: dict, tokens: torch.Tensor, lengths: torch.Tensor, total: int,
            cfg: GPT2Config, dtype=torch.bfloat16, adapter_idx=None):
    """Whole-prompt forward: fills the KV cache, returns last-token logits.

    tokens [B, P] int32 (zero-padded), lengths [B] int32, ``total`` the cache
    length (P + max_new).  Returns (logits [B, V] f32 at position
    length - 1, cache_k, cache_v [L, B, total, D]).  ``adapter_idx`` [B]
    routes each row through its tenant's slot (0: the base).
    """
    B, P = tokens.shape
    dev = tokens.device
    pos = torch.arange(P, device=dev)
    x = _embed(params, tokens, pos[None, :].expand(B, P), cfg, dtype)
    # Causal and ragged: query i attends keys j <= i that are real (j < len).
    causal = pos[None, :, None] >= pos[None, None, :]
    real = pos[None, None, :] < lengths.long()[:, None, None]
    mask_bias = torch.where(causal & real, 0.0, _NEG).float()[:, None]
    cache_k = torch.zeros((cfg.layers, B, total, cfg.d_model), dtype=dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    for i in range(cfg.layers):
        def write_kv(k, v, i=i):
            cache_k[i, :, :P] = k
            cache_v[i, :, :P] = v
            return _split_heads(k, cfg.heads), _split_heads(v, cfg.heads)

        x = _layer(params[f"layer{i}"], x, mask_bias, cfg, write_kv,
                   _lora_of(params, i, adapter_idx), adapter_idx)
    x = _ln(params["ln_f"], x, cfg.ln_eps)
    last = lengths.long() - 1
    last = torch.where(last < 0, last + P, last)  # JAX's index normalisation
    x_last = x[torch.arange(B, device=dev), last]
    return _logits(params, x_last), cache_k, cache_v


def _step_logits(params: dict, tok, w, klen: int, writer, cfg: GPT2Config, dtype,
                 adapter_idx=None):
    """One token per row through every layer at positions ``w`` [S] int64,
    attending over key positions ``< klen`` that are ``<= w``;
    ``writer(i)`` is layer i's ``write_kv``.  Returns the logits [S, V] f32."""
    kpos = torch.arange(klen, device=tok.device)
    x = _embed(params, tok, w, cfg, dtype)[:, None, :]
    mask_bias = torch.where(kpos[None, :] <= w[:, None], 0.0, _NEG).float()[:, None, None, :]
    for i in range(cfg.layers):
        x = _layer(params[f"layer{i}"], x, mask_bias, cfg, writer(i),
                   _lora_of(params, i, adapter_idx), adapter_idx)
    x = _ln(params["ln_f"], x, cfg.ln_eps)
    return _logits(params, x[:, 0])


def decode_step(params: dict, cache_k, cache_v, tok, wpos, cfg: GPT2Config,
                dtype=torch.bfloat16, adapter_idx=None) -> torch.Tensor:
    """One token per row through every layer: embeds ``tok`` [S] at
    ``wpos`` [S], writes its K/V into the caches at ``wpos`` in place,
    attends over positions <= ``wpos``; returns the logits [S, V] f32."""
    rows = torch.arange(tok.shape[0], device=tok.device)
    w = wpos.long()

    def writer(i):
        def write_kv(k, v):
            cache_k[i, rows, w] = k[:, 0]
            cache_v[i, rows, w] = v[:, 0]
            return _split_heads(cache_k[i], cfg.heads), _split_heads(cache_v[i], cfg.heads)
        return write_kv

    return _step_logits(params, tok, w, cache_k.shape[2], writer, cfg, dtype, adapter_idx)


def _presence(tokens, lengths, vocab: int) -> torch.Tensor:
    """[B, V] bool: the prompt's tokens (pad positions excluded)."""
    B, P = tokens.shape
    valid = torch.arange(P, device=tokens.device)[None, :] < lengths.long()[:, None]
    pres = torch.zeros((B, vocab + 1), dtype=torch.bool, device=tokens.device)
    pres.scatter_(1, torch.where(valid, tokens.long(), vocab), True)
    return pres[:, :vocab]


def generate(params: dict, tokens, lengths, temperature, seeds, max_new: int,
             cfg: GPT2Config, dtype=torch.bfloat16, top_k=None, top_p=None,
             repetition_penalty=None, gates: Gates = ALL_ON, decode_params: dict | None = None,
             adapter_idx=None) -> torch.Tensor:
    """Prefill + decode loop, greedy or sampled per row.  Returns
    [B, max_new] int32, EOS-padded after the first EOS: one
    :func:`prefill_start` and one ``max_new``-step :func:`decode_segment`.

    ``decode_params`` lets the regime-routed lane (``params_dtype: auto``)
    prefill with one tree and decode with another; ``adapter_idx`` [B] routes
    each row through its adapter slot.

    ``gates`` (``ops.sampling.gates_of`` the batch's knobs, on the host)
    skips the sampling, penalty and filter work no row needs; the default
    runs all three, right for any batch.  Nothing here reads the device on
    the host, so a call captures into one CUDA graph."""
    B, P = tokens.shape
    presence = None
    if repetition_penalty is not None:
        presence = _presence(tokens, lengths, cfg.vocab_size)
    first, cache_k, cache_v = prefill_start(
        params, tokens, lengths, temperature, seeds, P + max_new, cfg, dtype,
        top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty, presence=presence,
        gates=gates, adapter_idx=adapter_idx)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    emits, *_ = decode_segment(
        params if decode_params is None else decode_params, cache_k, cache_v, first, lengths,
        zeros, zeros.bool(), temperature, seeds, max_new, cfg, dtype, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, presence=presence, gates=gates,
        adapter_idx=adapter_idx)
    return emits


def generate_greedy(params: dict, tokens, lengths, max_new: int, cfg: GPT2Config,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy-only convenience wrapper over :func:`generate`."""
    B = tokens.shape[0]
    zeros = torch.zeros((B,), device=tokens.device)
    return generate(params, tokens, lengths, zeros, zeros.int(), max_new, cfg, dtype,
                    gates=Gates(False, False, False))


def prefill_start(params: dict, tokens, lengths, temperature, seeds, total: int,
                  cfg: GPT2Config, dtype=torch.bfloat16, top_k=None, top_p=None,
                  repetition_penalty=None, presence=None, gates: Gates = ALL_ON,
                  adapter_idx=None):
    """Prefill and pick each row's first token: (first [B], cache_k,
    cache_v [L, B, total, D])."""
    logits, cache_k, cache_v = prefill(params, tokens, lengths, total, cfg, dtype, adapter_idx)
    if repetition_penalty is not None and gates.rep_on:
        logits = apply_repetition_penalty(logits, presence, repetition_penalty)
    t0 = torch.zeros(tokens.shape[:1], dtype=torch.int32, device=tokens.device)
    first = choose(logits, temperature, seeds, t0, top_k, top_p, sampled=gates.sampled,
                   filtered=gates.filtered)
    return first, cache_k, cache_v


def decode_segment(params: dict, cache_k, cache_v, tok, pos, step, finished, temperature,
                   seeds, seg: int, cfg: GPT2Config, dtype=torch.bfloat16, top_k=None,
                   top_p=None, repetition_penalty=None, presence=None, gates: Gates = ALL_ON,
                   adapter_idx=None):
    """Advance every slot by ``seg`` tokens.

    Per-slot state, all [S]: ``tok`` the next token to feed, ``pos`` its
    cache write position, ``step`` the sampling-step counter, ``finished``
    (a finished slot still computes, emits EOS, and keeps its ``pos``).
    Step t emits the token decided before it.  Returns (emits [S, seg],
    cache_k, cache_v, tok, pos, step, finished); the caches are the tensors
    passed in, updated in place, and ``presence`` gains each fed token.
    ``gates`` holds for the whole call (the knobs do not change).
    """
    rows = torch.arange(tok.shape[0], device=tok.device)
    rep_on = repetition_penalty is not None and gates.rep_on
    seen = torch.ones((), dtype=torch.bool, device=tok.device)  # no host-to-device copy a step

    def logits_at(tok, wpos):
        logits = decode_step(params, cache_k, cache_v, tok, wpos, cfg, dtype, adapter_idx)
        if repetition_penalty is not None:
            presence[rows, tok.long()] = seen
            if rep_on:
                logits = apply_repetition_penalty(logits, presence, repetition_penalty)
        return logits

    emits, tok, pos, step, finished = _segment_loop(
        logits_at, cache_k.shape[2], tok, pos, step, finished, temperature, seeds, seg, cfg,
        top_k, top_p, gates)
    return emits, cache_k, cache_v, tok, pos, step, finished


def _segment_loop(logits_at, limit: int, tok, pos, step, finished, temperature, seeds,
                  seg: int, cfg: GPT2Config, top_k, top_p, gates: Gates):
    """The decode loop both segment functions share: ``seg`` steps, each
    feeding ``tok`` at ``min(pos, limit - 1)`` through ``logits_at(tok,
    wpos)``.  Step t emits the token decided before it; a row that is
    finished, or feeds EOS, emits EOS and keeps its ``pos``.  Returns
    (emits [S, seg], tok, pos, step, finished)."""
    t = step
    emits = []
    for _ in range(seg):
        logits = logits_at(tok, pos.clamp(max=limit - 1))
        if gates.sampled:
            nxt = choose(logits, temperature, seeds, t + 1, top_k, top_p,
                         filtered=gates.filtered)
        else:
            nxt = logits.argmax(-1).to(torch.int32)
        emits.append(torch.where(finished, cfg.eos_id, tok))
        fin = finished | (tok == cfg.eos_id)
        tok = torch.where(fin, cfg.eos_id, nxt).to(torch.int32)
        pos = torch.where(fin, pos, pos + 1)
        t = t + 1
        finished = fin
    return torch.stack(emits, dim=1), tok, pos, t, finished


# ---------------------------------------------------------------------------
# Block-paged functions (serving/generation.PagedGenerationScheduler drives
# them): a pool of pages [L, num_blocks, block_size, D] and a block table
# [S, max_blocks] per row.  Writes go through the table
# (ops/paged_attention.scatter_kv), attention runs over the gathered virtual
# cache (gather_kv), which at every position a row wrote holds what the slot
# pool's contiguous row would, masked to exact zeros beyond.
# ---------------------------------------------------------------------------

def _paged_write(cache, layer: int, table, wpos, values, block_size: int):
    """Scatter ``values`` [S, T, D] at ``wpos`` [S, T] (clipped to the
    virtual range) through ``table`` into layer ``layer``'s pages, in place."""
    return scatter_kv(cache[layer], table, wpos, values, block_size)


def _paged_view(cache, layer: int, table, heads: int):
    """One layer's virtual cache [S, MB*BS, D], head-split for attention."""
    return _split_heads(gather_kv(cache[layer], table), heads)


def _paged_writer(cache_k, cache_v, table, wpos, block_size: int, heads: int):
    def writer(i):
        def write_kv(k, v):
            _paged_write(cache_k, i, table, wpos, k, block_size)
            _paged_write(cache_v, i, table, wpos, v, block_size)
            return (_paged_view(cache_k, i, table, heads),
                    _paged_view(cache_v, i, table, heads))
        return write_kv
    return writer


def prefill_chunk_logits(params: dict, tokens, start, lengths, cache_k, cache_v, table,
                         block_size: int, cfg: GPT2Config, dtype=torch.bfloat16,
                         adapter_idx=None):
    """One bounded prefill chunk over the paged pool, up to the logits.

    ``tokens`` [G, C] is the chunk's slice of each prompt (zero-padded in a
    final chunk), ``start`` [G] its absolute offset, ``lengths`` [G] the
    whole prompt's length.  The query at ``start + i`` attends every key
    ``j <= start + i`` with ``j < length``; earlier chunks' keys come back
    through the table, so chained chunks give the monolithic
    :func:`prefill`'s attention, and a prefix-cache hit's first chunk
    starts at the cached offset over frozen pages.  Writes the chunk's K/V
    into the caches in place and returns the logits [G, V] f32 at each
    row's last prompt position inside the chunk, which mean something only
    for rows whose final chunk this is."""
    G, C = tokens.shape
    VT = table.shape[1] * block_size
    dev = tokens.device
    pos = start.long()[:, None] + torch.arange(C, device=dev)[None, :]   # [G, C]
    wpos = pos.clamp(max=VT - 1)
    x = _embed(params, tokens, pos, cfg, dtype)
    kpos = torch.arange(VT, device=dev)
    keep = ((kpos[None, None, :] <= pos[:, :, None])
            & (kpos[None, None, :] < lengths.long()[:, None, None]))
    mask_bias = torch.where(keep, 0.0, _NEG).float()[:, None]
    writer = _paged_writer(cache_k, cache_v, table, wpos, block_size, cfg.heads)
    for i in range(cfg.layers):
        x = _layer(params[f"layer{i}"], x, mask_bias, cfg, writer(i),
                   _lora_of(params, i, adapter_idx), adapter_idx)
    x = _ln(params["ln_f"], x, cfg.ln_eps)
    idx = (lengths.long() - 1 - start.long()).clamp(0, C - 1)
    return _logits(params, x[torch.arange(G, device=dev), idx])


def prefill_chunk_paged(params: dict, tokens, start, lengths, cache_k, cache_v, table,
                        temperature, seeds, top_k, top_p, block_size: int, cfg: GPT2Config,
                        dtype=torch.bfloat16, gates: Gates = ALL_ON, adapter_idx=None):
    """:func:`prefill_chunk_logits` and each row's first token drawn from
    them: (first [G], cache_k, cache_v), the caches updated in place;
    ``first`` means something only for rows whose final chunk this is."""
    logits = prefill_chunk_logits(params, tokens, start, lengths, cache_k, cache_v, table,
                                  block_size, cfg, dtype, adapter_idx)
    t0 = torch.zeros(tokens.shape[:1], dtype=torch.int32, device=tokens.device)
    first = choose(logits, temperature, seeds, t0, top_k, top_p, sampled=gates.sampled,
                   filtered=gates.filtered)
    return first, cache_k, cache_v


def decode_segment_paged(params: dict, cache_k, cache_v, table, tok, pos, step, finished,
                         temperature, seeds, seg: int, cfg: GPT2Config, block_size: int,
                         dtype=torch.bfloat16, top_k=None, top_p=None,
                         gates: Gates = ALL_ON, adapter_idx=None):
    """:func:`decode_segment` over the paged pool: the same steps, writes
    and reads routed through ``table``.  Finished and empty rows carry an
    all-trash table row, so their frozen-position writes land in the trash
    page."""
    VT = table.shape[1] * block_size

    def logits_at(tok, wpos):
        w = wpos.long()
        writer = _paged_writer(cache_k, cache_v, table, w[:, None], block_size, cfg.heads)
        return _step_logits(params, tok, w, VT, writer, cfg, dtype, adapter_idx)

    emits, tok, pos, step, finished = _segment_loop(
        logits_at, VT, tok, pos, step, finished, temperature, seeds, seg, cfg, top_k, top_p,
        gates)
    return emits, cache_k, cache_v, tok, pos, step, finished


def propose_paged(params: dict, cache_k, cache_v, table, prev, tok, pos, step, finished,
                  temperature, seeds, k: int, cfg: GPT2Config, block_size: int,
                  dtype=torch.bfloat16, top_k=None, top_p=None, gates: Gates = ALL_ON):
    """The draft half of a speculative tick: ``k`` decode steps over the
    draft's own page pool (the target's block table: the same positions),
    each feeding its proposal back.

    ``k + 1`` steps run: step 0 feeds ``prev`` (the chain token at ``pos -
    1``) again, since after a tick that accepted every proposal the draft
    never fed its last one and its KV at ``pos - 1`` is missing (where it is
    there, the write is the same); its output is dropped, and step 1 feeds
    the pending ``tok``.  Proposal i of a sampled row draws at step ``step +
    1 + i`` with the seed XORed with ``DRAFT_SEED_SALT``.  Returns
    (proposals [S, k] int32, the draft's logits [S, k, V] f32, cache_k,
    cache_v), the caches updated in place."""
    from ..ops.sampling import DRAFT_SEED_SALT

    VT = table.shape[1] * block_size
    draft_seeds = seeds ^ DRAFT_SEED_SALT
    cur, p, t = prev, (pos - 1).clamp(min=0), step
    props, logits_k = [], []
    for j in range(k + 1):
        w = p.clamp(max=VT - 1).long()
        writer = _paged_writer(cache_k, cache_v, table, w[:, None], block_size, cfg.heads)
        logits = _step_logits(params, cur, w, VT, writer, cfg, dtype)
        if j == 0:
            nxt = tok
        else:
            nxt = choose(logits, temperature, draft_seeds, t + 1, top_k, top_p,
                         sampled=gates.sampled, filtered=gates.filtered)
            logits_k.append(logits)
        cur = torch.where(finished, cfg.eos_id, nxt).to(torch.int32)
        if j > 0:
            props.append(cur)
            t = t + 1
        p = torch.where(finished, p, p + 1)
    return torch.stack(props, dim=1), torch.stack(logits_k, dim=1), cache_k, cache_v


def verify_paged(params: dict, cache_k, cache_v, table, toks, pos, cfg: GPT2Config,
                 block_size: int, dtype=torch.bfloat16):
    """The target half of a speculative tick: one forward over the pending
    token and the K proposals of each row, ``toks`` [S, K+1] at positions
    ``pos..pos+K``.  Their K/V are written through the table first; then
    query i attends every key at or before its own position, over the
    gathered pages (multi-query paged attention, causal among the new
    positions), so its logits are those K+1 decode steps would give.
    Positions past the acceptance point keep rejected tokens' K/V until the
    next tick's writes replace them, before any mask admits them.  Returns
    (logits [S, K+1, V] f32, cache_k, cache_v), the caches updated in
    place; the products run at S x (K+1) rows."""
    S, K1 = toks.shape
    VT = table.shape[1] * block_size
    dev = toks.device
    wp = (pos.long()[:, None] + torch.arange(K1, device=dev)[None, :]).clamp(max=VT - 1)
    x = _embed(params, toks, wp, cfg, dtype)
    kpos = torch.arange(VT, device=dev)
    mask_bias = torch.where(kpos[None, None, :] <= wp[:, :, None], 0.0, _NEG).float()[:, None]
    writer = _paged_writer(cache_k, cache_v, table, wp, block_size, cfg.heads)
    for i in range(cfg.layers):
        x = _layer(params[f"layer{i}"], x, mask_bias, cfg, writer(i))
    x = _ln(params["ln_f"], x, cfg.ln_eps)
    logits = _logits(params, x.reshape(S * K1, x.shape[-1])).reshape(S, K1, -1)
    return logits, cache_k, cache_v


# ---------------------------------------------------------------------------
# Weights: seed init (no checkpoint is shipped) and the int8 rewrite
# ---------------------------------------------------------------------------

def init_gpt2_params(seed: int = 0, cfg: GPT2Config = SMALL, rng=None) -> dict:
    """A seed-initialised numpy tree in the JAX package's layout: the bytes
    of its ``init_gpt2_params`` (the same ``default_rng`` draws in the same
    order)."""
    g = np.random.default_rng(seed) if rng is None else rng

    def dense(i, o):
        return {"kernel": (g.standard_normal((i, o)) * 0.02).astype(np.float32),
                "bias": np.zeros((o,), np.float32)}

    def ln(d):
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    D, Fd = cfg.d_model, cfg.ffn_dim
    params = {
        "wte": (g.standard_normal((cfg.vocab_size, D)) * 0.02).astype(np.float32),
        "wpe": (g.standard_normal((cfg.max_positions, D)) * 0.01).astype(np.float32),
        "ln_f": ln(D),
    }
    for i in range(cfg.layers):
        params[f"layer{i}"] = {
            "ln1": ln(D), "q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
            "out": dense(D, D), "ln2": ln(D), "fc1": dense(D, Fd), "fc2": dense(Fd, D),
        }
    return params


def fuse_qkv(tree: dict, layers: int) -> dict:
    """A float numpy tree with each layer's q/k/v kernels and biases
    concatenated into one ``qkv`` node (``[D, 3D]``, order q|k|v, the order
    ``_layer`` splits).  The input tree is not modified."""
    tree = {k: ({n: dict(v2) if isinstance(v2, dict) else v2 for n, v2 in v.items()}
                if isinstance(v, dict) else v) for k, v in tree.items()}
    for i in range(layers):
        lp = tree[f"layer{i}"]
        lp["qkv"] = {
            "kernel": np.concatenate([np.asarray(lp[n]["kernel"], np.float32) for n in "qkv"],
                                     axis=1),
            "bias": np.concatenate([np.asarray(lp[n]["bias"], np.float32) for n in "qkv"]),
        }
        del lp["q"], lp["k"], lp["v"]
    return tree


def quantize_gpt2(tree: dict, layers: int, min_size: int = 1 << 16) -> dict:
    """The int8 lane's rewrite of a float numpy tree (the JAX servable's
    ``_quantize``): q/k/v fuse (:func:`fuse_qkv`) before quantizing; layer
    kernels of at least ``min_size`` elements become ``kernel_q`` +
    ``scale``; ``lm_q``/``lm_scale`` are the padded int8 copy of ``wte.T``.
    The input tree is not modified."""
    tree = quantize_tree(fuse_qkv(tree, layers), min_size=min_size)
    lm_q, lm_scale = quantize_per_channel(np.asarray(tree["wte"], np.float32).T.copy(), axis=0)
    tree["lm_q"], tree["lm_scale"] = pad_weights(lm_q, lm_scale)
    return tree


# ---------------------------------------------------------------------------
# Servable
# ---------------------------------------------------------------------------

def _fallback_tokenize(text: str, vocab_size: int) -> list[int]:
    """Offline stub: whitespace words hashed into the vocab (the JAX
    package's, id for id)."""
    return [int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "big")
            % max(vocab_size - 1, 1) for w in text.split()]


# The leaves the regime-routed lane's int8 tree shares with its bf16 tree:
# held once, in the bf16 tree (top level, then each layer's).
_SHARED = ("wte", "wpe", "ln_f")
_SHARED_LAYER = ("ln1", "ln2")


def int8_view(tree: dict, layers: int) -> dict:
    """The regime-routed lane's decode tree: its ``int8`` subtree with the
    shared leaves (the embeddings and every LayerNorm) taken from its
    ``bf16`` subtree, which holds them once."""
    b, q = tree["bf16"], tree["int8"]
    out = {**q, **{k: b[k] for k in _SHARED}}
    for i in range(layers):
        lq, lb = q[f"layer{i}"], b[f"layer{i}"]
        out[f"layer{i}"] = {**lq, **{k: lb[k] for k in _SHARED_LAYER}}
    return out


def _int8_only(tree: dict, layers: int) -> dict:
    """An int8 lane's tree without the leaves it shares with the bf16 tree."""
    out = {k: v for k, v in tree.items() if k not in _SHARED}
    for i in range(layers):
        out[f"layer{i}"] = {k: v for k, v in tree[f"layer{i}"].items()
                            if k not in _SHARED_LAYER}
    return out


def gpt2_params(cfg_model) -> tuple[dict, GPT2Config]:
    """The float tree the builder loads (a checkpoint, its config read off
    its shapes, else the seeded init of SMALL) and its config, with
    ``extra.arch``'s overrides."""
    from ..engine import weights as W

    arch = {k: int(v) for k, v in dict(cfg_model.extra.get("arch", {})).items()}
    if cfg_model.checkpoint:
        params = W.import_params(cfg_model.checkpoint, W.convert_gpt2)
        return params, dataclasses.replace(config_from_params(params), **arch)
    cfg = dataclasses.replace(SMALL, **arch) if arch else SMALL
    if cfg.vocab_size <= cfg.eos_id and "eos_id" not in arch:
        cfg = dataclasses.replace(cfg, eos_id=cfg.vocab_size - 1)
    return init_gpt2_params(0, cfg), cfg


def make_gpt2_servable(name: str, cfg_model):
    from ..engine import weights as W
    from ..engine.servable import Servable
    from .bert import resolve_dtype

    dtype = resolve_dtype(cfg_model.dtype)
    max_new = int(cfg_model.extra.get("max_new_tokens", 32))
    max_seq = max(cfg_model.seq_buckets)
    params_dtype = str(cfg_model.extra.get("params_dtype", ""))
    routed = params_dtype == "auto"
    # The regime crossover: the routed lane decodes on the int8 tree at up
    # to this many rows, on the bf16 tree above.  The default is the JAX
    # package's, from its sweep on its own chip; it is not measured on the
    # H100 (ROADMAP Queue 3).
    crossover = int(cfg_model.extra.get("int8_crossover_batch", 64))

    params, cfg = gpt2_params(cfg_model)
    if max_seq + max_new > cfg.max_positions:
        raise ValueError(
            f"{name}: max(seq_buckets) + max_new_tokens = {max_seq} + {max_new} exceeds the "
            f"model's max_positions ({cfg.max_positions}); shrink seq_buckets or "
            f"max_new_tokens")
    adapters_on = int(cfg_model.adapter_slots) > 0
    if adapters_on and params_dtype in ("int8", "auto"):
        # The fused int8 qkv has no per-projection seam for a delta, and the
        # routed lane would need the stacks in both trees.
        raise ValueError(f"{name}: adapter_slots cannot combine with params_dtype="
                         f"{params_dtype!r}; serve adapters on the bf16 lane")
    min_size = int(cfg_model.extra.get("quantize_min_size", 1 << 16))
    adapter_meta = None
    if params_dtype == "int8":
        # The JAX lane holds every >= 2-D float leaf in bf16.
        sd = W.tree_state_from_jax(quantize_gpt2(params, cfg.layers, min_size), torch.bfloat16)
    elif routed:
        # Both trees, each program picking one: prefill the bf16 tree, decode
        # the int8 tree at up to ``crossover`` rows.  The shared leaves are
        # registered once (in the bf16 tree), so the move to the device, the
        # host tier, the checkpoint store and the HBM ledger hold them once.
        bf16 = W.tree_state_from_jax(params, torch.bfloat16)
        q = W.tree_state_from_jax(_int8_only(quantize_gpt2(params, cfg.layers, min_size),
                                             cfg.layers), torch.bfloat16)
        sd = {**{f"bf16.{k}": v for k, v in bf16.items()},
              **{f"int8.{k}": v for k, v in q.items()}}
    else:
        if adapters_on:
            # The multi-tenant slot pool: fixed-shape zero stacks in the tree
            # (an attach writes a slot in place: no recapture), slot 0 the
            # reserved base.  serving/adapters.AdapterManager owns the slots.
            from ..ops.lora import zero_stacks

            D, Fd = cfg.d_model, cfg.ffn_dim
            every = {"q": (D, D), "k": (D, D), "v": (D, D), "out": (D, D), "fc1": (D, Fd),
                     "fc2": (Fd, D)}  # each target's (K, N)
            targets = tuple(cfg_model.adapter_targets) or ("q", "v")
            unknown = [t for t in targets if t not in every]
            if unknown:
                raise ValueError(f"{name}: unknown adapter_targets {unknown}; supported: "
                                 f"{sorted(every)}")
            dims = {t: every[t] for t in targets}
            slots = int(cfg_model.adapter_slots) + 1
            rank = max(int(cfg_model.adapter_rank), 1)
            params = {**params, "__adapters__": {
                f"layer{i}": zero_stacks(slots, rank, dims) for i in range(cfg.layers)}}
            adapter_meta = {"slots": slots, "rank": rank,
                            "targets": tuple(cfg_model.adapter_targets), "dims": dims,
                            "layers": cfg.layers}
        sd = W.tree_state_from_jax(params, dtype)  # cast at every use in the JAX package
    module = W.ParamTree(sd)
    module.eval()

    def pre_tree(tree: dict) -> dict:
        """Prefill weights: the bf16 tree on the routed lane."""
        return tree["bf16"] if routed else tree

    def dec_tree(tree: dict, rows: int) -> dict:
        """Decode weights for a program of ``rows`` decode rows."""
        if not routed:
            return tree
        return int8_view(tree, cfg.layers) if rows <= crossover else tree["bf16"]

    def aidx_of(sample) -> int:
        """A sample's adapter slot, checked on the host: an out-of-range
        gather on the GPU is a device-side assert that poisons the context."""
        a = int(np.asarray(sample.get("adapter_idx", 0)))
        if a and (adapter_meta is None or not 0 <= a < adapter_meta["slots"]):
            raise ValueError(f"adapter slot {a} outside the model's pool")
        return a

    tokenizer = None
    tok_path = cfg_model.extra.get("tokenizer")
    if tok_path:
        from tokenizers import Tokenizer

        tokenizer = Tokenizer.from_file(str(tok_path))
    default_temperature = float(cfg_model.extra.get("temperature", 0.0))

    # Over-length policy: "error" (default) is a clean 400; "truncate" keeps
    # the tail, the causal-LM convention.
    overlength = str(cfg_model.extra.get("overlength", "error"))
    if overlength not in ("truncate", "error"):
        raise ValueError(f"{name}: extra.overlength must be 'truncate' or 'error', got "
                         f"{overlength!r}")

    def _fit(ids: list[int]) -> list[int]:
        if len(ids) > max_seq:
            if overlength == "error":
                raise ValueError(
                    f"prompt is {len(ids)} tokens but the longest configured seq bucket is "
                    f"{max_seq}; send a shorter prompt or set extra.overlength='truncate' to "
                    f"keep the last {max_seq}")
            ids = ids[-max_seq:]
        return ids

    def apply_fn(m, inputs, variant: Gates = ALL_ON):
        tree = m.tree()
        rows = inputs["input_ids"].shape[0]  # static per bucket: one tree per graph
        return {"tokens": generate(pre_tree(tree), inputs["input_ids"], inputs["length"],
                                   inputs["temperature"], inputs["seed"], max_new, cfg, dtype,
                                   top_k=inputs["top_k"], top_p=inputs["top_p"],
                                   repetition_penalty=inputs["repetition_penalty"],
                                   gates=variant, decode_params=dec_tree(tree, rows),
                                   adapter_idx=inputs.get("adapter_idx"))}

    def variant_of(batch) -> Gates:
        """The collated host batch's gates: which captured variant runs it."""
        return gates_of(batch["temperature"], batch["top_k"], batch["top_p"],
                        batch["repetition_penalty"])

    def input_spec(bucket):
        b, s = bucket
        spec = {"input_ids": ((b, s), torch.int32), "length": ((b,), torch.int32),
                "temperature": ((b,), torch.float32), "seed": ((b,), torch.int32),
                "top_k": ((b,), torch.int32), "top_p": ((b,), torch.float32),
                "repetition_penalty": ((b,), torch.float32)}
        if adapter_meta is not None:
            spec["adapter_idx"] = ((b,), torch.int32)  # pad rows collate to 0: the base
        return spec

    def preprocess(payload):
        temperature, seed = default_temperature, 0
        top_k, top_p, rep = 0, 1.0, 1.0  # off unless the request sets them
        if isinstance(payload, dict):
            temperature = float(payload.get("temperature", temperature))
            seed = int(payload.get("seed", seed))
            top_k = int(payload.get("top_k", top_k))
            top_p = float(payload.get("top_p", top_p))
            rep = float(payload.get("repetition_penalty", rep))
        if isinstance(payload, dict) and "input_ids" in payload:
            ids = [int(i) for i in payload["input_ids"]]
        else:
            text = payload["text"] if isinstance(payload, dict) else str(
                payload.decode() if isinstance(payload, bytes) else payload)
            ids = (tokenizer.encode(text).ids if tokenizer is not None
                   else _fallback_tokenize(text, cfg.vocab_size))
        arr = np.asarray(_fit(ids or [cfg.eos_id]), np.int32)
        if arr.min() < 0 or arr.max() >= cfg.vocab_size:
            # Checked on the host: an out-of-range gather on the GPU is a
            # device-side assert that poisons the CUDA context.
            raise ValueError(f"input_ids must lie in [0, {cfg.vocab_size}); got "
                             f"{int(arr.min())}..{int(arr.max())}")
        sample = {"input_ids": arr, "length": np.int32(arr.shape[0]),
                  "temperature": np.float32(temperature), "seed": np.int32(seed),
                  "top_k": np.int32(top_k), "top_p": np.float32(top_p),
                  "repetition_penalty": np.float32(rep)}
        if adapter_meta is not None:
            # Slot 0: the base; the server stamps the tenant's slot after its
            # attach gate.
            sample["adapter_idx"] = np.int32(0)
        return sample

    def postprocess(out, i):
        toks = [int(t) for t in out["tokens"][i]]
        if cfg.eos_id in toks:
            toks = toks[: toks.index(cfg.eos_id)]
        result = {"tokens": toks}
        if tokenizer is not None:
            result["text"] = tokenizer.decode(toks)
        return result

    def collate_lengths(samples, bucket, spec):
        from ..engine.compiled import default_collate

        batch = default_collate(samples, bucket, spec)
        batch["length"] = np.maximum(batch["length"], 1)  # pad rows: a real index
        # Pad rows with neutral knobs, so that they open no gate.
        batch["repetition_penalty"][len(samples):] = 1.0
        batch["top_p"][len(samples):] = 1.0
        if adapter_meta is not None:
            for s in samples:
                aidx_of(s)
        return batch

    # The continuous-batching contract (serving/generation.py, the JAX
    # servable's keys): ``gen_slots`` rows in a pool [L, S, total, D],
    # advanced ``segment_tokens`` steps a segment.  Admission is
    # model-shaped (Whisper admits audio), so the scheduler sizes it with
    # ``admit_len_of`` and collates it with ``collate_admit``; ``prefill``
    # takes the (batched) payload.  The lane's knobs carry no repetition
    # penalty (the server refuses one on :generate).
    gen_slots = int(cfg_model.extra.get("gen_slots", 4))
    segment_tokens = int(cfg_model.extra.get("segment_tokens", 8))
    total = max_seq + max_new

    def collate_admit(sample, bucket):
        ids = np.asarray(sample["input_ids"], np.int32)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, : ids.shape[0]] = ids
        return {"input_ids": toks,
                "length": np.asarray([max(ids.shape[0], 1)], np.int32),
                "temperature": np.asarray([sample.get("temperature", 0.0)], np.float32),
                "seed": np.asarray([sample.get("seed", 0)], np.int32),
                "top_k": np.asarray([sample.get("top_k", 0)], np.int32),
                "top_p": np.asarray([sample.get("top_p", 1.0)], np.float32)}

    def admit_spec(bucket):
        return {"input_ids": ((1, bucket), torch.int32), "length": ((1,), torch.int32),
                "temperature": ((1,), torch.float32), "seed": ((1,), torch.int32),
                "top_k": ((1,), torch.int32), "top_p": ((1,), torch.float32)}

    def prefill_admit(tree, payload, gates: Gates = ALL_ON):
        return prefill_start(pre_tree(tree), payload["input_ids"], payload["length"],
                             payload["temperature"], payload["seed"], total, cfg, dtype,
                             top_k=payload["top_k"], top_p=payload["top_p"], gates=gates)

    def segment(tree, ck, cv, tok, pos, st, fin, temp, seeds, topk, topp,
                gates: Gates = ALL_ON):
        return decode_segment(dec_tree(tree, gen_slots), ck, cv, tok, pos, st, fin, temp, seeds,
                              segment_tokens, cfg, dtype, top_k=topk, top_p=topp, gates=gates)

    def make_paged(block_size: int, spec_k: int):
        """The paged lane's device functions for one pool layout, the
        speculative tick's ``propose`` (a draft's ``spec_k`` proposals) and
        ``verify`` (the target's forward over them) among them.  The chunk
        and the segment take each row's adapter slot (``aidx`` [S]); the
        draft never sees adapters (the scheduler decodes plain while an
        adapter stream is active).  Chunks run the prefill tree; segment,
        propose and verify the decode tree of the pool's ``gen_slots`` rows
        (the verify's too, not its S x (k+1) rows, as in the JAX package)."""
        bs, k = int(block_size), int(spec_k)
        ad = (lambda aidx: aidx) if adapter_meta is not None else (lambda aidx: None)
        return {
            "propose": (
                lambda tree, ck, cv, table, prev, tok, pos, st, fin, temp, seeds, topk, topp,
                gates=ALL_ON:
                propose_paged(dec_tree(tree, gen_slots), ck, cv, table, prev, tok, pos, st, fin,
                              temp, seeds, k, cfg, bs, dtype, top_k=topk, top_p=topp,
                              gates=gates)),
            "verify": (
                lambda tree, ck, cv, table, toks, pos:
                verify_paged(dec_tree(tree, gen_slots), ck, cv, table, toks, pos, cfg, bs,
                             dtype)),
            "prefill_chunk": (
                lambda tree, toks, start, length, ck, cv, table, temp, seed, topk, topp,
                gates=ALL_ON, aidx=None:
                prefill_chunk_paged(pre_tree(tree), toks, start, length, ck, cv, table, temp,
                                    seed, topk, topp, bs, cfg, dtype, gates=gates,
                                    adapter_idx=ad(aidx))),
            "segment": (
                lambda tree, ck, cv, table, tok, pos, st, fin, temp, seeds, topk, topp,
                gates=ALL_ON, aidx=None:
                decode_segment_paged(dec_tree(tree, gen_slots), ck, cv, table, tok, pos, st,
                                     fin, temp, seeds, segment_tokens, cfg, bs, dtype,
                                     top_k=topk, top_p=topp, gates=gates,
                                     adapter_idx=ad(aidx))),
        }

    continuous = {
        "slots": gen_slots, "segment_tokens": segment_tokens, "total": total,
        "eos_id": cfg.eos_id, "max_new": max_new,
        "prompt_buckets": tuple(sorted(int(s) for s in cfg_model.seq_buckets)),
        "admit_len_of": lambda s: int(np.asarray(s["input_ids"]).shape[0]),
        "collate_admit": collate_admit, "admit_spec": admit_spec,
        "cache_shape": (cfg.layers, gen_slots, total, cfg.d_model), "cache_dtype": dtype,
        "prefill": prefill_admit, "segment": segment,
        "detokenize": (lambda toks: tokenizer.decode(toks)) if tokenizer is not None else None,
        "paged": {
            "make": make_paged,
            "vocab": cfg.vocab_size,
            "cache_shape": lambda num_blocks, block_size: (cfg.layers, num_blocks, block_size,
                                                           cfg.d_model),
            # Host-side admission adapters: the scheduler builds its own
            # chunk payloads from the prompt ids and knobs.
            "prompt_ids": lambda s: np.asarray(s["input_ids"], np.int32).reshape(-1),
            "knobs": lambda s: (float(s.get("temperature", 0.0)), int(s.get("seed", 0)),
                                int(s.get("top_k", 0)), float(s.get("top_p", 1.0))),
            # The stream's adapter slot (0: the base); an eviction's
            # continuation (extend_sample) keeps it.
            "adapter_idx": aidx_of,
            # Eviction continuation: the prompt and the tokens emitted so far
            # become the re-admission prompt.
            "extend_sample": lambda s, toks: {
                **s, "input_ids": np.concatenate(
                    [np.asarray(s["input_ids"], np.int32).reshape(-1),
                     np.asarray(toks, np.int32)]),
                "length": np.int32(np.asarray(s["input_ids"]).reshape(-1).shape[0]
                                   + len(toks))},
        },
    }

    meta = {"seq_len_of": lambda s: int(s["input_ids"].shape[0]),
            "max_new_tokens": max_new, "collate": collate_lengths,
            "variant_of": variant_of, "continuous": continuous,
            # What warm-up captures: a request that sets no knob.
            "default_variant": Gates(default_temperature > 0.0, False, False),
            "config": cfg, "dtype": dtype,
            # Which tree a program reads (the routed lane's regime): what a
            # check composes the fixed route from.
            "pre_tree": pre_tree, "dec_tree": dec_tree}
    if routed:
        meta["int8_crossover_batch"] = crossover
    if adapter_meta is not None:
        # The pool's layout, which the AdapterManager builds host stacks
        # against (``slots`` counts the reserved slot 0).
        meta["adapters"] = adapter_meta
    return Servable(name=name, apply_fn=apply_fn, module=module, input_spec=input_spec,
                    preprocess=preprocess, postprocess=postprocess,
                    bucket_axes=("batch", "seq"), meta=meta)


from ..utils.registry import register_model, register_tree  # noqa: E402


@register_tree("gpt2")
def gpt2_tree(cfg_model) -> tuple[dict, dict]:
    from ..engine.weights import ShapeDraws

    params, cfg = gpt2_params(cfg_model)
    return params, init_gpt2_params(0, cfg, rng=ShapeDraws())


@register_model("gpt2", latency_class="latency")
def build_gpt2(cfg):
    return make_gpt2_servable("gpt2", cfg)
