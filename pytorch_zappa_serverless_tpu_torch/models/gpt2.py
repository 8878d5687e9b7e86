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
from ..ops.sampling import apply_repetition_penalty, choose

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


def _layer(p: dict, x, mask_bias, cfg: GPT2Config, write_kv):
    """One pre-LN block, shared by prefill and decode.  ``write_kv(k, v)``
    stores this block's fresh keys/values and returns the head-split K/V the
    attention runs against (the prompt at prefill, the cache at decode)."""
    h = _ln(p["ln1"], x, cfg.ln_eps)
    if "qkv" in p:  # int8 lane: one fused [D, 3D] projection
        q_, k_, v_ = _dense(p["qkv"], h).split(cfg.d_model, dim=-1)
    else:
        k_, v_ = _dense(p["k"], h), _dense(p["v"], h)
        q_ = _dense(p["q"], h)
    k_heads, v_heads = write_kv(k_, v_)
    ao = _attn(_split_heads(q_, cfg.heads), k_heads, v_heads, mask_bias)
    x = x + _dense(p["out"], ao)
    h = _ln(p["ln2"], x, cfg.ln_eps)
    h2 = F.gelu(_dense(p["fc1"], h), approximate="tanh")
    return x + _dense(p["fc2"], h2)


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
            cfg: GPT2Config, dtype=torch.bfloat16):
    """Whole-prompt forward: fills the KV cache, returns last-token logits.

    tokens [B, P] int32 (zero-padded), lengths [B] int32, ``total`` the cache
    length (P + max_new).  Returns (logits [B, V] f32 at position
    length - 1, cache_k, cache_v [L, B, total, D]).
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

        x = _layer(params[f"layer{i}"], x, mask_bias, cfg, write_kv)
    x = _ln(params["ln_f"], x, cfg.ln_eps)
    last = lengths.long() - 1
    last = torch.where(last < 0, last + P, last)  # JAX's index normalisation
    x_last = x[torch.arange(B, device=dev), last]
    return _logits(params, x_last), cache_k, cache_v


def decode_step(params: dict, cache_k, cache_v, tok, wpos, cfg: GPT2Config,
                dtype=torch.bfloat16) -> torch.Tensor:
    """One token per row through every layer: embeds ``tok`` [S] at
    ``wpos`` [S], writes its K/V into the caches at ``wpos`` in place,
    attends over positions <= ``wpos``; returns the logits [S, V] f32."""
    S = tok.shape[0]
    total = cache_k.shape[2]
    rows = torch.arange(S, device=tok.device)
    kpos = torch.arange(total, device=tok.device)
    w = wpos.long()
    x = _embed(params, tok, w, cfg, dtype)[:, None, :]
    mask_bias = torch.where(kpos[None, :] <= w[:, None], 0.0, _NEG).float()[:, None, None, :]
    for i in range(cfg.layers):
        def write_kv(k, v, i=i):
            cache_k[i, rows, w] = k[:, 0]
            cache_v[i, rows, w] = v[:, 0]
            return _split_heads(cache_k[i], cfg.heads), _split_heads(cache_v[i], cfg.heads)

        x = _layer(params[f"layer{i}"], x, mask_bias, cfg, write_kv)
    x = _ln(params["ln_f"], x, cfg.ln_eps)
    return _logits(params, x[:, 0])


def _presence(tokens, lengths, vocab: int) -> torch.Tensor:
    """[B, V] bool: the prompt's tokens (pad positions excluded)."""
    B, P = tokens.shape
    valid = torch.arange(P, device=tokens.device)[None, :] < lengths.long()[:, None]
    pres = torch.zeros((B, vocab + 1), dtype=torch.bool, device=tokens.device)
    pres.scatter_(1, torch.where(valid, tokens.long(), vocab), True)
    return pres[:, :vocab]


def generate(params: dict, tokens, lengths, temperature, seeds, max_new: int,
             cfg: GPT2Config, dtype=torch.bfloat16, top_k=None, top_p=None,
             repetition_penalty=None) -> torch.Tensor:
    """Prefill + decode loop, greedy or sampled per row.  Returns
    [B, max_new] int32, EOS-padded after the first EOS: one
    :func:`prefill_start` and one ``max_new``-step :func:`decode_segment`."""
    B, P = tokens.shape
    presence = None
    if repetition_penalty is not None:
        presence = _presence(tokens, lengths, cfg.vocab_size)
    first, cache_k, cache_v = prefill_start(
        params, tokens, lengths, temperature, seeds, P + max_new, cfg, dtype,
        top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty, presence=presence)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    emits, *_ = decode_segment(
        params, cache_k, cache_v, first, lengths, zeros, zeros.bool(), temperature, seeds,
        max_new, cfg, dtype, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, presence=presence)
    return emits


def generate_greedy(params: dict, tokens, lengths, max_new: int, cfg: GPT2Config,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy-only convenience wrapper over :func:`generate`."""
    B = tokens.shape[0]
    zeros = torch.zeros((B,), device=tokens.device)
    return generate(params, tokens, lengths, zeros, zeros.int(), max_new, cfg, dtype)


def prefill_start(params: dict, tokens, lengths, temperature, seeds, total: int,
                  cfg: GPT2Config, dtype=torch.bfloat16, top_k=None, top_p=None,
                  repetition_penalty=None, presence=None):
    """Prefill and pick each row's first token: (first [B], cache_k,
    cache_v [L, B, total, D])."""
    logits, cache_k, cache_v = prefill(params, tokens, lengths, total, cfg, dtype)
    if repetition_penalty is not None and bool((repetition_penalty != 1.0).any()):
        logits = apply_repetition_penalty(logits, presence, repetition_penalty)
    t0 = torch.zeros(tokens.shape[:1], dtype=torch.int32, device=tokens.device)
    return choose(logits, temperature, seeds, t0, top_k, top_p), cache_k, cache_v


def decode_segment(params: dict, cache_k, cache_v, tok, pos, step, finished, temperature,
                   seeds, seg: int, cfg: GPT2Config, dtype=torch.bfloat16, top_k=None,
                   top_p=None, repetition_penalty=None, presence=None):
    """Advance every slot by ``seg`` tokens.

    Per-slot state, all [S]: ``tok`` the next token to feed, ``pos`` its
    cache write position, ``step`` the sampling-step counter, ``finished``
    (a finished slot still computes, emits EOS, and keeps its ``pos``).
    Step t emits the token decided before it.  Returns (emits [S, seg],
    cache_k, cache_v, tok, pos, step, finished); the caches are the tensors
    passed in, updated in place, and ``presence`` gains each fed token.
    """
    total = cache_k.shape[2]
    rows = torch.arange(tok.shape[0], device=tok.device)
    # Both gates hold for the whole call (the knobs do not change), so the
    # greedy path runs no host sync per step.
    sampled = bool((temperature > 0.0).any())
    rep_on = repetition_penalty is not None and bool((repetition_penalty != 1.0).any())
    t = step
    emits = []
    for _ in range(seg):
        wpos = pos.clamp(max=total - 1)
        logits = decode_step(params, cache_k, cache_v, tok, wpos, cfg, dtype)
        if repetition_penalty is not None:
            presence[rows, tok.long()] = True
            if rep_on:
                logits = apply_repetition_penalty(logits, presence, repetition_penalty)
        if sampled:
            nxt = choose(logits, temperature, seeds, t + 1, top_k, top_p)
        else:
            nxt = logits.argmax(-1).to(torch.int32)
        emits.append(torch.where(finished, cfg.eos_id, tok))
        fin = finished | (tok == cfg.eos_id)
        tok = torch.where(fin, cfg.eos_id, nxt).to(torch.int32)
        pos = torch.where(fin, pos, pos + 1)
        t = t + 1
        finished = fin
    return torch.stack(emits, dim=1), cache_k, cache_v, tok, pos, t, finished


# ---------------------------------------------------------------------------
# Weights: seed init (no checkpoint is shipped) and the int8 rewrite
# ---------------------------------------------------------------------------

def init_gpt2_params(seed: int = 0, cfg: GPT2Config = SMALL) -> dict:
    """A seed-initialised numpy tree in the JAX package's layout: the bytes
    of its ``init_gpt2_params`` (the same ``default_rng`` draws in the same
    order)."""
    g = np.random.default_rng(seed)

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


# Options of the JAX servable that the port does not serve yet (ROADMAP
# Queue 1 item 7 lists them): the extra keys that ask for them.
_LATER = {
    "int8_crossover_batch": "params_dtype 'auto' (the regime-routed lane)",
    "adapter_slots": "LoRA adapters", "adapter_targets": "LoRA adapters",
    "adapter_rank": "LoRA adapters",
    "gen_slots": "the continuous-batching contract (:generate)",
    "segment_tokens": "the continuous-batching contract (:generate)",
    "kv_cache": "the paged KV-cache contract",
    "block_size": "the paged KV-cache contract",
    "num_blocks": "the paged KV-cache contract",
}


def make_gpt2_servable(name: str, cfg_model):
    from ..engine import weights as W
    from ..engine.servable import Servable
    from .bert import resolve_dtype

    dtype = resolve_dtype(cfg_model.dtype)
    max_new = int(cfg_model.extra.get("max_new_tokens", 32))
    arch = {k: int(v) for k, v in dict(cfg_model.extra.get("arch", {})).items()}
    max_seq = max(cfg_model.seq_buckets)
    params_dtype = str(cfg_model.extra.get("params_dtype", ""))
    if params_dtype == "auto":
        raise ValueError(f"{name}: params_dtype {params_dtype!r} is not served by the port yet "
                         f"(a later slice ports the 'auto' lane, ROADMAP Queue 1 item 7); use "
                         f"'int8' or 'bfloat16', or leave it unset")
    later = sorted(k for k in cfg_model.extra if k in _LATER)
    if later:
        raise ValueError(f"{name}: {', '.join(_LATER[k] for k in later)} "
                         f"({', '.join(later)}) is not served by the port yet; a later slice "
                         f"ports it (ROADMAP Queue 1 item 7)")

    if cfg_model.checkpoint:
        params = W.import_params(cfg_model.checkpoint, W.convert_gpt2)
        cfg = dataclasses.replace(config_from_params(params), **arch)
    else:
        cfg = dataclasses.replace(SMALL, **arch) if arch else SMALL
        if cfg.vocab_size <= cfg.eos_id and "eos_id" not in arch:
            cfg = dataclasses.replace(cfg, eos_id=cfg.vocab_size - 1)
        params = init_gpt2_params(0, cfg)
    if max_seq + max_new > cfg.max_positions:
        raise ValueError(
            f"{name}: max(seq_buckets) + max_new_tokens = {max_seq} + {max_new} exceeds the "
            f"model's max_positions ({cfg.max_positions}); shrink seq_buckets or "
            f"max_new_tokens")
    if params_dtype == "int8":
        params = quantize_gpt2(params, cfg.layers,
                               int(cfg_model.extra.get("quantize_min_size", 1 << 16)))
        rest = torch.bfloat16  # the JAX lane holds every >= 2-D float leaf in bf16
    else:
        rest = dtype  # cast at every use in the JAX package: the same values
    module = W.ParamTree(W.gpt2_state_from_jax(params, rest))
    module.eval()

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

    def apply_fn(m, inputs):
        return {"tokens": generate(m.tree(), inputs["input_ids"], inputs["length"],
                                   inputs["temperature"], inputs["seed"], max_new, cfg, dtype,
                                   top_k=inputs["top_k"], top_p=inputs["top_p"],
                                   repetition_penalty=inputs["repetition_penalty"])}

    def input_spec(bucket):
        b, s = bucket
        return {"input_ids": ((b, s), torch.int32), "length": ((b,), torch.int32),
                "temperature": ((b,), torch.float32), "seed": ((b,), torch.int32),
                "top_k": ((b,), torch.int32), "top_p": ((b,), torch.float32),
                "repetition_penalty": ((b,), torch.float32)}

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
        return {"input_ids": arr, "length": np.int32(arr.shape[0]),
                "temperature": np.float32(temperature), "seed": np.int32(seed),
                "top_k": np.int32(top_k), "top_p": np.float32(top_p),
                "repetition_penalty": np.float32(rep)}

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
        return batch

    meta = {"seq_len_of": lambda s: int(s["input_ids"].shape[0]),
            "max_new_tokens": max_new, "collate": collate_lengths,
            "config": cfg, "dtype": dtype}
    return Servable(name=name, apply_fn=apply_fn, module=module, input_spec=input_spec,
                    preprocess=preprocess, postprocess=postprocess,
                    bucket_axes=("batch", "seq"), meta=meta)


from ..utils.registry import register_model  # noqa: E402


@register_model("gpt2", latency_class="latency")
def build_gpt2(cfg):
    return make_gpt2_servable("gpt2", cfg)
