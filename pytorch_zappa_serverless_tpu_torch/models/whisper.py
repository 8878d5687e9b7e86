"""Whisper-tiny speech recognition in PyTorch, served on ``:predict``.

The JAX package's ``models/whisper.py``, function for function, over a
nested dict of tensors in its layout (dense kernels ``[in, out]``; the conv
stem's kernels as ``Conv1d`` weights ``[out, in, 3]``):

- log-mel ``[B, 80, 3000]`` → conv stem (stride 1, then 2) → pre-LN encoder
  → each decoder layer's cross-attention K/V once → the task prompt in one
  batched prefill → ``max_new`` greedy steps against a fixed-size KV cache
  ``[L, B, P + max_new, D]``.  The steps are a Python loop where the JAX
  package scans; each step's position is a Python int, so a call holds no
  host read and captures into one CUDA graph per bucket.
- A row pins its output to EOT after its first EOT (the loop cannot end
  early: every step runs, as every scan step does).
- LayerNorm, softmax and the tied head's logits in f32; exact-erf GELU;
  finite ``-1e9`` masks; products in the working dtype.

With ``extra.params_dtype: int8`` each decoder layer's q/k/v/out/cq/cout/
fc1/fc2 kernel and a padded transposed int8 copy of ``embed_tokens`` (the
lm head) run through ``ops/int8_matmul``: 33 launches a position, 2145 a
call at 4 layers and 64 new tokens (the prompt's prefill and 64 steps).
The encoder, the stem and cross K/V stay float (bf16 at rest).
"""

from __future__ import annotations

import dataclasses
import io
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8_matmul import (dense_maybe_int8, int8_matmul, pad_weights, quantize_per_channel,
                               quantize_tree)
from ..ops.sampling import ALL_ON, Gates, choose
from ..parallel.mesh import WHISPER_TP_RULES

# The int8 product every quantized projection and the lm head go through; a
# check may set it to ``int8_matmul_reference`` to hold the served model
# against the plain version on the same weights.
int8_mm = int8_matmul

_NEG = -1e9
# The decoder's projections the int8 lane quantizes.
INT8_PROJECTIONS = ("q", "k", "v", "out", "cq", "cout", "fc1", "fc2")


@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    heads: int = 6
    ffn_dim: int = 1536
    n_mels: int = 80
    source_positions: int = 1500  # 30 s / (10 ms hop x the stem's stride 2)
    target_positions: int = 448
    sot_id: int = 50258  # <|startoftranscript|>
    eot_id: int = 50257  # <|endoftext|>

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads


TINY = WhisperConfig()


def config_from_params(params: dict) -> WhisperConfig:
    """A WhisperConfig from a converted tree's shapes (JAX layout: the stem's
    kernel ``[3, n_mels, D]``).  ``heads = d_model // 64`` (every published
    Whisper size has head_dim 64); the vocabulary sets the control ids
    (51865+: multilingual, EOT 50257; else EOT 50256; SOT = EOT + 1)."""
    enc, dec = params["encoder"], params["decoder"]
    conv1 = np.asarray(enc["conv1"]["kernel"])
    n_mels, d_model = int(conv1.shape[1]), int(conv1.shape[2])
    vocab = int(np.asarray(dec["embed_tokens"]).shape[0])
    eot = 50257 if vocab >= 51865 else 50256
    return WhisperConfig(
        vocab_size=vocab, d_model=d_model,
        encoder_layers=sum(1 for k in enc if k.startswith("layer")),
        decoder_layers=sum(1 for k in dec if k.startswith("layer")),
        heads=max(d_model // 64, 1),
        ffn_dim=int(np.asarray(enc["layer0"]["fc1"]["kernel"]).shape[1]),
        n_mels=n_mels,
        source_positions=int(np.asarray(enc["pos_embed"]).shape[0]),
        target_positions=int(np.asarray(dec["pos_embed"]).shape[0]),
        sot_id=eot + 1, eot_id=eot)


# ---------------------------------------------------------------------------
# Core math (functions over the param dict)
# ---------------------------------------------------------------------------

def _ln(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain or W8A16 projection, keyed on the param node."""
    return dense_maybe_int8(p, x, matmul=int8_mm)


def _logits_tied(dec: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied lm head: x [B, D] → f32 logits [B, V].  Int8 lane: the padded
    transposed copy (``lm_q`` [D, Vp] + ``lm_scale``) through the int8
    product with an f32 output, pad columns sliced off; float lane: an f32
    product with the table."""
    vocab = dec["embed_tokens"].shape[0]
    if "lm_q" in dec:
        return int8_mm(x.to(torch.bfloat16).contiguous(), dec["lm_q"], dec["lm_scale"],
                       out_dtype=torch.float32)[:, :vocab]
    return x.float() @ dec["embed_tokens"].float().t()


def _attn(q, k, v, head_dim: int, mask_bias=None) -> torch.Tensor:
    """q [B, Tq, D], k/v [B, Tk, D] (projected) → [B, Tq, D]: products in the
    working dtype, scores and softmax in f32, P cast back before P·V.  D is
    the width this rank holds (d_model / model on a mesh): the heads are
    D / ``head_dim``."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = head_dim
    heads = D // hd
    scores = torch.einsum("bqhd,bkhd->bhqk", q.reshape(B, Tq, heads, hd),
                          k.reshape(B, Tk, heads, hd)).float()
    if mask_bias is not None:
        scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.reshape(B, Tk, heads, hd)).reshape(B, Tq, D)


def _self_attn_block(p: dict, x, head_dim: int, scale: float, mask_bias=None):
    h = _ln(p["self_ln"], x)
    q = _dense(p["q"], h) * scale
    return x + _dense(p["out"], _attn(q, _dense(p["k"], h), _dense(p["v"], h), head_dim,
                                      mask_bias))


def _ffn_block(p: dict, x):
    h = _ln(p["ffn_ln"], x)
    return x + _dense(p["fc2"], F.gelu(_dense(p["fc1"], h)))


def _conv_gelu(p: dict, x, stride: int, dtype):
    """One stem conv: cross-correlation, pad 1 each side, bias after the
    product in ``dtype``, exact GELU.  x and the output [B, C, T]."""
    y = F.conv1d(x, p["weight"].to(dtype), None, stride, 1)
    return F.gelu(y + p["bias"].to(dtype)[:, None])


def encode(params: dict, mel: torch.Tensor, cfg: WhisperConfig = TINY,
           dtype=torch.bfloat16) -> torch.Tensor:
    """mel [B, n_mels, 3000] → encoder states [B, 1500, D] in ``dtype``."""
    enc = params["encoder"]
    x = _conv_gelu(enc["conv1"], mel.to(dtype), 1, dtype)
    x = _conv_gelu(enc["conv2"], x, 2, dtype).transpose(1, 2)  # [B, T, D]
    x = x + enc["pos_embed"].to(dtype)[None]
    scale = cfg.head_dim ** -0.5
    for i in range(cfg.encoder_layers):
        p = enc[f"layer{i}"]
        x = _ffn_block(p, _self_attn_block(p, x, cfg.head_dim, scale))
    return _ln(enc["final_ln"], x).to(dtype)


def _cross_kv(params: dict, enc_out: torch.Tensor, cfg: WhisperConfig) -> list:
    """Each decoder layer's cross-attention K/V, once a request."""
    dec = params["decoder"]
    return [(_dense(dec[f"layer{i}"]["ck"], enc_out), _dense(dec[f"layer{i}"]["cv"], enc_out))
            for i in range(cfg.decoder_layers)]


def _kv_width(params: dict, cfg: WhisperConfig) -> int:
    """The width of a decoder layer's K/V as this rank holds them: d_model,
    or d_model / model when K is column-parallel on a mesh."""
    k = params["decoder"]["layer0"].get("k")
    return int(k["kernel"].shape[-1]) if k is not None and "kernel" in k else cfg.d_model


def _embed(dec: dict, tok: torch.Tensor, pos, dtype) -> torch.Tensor:
    """Token plus position embedding, rows gathered before the cast."""
    return dec["embed_tokens"][tok.long()].to(dtype) + dec["pos_embed"][pos].to(dtype)


def _cross_block(p: dict, x, cross_kv, head_dim: int, scale: float):
    h = _ln(p["cross_ln"], x)
    ck, cv = cross_kv
    return x + _dense(p["cout"], _attn(_dense(p["cq"], h) * scale, ck, cv, head_dim))


def _decoder_step(params: dict, cfg: WhisperConfig, dtype, cross, tok, pos,
                  cache_k, cache_v, mask_bias) -> torch.Tensor:
    """One decoder position for every row: tok [B] at position ``pos`` (a
    Python int, or a per-row int64 tensor [B] on the continuous lane), its
    K/V written into the caches [L, B, T, D] in place, the self-attention
    over the cache under ``mask_bias`` ([T] f32, or [B, 1, 1, T]).  Returns
    the logits [B, V] f32."""
    dec = params["decoder"]
    scale = cfg.head_dim ** -0.5
    x = _embed(dec, tok, pos, dtype)[:, None, :]
    at = ((slice(None), pos) if isinstance(pos, int)
          else (torch.arange(tok.shape[0], device=tok.device), pos))
    for i in range(cfg.decoder_layers):
        p = dec[f"layer{i}"]
        h = _ln(p["self_ln"], x)
        q = _dense(p["q"], h) * scale
        cache_k[i][at] = _dense(p["k"], h)[:, 0]
        cache_v[i][at] = _dense(p["v"], h)[:, 0]
        x = x + _dense(p["out"], _attn(q, cache_k[i], cache_v[i], cfg.head_dim, mask_bias))
        x = _ffn_block(p, _cross_block(p, x, cross[i], cfg.head_dim, scale))
    x = _ln(dec["final_ln"], x)
    return _logits_tied(dec, x[:, 0])


def prefill_decoder(params: dict, cross, prompt: torch.Tensor, total: int,
                    cfg: WhisperConfig = TINY, dtype=torch.bfloat16):
    """The task prompt [B, P] (the same for every row) in one batched forward
    under a causal mask; returns (last-position logits [B, V] f32, cache_k,
    cache_v [L, B, total, D] with positions < P written)."""
    dec = params["decoder"]
    B, P = prompt.shape
    dev = prompt.device
    scale = cfg.head_dim ** -0.5
    pos = torch.arange(P, device=dev)
    x = _embed(dec, prompt, pos[None], dtype)
    mask = torch.where(pos[:, None] >= pos[None, :], 0.0, _NEG).float()[None, None]
    L = cfg.decoder_layers
    cache_k = torch.zeros((L, B, total, _kv_width(params, cfg)), dtype=dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    for i in range(L):
        p = dec[f"layer{i}"]
        h = _ln(p["self_ln"], x)
        q = _dense(p["q"], h) * scale
        k, v = _dense(p["k"], h), _dense(p["v"], h)
        cache_k[i, :, :P] = k
        cache_v[i, :, :P] = v
        x = x + _dense(p["out"], _attn(q, k, v, cfg.head_dim, mask))
        x = _ffn_block(p, _cross_block(p, x, cross[i], cfg.head_dim, scale))
    x = _ln(dec["final_ln"], x)
    return _logits_tied(dec, x[:, -1]), cache_k, cache_v


def _kpos_mask(total: int, last: int, device) -> torch.Tensor:
    """[total] f32: 0 at key positions <= ``last``, -1e9 after."""
    return torch.where(torch.arange(total, device=device) <= last, 0.0, _NEG).float()


def decode_greedy(params: dict, enc_out: torch.Tensor, prompt: torch.Tensor, max_new: int,
                  cfg: WhisperConfig = TINY, dtype=torch.bfloat16) -> torch.Tensor:
    """Prefill the prompt, then ``max_new`` greedy steps.  Returns [B,
    max_new] int32, EOT after a row's first EOT.  Step t emits the token
    decided before it (the first from the prefill)."""
    B, P = prompt.shape
    total = P + max_new
    cross = _cross_kv(params, enc_out, cfg)
    logits, cache_k, cache_v = prefill_decoder(params, cross, prompt, total, cfg, dtype)
    tok = logits.argmax(-1).to(torch.int32)
    finished = torch.zeros((B,), dtype=torch.bool, device=prompt.device)
    emits = []
    for t in range(max_new):
        logits = _decoder_step(params, cfg, dtype, cross, tok, P + t, cache_k, cache_v,
                               _kpos_mask(total, P + t, prompt.device))
        emits.append(torch.where(finished, cfg.eot_id, tok))
        finished = finished | (tok == cfg.eot_id)
        tok = logits.argmax(-1).to(torch.int32)
    return torch.stack(emits, dim=1).to(torch.int32)


def prefill_continuous(params: dict, mel: torch.Tensor, prompt: torch.Tensor, total_self: int,
                       cfg: WhisperConfig = TINY, dtype=torch.bfloat16, temperature=None,
                       seeds=None, top_k=None, top_p=None, gates: Gates = ALL_ON):
    """Admission for the continuous lane: audio → first token and packed
    cache rows.  The encoder, each layer's cross K/V and the task prompt
    ``prompt`` [B, P] run in one call; the rows are packed as ``[L, B,
    source_positions + total_self, D]``, cross K/V in the first
    ``source_positions`` slots and the self-attention cache after, so the
    scheduler holds one (k, v) pool pair per model, as for GPT-2.  The first
    token draws with the request's knobs at step 0 (greedy at temperature
    0, the :predict chain)."""
    enc = encode(params, mel, cfg, dtype)
    cross = _cross_kv(params, enc, cfg)
    logits, sk, sv = prefill_decoder(params, cross, prompt, total_self, cfg, dtype)
    B = mel.shape[0]
    if temperature is None:
        first = logits.argmax(-1).to(torch.int32)
    else:
        zeros = torch.zeros((B,), dtype=torch.int32, device=mel.device)
        first = choose(logits, temperature, zeros if seeds is None else seeds, zeros, top_k,
                       top_p, sampled=gates.sampled, filtered=gates.filtered)
    cross_k = torch.stack([c[0] for c in cross]).to(dtype)  # [L, B, CL, D]
    cross_v = torch.stack([c[1] for c in cross]).to(dtype)
    return first, torch.cat([cross_k, sk], dim=2), torch.cat([cross_v, sv], dim=2)


def decode_segment(params: dict, cache_k, cache_v, tok, pos, step, finished, seg: int,
                   cfg: WhisperConfig = TINY, dtype=torch.bfloat16, temperature=None,
                   seeds=None, top_k=None, top_p=None, gates: Gates = ALL_ON):
    """Advance every slot ``seg`` tokens through :func:`_decoder_step`: the
    continuous lane's segment over the packed pools [L, S, CL + total_self,
    D] of :func:`prefill_continuous`, updated in place.  ``pos`` [S] is each
    row's next self-cache position.  Step t emits the token decided before
    it; a row pins to EOT after its first EOT and keeps its ``pos``.  The
    per-step math is :func:`decode_greedy`'s, so a lone slot's greedy
    stream is the fixed-batch chain.  Returns (emits [S, seg], cache_k,
    cache_v, tok, pos, step, finished)."""
    CL = cfg.source_positions
    total_self = cache_k.shape[2] - CL
    self_k, self_v = cache_k[:, :, CL:], cache_v[:, :, CL:]
    cross = [(cache_k[i, :, :CL], cache_v[i, :, :CL]) for i in range(cfg.decoder_layers)]
    kpos = torch.arange(total_self, device=tok.device)
    sampled = temperature is not None and gates.sampled
    zeros = torch.zeros_like(tok)
    t = step
    emits = []
    for _ in range(seg):
        wpos = pos.clamp(max=total_self - 1).long()
        mask = torch.where(kpos[None, :] <= wpos[:, None], 0.0, _NEG).float()[:, None, None, :]
        logits = _decoder_step(params, cfg, dtype, cross, tok, wpos, self_k, self_v, mask)
        if sampled:
            nxt = choose(logits, temperature, zeros if seeds is None else seeds, t + 1, top_k,
                         top_p, filtered=gates.filtered)
        else:
            nxt = logits.argmax(-1).to(torch.int32)
        emits.append(torch.where(finished, cfg.eot_id, tok))
        fin = finished | (tok == cfg.eot_id)
        tok = torch.where(fin, cfg.eot_id, nxt).to(torch.int32)
        pos = torch.where(fin, pos, pos + 1)
        t = t + 1
        finished = fin
    return torch.stack(emits, dim=1), cache_k, cache_v, tok, pos, t, finished


def decode_forced(params: dict, enc_out: torch.Tensor, tokens: torch.Tensor,
                  cfg: WhisperConfig = TINY, dtype=torch.bfloat16) -> torch.Tensor:
    """Teacher-forced step logits [B, T, V] f32 of ``tokens`` [B, T], one
    decoder step a position (scoring and parity)."""
    B, T = tokens.shape
    cross = _cross_kv(params, enc_out, cfg)
    cache_k = torch.zeros((cfg.decoder_layers, B, T, _kv_width(params, cfg)), dtype=dtype,
                          device=tokens.device)
    cache_v = torch.zeros_like(cache_k)
    return torch.stack([_decoder_step(params, cfg, dtype, cross, tokens[:, t], t, cache_k,
                                      cache_v, _kpos_mask(T, t, tokens.device))
                        for t in range(T)], dim=1)


# ---------------------------------------------------------------------------
# Weights: seed init (no checkpoint is shipped), the int8 rewrite, the bridge
# ---------------------------------------------------------------------------

def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder position embedding."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_whisper_params(seed: int = 0, cfg: WhisperConfig = TINY, rng=None) -> dict:
    """A seed-initialised numpy tree in the JAX package's layout: the bytes
    of its ``init_whisper_params`` (the same ``default_rng`` draws in the
    same order)."""
    g = np.random.default_rng(seed) if rng is None else rng

    def dense(i, o, bias=True):
        p = {"kernel": (g.standard_normal((i, o)) * 0.02).astype(np.float32)}
        if bias:
            p["bias"] = np.zeros((o,), np.float32)
        return p

    def ln(d):
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    D, Fd = cfg.d_model, cfg.ffn_dim

    def enc_layer():
        return {"self_ln": ln(D), "q": dense(D, D), "k": dense(D, D, bias=False),
                "v": dense(D, D), "out": dense(D, D),
                "ffn_ln": ln(D), "fc1": dense(D, Fd), "fc2": dense(Fd, D)}

    def dec_layer():
        return {**enc_layer(), "cross_ln": ln(D), "cq": dense(D, D),
                "ck": dense(D, D, bias=False), "cv": dense(D, D), "cout": dense(D, D)}

    encoder = {
        "conv1": {"kernel": (g.standard_normal((3, cfg.n_mels, D)) * 0.02).astype(np.float32),
                  "bias": np.zeros((D,), np.float32)},
        "conv2": {"kernel": (g.standard_normal((3, D, D)) * 0.02).astype(np.float32),
                  "bias": np.zeros((D,), np.float32)},
        "pos_embed": _sinusoids(cfg.source_positions, D),
        "final_ln": ln(D),
    }
    for i in range(cfg.encoder_layers):
        encoder[f"layer{i}"] = enc_layer()
    decoder = {
        "embed_tokens": (g.standard_normal((cfg.vocab_size, D)) * 0.02).astype(np.float32),
        "pos_embed": (g.standard_normal((cfg.target_positions, D)) * 0.02).astype(np.float32),
        "final_ln": ln(D),
    }
    for i in range(cfg.decoder_layers):
        decoder[f"layer{i}"] = dec_layer()
    return {"encoder": encoder, "decoder": decoder}


def quantize_whisper(tree: dict, layers: int, min_size: int = 1 << 16) -> dict:
    """The int8 lane's rewrite of a float numpy tree (the JAX servable's):
    each decoder layer's ``INT8_PROJECTIONS`` kernels of at least
    ``min_size`` elements become ``kernel_q`` + ``scale``; ``lm_q``/
    ``lm_scale`` are the padded int8 copy of ``embed_tokens.T``.  The input
    tree is not modified."""
    dec = dict(tree["decoder"])
    for i in range(layers):
        lp = dict(dec[f"layer{i}"])
        for n in INT8_PROJECTIONS:
            lp[n] = quantize_tree(lp[n], min_size=min_size)
        dec[f"layer{i}"] = lp
    lm_q, lm_scale = quantize_per_channel(np.asarray(dec["embed_tokens"], np.float32).T.copy(),
                                          axis=0)
    dec["lm_q"], dec["lm_scale"] = pad_weights(lm_q, lm_scale)
    return {**tree, "decoder": dec}


def state_from_jax(tree: dict, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A Whisper param tree (numpy, the JAX package's layout) → a
    ``state_dict`` for ``ParamTree``: the stem's ``kernel [3, in, out]``
    becomes a ``Conv1d`` ``weight [out, in, 3]`` (a permute, no flip: both
    sides cross-correlate), everything else as
    ``weights.tree_state_from_jax`` keeps it (float leaves of two or more
    dims in ``dtype``)."""
    from ..engine.weights import tree_state_from_jax

    enc = dict(tree["encoder"])
    for name in ("conv1", "conv2"):
        conv = dict(enc[name])
        conv["weight"] = np.ascontiguousarray(np.transpose(conv.pop("kernel"), (2, 1, 0)))
        enc[name] = conv
    return tree_state_from_jax({**tree, "encoder": enc}, dtype)


# ---------------------------------------------------------------------------
# Servable
# ---------------------------------------------------------------------------

def decode_audio_payload(payload) -> np.ndarray:
    """WAV bytes (any rate, 8/16/32-bit, any channel count: averaged to
    mono) or ``{"array": [...], "rate": N}`` (16 kHz without ``rate``) →
    float32 mono 16 kHz waveform, resampled on the host (``ops/audio``)."""
    from ..ops.audio import TARGET_RATE, resample

    if isinstance(payload, dict) and "array" in payload:
        x = np.asarray(payload["array"], dtype=np.float32)
        return resample(x, int(payload.get("rate", TARGET_RATE)))
    if not isinstance(payload, (bytes, bytearray)):
        raise ValueError('send WAV bytes, {"b64": <WAV>} or {"array": [...], "rate": N}')
    import wave

    with wave.open(io.BytesIO(bytes(payload))) as w:
        raw = w.readframes(w.getnframes())
        width = w.getsampwidth()
        dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        x = np.frombuffer(raw, dtype=dt).astype(np.float32)
        x = (x - 128.0) / 128.0 if width == 1 else x / float(2 ** (8 * width - 1))
        if w.getnchannels() > 1:
            x = x.reshape(-1, w.getnchannels()).mean(-1)
        return resample(x, w.getframerate())


def whisper_params(cfg_model) -> tuple[dict, WhisperConfig]:
    """The float tree the builder loads (a checkpoint, its config read off
    its shapes, else the seeded init of TINY) and its config, with
    ``extra.arch``'s overrides."""
    from ..engine import weights as W

    arch = {k: int(v) for k, v in dict(cfg_model.extra.get("arch", {})).items()}
    if cfg_model.checkpoint:
        params = W.import_params(cfg_model.checkpoint, W.convert_whisper)
        cfg = dataclasses.replace(config_from_params(params), **arch)
    else:
        cfg = dataclasses.replace(TINY, **arch) if arch else TINY
    if cfg.vocab_size <= cfg.eot_id and "eot_id" not in arch:
        # A shrunk vocabulary (test archs): the control ids move into range.
        cfg = dataclasses.replace(cfg, eot_id=cfg.vocab_size - 2, sot_id=cfg.vocab_size - 1)
    if not cfg_model.checkpoint:
        params = init_whisper_params(0, cfg)
    return params, cfg


def make_whisper_servable(name: str, cfg_model):
    from ..engine import weights as W
    from ..engine.servable import Servable
    from ..ops.logmel import N_FRAMES, chunk_waveform, log_mel_spectrogram
    from .bert import resolve_dtype

    dtype = resolve_dtype(cfg_model.dtype)
    max_new = int(cfg_model.extra.get("max_new_tokens", 64))
    params, cfg = whisper_params(cfg_model)
    if str(cfg_model.extra.get("params_dtype", "")) == "int8":
        params = quantize_whisper(params, cfg.decoder_layers,
                                  int(cfg_model.extra.get("quantize_min_size", 1 << 16)))
        rest = torch.bfloat16  # the JAX lane holds every >= 2-D float leaf in bf16
    else:
        rest = torch.float32  # f32 at rest, cast at every use, as the JAX package
    module = W.ParamTree(state_from_jax(params, rest))
    # sot, en, transcribe, notimestamps: the multilingual vocabulary's task
    # prompt; English-only and test vocabularies take a bare SOT.
    default_prompt = ((cfg.sot_id, 50259, 50359, 50363) if cfg.vocab_size >= 51865
                      else (cfg.sot_id,))
    prompt_ids = tuple(int(t) for t in cfg_model.extra.get("prompt_ids", default_prompt))
    if len(prompt_ids) + max_new > cfg.target_positions:
        raise ValueError(f"{name}: the prompt ({len(prompt_ids)} tokens) and max_new_tokens "
                         f"({max_new}) exceed the decoder's {cfg.target_positions} positions")
    # A buffer, so a captured call reads the prompt on the device.
    module.register_buffer("prompt_ids", torch.tensor(prompt_ids, dtype=torch.int32),
                           persistent=False)
    module.eval()

    def apply_fn(m, inputs):
        tree = m.tree()
        mel = inputs["mel"]
        enc = encode(tree, mel, cfg, dtype)
        prompt = m.prompt_ids[None].expand(mel.shape[0], -1)
        return {"tokens": decode_greedy(tree, enc, prompt, max_new, cfg, dtype)}

    def input_spec(bucket):
        return {"mel": ((bucket[0], cfg.n_mels, N_FRAMES), torch.float32)}

    def preprocess(payload):
        """One request → one sample, or a list of samples (one per 30 s
        window) for longer audio; the server merges their results."""
        samples = [{"mel": log_mel_spectrogram(w)}
                   for w in chunk_waveform(decode_audio_payload(payload))]
        return samples[0] if len(samples) == 1 else samples

    def postprocess(out, i):
        toks = [int(t) for t in out["tokens"][i]]
        if cfg.eot_id in toks:
            toks = toks[: toks.index(cfg.eot_id)]
        return {"tokens": toks}

    def merge_results(results):
        """Per-window results, in order → one transcript."""
        return {"tokens": [t for r in results for t in r["tokens"]], "chunks": len(results)}

    # The continuous lane (:generate), GPT-2's contract: admission carries
    # one log-mel window (long audio belongs to :predict's chunk-and-merge)
    # and the fixed task prompt; one admission bucket.
    gen_slots = int(cfg_model.extra.get("gen_slots", 4))
    segment_tokens = int(cfg_model.extra.get("segment_tokens", 8))
    P = len(prompt_ids)
    total_self = P + max_new
    CL = cfg.source_positions

    def collate_admit(sample, bucket):
        return {"mel": np.asarray(sample["mel"], np.float32)[None],
                "length": np.asarray([P], np.int32),
                "temperature": np.asarray([sample.get("temperature", 0.0)], np.float32),
                "seed": np.asarray([sample.get("seed", 0)], np.int32),
                "top_k": np.asarray([sample.get("top_k", 0)], np.int32),
                "top_p": np.asarray([sample.get("top_p", 1.0)], np.float32)}

    def admit_spec(bucket):
        return {"mel": ((1, cfg.n_mels, N_FRAMES), torch.float32),
                "length": ((1,), torch.int32), "temperature": ((1,), torch.float32),
                "seed": ((1,), torch.int32), "top_k": ((1,), torch.int32),
                "top_p": ((1,), torch.float32)}

    def prefill_admit(tree, payload, gates: Gates = ALL_ON):
        mel = payload["mel"]
        prompt = tree["prompt_ids"][None].expand(mel.shape[0], -1)
        return prefill_continuous(tree, mel, prompt, total_self, cfg, dtype,
                                  temperature=payload["temperature"], seeds=payload["seed"],
                                  top_k=payload["top_k"], top_p=payload["top_p"], gates=gates)

    def segment(tree, ck, cv, tok, pos, st, fin, temp, seeds, topk, topp,
                gates: Gates = ALL_ON):
        return decode_segment(tree, ck, cv, tok, pos, st, fin, segment_tokens, cfg, dtype,
                              temperature=temp, seeds=seeds, top_k=topk, top_p=topp,
                              gates=gates)

    continuous = {
        "slots": gen_slots, "segment_tokens": segment_tokens, "total": total_self,
        "eos_id": cfg.eot_id, "max_new": max_new,
        "prompt_buckets": (1,), "admit_len_of": lambda s: 1,
        "collate_admit": collate_admit, "admit_spec": admit_spec,
        "cache_shape": (cfg.decoder_layers, gen_slots, CL + total_self, cfg.d_model),
        "cache_dtype": dtype, "prefill": prefill_admit, "segment": segment,
        "detokenize": None,
    }

    meta = {"max_new_tokens": max_new, "merge_results": merge_results,
            "continuous": continuous,
            # :predict decodes greedily; the server answers 400 to these
            # knobs rather than ignore them.
            "predict_ignores_sampling": ("temperature", "seed", "top_k", "top_p"),
            # The WAV decode, resample and log-mel of every body run off the
            # event loop.
            "heavy_preprocess": True,
            "config": cfg, "dtype": dtype, "prompt_ids": prompt_ids,
            # On a mesh: Megatron on both towers, whole heads a rank.
            "tp_rules": WHISPER_TP_RULES, "tp_heads": cfg.heads}
    return Servable(name=name, apply_fn=apply_fn, module=module, input_spec=input_spec,
                    preprocess=preprocess, postprocess=postprocess,
                    bucket_axes=("batch",), meta=meta)


from ..utils.registry import register_model, register_tree  # noqa: E402


@register_tree("whisper_tiny")
def whisper_tree(cfg_model) -> tuple[dict, dict]:
    from ..engine.weights import ShapeDraws

    params, cfg = whisper_params(cfg_model)
    return params, init_whisper_params(0, cfg, rng=ShapeDraws())


@register_model("whisper_tiny", latency_class="latency")
def build_whisper_tiny(cfg):
    return make_whisper_servable("whisper_tiny", cfg)
