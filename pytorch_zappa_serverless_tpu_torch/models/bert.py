"""BERT-base sequence classification (BASELINE config #3) in PyTorch.

Embeddings (word + position + segment, LayerNorm) → post-LN encoder layers
(multi-head attention, exact-erf GELU FFN) → pooler (tanh on [CLS]) →
classifier.  Numerics follow the JAX package's ``models/bert.py``:

- f32 params, compute in ``dtype``; LayerNorm and softmax in f32 on the
  residual sum taken in ``dtype``;
- attention as two batched products with f32 scores and a finite additive
  ``(1 - mask) * -1e9`` bias, so a padded row matches an unpadded run and a
  fully masked row stays finite;
- pooler and classifier in f32 on ``x[:, 0]``.

``bert_embed`` is the same encoder serving sentence embeddings: the last
hidden states mean-pooled over the real tokens (mask-aware) in f32 and
L2-normalised, ``{"embedding": [...]}``.

With ``extra.params_dtype: int8`` the six encoder projections of every layer
are :class:`Int8Dense` (W8A16, ``ops/int8_matmul``); embeddings, norms,
pooler and classifier stay float.  Submodule names are the flax names
(``layer{i}.attention.query``, ``attention_output``, ``attention_ln``,
``intermediate``, ``output``, ``output_ln``, ``embeddings_ln``, ``pooler``,
``classifier``), so ``engine.weights.params_from_jax`` is a rename plus a
transpose.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_matmul import dense_maybe_int8, int8_matmul, quantize_tree

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; one of {sorted(_DTYPES)}") from None


class Dense(nn.Module):
    """``nn.Dense`` of the JAX package: f32 ``weight [out, in]`` at rest; the
    input, weight and bias are cast to ``dtype`` and the bias is added after
    the product."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_features), requires_grad=False)
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        return F.linear(x, self.weight.to(self.dtype)) + self.bias.to(self.dtype)


class Int8Dense(nn.Module):
    """W8A16 projection: ``kernel_q`` int8 ``[in, out]`` + per-output
    ``scale`` (the kernel's layout), f32 bias.

    ``matmul`` is :func:`int8_matmul`; a check may set it to
    ``int8_matmul_reference`` to hold a served forward against the plain
    version on the same weights and inputs.
    """

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("kernel_q", torch.empty(in_features, out_features,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.empty(out_features))
        self.bias = nn.Parameter(torch.empty(out_features), requires_grad=False)
        self.dtype = dtype
        self.matmul = int8_matmul

    def forward(self, x):
        return dense_maybe_int8({"kernel_q": self.kernel_q, "scale": self.scale,
                                 "bias": self.bias}, x.to(self.dtype),
                                matmul=self.matmul)


def _dense(quantized: bool, i: int, o: int, dtype: torch.dtype) -> nn.Module:
    return (Int8Dense if quantized else Dense)(i, o, dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, dtype: torch.dtype,
                 quantized: bool = False):
        super().__init__()
        d = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.query = _dense(quantized, d, d, dtype)
        self.key = _dense(quantized, d, d, dtype)
        self.value = _dense(quantized, d, d, dtype)
        self.dtype = dtype

    def forward(self, x, mask_bias):
        B, S, _ = x.shape
        q, k, v = (m(x).view(B, S, self.num_heads, self.head_dim).transpose(1, 2)
                   for m in (self.query, self.key, self.value))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(self.head_dim)
        probs = (scores.float() + mask_bias).softmax(-1).to(self.dtype)
        return (probs @ v).transpose(1, 2).reshape(B, S, -1)


class BertLayer(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, mlp_dim: int,
                 dtype: torch.dtype, ln_eps: float = 1e-12, quantized: bool = False):
        super().__init__()
        d = num_heads * head_dim
        self.attention = BertSelfAttention(num_heads, head_dim, dtype, quantized)
        self.attention_output = _dense(quantized, d, d, dtype)
        self.attention_ln = nn.LayerNorm(d, eps=ln_eps)
        self.intermediate = _dense(quantized, d, mlp_dim, dtype)
        self.output = _dense(quantized, mlp_dim, d, dtype)
        self.output_ln = nn.LayerNorm(d, eps=ln_eps)
        self.dtype = dtype

    def forward(self, x, mask_bias):
        attn = self.attention_output(self.attention(x, mask_bias))
        x = self.attention_ln((x + attn).float()).to(self.dtype)
        h = self.output(F.gelu(self.intermediate(x)))
        return self.output_ln((x + h).float()).to(self.dtype)


class BertClassifier(nn.Module):
    def __init__(self, vocab_size: int = 30522, max_position: int = 512,
                 type_vocab_size: int = 2, num_layers: int = 12,
                 num_heads: int = 12, head_dim: int = 64, mlp_dim: int = 3072,
                 num_labels: int = 2, dtype: torch.dtype = torch.bfloat16,
                 ln_eps: float = 1e-12, quantized: bool = False):
        super().__init__()
        d = num_heads * head_dim
        self.shapes = {"vocab_size": vocab_size, "max_position": max_position,
                       "type_vocab_size": type_vocab_size, "num_layers": num_layers,
                       "d": d, "mlp_dim": mlp_dim, "num_labels": num_labels}
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(vocab_size, d)
        self.position_embeddings = nn.Embedding(max_position, d)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, d)
        self.embeddings_ln = nn.LayerNorm(d, eps=ln_eps)
        self.layers = [f"layer{i}" for i in range(num_layers)]
        for name in self.layers:
            self.add_module(name, BertLayer(num_heads, head_dim, mlp_dim, dtype,
                                            ln_eps, quantized))
        self.pooler = Dense(d, d, torch.float32)
        self.classifier = Dense(d, num_labels, torch.float32)

    def forward(self, input_ids, attention_mask, token_type_ids, return_hidden: bool = False):
        """All inputs int32 [B, S]; returns f32 logits [B, num_labels], or
        with ``return_hidden`` the last hidden states [B, S, D]."""
        dt = self.dtype
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos)[None].to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt))
        x = self.embeddings_ln(x.float()).to(dt)
        # [B, S] 1/0 -> additive bias broadcast over heads and queries.
        mask_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for name in self.layers:
            x = getattr(self, name)(x, mask_bias)
        if return_hidden:
            return x
        pooled = torch.tanh(self.pooler(x[:, 0].float()))
        return self.classifier(pooled)


def init_params(model: BertClassifier, seed: int = 0) -> dict:
    """A seed-initialised float param tree in the JAX package's layout.

    N(0, 0.02) weights and embeddings (BERT's own initializer range), zero
    biases, unit LayerNorm scales, drawn from a ``torch.Generator``.  It does
    not reproduce the JAX package's ``jax.random.key(0)`` init; parity tests
    carry the JAX tree across with ``params_from_jax`` instead.
    """
    g = torch.Generator().manual_seed(seed)
    s = model.shapes
    d, f = s["d"], s["mlp_dim"]

    def normal(*shape):
        return (torch.randn(*shape, generator=g) * 0.02).numpy()

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": np.zeros(o, np.float32)}

    def ln():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    tree = {"word_embeddings": {"embedding": normal(s["vocab_size"], d)},
            "position_embeddings": {"embedding": normal(s["max_position"], d)},
            "token_type_embeddings": {"embedding": normal(s["type_vocab_size"], d)},
            "embeddings_ln": ln()}
    for name in model.layers:
        tree[name] = {
            "attention": {k: dense(d, d) for k in ("query", "key", "value")},
            "attention_output": dense(d, d), "attention_ln": ln(),
            "intermediate": dense(d, f), "output": dense(f, d), "output_ln": ln()}
    tree["pooler"] = dense(d, d)
    tree["classifier"] = dense(d, s["num_labels"])
    return tree


# ---------------------------------------------------------------------------
# Servable
# ---------------------------------------------------------------------------

def _fallback_tokenize(text: str, vocab_size: int) -> list[int]:
    """Deterministic offline tokenizer stub: whitespace words hashed into the
    wordpiece id space (the JAX package's, id for id).  Unbounded — the
    servable's ``_fit`` applies the over-length policy."""
    import hashlib

    lo = 1000 if vocab_size > 2000 else 103
    span = max(vocab_size - lo, 1)
    ids = [101]  # [CLS]
    for w in text.lower().split():
        h = int(hashlib.md5(w.encode()).hexdigest(), 16)
        ids.append(lo + h % span)
    ids.append(102)  # [SEP]
    return ids


def meta_model(cfg, quantized: bool = False) -> BertClassifier:
    """The classifier on the meta device (its weights arrive with
    ``load_state_dict``); ``extra.arch`` overrides the architecture (tiny
    variants for tests)."""
    arch = {k: int(v) for k, v in dict(cfg.extra.get("arch", {})).items()}
    with torch.device("meta"):
        return BertClassifier(num_labels=int(cfg.extra.get("num_labels", 2)),
                              dtype=resolve_dtype(cfg.dtype), quantized=quantized, **arch)


def bert_tree(cfg) -> tuple[dict, BertClassifier]:
    """The float tree the builder loads (a checkpoint, else the seeded init)
    and the float classifier on meta it fits."""
    from ..engine import weights as W

    model = meta_model(cfg)
    if cfg.checkpoint:
        return W.import_params(cfg.checkpoint, W.convert_bert), model
    return init_params(model), model


def make_bert_servable(name: str, cfg):
    from ..engine import weights as W
    from ..engine.servable import Servable

    num_labels = int(cfg.extra.get("num_labels", 2))
    labels = cfg.extra.get("labels") or [f"label_{i}" for i in range(num_labels)]
    max_seq = max(cfg.seq_buckets)
    int8 = str(cfg.extra.get("params_dtype", "")) == "int8"
    params, _ = bert_tree(cfg)
    model = meta_model(cfg, quantized=int8)
    if int8:
        # W8A16 lane: encoder projection kernels -> int8 + per-column scale
        # (the JAX package's rewrite, byte for byte); everything outside
        # layer{i} stays float.
        params = {k: (quantize_tree(v, min_size=1) if k.startswith("layer") else v)
                  for k, v in params.items()}
    model.load_state_dict(W.params_from_jax(params), assign=True)
    model.eval()

    tokenizer = None
    tok_path = cfg.extra.get("tokenizer")
    if tok_path:
        from tokenizers import Tokenizer

        tokenizer = Tokenizer.from_file(str(tok_path))
    vocab_size = model.shapes["vocab_size"]
    embed = bool(cfg.extra.get("embed", False))

    def apply_fn(module, inputs):
        if embed:
            hidden = module(inputs["input_ids"], inputs["attention_mask"],
                            inputs["token_type_ids"], return_hidden=True)
            mask = inputs["attention_mask"].float()[:, :, None]
            pooled = (hidden.float() * mask).sum(1) / mask.sum(1).clamp(min=1.0)
            norm = (pooled * pooled).sum(-1, keepdim=True).clamp(min=1e-12).sqrt()
            return {"embedding": pooled / norm}  # [B, D] unit vectors
        logits = module(inputs["input_ids"], inputs["attention_mask"],
                        inputs["token_type_ids"])
        return {"probs": logits.softmax(-1)}  # [B, num_labels]: one small fetch

    def input_spec(bucket):
        b, s = bucket
        return {k: ((b, s), torch.int32)
                for k in ("input_ids", "attention_mask", "token_type_ids")}

    # Over-length policy (extra.overlength): "truncate" keeps the head;
    # "error" turns an over-bucket input into a clean 400 at preprocess.
    overlength = str(cfg.extra.get("overlength", "truncate"))
    if overlength not in ("truncate", "error"):
        raise ValueError(f"{name}: extra.overlength must be 'truncate' or "
                         f"'error', got {overlength!r}")

    def _fit(ids: list[int]) -> list[int]:
        if len(ids) > max_seq:
            if overlength == "error":
                raise ValueError(
                    f"input is {len(ids)} tokens but the longest configured "
                    f"seq bucket is {max_seq}; send a shorter input or serve "
                    f"with a larger seq bucket")
            ids = ids[:max_seq]
        return ids

    def preprocess(payload):
        if isinstance(payload, dict) and "input_ids" in payload:
            ids = _fit([int(i) for i in payload["input_ids"]])
        else:
            text = payload["text"] if isinstance(payload, dict) else str(payload)
            if tokenizer is not None:
                ids = _fit(tokenizer.encode(text).ids)
            else:
                ids = _fit(_fallback_tokenize(text, vocab_size))
        ids = np.asarray(ids, dtype=np.int32)
        if ids.size and (ids.min() < 0 or ids.max() >= vocab_size):
            # Checked on the host: an out-of-range gather on the GPU is a
            # device-side assert that poisons the CUDA context for every
            # later request.
            raise ValueError(f"input_ids must lie in [0, {vocab_size}); got "
                             f"{int(ids.min())}..{int(ids.max())}")
        return {"input_ids": ids,
                "attention_mask": np.ones_like(ids),
                "token_type_ids": np.zeros_like(ids)}

    def postprocess(out, i):
        if embed:
            return {"embedding": out["embedding"][i].astype(float).tolist()}
        probs = out["probs"][i]
        order = np.argsort(probs)[::-1]
        return {"scores": [{"label": str(labels[int(j)]), "prob": float(probs[int(j)])}
                           for j in order]}

    return Servable(
        name=name, apply_fn=apply_fn, module=model, input_spec=input_spec,
        preprocess=preprocess, postprocess=postprocess,
        bucket_axes=("batch", "seq"),
        meta={"seq_len_of": lambda s: int(s["input_ids"].shape[0]),
              "num_labels": num_labels})


from ..utils.registry import register_model, register_tree  # noqa: E402

register_tree("bert_base", "bert_embed")(bert_tree)


@register_model("bert_base", latency_class="latency")
def build_bert_base(cfg):
    return make_bert_servable("bert_base", cfg)


@register_model("bert_embed", latency_class="latency")
def build_bert_embed(cfg):
    """The embeddings lane: the same encoder, mean-pooled unit vectors out.
    A copy of the config carries ``embed``: the caller's may be shared."""
    import dataclasses

    return make_bert_servable("bert_embed", dataclasses.replace(
        cfg, extra={**cfg.extra, "embed": True}))
