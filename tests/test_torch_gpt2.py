"""The port's GPT-2 (pytorch_zappa_serverless_tpu_torch/models/gpt2.py) held
against the JAX package's on the same weights and inputs.

Weights are the JAX package's seed tree (``init_gpt2_params``, which the port
must reproduce byte for byte) or a ``transformers`` checkpoint; inputs come
from a numpy seed.  Archs: tests/test_gpt2_parity.py's (32 wide, 2 layers)
and tests/test_gpt2_int8.py's (128 wide).  Tolerances:

- f32 on both sides: logits within 1e-4 (the summation orders of XLA and
  PyTorch on the CPU), token chains identical;
- the int8 lane in bf16: prefill logits within 2e-2 of the largest logit,
  the bf16 roundings of the two frameworks' unfused products, as
  tests/test_gpt2_int8.py holds the TPU lane;
- the fused bench step against the unfused step (bf16): logits within
  5e-2 of the largest, because the fused step keeps P·V in f32 where the
  unfused one rounds P to bf16 first.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu import models as _jax_zoo  # noqa: F401
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.models import gpt2 as JG
from pytorch_zappa_serverless_tpu.utils.registry import get_model_builder as j_builder
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig as PModelConfig
from pytorch_zappa_serverless_tpu_torch.config import ServeConfig as PServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.models import gpt2 as PG
from pytorch_zappa_serverless_tpu_torch.ops import sampling as PS
from pytorch_zappa_serverless_tpu_torch.ops.int8_matmul import int8_matmul
from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as B
from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder as p_builder

TINY = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128, "vocab_size": 500,
        "max_positions": 64}
INT8_ARCH = {"vocab_size": 512, "d_model": 128, "layers": 2, "heads": 2, "ffn_dim": 256,
             "max_positions": 64, "eos_id": 511}


def _cfg(arch=TINY, **over):
    cfg = dataclasses.replace(JG.SMALL, **arch, **over)
    if cfg.eos_id >= cfg.vocab_size:
        cfg = dataclasses.replace(cfg, eos_id=cfg.vocab_size - 1)
    return cfg


def _pcfg(jcfg):
    return PG.GPT2Config(**dataclasses.asdict(jcfg))


def _trees(cfg, seed=0):
    np_params = JG.init_gpt2_params(seed, cfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    pp = PW.ParamTree(PW.tree_state_from_jax(np_params, torch.float32)).tree()
    return jp, pp


def _ragged(B_, P_, vocab, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab - 1, (B_, P_)).astype(np.int32)
    lengths = np.asarray(lengths if lengths is not None
                         else rng.integers(1, P_ + 1, (B_,)), np.int32)
    toks[np.arange(P_)[None, :] >= lengths[:, None]] = 0
    return toks, lengths


@pytest.mark.parametrize("arch,seed", [(TINY, 0), (TINY, 3), (INT8_ARCH, 0)])
def test_init_params_byte_identical(arch, seed):
    cfg = _cfg(arch)
    want = JG.init_gpt2_params(seed, cfg)
    got = PG.init_gpt2_params(seed, _pcfg(cfg))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert PG.config_from_params(got) == PG.GPT2Config(
        **dataclasses.asdict(JG.config_from_params(want)))


def test_prefill_ragged_matches_jax():
    cfg = _cfg()
    jp, pp = _trees(cfg)
    toks, lengths = _ragged(3, 8, cfg.vocab_size, lengths=[5, 3, 8])
    jl, jk, jv = jax.jit(lambda p, t, l: JG.prefill(p, t, l, 12, cfg, jnp.float32))(
        jp, toks, lengths)
    pl, pk, pv = PG.prefill(pp, torch.from_numpy(toks), torch.from_numpy(lengths), 12,
                            _pcfg(cfg), torch.float32)
    assert pl.shape == (3, cfg.vocab_size) and pk.shape == (2, 3, 12, 32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def _generate_both(cfg, toks, lengths, max_new, temperature=None, seeds=None, top_k=None,
                   top_p=None, rep=None, seed=0):
    jp, pp = _trees(cfg, seed)
    B_ = toks.shape[0]
    temperature = np.zeros(B_, np.float32) if temperature is None else temperature
    seeds = np.zeros(B_, np.int32) if seeds is None else seeds
    opt_j = (lambda a: None if a is None else jnp.asarray(a))
    opt_p = (lambda a: None if a is None else torch.from_numpy(a))
    want = np.asarray(jax.jit(lambda p: JG.generate(
        p, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(temperature),
        jnp.asarray(seeds), max_new, cfg, jnp.float32, top_k=opt_j(top_k),
        top_p=opt_j(top_p), repetition_penalty=opt_j(rep)))(jp))
    got = PG.generate(pp, torch.from_numpy(toks), torch.from_numpy(lengths),
                      torch.from_numpy(temperature), torch.from_numpy(seeds), max_new,
                      _pcfg(cfg), torch.float32, top_k=opt_p(top_k), top_p=opt_p(top_p),
                      repetition_penalty=opt_p(rep)).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_jax(seed):
    cfg = _cfg()
    toks, lengths = _ragged(4, 8, cfg.vocab_size, seed=seed)
    got, want = _generate_both(cfg, toks, lengths, 6, seed=seed)
    assert got.dtype == np.int32 and got.shape == (4, 6)
    np.testing.assert_array_equal(got, want)
    one = PG.generate_greedy(_trees(cfg, seed)[1], torch.from_numpy(toks[:1]),
                             torch.from_numpy(lengths[:1]), 6, _pcfg(cfg), torch.float32)
    np.testing.assert_array_equal(one.numpy()[0], got[0])  # a row alone = in its batch


def test_repetition_penalty_generate_matches_jax():
    cfg = _cfg()
    toks, lengths = _ragged(3, 8, cfg.vocab_size, seed=4)
    rep = np.array([1.0, 1.5, 0.8], np.float32)
    got, want = _generate_both(cfg, toks, lengths, 6, rep=rep)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's Gumbel draws replaced by JAX's own for each (seed, step)."""
    def noise(seeds, t, V, device):
        return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
            jax.random.fold_in(jax.random.key(int(s)), int(tt)), (V,), jnp.float32))
            for s, tt in zip(seeds.tolist(), t.tolist())])).to(device)

    monkeypatch.setattr(PS, "gumbel_noise", noise)


def test_sampled_generate_matches_jax_draws(jax_noise):
    cfg = _cfg()
    toks, lengths = _ragged(4, 8, cfg.vocab_size, seed=5)
    got, want = _generate_both(
        cfg, toks, lengths, 6, temperature=np.array([0.8, 0.0, 1.2, 1.0], np.float32),
        seeds=np.array([7, 7, 3, 11], np.int32), top_k=np.array([40, 0, 0, 5], np.int32),
        top_p=np.array([0.95, 1.0, 0.9, 1.0], np.float32),
        rep=np.array([1.0, 1.0, 1.2, 1.0], np.float32))
    np.testing.assert_array_equal(got, want)


def test_decode_segment_slot_pool_matches_jax():
    """A pool of 4 slots at ragged positions and step counters, one already
    finished, advanced 5 steps; then again with EOS set to a token one row
    emits, so a slot finishes inside the segment."""
    cfg = _cfg()
    jp, pp = _trees(cfg)
    toks, lengths = _ragged(4, 8, cfg.vocab_size, seed=6, lengths=[8, 2, 5, 7])
    total = 16

    def run(cfg):
        jl, jk, jv = JG.prefill(jp, jnp.asarray(toks), jnp.asarray(lengths), total, cfg,
                                jnp.float32)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        state = (tok, lengths, np.array([0, 3, 1, 0], np.int32),
                 np.array([False, False, True, False]))
        temp, seeds = np.zeros(4, np.float32), np.zeros(4, np.int32)
        want = JG.decode_segment(jp, jk, jv, *map(jnp.asarray, state), jnp.asarray(temp),
                                 jnp.asarray(seeds), 5, cfg, jnp.float32)
        _, pk, pv = PG.prefill(pp, torch.from_numpy(toks), torch.from_numpy(lengths), total,
                               _pcfg(cfg), torch.float32)
        got = PG.decode_segment(pp, pk, pv, *map(torch.from_numpy, state),
                                torch.from_numpy(temp), torch.from_numpy(seeds), 5,
                                _pcfg(cfg), torch.float32)
        assert got[1] is pk and got[2] is pv  # the caches, updated in place
        for name, g, w in zip(("emits", "cache_k", "cache_v", "tok", "pos", "step",
                               "finished"), got, want):
            if name.startswith("cache"):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        return got[0].numpy(), got[6].numpy()

    emits, finished = run(cfg)
    assert (emits[2] == cfg.eos_id).all() and finished[2]
    eos = int(emits[0, 2])  # row 0 emits it at step 2: it finishes there
    emits, finished = run(dataclasses.replace(cfg, eos_id=eos))
    assert finished[0] and (emits[0, 2:] == eos).all()


def _build(make, mc_cls, arch, **extra):
    mc = mc_cls(name="gpt2", dtype=extra.pop("dtype", "float32"), seq_buckets=(16,),
                batch_buckets=extra.pop("batch_buckets", (2,)),
                extra={"max_new_tokens": 8, "arch": arch, **extra})
    return make("gpt2")(mc), mc


@pytest.fixture(scope="module")
def int8_pair():
    kw = dict(dtype="bfloat16", params_dtype="int8", quantize_min_size=1024)
    jsv, _ = _build(j_builder, JModelConfig, INT8_ARCH, **dict(kw))
    psv, _ = _build(p_builder, PModelConfig, INT8_ARCH, **dict(kw))
    return jsv, psv


def test_int8_tree_matches_jax(int8_pair):
    jsv, psv = int8_pair
    got = psv.module.tree()
    want = jax.tree.map(np.asarray, jsv.params)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, want))
    for path in (("layer0", "qkv", "kernel_q"), ("layer1", "fc2", "scale"), ("lm_q",),
                 ("lm_scale",)):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert g.numpy().tobytes() == w.tobytes(), path
    assert got["lm_q"].shape == (128, 512) and got["layer0"]["qkv"]["kernel_q"].is_contiguous()
    assert got["wte"].dtype == torch.bfloat16 and got["ln_f"]["scale"].dtype == torch.float32


def test_int8_prefill_matches_jax_int8_lane(int8_pair):
    """The int8 lane's prefill logits (the four fused projections per layer
    and the lm head through the int8 product) against the JAX lane's, whose
    int8 product is its Pallas kernel in interpret mode."""
    jsv, psv = int8_pair
    cfg = psv.meta["config"]
    jcfg = JG.GPT2Config(**dataclasses.asdict(cfg))
    toks, lengths = _ragged(2, 16, cfg.vocab_size, seed=7, lengths=[16, 9])
    want = np.asarray(jax.jit(lambda p: JG.prefill(p, jnp.asarray(toks), jnp.asarray(lengths),
                                                   24, jcfg, jnp.bfloat16)[0])(jsv.params))
    got = PG.prefill(psv.module.tree(), torch.from_numpy(toks), torch.from_numpy(lengths), 24,
                     cfg, torch.bfloat16)[0].numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


def test_int8_lane_goes_through_int8_matmul(int8_pair, monkeypatch):
    """49 int8 products per forward position step at 12 layers: here 4 per
    layer plus the lm head, counted through the seam a check uses."""
    _, psv = int8_pair
    calls = []

    def counting(x, w_q, scale, **kw):
        calls.append(tuple(w_q.shape))
        return int8_matmul(x, w_q, scale, **kw)

    monkeypatch.setattr(PG, "int8_mm", counting)
    cfg = psv.meta["config"]
    toks, lengths = _ragged(2, 16, cfg.vocab_size, seed=8)
    z = torch.zeros(2)
    PG.generate(psv.module.tree(), torch.from_numpy(toks), torch.from_numpy(lengths), z,
                z.int(), 3, cfg, torch.bfloat16)
    per_step = 4 * cfg.layers + 1
    assert len(calls) == (1 + 3) * per_step
    assert calls[:5] == [(128, 384), (128, 128), (128, 256), (256, 128), (128, 384)]
    assert calls[per_step - 1] == (128, 512)  # the lm head, last of each step


def _hf_state_dict(cfg):
    from transformers import GPT2Config as HFConfig
    from transformers import GPT2LMHeadModel

    torch.manual_seed(0)
    hf = GPT2LMHeadModel(HFConfig(vocab_size=cfg.vocab_size, n_positions=cfg.max_positions,
                                  n_embd=cfg.d_model, n_layer=cfg.layers, n_head=cfg.heads,
                                  n_inner=cfg.ffn_dim))
    return hf.state_dict()


def test_convert_gpt2_matches_jax(tmp_path):
    from pytorch_zappa_serverless_tpu.engine import weights as JW

    cfg = _cfg()
    sd = _hf_state_dict(cfg)
    np_sd = {k: v.detach().numpy() for k, v in sd.items()}
    got, want = PW.convert_gpt2(np_sd), JW.convert_gpt2(np_sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # checkpoint: a .pt state dict through both servables, the same greedy tokens
    path = tmp_path / "gpt2.pt"
    torch.save(sd, path)
    arch = {"heads": cfg.heads}
    jsv, jmc = _build(j_builder, JModelConfig, arch)
    psv, pmc = _build(p_builder, PModelConfig, arch)
    jmc.checkpoint = pmc.checkpoint = str(path)
    jsv, psv = j_builder("gpt2")(jmc), p_builder("gpt2")(pmc)
    assert psv.meta["config"].d_model == 32 and psv.meta["config"].vocab_size == 500
    samples = [jsv.preprocess({"input_ids": [5, 6, 7, 8, 9]}),
               jsv.preprocess({"input_ids": [40, 41]})]
    np.testing.assert_array_equal(_tokens_port(psv, samples), _tokens_jax(jsv, samples))


def _tokens_jax(jsv, samples, bucket=(2, 16)):
    batch = jsv.meta["collate"](samples, bucket, jsv.input_spec(bucket))
    return np.asarray(jax.jit(jsv.apply_fn)(jsv.params, batch)["tokens"])[:len(samples)]


def _tokens_port(psv, samples, bucket=(2, 16)):
    spec = psv.input_spec(bucket)
    batch = psv.meta["collate"](samples, bucket, spec)
    with torch.inference_mode():
        out = psv.apply_fn(psv.module, {k: torch.from_numpy(v) for k, v in batch.items()})
    return out["tokens"].numpy()[:len(samples)]


def test_servable_io_matches_jax():
    jsv, _ = _build(j_builder, JModelConfig, TINY)
    psv, _ = _build(p_builder, PModelConfig, TINY)
    payloads = [{"text": "hello there world"}, {"input_ids": [1, 2, 3]}, "a plain body",
                {"text": "x y", "temperature": 0.7, "seed": 3, "top_k": 4, "top_p": 0.9,
                 "repetition_penalty": 1.2}, {"input_ids": []}]
    for p in payloads:
        got, want = psv.preprocess(p), jsv.preprocess(p)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert psv.meta["seq_len_of"](psv.preprocess(payloads[0])) == 3
    assert psv.meta["max_new_tokens"] == jsv.meta["max_new_tokens"] == 8
    out = {"tokens": np.array([[5, 6, 499, 7], [1, 2, 3, 4]], np.int32)}
    for i in range(2):
        assert json.dumps(psv.postprocess(out, i)) == json.dumps(jsv.postprocess(out, i))
    for text in ["", "The quick brown fox", "a " * 100, "Ünïcode"]:
        assert PG._fallback_tokenize(text, 500) == JG._fallback_tokenize(text, 500)
    with pytest.raises(ValueError, match="input_ids must lie in"):
        psv.preprocess({"input_ids": [1, 500]})


def test_overlength_matches_jax():
    for policy in ("error", "truncate"):
        jsv, _ = _build(j_builder, JModelConfig, TINY, overlength=policy)
        psv, _ = _build(p_builder, PModelConfig, TINY, overlength=policy)
        if policy == "error":
            for sv in (jsv, psv):
                with pytest.raises(ValueError, match="longest configured seq bucket is 16"):
                    sv.preprocess({"input_ids": list(range(17))})
        else:
            got = psv.preprocess({"input_ids": list(range(1, 21))})["input_ids"]
            want = jsv.preprocess({"input_ids": list(range(1, 21))})["input_ids"]
            np.testing.assert_array_equal(got, want)
            assert got[0] == 5


@pytest.mark.parametrize("extra,match", [
    ({"params_dtype": "int8", "adapter_slots": 2}, "cannot combine with params_dtype='int8'"),
    ({"params_dtype": "auto", "adapter_slots": 2}, "cannot combine with params_dtype='auto'"),
    ({"adapter_slots": 2, "adapter_targets": ("q", "lm_head")}, "unknown adapter_targets"),
    ({"params_dtype": "auto", "int8_crossover_batch": 32}, None),
    ({"max_new_tokens": 60}, "exceeds the model's max_positions"),
    ({"overlength": "drop"}, "overlength"),
])
def test_servable_refuses_what_the_port_lacks(extra, match):
    """The build refusals the port shares with the JAX package, each
    refused by both with the same words; and the regime-routed lane, which
    the port now builds (the dual tree: bf16 beside int8, the shared
    leaves held once, in the bf16 tree)."""
    fields = {k: extra.pop(k) for k in ("adapter_slots", "adapter_targets") if k in extra}
    quantized = bool(extra.get("params_dtype"))
    arch = INT8_ARCH if quantized else TINY

    def build(make, mc_cls):
        mc = mc_cls(name="gpt2", dtype="bfloat16" if quantized else "float32",
                    seq_buckets=(16,), batch_buckets=(2,), **fields,
                    extra={"max_new_tokens": 8, "arch": arch, "quantize_min_size": 1024,
                           **extra})
        return make("gpt2")(mc)

    if match is None:
        psv = build(p_builder, PModelConfig)
        assert set(psv.module._modules) == {"bf16", "int8"}
        tree = psv.module.tree()
        assert tree["int8"]["layer0"]["qkv"]["kernel_q"].dtype == torch.int8
        assert "qkv" not in tree["bf16"]["layer0"] and "wte" not in tree["int8"]
        dec = psv.meta["dec_tree"](tree, 32)
        assert dec["wte"] is tree["bf16"]["wte"] and "qkv" in dec["layer0"]
        assert psv.meta["dec_tree"](tree, 33) is tree["bf16"]
        return
    for builder, mcfg in ((j_builder, JModelConfig), (p_builder, PModelConfig)):
        with pytest.raises(ValueError, match=match):
            build(builder, mcfg)


def test_predict_through_engine_and_server_matches_jax():
    """:predict through build_engine(device="cpu") and the port's HTTP server:
    one request, and three ragged instances in one body, answer with the
    JAX servable's tokens."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    mc = PModelConfig(name="gpt2", dtype="float32", seq_buckets=(16,), batch_buckets=(1, 4),
                      extra={"max_new_tokens": 8, "arch": TINY})
    cfg = PServeConfig(models=[mc])
    engine = build_engine(cfg, device="cpu")
    jsv, _ = _build(j_builder, JModelConfig, TINY, batch_buckets=(1, 4))
    bodies = [{"input_ids": [3, 1, 4, 1, 5, 9, 2, 6]},
              {"instances": [{"text": "the cat sat on the mat"}, {"input_ids": [10, 20]},
                             {"input_ids": list(range(30, 46))}]}]

    def post(port, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/gpt2:predict",
                                     data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        with BackgroundServer(cfg, engine) as srv:
            answers = [post(srv.port, b) for b in bodies]
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/models") as r:
                assert "gpt2" in json.loads(r.read())["models"]
    finally:
        engine.shutdown()
    for body, out in zip(bodies, answers):
        instances = body.get("instances", [body])
        preds = out["predictions"] if "instances" in body else [out["predictions"]]
        samples = [jsv.preprocess(p) for p in instances]
        bucket = (1, 16) if len(samples) == 1 else (4, 16)
        batch = jsv.meta["collate"](samples, bucket, jsv.input_spec(bucket))
        toks = np.asarray(jax.jit(jsv.apply_fn)(jsv.params, batch)["tokens"])
        want = [jsv.postprocess({"tokens": toks}, i) for i in range(len(samples))]
        assert preds == want
        assert all(len(p["tokens"]) <= 8 for p in preds)


def _bench_case(int8: bool):
    """Two-row pool of the narrow model: prefill, then per-layer caches for
    the fused step and serving caches for the unfused one, same weights."""
    cfg = _pcfg(_cfg(INT8_ARCH))
    params = PG.init_gpt2_params(0, cfg)
    tree = B.to_device(B.int8_tree(params, cfg.layers) if int8
                       else PG.fuse_qkv(params, cfg.layers), "cpu")
    toks, lengths = B.prompts(cfg, rows=3, bucket=16)
    toks, lengths = torch.from_numpy(toks), torch.from_numpy(lengths)
    _, ck, cv = PG.prefill(tree, toks, lengths, 24, cfg, torch.bfloat16)
    return cfg, tree, ck, cv, lengths


@pytest.mark.parametrize("int8", [False, True])
def test_bench_fused_step_matches_unfused_step(int8):
    """The bench's fused step against the unfused serving step on the same
    weights, teacher-forced for 4 steps (both fed the unfused step's greedy
    token): per-step logits within 5e-2 of the largest, and the caches the
    fused kernels write hold the unfused step's K/V."""
    cfg, tree, ck, cv, pos = _bench_case(int8)
    cks, cvs = B.per_layer(ck), B.per_layer(cv)
    tok = torch.tensor([7, 300, 42], dtype=torch.int32)
    fn = B.fused_step_int8 if int8 else B.fused_step
    for _ in range(4):
        want = PG.decode_step(tree, ck, cv, tok, pos, cfg, torch.bfloat16)
        nxt, got = fn(tree, cks, cvs, tok, pos, cfg)
        assert got.shape == want.shape == (3, cfg.vocab_size)
        err = (got - want).abs().max() / want.abs().max()
        assert err <= 5e-2, err
        assert torch.equal(nxt, got.argmax(-1).to(torch.int32))
        rows = torch.arange(3)
        for i in range(cfg.layers):
            torch.testing.assert_close(cks[i][pos.long(), rows].float(),
                                       ck[i, rows, pos.long()].float(), rtol=2e-2, atol=2e-2)
        tok, pos = want.argmax(-1).to(torch.int32), pos + 1


def test_bench_lanes_on_cpu():
    """The bench's three lanes at a narrow width on the CPU (a multiple of 128,
    as the padded int8 lm head needs): each builds, steps, and times; the
    fused lanes' per-layer caches are [T, S, D]."""
    cfg = _pcfg(_cfg(INT8_ARCH))
    lanes = B.build_lanes(cfg, "cpu")
    assert sorted(lanes) == ["fused", "fused_int8", "seg1"]
    assert lanes["fused"].ck[0].shape == (B.T, B.S, cfg.d_model)
    assert lanes["seg1"].ck.shape == (cfg.layers, B.S, B.T, cfg.d_model)
    for lane in lanes.values():
        emit = B.step(lane, cfg)
        assert emit.shape == (B.S,) and emit.dtype == torch.int32
        assert B.time_lane(lane, cfg, steps=1, reps=1) > 0
    assert B.main(["--platform", "cpu", "--arch", json.dumps(INT8_ARCH), "--steps", "1"]) == 0


def test_bench_needs_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.main(["--steps", "1"])
