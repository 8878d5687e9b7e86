"""Speculative decoding in the port against the JAX package, on the CPU at a
tiny GPT-2 (2 layers, width 32, fp32; ``gen_slots`` 2, ``kv_block_size`` 4).

- ``speculative_verify``: greedy rows give JAX's accepted counts and output
  tokens exactly; sampled rows too when the core is handed JAX's draws
  (its uniforms and the Gumbel noise of its categorical draws); the port's
  own draws are deterministic streams apart from the plain lane's.
- ``propose_paged`` and ``verify_paged`` against the JAX package's on the
  same prefilled pool: logits within 1e-5, greedy proposals equal, the
  pool's pages within 1e-5.
- The paged scheduler: greedy speculation ON gives OFF's tokens (a draft
  with the target's weights accepts every proposal; an int8 draft of
  another width is corrected to the fixed route), and the same tokens as
  the JAX package's scheduler with its draft; the ``spec_mismatch`` fault
  derails every proposal with the output unchanged; a draft that goes cold
  falls back to plain decode; over HTTP the ``X-Spec-Draft`` header, the
  final event's stats and the spec families, and a draft demoted and
  restored on a live server.

Every wait is bounded by ``asyncio.wait_for``.
"""

import asyncio
import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.config import ServeConfig as JServeConfig
from pytorch_zappa_serverless_tpu.models import gpt2 as JG
from pytorch_zappa_serverless_tpu.ops import sampling as JS
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import gpt2 as PG
from pytorch_zappa_serverless_tpu_torch.ops import sampling as PS
from pytorch_zappa_serverless_tpu_torch.serving.generation import (DraftGate,
                                                                   PagedGenerationScheduler)
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

TINY_ARCH = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128,
             "vocab_size": 500, "max_positions": 96}
WAIT_S = 60
PROMPTS = ([5, 6, 7], [9, 10], [2, 3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46, 47, 48])


def _model_cfg(**over):
    extra = {"max_new_tokens": 12, "arch": TINY_ARCH, "gen_slots": 2, "segment_tokens": 3}
    extra.update(over.pop("extra", {}))
    kw = dict(name="gpt2", dtype="float32", batch_buckets=(1, 2), seq_buckets=(16,),
              coalesce_ms=1.0, kv_cache="paged", kv_block_size=4, extra=extra)
    kw.update(over)
    return ModelConfig(**kw)


def _draft_cfg(name="gpt2_draft", **extra):
    return ModelConfig(name=name, builder="gpt2", dtype="float32", batch_buckets=(1, 2),
                       seq_buckets=(16,), coalesce_ms=1.0,
                       extra={"max_new_tokens": 12, "arch": TINY_ARCH, "gen_slots": 2,
                              "segment_tokens": 3, **extra})


def _spec_engine(**target_over):
    """gpt2 with spec_draft gpt2_draft: the same builder and seed, so the
    draft has the target's weights (every greedy proposal accepted)."""
    return build_engine(ServeConfig(warmup_at_boot=False, models=[
        _model_cfg(spec_draft="gpt2_draft", spec_k=3, **target_over), _draft_cfg()]),
        device="cpu")


def _gate(draft_cm, live=None):
    return DraftGate(draft_cm.servable.name,
                     lambda: draft_cm if live is None or live["on"] else None)


async def _greedy(sched, cm, ids, max_new=10):
    return await asyncio.wait_for(sched.submit(cm.servable.preprocess({"input_ids": ids}),
                                               max_new).done, WAIT_S)


def _fixed(eng, cm, ids):
    return eng.runner.run_fn_sync(cm.run_batch,
                                  [cm.servable.preprocess({"input_ids": ids})])[0][0]["tokens"]


# ---------------------------------------------------------------------------
# speculative_verify against the JAX package's
# ---------------------------------------------------------------------------

def _verify_case(seed: int, S: int = 4, K: int = 3, V: int = 37):
    """Target and draft logits with proposals that follow the target's
    argmax for a random number of positions, then diverge."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(S, K + 1, V)).astype(np.float32) * 2
    d = (t[:, :K] + rng.normal(size=(S, K, V)).astype(np.float32)).astype(np.float32)
    toks = t[:, :K].argmax(-1).astype(np.int32)
    for s in range(S):
        cut = int(rng.integers(0, K + 1))
        if cut < K:
            toks[s, cut] = (toks[s, cut] + 1 + int(rng.integers(0, V - 1))) % V
    return t, d, toks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_verify_greedy_matches_jax(seed):
    t, d, toks = _verify_case(seed)
    S = t.shape[0]
    z = np.zeros(S, np.float32)
    seeds, step = np.arange(S, dtype=np.int32), np.arange(S, dtype=np.int32) * 5
    jn, jout = JS.speculative_verify(jnp.asarray(t), jnp.asarray(d), jnp.asarray(toks),
                                     jnp.asarray(z), jnp.asarray(seeds), jnp.asarray(step))
    for sampled in (False, True):  # a greedy batch's result with the gate either way
        n, out = PS.speculative_verify(torch.from_numpy(t), torch.from_numpy(d),
                                       torch.from_numpy(toks), torch.from_numpy(z),
                                       torch.from_numpy(seeds), torch.from_numpy(step),
                                       sampled=sampled)
        assert n.tolist() == np.asarray(jn).tolist()
        assert out.tolist() == np.asarray(jout).tolist()


def _jax_draws(seeds, step, K, V):
    """The draws JAX's speculative_verify makes: acceptance uniforms and the
    Gumbel noise its categorical draws add to the log-probabilities."""
    keys = jax.vmap(lambda s, t: jax.random.fold_in(jax.random.key(s), t))(
        jnp.asarray(seeds), jnp.asarray(step))
    u = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, JS._ACCEPT_SALT),
                                              (K,)))(keys)
    g_res = jax.vmap(lambda k: jax.vmap(lambda i: jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(k, JS._RESIDUAL_SALT), i), (V,)))(
        jnp.arange(K)))(keys)
    g_bonus = jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(k, JS._BONUS_SALT),
                                                   (V,)))(keys)
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in (u, g_res, g_bonus))


@pytest.mark.parametrize("knobs", [
    {"temp": [1.0, 0.7, 1.3, 0.0], "top_k": [0, 0, 0, 0], "top_p": [1.0, 1.0, 1.0, 1.0]},
    {"temp": [0.9, 1.1, 0.0, 0.6], "top_k": [5, 0, 3, 8], "top_p": [1.0, 0.8, 1.0, 0.9]},
])
@pytest.mark.parametrize("seed", [3, 4])
def test_speculative_verify_sampled_matches_jax_on_its_draws(seed, knobs):
    t, d, toks = _verify_case(seed)
    S, K1, V = t.shape
    temp = np.asarray(knobs["temp"], np.float32)
    topk, topp = np.asarray(knobs["top_k"], np.int32), np.asarray(knobs["top_p"], np.float32)
    seeds, step = np.asarray([11, 12, 13, 14], np.int32), np.asarray([0, 3, 9, 2], np.int32)
    jn, jout = JS.speculative_verify(jnp.asarray(t), jnp.asarray(d), jnp.asarray(toks),
                                     jnp.asarray(temp), jnp.asarray(seeds), jnp.asarray(step),
                                     jnp.asarray(topk), jnp.asarray(topp))
    n, out = PS.speculative_verify_core(
        torch.from_numpy(t), torch.from_numpy(d), torch.from_numpy(toks),
        torch.from_numpy(temp), torch.from_numpy(topk), torch.from_numpy(topp),
        _jax_draws(seeds, step, K1 - 1, V), filtered=bool((topk > 0).any() or (topp < 1).any()))
    assert n.tolist() == np.asarray(jn).tolist()
    jout = np.asarray(jout)
    # Entries past n are padding in both; the emitted ones must agree.
    for s in range(S):
        assert out[s, :int(n[s]) + 1].tolist() == jout[s, :int(n[s]) + 1].tolist()


def test_spec_draws_are_deterministic_streams_of_their_own():
    seeds, step = torch.tensor([1, 2, 3]), torch.tensor([4, 4, 9])
    u, g_res, g_bonus = PS.spec_draws(seeds, step, 3, 50, torch.device("cpu"))
    u2, g_res2, _ = PS.spec_draws(seeds, step, 3, 50, torch.device("cpu"))
    assert torch.equal(u, u2) and torch.equal(g_res, g_res2)
    assert u.shape == (3, 3) and bool(((u >= 0) & (u < 1)).all())
    assert g_res.shape == (3, 3, 50) and g_bonus.shape == (3, 50)
    plain = PS.gumbel_noise(seeds, step, 50, torch.device("cpu"))
    streams = [plain, g_bonus, g_res[:, 0], g_res[:, 1], g_res[:, 2]]
    for i, a in enumerate(streams):
        for b in streams[i + 1:]:
            assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# propose_paged / verify_paged against the JAX package's
# ---------------------------------------------------------------------------

def _prefilled_pools(cfg, jp, pp, prompts, BS, MB):
    """Both packages' pools after the same chunked prefill of ``prompts``
    (one row each), the table and the first tokens."""
    S = len(prompts)
    NB = S * MB + 1
    table = (np.arange(S * MB, dtype=np.int32) + 1).reshape(S, MB)
    P = max(len(p) for p in prompts)
    toks = np.zeros((S, 16), np.int32)
    for s, p in enumerate(prompts):
        toks[s, :len(p)] = p
    start, lens = np.zeros(S, np.int32), np.asarray([len(p) for p in prompts], np.int32)
    z, zi, ones = np.zeros(S, np.float32), np.zeros(S, np.int32), np.ones(S, np.float32)
    T = torch.from_numpy
    ck = torch.zeros((cfg.layers, NB, BS, cfg.d_model))
    cv = torch.zeros_like(ck)
    first, ck, cv = PG.prefill_chunk_paged(pp, T(toks), T(start), T(lens), ck, cv, T(table),
                                           T(z), T(zi), T(zi), T(ones), BS, cfg, torch.float32)
    jk = jnp.zeros(tuple(ck.shape), jnp.float32)
    jv = jnp.zeros(tuple(cv.shape), jnp.float32)
    jfirst, jk, jv = JG.prefill_chunk_paged(
        jp, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(lens), jk, jv,
        jnp.asarray(table), jnp.asarray(z), jnp.asarray(zi), jnp.asarray(zi),
        jnp.asarray(ones), BS, cfg, jnp.float32)
    assert first.tolist() == np.asarray(jfirst).tolist()
    assert P <= 16
    return ck, cv, jk, jv, table, first.numpy().astype(np.int32), lens


def test_propose_and_verify_match_jax():
    jcfg = dataclasses.replace(JG.SMALL, **TINY_ARCH, eos_id=499)
    cfg = PG.GPT2Config(**dataclasses.asdict(jcfg))
    np_params = JG.init_gpt2_params(3, jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    pp = PW.ParamTree(PW.tree_state_from_jax(np_params, torch.float32)).tree()
    BS, MB, K = 4, 8, 3
    prompts = [[5, 6, 7, 8, 9], [100, 200, 300]]
    ck, cv, jk, jv, table, first, lens = _prefilled_pools(jcfg, jp, pp, prompts, BS, MB)
    S = len(prompts)
    prev = np.asarray([p[-1] for p in prompts], np.int32)
    z, zi = np.zeros(S, np.float32), np.zeros(S, np.int32)
    fin = np.zeros(S, bool)
    T = torch.from_numpy
    props, dlog, ck, cv = PG.propose_paged(pp, ck, cv, T(table), T(prev), T(first), T(lens),
                                           T(zi), T(fin), T(z), T(zi), K, cfg, BS,
                                           torch.float32, top_k=T(zi),
                                           top_p=T(np.ones(S, np.float32)))
    jprops, jdlog, jk, jv = JG.propose_paged(
        jp, jk, jv, jnp.asarray(table), jnp.asarray(prev), jnp.asarray(first),
        jnp.asarray(lens), jnp.asarray(zi), jnp.asarray(fin), jnp.asarray(z),
        jnp.asarray(zi), K, jcfg, BS, jnp.float32, top_k=jnp.asarray(zi),
        top_p=jnp.ones((S,), jnp.float32))
    assert props.tolist() == np.asarray(jprops).tolist()
    np.testing.assert_allclose(dlog.numpy(), np.asarray(jdlog), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    # The verify forward over the pending token and the proposals.
    vt = np.concatenate([first[:, None], props.numpy()], axis=1).astype(np.int32)
    logits, ck, cv = PG.verify_paged(pp, ck, cv, T(table), T(vt), T(lens), cfg, BS,
                                     torch.float32)
    jlogits, jk, jv = JG.verify_paged(jp, jk, jv, jnp.asarray(table), jnp.asarray(vt),
                                      jnp.asarray(lens), jnp.asarray(fin), jcfg, BS,
                                      jnp.float32)
    assert logits.shape == (S, K + 1, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The paged scheduler with a draft
# ---------------------------------------------------------------------------

def test_spec_on_matches_spec_off_greedy():
    eng = _spec_engine()
    try:
        cm, dcm = eng.model("gpt2"), eng.model("gpt2_draft")

        async def run():
            plain = PagedGenerationScheduler(cm, eng.runner, cm.cfg).start()
            spec = PagedGenerationScheduler(cm, eng.runner, cm.cfg, draft=_gate(dcm)).start()
            try:
                for ids in PROMPTS:
                    a, b = await _greedy(plain, cm, ids), await _greedy(spec, cm, ids)
                    assert a == b and a, ids
                    assert a == _fixed(eng, cm, ids)[:len(a)]
                # Two streams at once: the pool verifies both rows in one forward.
                both = await asyncio.gather(*(_greedy(spec, cm, ids) for ids in PROMPTS[:2]))
                assert both == [await _greedy(plain, cm, ids) for ids in PROMPTS[:2]]
                return spec.gen_snapshot()["spec"], plain.spec_proposed
            finally:
                await plain.stop()
                await spec.stop()

        snap, plain_proposed = asyncio.run(run())
        assert snap["proposed"] > 0 and snap["accepted"] == snap["proposed"]
        assert snap["draft"] == "gpt2_draft" and snap["k"] == 3 and plain_proposed == 0
    finally:
        eng.shutdown()


def test_spec_with_an_int8_draft_of_another_width_is_corrected():
    """A draft with other weights (width 128, int8) proposes tokens the
    target rejects in part; verification keeps the target's greedy chain."""
    eng = build_engine(ServeConfig(warmup_at_boot=False, models=[
        _model_cfg(spec_draft="gpt2_i8", spec_k=3),
        _draft_cfg("gpt2_i8", arch={**TINY_ARCH, "d_model": 128}, params_dtype="int8",
                   quantize_min_size=1024)]), device="cpu")
    try:
        cm = eng.model("gpt2")

        async def run():
            spec = PagedGenerationScheduler(cm, eng.runner, cm.cfg,
                                            draft=_gate(eng.model("gpt2_i8"))).start()
            try:
                for ids in PROMPTS:
                    got = await _greedy(spec, cm, ids)
                    assert got and got == _fixed(eng, cm, ids)[:len(got)], ids
                return spec.spec_proposed, spec.spec_accepted
            finally:
                await spec.stop()

        proposed, accepted = asyncio.run(run())
        assert proposed > 0 and 0 <= accepted < proposed
    finally:
        eng.shutdown()


def test_spec_stream_matches_the_jax_package_spec_stream(tmp_path):
    """The same greedy prompts through the JAX package's paged scheduler
    with its draft, and through the port's: the same tokens."""
    from pytorch_zappa_serverless_tpu.engine.loader import build_engine as jax_build
    from pytorch_zappa_serverless_tpu.serving.generation import DraftGate as JGate
    from pytorch_zappa_serverless_tpu.serving.generation import \
        PagedGenerationScheduler as JPaged

    extra = {"max_new_tokens": 12, "arch": TINY_ARCH, "gen_slots": 2, "segment_tokens": 3}
    common = dict(dtype="float32", batch_buckets=(1, 2), seq_buckets=(16,), coalesce_ms=1.0)
    jeng = jax_build(JServeConfig(compile_cache_dir=str(tmp_path / "xla"), warmup_at_boot=False,
                                  models=[JModelConfig(name="gpt2", kv_cache="paged",
                                                       kv_block_size=4, spec_draft="gpt2_draft",
                                                       spec_k=3, extra=extra, **common),
                                          JModelConfig(name="gpt2_draft", builder="gpt2",
                                                       extra=extra, **common)]))
    eng = _spec_engine()
    try:
        async def stream(sched, cm, ids):
            return await asyncio.wait_for(
                sched.submit(cm.servable.preprocess({"input_ids": ids}), 10).done, WAIT_S)

        async def run():
            jcm, jdcm = jeng.model("gpt2"), jeng.model("gpt2_draft")
            js = JPaged(jcm, jeng.runner, jcm.cfg,
                        draft=JGate("gpt2_draft", lambda: jdcm)).start()
            cm = eng.model("gpt2")
            ps = PagedGenerationScheduler(cm, eng.runner, cm.cfg,
                                          draft=_gate(eng.model("gpt2_draft"))).start()
            try:
                out = []
                for ids in PROMPTS[:3]:
                    out.append((await stream(js, jcm, ids), await stream(ps, cm, ids)))
                return out, js.spec_proposed, ps.spec_proposed
            finally:
                await js.stop()
                await ps.stop()

        pairs, jprop, pprop = asyncio.run(run())
        for want, got in pairs:
            assert got == want and got
        assert jprop > 0 and pprop == jprop
    finally:
        eng.shutdown()
        jeng.shutdown()


def test_spec_mismatch_fault_exercises_the_rejection_path():
    eng = _spec_engine()
    try:
        cm = eng.model("gpt2")
        eng.runner.faults.configure(model="gpt2", fail_every_n=1, kind="spec_mismatch")

        async def run():
            spec = PagedGenerationScheduler(cm, eng.runner, cm.cfg,
                                            draft=_gate(eng.model("gpt2_draft"))).start()
            try:
                got = [await _greedy(spec, cm, ids) for ids in PROMPTS[:2]]
                return got, spec.spec_proposed, spec.spec_accepted
            finally:
                await spec.stop()

        got, proposed, accepted = asyncio.run(run())
        for ids, toks in zip(PROMPTS, got):
            assert toks and toks == _fixed(eng, cm, ids)[:len(toks)]
        assert proposed > 0 and accepted == 0
        assert eng.runner.faults.snapshot()["injected"]["spec"] > 0
    finally:
        eng.shutdown()


def test_spec_falls_back_to_plain_decode_when_the_draft_is_cold():
    eng = _spec_engine()
    try:
        cm = eng.model("gpt2")
        live = {"on": True}

        async def run():
            sched = PagedGenerationScheduler(cm, eng.runner, cm.cfg,
                                             draft=_gate(eng.model("gpt2_draft"), live)).start()
            try:
                a = await _greedy(sched, cm, [5, 6, 7])
                assert sched.spec_proposed > 0
                live["on"] = False  # the draft goes COLD or quarantined
                before = sched.spec_proposed
                b = await _greedy(sched, cm, [5, 6, 7])
                assert b == a and sched.spec_proposed == before
                assert not sched.spec_live()
                # A stream admitted while cold never prefilled on the draft:
                # the draft's return does not make its ticks speculate.
                req = sched.submit(cm.servable.preprocess({"input_ids": [9, 10]}), 10)
                while not req.tokens:
                    await asyncio.sleep(0.001)
                live["on"] = True
                before = sched.spec_proposed
                c = await asyncio.wait_for(req.done, WAIT_S)
                return c, sched.spec_fallback_ticks, req.has_draft, sched.spec_proposed - before
            finally:
                await sched.stop()

        c, fallback, had, proposed = asyncio.run(run())
        assert fallback > 0 and not had and proposed == 0
        assert c == _fixed(eng, cm, [9, 10])[:len(c)]
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# Over HTTP: the header, the stats, the families, a draft demoted and restored
# ---------------------------------------------------------------------------

def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return r.status, dict(r.headers), r.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=WAIT_S) as r:
        return r.read().decode()


def test_http_spec_header_stats_families_and_a_draft_demoted():
    cfg = ServeConfig(warmup_at_boot=False, models=[
        _model_cfg(spec_draft="gpt2_draft", spec_k=3), _draft_cfg()])
    with BackgroundServer(cfg, device="cpu") as srv:
        status, heads, raw = _post(srv.port, "/v1/models/gpt2:generate",
                                   {"input_ids": [5, 6, 7], "max_new_tokens": 9})
        assert status == 200 and heads.get("X-Spec-Draft") == "gpt2_draft"
        events = [json.loads(line[6:]) for line in raw.decode().splitlines()
                  if line.startswith("data: ")]
        final = events[-1]
        assert final["done"] and final["stats"]["spec_draft"] == "gpt2_draft"
        assert final["stats"]["spec_proposed"] > 0
        assert final["stats"]["spec_accepted"] == final["stats"]["spec_proposed"]
        want = final["tokens"]
        prom = _get(srv.port, "/metrics?format=prometheus")
        assert 'tpuserve_spec_proposed_total{model="gpt2"}' in prom
        assert 'tpuserve_spec_accepted_total{model="gpt2"}' in prom
        # The draft demoted to the host tier: plain decode, no header, the
        # same tokens; restored: its graphs made again and speculation back.
        status, _, _ = _post(srv.port, "/admin/models/gpt2_draft",
                             {"action": "demote", "to": "host"})
        assert status == 200
        status, heads, raw = _post(srv.port, "/v1/models/gpt2:generate",
                                   {"input_ids": [5, 6, 7], "max_new_tokens": 9,
                                    "stream": False})
        body = json.loads(raw)
        assert "X-Spec-Draft" not in heads and "spec_proposed" not in body["predictions"].get(
            "stats", {})
        assert body["predictions"]["tokens"] == want
        sched = srv.server.schedulers["gpt2"]
        assert sched._draft_kernels.graphs.released
        status, _, _ = _post(srv.port, "/admin/models/gpt2_draft", {"action": "activate"})
        assert status == 200
        status, heads, raw = _post(srv.port, "/v1/models/gpt2:generate",
                                   {"input_ids": [5, 6, 7], "max_new_tokens": 9,
                                    "stream": False})
        body = json.loads(raw)
        assert heads.get("X-Spec-Draft") == "gpt2_draft"
        assert body["predictions"]["stats"]["spec_proposed"] > 0
        assert body["predictions"]["tokens"] == want
        assert not sched._draft_kernels.graphs.released
        assert sched._draft_kernels.cm is srv.server.engine.model("gpt2_draft")
