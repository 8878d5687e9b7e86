"""The port's paged :generate lane against the JAX package's and its own
fixed-batch route, on the CPU: the non-speculative half of
tests/test_generation_v2.py at its tiny arch (fp32, ``gen_slots`` 2,
``segment_tokens`` 3, ``kv_block_size`` 4).

- ``BlockManager``: the same calls on the port's copy and the JAX
  package's give the same answers.
- Chunked prefill equals the monolithic prefill (first token, the cache rows
  bit for bit, the decode chain after it), and the port's
  ``prefill_chunk_paged`` chunk by chunk equals the JAX package's (logits
  within 1e-5, the rows within 1e-5, the chain identical).
- The paged scheduler against the fixed batch, greedy and sampled: the same
  tokens; slots reused and pages freed; backpressure, cancel and an
  over-length prompt; a long prompt's chunks interleave with a live stream;
  eviction requeues the newest stream and keeps both chains; exhaustion
  sheds with a computed Retry-After, over HTTP too; a servable without the
  paged contract fails loudly; a JAX-style profile with ``kv_cache: paged``
  boots the port.

Every wait is bounded by ``asyncio.wait_for``.
"""

import asyncio
import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.models import gpt2 as JG
from pytorch_zappa_serverless_tpu.serving import kvcache as JK
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig, load_config
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import gpt2 as PG
from pytorch_zappa_serverless_tpu_torch.serving import kvcache as PK
from pytorch_zappa_serverless_tpu_torch.serving.generation import PagedGenerationScheduler
from pytorch_zappa_serverless_tpu_torch.serving.kvcache import TRASH_BLOCK, KVPoolExhausted
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

TINY_ARCH = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128,
             "vocab_size": 500, "max_positions": 96}
WAIT_S = 60


def _tiny_cfg():
    return dataclasses.replace(JG.SMALL, **TINY_ARCH, eos_id=499)


def _model_cfg(**over):
    extra = {"max_new_tokens": 12, "arch": TINY_ARCH, "gen_slots": 2, "segment_tokens": 3}
    extra.update(over.pop("extra", {}))
    kw = dict(name="gpt2", dtype="float32", batch_buckets=(1, 2), seq_buckets=(16,),
              coalesce_ms=1.0, kv_cache="paged", kv_block_size=4, extra=extra)
    kw.update(over)
    return ModelConfig(**kw)


def _engine(*models):
    return build_engine(ServeConfig(warmup_at_boot=False, models=list(models)), device="cpu")


def _fixed(eng, sample):
    cm = eng.model("gpt2")
    return eng.runner.run_fn_sync(cm.run_batch, [sample])[0][0]["tokens"]


def _drive(eng, body, mc=None):
    """Run ``body(sched, cm)`` against a started paged scheduler."""
    cm = eng.model("gpt2")

    async def run():
        sched = PagedGenerationScheduler(cm, eng.runner, mc or cm.cfg).start()
        try:
            return await body(sched, cm)
        finally:
            await sched.stop()

    return asyncio.run(run())


# ---------------------------------------------------------------------------
# BlockManager: the port's copy against the JAX package's
# ---------------------------------------------------------------------------

def _alloc_free_roundtrip(m):
    out = [m.blocks_for(1), m.blocks_for(4), m.blocks_for(5), m.alloc("a", 9),
           m.used_blocks, m.free_blocks, m.table_row("a")]
    assert len(out[-1]) == 6 and out[-1][3:] == [TRASH_BLOCK] * 3
    assert TRASH_BLOCK not in out[-1][:3]
    out += [m.extend("a", 13), m.used_blocks, m.extend("a", 2), m.used_blocks, m.free("a"),
            m.used_blocks, m.free_blocks]
    return out


def _all_or_nothing(m):
    out = [m.alloc("a", 12), m.alloc("b", 12), m.free_blocks, m.holds("b"), m.alloc("b", 8),
           m.extend("b", 16), m.free("a"), m.extend("b", 16)]
    return out


def _utilization(m):
    m.alloc("a", 9)
    snap = m.snapshot()
    m.note_tokens("a", 12)
    return [snap, m.snapshot()]


@pytest.mark.parametrize("case,args,want", [
    (_alloc_free_roundtrip, (8, 4, 6), [1, 1, 2, True, 3, 4, None, True, 4, True, 4, 4, 0, 7]),
    (_all_or_nothing, (6, 4, 5), [True, False, 2, False, True, False, 3, True]),
    (_utilization, (16, 8, 10), None),
])
def test_block_manager_matches_jax(case, args, want):
    got, ref = case(PK.BlockManager(*args)), case(JK.BlockManager(*args))
    assert got == ref
    if want is not None:
        assert [g for g, w in zip(got, want) if w is not None] == [w for w in want
                                                                     if w is not None]
    else:
        assert got[0]["blocks_used"] == 2 and got[0]["utilization"] == round(9 / 16, 4)
        assert got[0]["fragmentation"] == round(1 - 9 / 16, 4)
        assert got[1]["utilization"] == round(12 / 16, 4)
    with pytest.raises(ValueError):
        PK.BlockManager(num_blocks=4, block_size=4, max_blocks=8)


# ---------------------------------------------------------------------------
# Chunked prefill == monolithic prefill, and == the JAX package's chunks
# ---------------------------------------------------------------------------

def test_chunk_logits_are_the_monolithic_prefills():
    """The last chunk's ``prefill_chunk_logits`` (what ``prefill_chunk_paged``
    draws its first token from) are the whole prompt's prefill logits, the
    port's and the JAX package's, and the chunk's greedy first token is
    their argmax."""
    cfg = _tiny_cfg()
    pcfg = PG.GPT2Config(**dataclasses.asdict(cfg))
    np_params = JG.init_gpt2_params(5, cfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    pp = PW.ParamTree(PW.tree_state_from_jax(np_params, torch.float32)).tree()
    rng = np.random.default_rng(1)
    P, BS, C = 11, 4, 8
    ids = rng.integers(1, 400, (P,)).astype(np.int32)
    T = torch.from_numpy
    lens = np.asarray([P], np.int32)
    MB = -(-P // BS)
    table = T(np.arange(1, MB + 1, dtype=np.int32)[None])
    ck = torch.zeros((cfg.layers, MB + 1, BS, cfg.d_model))
    cv = torch.zeros_like(ck)
    for start in range(0, P, C):
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :len(ids[start:start + C])] = ids[start:start + C]
        logits = PG.prefill_chunk_logits(pp, T(chunk), T(np.asarray([start], np.int32)),
                                         T(lens), ck, cv, table, BS, pcfg, torch.float32)
    want, _, _ = PG.prefill(pp, T(ids[None]), T(lens), P, pcfg, torch.float32)
    jwant, _, _ = JG.prefill(jp, jnp.asarray(ids[None]), jnp.asarray(lens), P, cfg, jnp.float32)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jwant), rtol=0, atol=1e-5)
    z = np.zeros((1,), np.float32)
    first, _, _ = PG.prefill_chunk_paged(
        pp, T(chunk), T(np.asarray([8], np.int32)), T(lens), ck.clone(), cv.clone(), table,
        T(z), T(np.zeros((1,), np.int32)), T(np.zeros((1,), np.int32)), T(np.ones_like(z)),
        BS, pcfg, torch.float32)
    assert int(first[0]) == int(logits[0].argmax())


def test_chunked_prefill_matches_monolithic_and_jax():
    cfg = _tiny_cfg()
    pcfg = PG.GPT2Config(**dataclasses.asdict(cfg))
    np_params = JG.init_gpt2_params(3, cfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    pp = PW.ParamTree(PW.tree_state_from_jax(np_params, torch.float32)).tree()
    rng = np.random.default_rng(0)
    P, max_new, BS, C = 13, 9, 4, 4
    ids = rng.integers(1, 400, (P,)).astype(np.int32)
    T = torch.from_numpy
    lens = np.asarray([P], np.int32)
    z1, s1 = np.zeros((1,), np.float32), np.zeros((1,), np.int32)
    topk, topp = np.zeros((1,), np.int32), np.ones((1,), np.float32)
    total = P + max_new
    MB = -(-total // BS)
    first_ref, ck_ref, _ = PG.prefill_start(pp, T(ids[None]), T(lens), T(z1), T(s1), total,
                                            pcfg, torch.float32)
    want = PG.generate(pp, T(ids[None]), T(lens), T(z1), T(s1), max_new, pcfg,
                       torch.float32).numpy()[0]
    table = np.full((1, MB), TRASH_BLOCK, np.int32)
    table[0] = np.arange(1, MB + 1)
    ck = torch.zeros((cfg.layers, MB + 2, BS, cfg.d_model))
    cv = torch.zeros_like(ck)
    jk, jv = jnp.zeros(tuple(ck.shape), jnp.float32), jnp.zeros(tuple(cv.shape), jnp.float32)
    for start in range(0, P, C):
        sl = ids[start:start + C]
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :sl.shape[0]] = sl
        st = np.asarray([start], np.int32)
        first, ck, cv = PG.prefill_chunk_paged(pp, T(chunk), T(st), T(lens), ck, cv, T(table),
                                               T(z1), T(s1), T(topk), T(topp), BS, pcfg,
                                               torch.float32)
        jfirst, jk, jv = JG.prefill_chunk_paged(
            jp, jnp.asarray(chunk), jnp.asarray(st), jnp.asarray(lens), jk, jv,
            jnp.asarray(table), jnp.asarray(z1), jnp.asarray(s1), jnp.asarray(topk),
            jnp.asarray(topp), BS, cfg, jnp.float32)
        np.testing.assert_allclose(ck.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
        assert int(first[0]) == int(jfirst[0])
    # The same first token and the same cache rows at every prompt position.
    assert int(first[0]) == int(first_ref[0])
    virt = ck[0][T(table[0]).long()].reshape(-1, cfg.d_model)[:P]
    assert torch.equal(virt, ck_ref[0, 0, :P])
    # The decode chain off the chunked cache is the one-shot generate's, and
    # the JAX package's paged segments give it too.
    tok, pos = first, T(lens)
    step, fin = torch.zeros((1,), dtype=torch.int32), torch.zeros((1,), dtype=torch.bool)
    jtok, jpos, jstep, jfin = jfirst, jnp.asarray(lens), jnp.zeros((1,), jnp.int32), \
        jnp.zeros((1,), bool)
    got, jgot = [], []
    for _ in range(3):
        emits, ck, cv, tok, pos, step, fin = PG.decode_segment_paged(
            pp, ck, cv, T(table), tok, pos, step, fin, T(z1), T(s1), 3, pcfg, BS,
            torch.float32, top_k=T(topk), top_p=T(topp))
        got.append(emits.numpy())
        jemits, jk, jv, jtok, jpos, jstep, jfin = JG.decode_segment_paged(
            jp, jk, jv, jnp.asarray(table), jtok, jpos, jstep, jfin, jnp.asarray(z1),
            jnp.asarray(s1), 3, cfg, BS, jnp.float32, top_k=jnp.asarray(topk),
            top_p=jnp.asarray(topp))
        jgot.append(np.asarray(jemits))
    np.testing.assert_array_equal(np.concatenate(got, axis=1)[0], want)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), np.concatenate(jgot, axis=1))


# ---------------------------------------------------------------------------
# The paged scheduler against the fixed batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    eng = _engine(_model_cfg())
    yield eng
    eng.shutdown()


def test_paged_scheduler_matches_fixed_batch(engine):
    cm = engine.model("gpt2")
    samples = [cm.servable.preprocess({"input_ids": ids}) for ids in ([5, 6, 7], [9, 10], [3])]

    async def body(sched, cm):
        return [await asyncio.wait_for(sched.submit(s).done, WAIT_S) for s in samples]

    for s, got in zip(samples, _drive(engine, body)):
        assert got == _fixed(engine, s)


def test_paged_sampled_stream_matches_fixed_batch(engine):
    cm = engine.model("gpt2")
    sample = cm.servable.preprocess({"input_ids": [5, 6, 7], "temperature": 1.3, "seed": 11,
                                     "top_k": 5, "top_p": 0.9})

    async def body(sched, cm):
        return await asyncio.wait_for(sched.submit(sample).done, WAIT_S)

    got = _drive(engine, body)
    assert got and got == _fixed(engine, sample)


def test_paged_slots_reused_and_kv_freed(engine):
    cm = engine.model("gpt2")
    samples = [cm.servable.preprocess({"input_ids": [3 + i, 4 + i]}) for i in range(5)]

    async def body(sched, cm):
        reqs = [sched.submit(s, max_new=4) for s in samples]
        outs = await asyncio.wait_for(asyncio.gather(*[r.done for r in reqs]), 120)
        return outs, sched.gen_snapshot()

    outs, snap = _drive(engine, body)
    for s, got in zip(samples, outs):
        want = _fixed(engine, s)
        assert got and len(got) <= 4 and got == want[: len(got)]
    # Everything released but the prefix tree's frozen pages (none here: no
    # prompt fills a page... two-token prompts freeze nothing).
    assert snap["kv"]["blocks_used"] == 0
    assert snap["kv"]["high_water_blocks"] > 0


def test_backpressure_cancel_and_overlength(engine):
    async def body(sched, cm):
        sched._max_pending = 2
        mk = lambda *ids: cm.servable.preprocess({"input_ids": list(ids)})  # noqa: E731
        a = sched.submit(mk(5, 1), max_new=12)
        b = sched.submit(mk(5, 2), max_new=12)
        with pytest.raises(OverflowError):
            sched.submit(mk(5, 3))
        sched._max_pending = 99
        with pytest.raises(ValueError, match="longest configured"):
            sched.submit({**mk(5), "input_ids": np.arange(1, 19, dtype=np.int32)})
        sched.cancel(b)
        with pytest.raises(RuntimeError, match="cancelled"):
            await asyncio.wait_for(b.done, WAIT_S)
        await asyncio.wait_for(a.done, WAIT_S)

    _drive(engine, body)


def test_long_prompt_prefill_does_not_stall_live_stream():
    eng = _engine(_model_cfg(prefill_chunk_tokens=4, extra={"max_new_tokens": 16}))
    try:
        ids_b = list(range(1, 16))

        async def body(sched, cm):
            a = sched.submit(cm.servable.preprocess({"input_ids": [5, 6]}), max_new=16)
            first_a = await asyncio.wait_for(a.events.get(), WAIT_S)
            assert first_a is not None and not a.done.done()
            # A 15-token prompt at chunk cap 4: 4 chunks, each beside a
            # decode segment of A's.
            b = sched.submit(cm.servable.preprocess({"input_ids": ids_b}), max_new=3)
            await asyncio.wait_for(b.events.get(), WAIT_S)
            assert b.segments_to_first_token is not None
            assert b.segments_to_first_token >= 3
            assert sched.prefill_chunks >= 5  # 1 (a) + 4 (b)
            await asyncio.wait_for(asyncio.gather(a.done, b.done), 120)
            return b.tokens

        got = _drive(eng, body)
        want = _fixed(eng, eng.model("gpt2").servable.preprocess({"input_ids": ids_b}))
        assert got and got == want[: len(got)]
    finally:
        eng.shutdown()


def test_eviction_requeues_newest_and_streams_stay_correct():
    # 7 allocatable pages of 4: one 16 + 12-token stream needs up to 7, so
    # two concurrent streams must collide and evict (kv_migrate off:
    # eviction and re-prefill is the ladder's only rung; with it on the
    # newest stream swaps to host, tests/test_torch_migration.py).
    eng = _engine(_model_cfg(kv_num_blocks=8, prefix_cache=False, kv_migrate=False,
                             extra={"gen_slots": 2, "max_new_tokens": 12}))
    try:
        ids_a, ids_b = [5, 6, 7, 8, 9, 10, 11, 12], [9, 10, 11, 12, 13, 14]

        async def body(sched, cm):
            mk = lambda ids: cm.servable.preprocess({"input_ids": ids})  # noqa: E731
            a = sched.submit(mk(ids_a), max_new=12)
            b = sched.submit(mk(ids_b), max_new=12)
            await asyncio.wait_for(asyncio.gather(a.done, b.done), 120)
            return a, b, sched.gen_snapshot()

        a, b, snap = _drive(eng, body)
        assert snap["kv"]["evictions"] > 0 and a.evictions + b.evictions > 0
        cm = eng.model("gpt2")
        for req, ids in ((a, ids_a), (b, ids_b)):
            want = _fixed(eng, cm.servable.preprocess({"input_ids": ids}))
            assert req.tokens and req.tokens == want[: len(req.tokens)]
    finally:
        eng.shutdown()


def test_kv_exhaustion_sheds_with_computed_retry():
    eng = _engine(_model_cfg(kv_num_blocks=8, extra={"gen_slots": 2, "max_new_tokens": 12}))
    try:
        cm = eng.model("gpt2")

        async def run():
            sched = PagedGenerationScheduler(cm, eng.runner, cm.cfg)  # not started
            mk = lambda seed: cm.servable.preprocess({"input_ids": [seed] * 12})  # noqa: E731
            sched.submit(mk(1))  # 4 blocks of pending demand
            sched._mgr.alloc("squatter", 20)  # 5 of 7 blocks gone
            with pytest.raises(KVPoolExhausted) as ei:
                sched.submit(mk(2))
            return ei.value

        e = asyncio.run(run())
        assert e.retry_after_s > 0 and e.free_blocks == 2 and e.needed_blocks == 4
    finally:
        eng.shutdown()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            if r.headers.get("Content-Type", "").startswith("text/event-stream"):
                return r.status, [json.loads(line[6:]) for line in r
                                  if line.startswith(b"data: ")], dict(r.headers)
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_sse_paged_and_exhaustion_answers_429_over_http():
    cfg = ServeConfig(warmup_at_boot=False, models=[_model_cfg(
        kv_num_blocks=8, prefill_chunk_tokens=8, extra={"gen_slots": 2, "max_new_tokens": 12})])
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            status, events, headers = _post(srv.port, "/v1/models/gpt2:generate",
                                            {"input_ids": [5, 6, 7], "max_new_tokens": 6})
            assert status == 200 and headers["Content-Type"] == "text/event-stream"
            final = events[-1]
            assert final["done"] is True
            assert [e["token"] for e in events[:-1]] == final["tokens"]
            status, body, _ = _post(srv.port, "/v1/models/gpt2:generate",
                                    {"input_ids": [5, 6, 7], "max_new_tokens": 6,
                                     "stream": False})
            assert status == 200 and body["predictions"]["tokens"] == final["tokens"]
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics") as r:
                gen = json.loads(r.read())["generation"]["gpt2"]
            assert gen["mode"] == "paged" and gen["kv"]["blocks_total"] == 7
            assert gen["prefill_chunks"] == 2 and "prefix" in gen

            # Pending demand and a squatter on 5 of 7 pages: the next prompt
            # sheds 429 with the KV fields and a Retry-After from the pace.
            sched = srv.server.schedulers["gpt2"]
            sched._pending.append(object())  # a queued request the loop never sees
            sched._mgr.alloc("squatter", 20)
            status, body, headers = _post(srv.port, "/v1/models/gpt2:generate",
                                          {"input_ids": [2] * 12})
            sched._pending.clear()
            sched._mgr.free("squatter")
            assert status == 429, body
            assert body["kv_blocks_free"] == 2 and body["kv_blocks_needed"] == 4
            assert body["estimated_wait_ms"] > 0 and int(headers["Retry-After"]) >= 1
    finally:
        eng.shutdown()


def test_paged_lane_without_contract_is_loud():
    """kv_cache='paged' on a servable without the paged contract (Whisper)
    is a config error, not a silent downgrade: the lane and the server's
    boot both refuse it."""
    mc = ModelConfig(name="whisper_tiny", dtype="float32", batch_buckets=(1,),
                     kv_cache="paged",
                     extra={"max_new_tokens": 8,
                            "arch": {"d_model": 32, "encoder_layers": 2, "decoder_layers": 2,
                                     "heads": 2, "ffn_dim": 64, "vocab_size": 64,
                                     "target_positions": 96}})
    cfg = ServeConfig(warmup_at_boot=False, models=[mc])
    eng = build_engine(cfg, device="cpu")
    try:
        cm = eng.model("whisper_tiny")
        assert "continuous" in cm.servable.meta
        with pytest.raises(ValueError, match="paged"):
            PagedGenerationScheduler(cm, eng.runner, cm.cfg)
        from pytorch_zappa_serverless_tpu_torch.serving.server import Server

        with pytest.raises(ValueError, match="paged"):
            asyncio.run(Server(cfg, eng).start(port=0))
    finally:
        eng.shutdown()


def test_reference_profile_with_paged_kv_boots_the_port(tmp_path):
    """A profile written for the JAX package, with ``kv_cache: paged``,
    ``kv_block_size`` and ``prefill_chunk_tokens`` as model fields, loads in
    both packages alike and serves :generate on the port."""
    from pytorch_zappa_serverless_tpu import config as JC

    path = tmp_path / "profile.json"
    path.write_text(json.dumps({"port": 0, "warmup_at_boot": False, "models": [{
        "name": "gpt2", "dtype": "float32", "batch_buckets": [1], "seq_buckets": [16],
        "kv_cache": "paged", "kv_block_size": 4, "prefill_chunk_tokens": 8,
        "prefix_cache_ttl_s": 30.0,
        "extra": {"max_new_tokens": 6, "arch": TINY_ARCH, "gen_slots": 2,
                  "segment_tokens": 3}}]}))
    cfg, ref = load_config(path), JC.load_config(path)
    for f in ("kv_cache", "kv_block_size", "kv_num_blocks", "prefill_chunk_tokens",
              "prefix_cache", "prefix_cache_ttl_s", "prefix_cache_blocks", "spec_draft",
              "spec_k"):
        assert getattr(cfg.models[0], f) == getattr(ref.models[0], f), f
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            sched = srv.server.schedulers["gpt2"]
            assert isinstance(sched, PagedGenerationScheduler)
            assert sched.block_size == 4 and sched.chunk_cap == 8 and sched.prefix_ttl_s == 30
            status, body, _ = _post(srv.port, "/v1/models/gpt2:generate",
                                    {"input_ids": list(range(1, 12)), "stream": False})
            assert status == 200 and 1 <= len(body["predictions"]["tokens"]) <= 6
    finally:
        eng.shutdown()
