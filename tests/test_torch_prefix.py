"""The port's prefix KV cache against the JAX package's, on the CPU: the
non-adapter, non-speculative cases of tests/test_prefix.py at its tiny arch
(fp32, ``gen_slots`` 2, ``segment_tokens`` 3, ``kv_block_size`` 4).

- ``BlockManager`` refcounts, adopt and copy-on-write, shared pages counted
  once; ``PrefixCache`` radix lookup, insert, edge split and partial-page
  match, LRU leaf-first reclaim, TTL decay and the page cap: each case runs
  the same calls on the port's copies and the JAX package's, which must
  answer alike, and holds the JAX test's own assertions.
- The paged lane: a warm prompt's tokens equal the cold run's and the fixed
  batch's, greedy and sampled; copy-on-write never changes a shared page's
  bytes; under pool pressure the tree's pages are reclaimed before any live
  stream is evicted.
"""

import asyncio

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu.serving import kvcache as JK
from pytorch_zappa_serverless_tpu.serving import prefixcache as JP
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.serving import kvcache as PK
from pytorch_zappa_serverless_tpu_torch.serving import prefixcache as PP
from pytorch_zappa_serverless_tpu_torch.serving.generation import PagedGenerationScheduler

TINY_ARCH = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128,
             "vocab_size": 500, "max_positions": 96}
WAIT_S = 60


def _model_cfg(**over):
    extra = {"max_new_tokens": 8, "arch": TINY_ARCH, "gen_slots": 2, "segment_tokens": 3}
    extra.update(over.pop("extra", {}))
    kw = dict(name="gpt2", dtype="float32", batch_buckets=(1, 2), seq_buckets=(16,),
              coalesce_ms=1.0, kv_cache="paged", kv_block_size=4, extra=extra)
    kw.update(over)
    return ModelConfig(**kw)


def _ids(*toks):
    return np.asarray(toks, np.int32)


def _freeze(cache, mgr, aidx, ids, seq):
    """Alloc + insert, as the scheduler does when a prefill completes."""
    assert mgr.alloc(seq, ids.shape[0] + 1)
    return cache.insert(aidx, ids, mgr.blocks_of(seq))


# ---------------------------------------------------------------------------
# BlockManager refcounts and PrefixCache units, the port beside the JAX package
# ---------------------------------------------------------------------------

def _refcounts(K, PC):
    m = K.BlockManager(num_blocks=8, block_size=4, max_blocks=6)
    out = [m.alloc("a", 8)]
    blocks = m.blocks_of("a")
    out.append([m.refcount(b) for b in blocks])
    for b in blocks:
        m.incref(b)  # the "prefix tree" holds on
    out += [m.shared_blocks(), m.free("a"), m.used_blocks, [m.refcount(b) for b in blocks],
            m.decref(blocks[0]), m.decref(blocks[1]), m.used_blocks]
    with pytest.raises(ValueError, match="double free"):
        m.decref(blocks[0])
    with pytest.raises(ValueError, match="unallocated"):
        m.incref(blocks[0])
    return out


def _adopt_cow(K, PC):
    m = K.BlockManager(num_blocks=10, block_size=4, max_blocks=8)
    out = [m.alloc("owner", 8)]
    shared = m.blocks_of("owner")
    out += [m.adopt("reader", shared, 8), [m.refcount(b) for b in shared], m.used_blocks]
    src, dst = m.cow("reader", 1)
    out += [src == shared[1], dst not in shared, m.refcount(src), m.refcount(dst),
            m.blocks_of("reader") == [shared[0], dst]]
    m.decref(src)  # the copy landed
    out += [m.refcount(src), m.free("reader"), m.free("owner")]
    return out


def _shared_once(K, PC):
    m = K.BlockManager(num_blocks=16, block_size=8, max_blocks=10)
    m.alloc("a", 16)
    m.adopt("b", m.blocks_of("a"), 16)
    m.extend("b", 24)
    out = [m.snapshot()]
    out.append(m.free("b"))
    blocks = m.blocks_of("a")
    for b in blocks:
        m.incref(b)
    m.free("a")
    return out + [m.snapshot()]


def _radix(K, PC):
    mgr = K.BlockManager(num_blocks=32, block_size=4, max_blocks=16)
    pc = PC(mgr, 4)
    ids_a = _ids(*range(1, 11))
    out = [_freeze(pc, mgr, 0, ids_a, "a"), pc.node_count, pc.page_count]
    n, blocks = pc.lookup(0, ids_a, max_tokens=9)
    out += [n, blocks == mgr.blocks_of("a")[:2]]
    ids_b = _ids(1, 2, 3, 4, 5, 6, 90, 91, 92)
    out.append(pc.lookup(0, ids_b, max_tokens=8))
    assert mgr.alloc("b", ids_b.shape[0] + 1)
    pc.insert(0, ids_b, mgr.blocks_of("b"))
    out += [pc.node_count, pc.page_count, pc.lookup(0, ids_b, max_tokens=8)[0],
            pc.lookup(0, _ids(200, 201, 202, 203, 204), max_tokens=4)]
    return out + [pc.snapshot()]


def _invalidate(K, PC):
    mgr = K.BlockManager(num_blocks=16, block_size=4, max_blocks=8)
    pc = PC(mgr, 4)
    ids = _ids(*range(1, 9))
    _freeze(pc, mgr, 1, ids, "t1")
    out = [pc.lookup(0, ids, max_tokens=7)[0], pc.lookup(1, ids, max_tokens=7)[0]]
    mgr.free("t1")
    used_before = mgr.used_blocks
    out += [pc.invalidate(1), pc.lookup(1, ids, max_tokens=7)[0],
            used_before - mgr.used_blocks, pc.snapshot()["evictions"]]
    return out


def _reclaim(K, PC):
    mgr = K.BlockManager(num_blocks=32, block_size=4, max_blocks=16)
    clock = {"t": 0.0}
    pc = PC(mgr, 4, clock=lambda: clock["t"])
    old, hot = _ids(*range(1, 9)), _ids(*range(50, 58))
    _freeze(pc, mgr, 0, old, "old")
    clock["t"] = 10.0
    _freeze(pc, mgr, 0, hot, "hot")
    mgr.free("old")
    mgr.free("hot")
    out = [pc.reclaimable(), pc.reclaim(1), pc.lookup(0, hot, max_tokens=7)[0],
           pc.lookup(0, old, max_tokens=7)[0]]
    n, blocks = pc.lookup(0, hot, max_tokens=7)
    assert mgr.adopt("reader", blocks, n)
    out.append(pc.reclaim(99))  # a stream still shares the hot pages
    mgr.free("reader")
    out += [pc.reclaim(99, protect=frozenset(blocks)), pc.reclaim(99)]
    return out


def _ttl_cap(K, PC):
    mgr = K.BlockManager(num_blocks=32, block_size=4, max_blocks=16)
    clock = {"t": 0.0}
    pc = PC(mgr, 4, max_pages=2, clock=lambda: clock["t"])
    a = _ids(*range(1, 9))
    _freeze(pc, mgr, 0, a, "a")
    mgr.free("a")
    out = [pc.page_count]
    clock["t"] = 1.0
    b = _ids(*range(30, 38))
    _freeze(pc, mgr, 0, b, "b")
    mgr.free("b")
    out += [pc.page_count, pc.lookup(0, b, max_tokens=7)[0], pc.lookup(0, a, max_tokens=7)[0],
            pc.decay(5.0)]
    clock["t"] = 100.0
    return out + [pc.decay(5.0), pc.page_count, mgr.used_blocks]


CASES = {
    "refcounts": (_refcounts, [True, [1, 1], 2, 0, 2, [1, 1], True, True, 0]),
    "adopt_cow": (_adopt_cow, [True, True, [2, 2], 2, True, True, 2, 1, True, 1, 1, 2]),
    "shared_once": (_shared_once, None),
    "radix": (_radix, None),
    "invalidate": (_invalidate, [0, 7, 1, 0, 2, 1]),
    "reclaim": (_reclaim, [4, 2, 7, 0, 0, 0, 2]),
    "ttl_cap": (_ttl_cap, [2, 2, 7, 0, 0, 2, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_units_match_jax(case):
    fn, want = CASES[case]
    got = fn(PK, PP.PrefixCache)
    assert got == fn(JK, JP.PrefixCache)  # the reference's answers
    if want is not None:
        assert got == want
    elif case == "shared_once":
        first, freed, last = got
        assert first["blocks_used"] == 3 and first["shared_blocks"] == 2
        assert first["utilization"] == 1.0 and freed == 1
        assert last["utilization"] == 1.0 and last["blocks_used"] == 2
    else:  # radix
        assert got[:5] == [2, 1, 2, 8, True]
        n, blocks = got[5]
        assert n == 6 and len(blocks) == 2  # the partial page rides along
        assert got[6:9] == [3, 3, 8] and got[9] == (0, [])
        snap = got[10]
        assert snap["hits"] == 3 and snap["misses"] == 1
        assert snap["nodes_total"] == 3 and snap["pages_total"] == 3
        assert snap["cached_tokens"]["count"] == 3


# ---------------------------------------------------------------------------
# The paged lane: warm == cold == fixed batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    eng = build_engine(ServeConfig(warmup_at_boot=False, models=[_model_cfg()]), device="cpu")
    yield eng
    eng.shutdown()


def _fixed(eng, payload):
    cm = eng.model("gpt2")
    return eng.runner.run_fn_sync(cm.run_batch, [cm.servable.preprocess(payload)])[0][0]["tokens"]


async def _run(sched, cm, payload, max_new=None):
    req = sched.submit(cm.servable.preprocess(payload), max_new)
    await asyncio.wait_for(req.done, WAIT_S)
    return req


def _drive(eng, body):
    cm = eng.model("gpt2")

    async def run():
        sched = PagedGenerationScheduler(cm, eng.runner, cm.cfg).start()
        try:
            return await body(sched, cm)
        finally:
            await sched.stop()

    return asyncio.run(run())


def test_warm_prefix_parity_greedy_and_sampled(engine):
    payloads = ({"input_ids": list(range(5, 15))},
                {"input_ids": list(range(30, 40)), "temperature": 1.3, "seed": 11, "top_k": 5,
                 "top_p": 0.9})

    async def body(sched, cm):
        runs = []
        for p in payloads:
            cold = await _run(sched, cm, p)
            warm = await _run(sched, cm, p)
            runs.append((cold, warm))
        return runs, sched.gen_snapshot()["prefix"]

    runs, snap = _drive(engine, body)
    for p, (cold, warm) in zip(payloads, runs):
        want = _fixed(engine, p)
        assert cold.cached_tokens == 0 and cold.tokens == want
        assert warm.tokens == want and warm.cached_tokens == 8  # 2 pages reused
    assert snap["hits"] == 2 and snap["misses"] == 2 and snap["pages"] >= 2
    assert snap["cached_tokens"]["count"] == 2


def test_cow_divergence_never_mutates_shared_page(engine):
    base = list(range(5, 14))  # 9 tokens: 2 frozen pages
    div = base[:6] + [90, 91, 92]

    async def body(sched, cm):
        cold = await _run(sched, cm, {"input_ids": base})
        node = next(iter(sched._prefix._roots[0].children.values()))
        blocks = list(node.blocks)
        before = (sched.kernels.cache_k[:, blocks].clone(), sched.kernels.cache_v[:, blocks].clone())
        dreq = await _run(sched, cm, {"input_ids": div})
        after = (sched.kernels.cache_k[:, blocks], sched.kernels.cache_v[:, blocks])
        cows = sched.gen_snapshot()["prefix"]["cow_copies"]
        again = await _run(sched, cm, {"input_ids": base})
        return cold, dreq, again, before, after, cows

    cold, dreq, again, before, after, cows = _drive(engine, body)
    want_base, want_div = _fixed(engine, {"input_ids": base}), _fixed(engine, {"input_ids": div})
    assert cold.tokens == want_base
    assert dreq.tokens == want_div and dreq.cached_tokens == 6  # 1 full + half a page
    assert cows == 1
    # The shared pages are bit for bit untouched, and the original prompt
    # still replays warm.
    assert all(b.numpy().tobytes() == a.numpy().tobytes() for b, a in zip(before, after))
    assert again.tokens == want_base and again.cached_tokens == 8


def test_eviction_reclaims_prefix_pages_before_live_streams():
    # 6 allocatable pages; A retires leaving 2 frozen pages; B must then grow
    # past the free pages: the tree yields before any live stream does.
    eng = build_engine(ServeConfig(warmup_at_boot=False, models=[_model_cfg(
        kv_num_blocks=7, extra={"gen_slots": 2, "max_new_tokens": 8})]), device="cpu")
    try:
        ids_b = [20, 21, 22, 23, 24, 25, 26, 27]

        async def body(sched, cm):
            a = await _run(sched, cm, {"input_ids": [5, 6, 7, 8, 9, 10, 11, 12]}, max_new=2)
            snap_a = sched.gen_snapshot()["prefix"]
            b = await _run(sched, cm, {"input_ids": ids_b}, max_new=8)
            return a, b, snap_a, sched.gen_snapshot()

        a, b, snap_a, snap = _drive(eng, body)
        assert snap_a["pages"] == 2 and snap_a["reclaimable_pages"] == 2
        assert b.tokens == _fixed(eng, {"input_ids": ids_b})
        assert b.evictions == 0
        assert snap["prefix"]["evictions"] >= 1 and snap["kv"]["evictions"] == 0
        assert a.tokens
    finally:
        eng.shutdown()


def test_invalidate_prefix_drops_the_base_slot(engine):
    async def body(sched, cm):
        await _run(sched, cm, {"input_ids": list(range(5, 15))})
        dropped = sched.invalidate_prefix(0)
        warm = await _run(sched, cm, {"input_ids": list(range(5, 15))})
        return dropped, warm.cached_tokens

    dropped, cached = _drive(engine, body)
    assert dropped == 1 and cached == 0


# ---------------------------------------------------------------------------
# Prefix chaos (the JAX package's tests/test_prefix.py chaos cases)
# ---------------------------------------------------------------------------

def test_prefix_poison_chaos_falls_back_to_uncached(engine):
    ids = list(range(5, 15))
    faults = engine.runner.faults

    async def body(sched, cm):
        cold = await _run(sched, cm, {"input_ids": ids})
        # Every lookup fails: the warm request prefills cold, with the same
        # tokens, and counts as a miss.
        faults.configure(model="gpt2", fail_every_n=1, kind="prefix")
        try:
            warm = await _run(sched, cm, {"input_ids": ids})
            snap = dict(sched.gen_snapshot()["prefix"])
            injected = faults.snapshot()["injected"]["prefix"]
        finally:
            faults.clear()
        again = await _run(sched, cm, {"input_ids": ids})
        return cold, warm, snap, injected, again

    cold, warm, snap, injected, again = _drive(engine, body)
    assert warm.tokens == cold.tokens == _fixed(engine, {"input_ids": ids})
    assert warm.cached_tokens == 0
    assert snap["hits"] == 0 and snap["misses"] == 2 and injected > 0
    # The rule cleared: reuse resumes on the same frozen pages.
    assert again.tokens == cold.tokens and again.cached_tokens == 8


def test_prefix_force_cow_chaos_stays_byte_identical(engine):
    ids = list(range(5, 15))
    faults = engine.runner.faults

    async def body(sched, cm):
        cold = await _run(sched, cm, {"input_ids": ids})
        faults.configure(model="gpt2", fail_every_n=1, kind="prefix", mode="cow")
        try:
            warm = await _run(sched, cm, {"input_ids": ids})
        finally:
            faults.clear()
        return cold, warm, sched.gen_snapshot()["prefix"]

    cold, warm, snap = _drive(engine, body)
    assert warm.tokens == cold.tokens  # the copies are pure
    assert warm.cached_tokens == 8     # still a hit
    assert snap["cow_copies"] == 2 and snap["hits"] == 1  # every shared page cloned
