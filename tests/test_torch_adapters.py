"""Multi-tenant LoRA adapters in the port (``serving/adapters.py``,
``ops/lora.py``), the twins of the JAX package's ``tests/test_adapters.py``
at its tiny GPT-2 (width 32, 2 layers, fp32), on the CPU.

- Model: a co-batched generate of three tenants and the base gives the JAX
  package's ``generate(..., adapter_idx=...)`` tokens on the same stacks,
  each row its solo run's, and slot 0 the plain model's, bitwise.
- Unit: the residency state machine against a fake engine (single-flight
  attach, cold admission, idle scale-to-zero per tenant, LRU slot eviction,
  the HBM budget's shed), each attach and detach one slot written in place
  under the stacks' addresses, a base's demotion or rebuild leaving its
  adapters cold, and the ``adapter`` fault's own target.
- HTTP, through the port's ``BackgroundServer``: two tenants in one
  dispatch (the trace's batch mates and adapter mix) with the JAX
  package's tokens; 503 ``adapter_cold`` + Retry-After; idle detach and
  re-attach; one poisoned tenant; the 404 ladder; discovery; (model,
  adapter) jobs; per-stream adapters on the paged ``:generate`` lane (the
  slot lane answers 400) and a detach dropping the slot's prefix tree;
  the adapter families through ``tools/check_metrics.py``; an adapter
  stream moved to another server byte-equal (the importer attaches the
  adapter, at its own slot); and speculation falling back to plain decode
  while an adapter stream is active.

Every wait is bounded.
"""

import asyncio
import dataclasses
import http.client
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu import faults as jfaults
from pytorch_zappa_serverless_tpu.engine import weights as JW
from pytorch_zappa_serverless_tpu.models import gpt2 as JG
from pytorch_zappa_serverless_tpu.ops import lora as JL
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.faults import FaultInjector
from pytorch_zappa_serverless_tpu_torch.models import gpt2 as PG
from pytorch_zappa_serverless_tpu_torch.ops import lora as PL
from pytorch_zappa_serverless_tpu_torch.serving.adapters import (ACTIVE, COLD, AdapterCold,
                                                                 AdapterManager, UnknownAdapter)
from pytorch_zappa_serverless_tpu_torch.serving.generation import (DraftGate,
                                                                   PagedGenerationScheduler)
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

TINY_ARCH = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 64, "vocab_size": 300,
             "max_positions": 64}
DIMS = {"q": (32, 32), "v": (32, 32)}
WAIT_S = 60
ROOT = Path(__file__).resolve().parents[1]
# Random dev adapters on a random tiny base need a large alpha before a
# rank-4 delta moves a greedy argmax (the JAX package's tests use 128).
ALPHA = 128


def _jcfg():
    return dataclasses.replace(JG.SMALL, **TINY_ARCH, eos_id=299)


def _run(coro, timeout=WAIT_S):
    async def bounded():
        return await asyncio.wait_for(coro, timeout)
    return asyncio.run(bounded())


# ---------------------------------------------------------------------------
# The model: co-batched tenants against the JAX package's generate
# ---------------------------------------------------------------------------

def _stacks(n=3, rank=4, layers=2):
    stacks = {f"layer{i}": JL.zero_stacks(n + 1, rank, DIMS) for i in range(layers)}
    for slot in range(1, n + 1):
        JL.install_adapter(stacks, slot, JW.init_lora(layers, DIMS, rank, seed=slot),
                           scaling=1.0 + slot)
    return stacks


def _port_tree(params, stacks=None):
    tree = dict(params)
    if stacks is not None:
        tree["__adapters__"] = stacks
    return PW.ParamTree(PW.tree_state_from_jax(tree, torch.float32)).tree()


def test_cobatched_generate_matches_jax_and_solo():
    """Three tenants and the base in one batch: the JAX package's tokens on
    the same stacks, each row its solo run's, and distinct tenants distinct
    continuations; a whole batch at slot 0 is the plain model, bitwise."""
    cfg = _jcfg()
    pcfg = PG.GPT2Config(**dataclasses.asdict(cfg))
    np_params = JG.init_gpt2_params(2, cfg)
    stacks = _stacks(3)
    import jax

    jparams = jax.tree.map(jnp.asarray, {**np_params, "__adapters__": stacks})
    tree = _port_tree(np_params, stacks)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 290, (4, 6)).astype(np.int32)
    lens = np.array([6, 4, 5, 6], np.int32)
    toks[np.arange(6)[None, :] >= lens[:, None]] = 0
    aidx = np.array([1, 2, 0, 3], np.int32)
    z, s = np.zeros(4, np.float32), np.zeros(4, np.int32)
    want = np.asarray(JG.generate(jparams, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(z),
                                  jnp.asarray(s), 8, cfg, jnp.float32,
                                  adapter_idx=jnp.asarray(aidx)))
    T = torch.from_numpy
    with torch.inference_mode():
        got = PG.generate(tree, T(toks), T(lens), T(z), T(s), 8, pcfg, torch.float32,
                          adapter_idx=T(aidx)).numpy()
        np.testing.assert_array_equal(got, want)
        for i in range(4):
            solo = PG.generate(tree, T(toks[i:i + 1]), T(lens[i:i + 1]), T(z[:1]), T(s[:1]), 8,
                               pcfg, torch.float32, adapter_idx=T(aidx[i:i + 1])).numpy()
            np.testing.assert_array_equal(got[i], solo[0])
        assert len({tuple(r) for r in got}) == 4
        plain = PG.generate(_port_tree(np_params), T(toks), T(lens), T(z), T(s), 8, pcfg,
                            torch.float32).numpy()
        thru = PG.generate(tree, T(toks), T(lens), T(z), T(s), 8, pcfg, torch.float32,
                           adapter_idx=T(np.zeros(4, np.int32))).numpy()
        np.testing.assert_array_equal(plain, thru)


# ---------------------------------------------------------------------------
# Unit: the residency state machine against a fake engine
# ---------------------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


def _adapter_cfg(n=3, slots=2, **kw):
    return ServeConfig(warmup_at_boot=False, models=[ModelConfig(
        name="gpt2", dtype="float32", batch_buckets=(1, 4), seq_buckets=(8,), coalesce_ms=20.0,
        adapter_slots=slots, adapter_rank=4,
        adapters={f"t{i}": {"seed": i + 1, "tenants": [f"tenant-{i}"]} for i in range(n)},
        extra={"max_new_tokens": 4, "arch": TINY_ARCH})], **kw)


class _FakeRunner:
    def __init__(self, base_bytes=1000):
        self.faults = FaultInjector()
        self._resident = {"gpt2": base_bytes}
        self.writes = 0

    def track_model(self, name, nbytes):
        self._resident[name] = int(nbytes)

    def untrack_model(self, name):
        self._resident.pop(name, None)

    def resident_bytes(self):
        return dict(self._resident)

    async def run_fn(self, fn, *args):
        # The dispatch thread runs the write later: yield around it, as the
        # real runner's await does.
        self.writes += 1
        await asyncio.sleep(0)
        out = fn(*args)
        await asyncio.sleep(0)
        return out


def _fake_stack(**cfg_kw):
    """(manager, fake server, clock) over a real tiny GPT-2 servable (its
    stack pool lies in its module) and a fake runner and ledger."""
    cfg = _adapter_cfg(**cfg_kw)
    servable = PG.make_gpt2_servable("gpt2", cfg.models[0])
    cm = SimpleNamespace(servable=servable)
    engine = SimpleNamespace(models={"gpt2": cm}, runner=_FakeRunner())
    server = SimpleNamespace(cfg=cfg, engine=engine, tracer=None)
    clock = _FakeClock()
    return AdapterManager(server, cfg, clock=clock), server, clock


def _device_slot(cm, slot):
    st = cm.servable.module.tree()["__adapters__"]
    return torch.cat([st[l][t][h][slot].flatten() for l in sorted(st) for t in sorted(st[l])
                      for h in "ab"])


def test_single_flight_attach_and_resolution():
    async def scenario():
        mgr, server, clock = _fake_stack()
        slots = await asyncio.gather(*[mgr.ensure_attached("gpt2", "t0") for _ in range(8)])
        rec = mgr.get("gpt2", "t0")
        assert rec.state == ACTIVE and rec.attaches == 1
        assert all(s == slots[0] for s in slots)
        assert server.engine.runner.resident_bytes()["gpt2:t0"] > 0
        assert mgr.resolve("gpt2", "t1", None).name == "t1"
        assert mgr.resolve("gpt2", None, "tenant-2").name == "t2"
        assert mgr.resolve("gpt2", None, None) is None
        with pytest.raises(UnknownAdapter):
            mgr.resolve("gpt2", "nope", None)
        with pytest.raises(UnknownAdapter):
            mgr.resolve("gpt2", None, "stranger")
    _run(scenario())


def test_deadline_infeasible_attach_fast_fails():
    async def scenario():
        mgr, server, clock = _fake_stack()
        with pytest.raises(AdapterCold) as ei:
            await mgr.ensure_attached("gpt2", "t0", deadline_ms=5.0)
        assert ei.value.estimated_attach_ms == 500.0
        assert ei.value.retry_after_s >= 1.0
        assert mgr.get("gpt2", "t0").cold_fast_fails == 1
        await mgr.ensure_attached("gpt2", "t0")
        assert mgr.get("gpt2", "t0").attaches == 1  # shared, not doubled
        await mgr.ensure_attached("gpt2", "t0", deadline_ms=5000.0)
    _run(scenario())


def test_idle_detach_and_lru_slot_eviction():
    async def scenario():
        mgr, server, clock = _fake_stack(adapter_idle_unload_s=10.0)
        await mgr.ensure_attached("gpt2", "t0")
        clock.advance(1)
        await mgr.ensure_attached("gpt2", "t1")
        rec0 = mgr.get("gpt2", "t0")
        mgr.enter(rec0)  # busy adapters never idle-detach
        clock.advance(50)
        await mgr.tick_once()
        assert rec0.state == ACTIVE
        assert mgr.get("gpt2", "t1").state == COLD
        assert "gpt2:t1" not in server.engine.runner.resident_bytes()
        mgr.exit(rec0)
        clock.advance(50)
        await mgr.tick_once()
        assert rec0.state == COLD
        # 2 slots, 3 tenants: the least recently used idle one makes room.
        await mgr.ensure_attached("gpt2", "t0")
        clock.advance(1)
        await mgr.ensure_attached("gpt2", "t1")
        clock.advance(1)
        await mgr.ensure_attached("gpt2", "t2")
        assert mgr.get("gpt2", "t0").state == COLD
        assert mgr.get("gpt2", "t1").state == ACTIVE
        assert mgr.get("gpt2", "t2").state == ACTIVE
        assert mgr.get("gpt2", "t2").slot != mgr.get("gpt2", "t1").slot
    _run(scenario())


def test_hbm_budget_sheds_adapter_bytes():
    async def scenario():
        mgr, server, clock = _fake_stack()
        await mgr.ensure_attached("gpt2", "t0")
        nbytes = mgr.get("gpt2", "t0").nbytes
        assert nbytes > 0 and server.engine.runner.resident_bytes()["gpt2:t0"] == nbytes
        clock.advance(1)
        await mgr.ensure_attached("gpt2", "t1")
        server.cfg.hbm_budget_bytes = 1000 + nbytes + nbytes // 2
        await mgr.tick_once()
        resident = server.engine.runner.resident_bytes()
        assert "gpt2:t0" not in resident and resident["gpt2:t1"] == nbytes
        assert sum(resident.values()) <= server.cfg.hbm_budget_bytes
        assert mgr.get("gpt2", "t0").state == COLD and mgr.get("gpt2", "t1").state == ACTIVE
    _run(scenario())


def test_attach_and_detach_write_one_slot_in_place():
    """The first attach writes the fresh pool (every slot), later ones
    their slot alone, under the stacks' addresses; a detach zeroes its
    slot and leaves the others."""
    async def scenario():
        mgr, server, clock = _fake_stack()
        cm = server.engine.models["gpt2"]
        stacks = cm.servable.module.tree()["__adapters__"]
        ptrs = [t.data_ptr() for l in stacks.values() for n in l.values() for t in n.values()]
        await mgr.ensure_attached("gpt2", "t0")
        await mgr.ensure_attached("gpt2", "t1")
        s0, s1 = mgr.get("gpt2", "t0").slot, mgr.get("gpt2", "t1").slot
        assert server.engine.runner.writes == 2 and {s0, s1} == {1, 2}
        assert _device_slot(cm, s0).any() and _device_slot(cm, s1).any()
        assert not _device_slot(cm, 0).any()
        host = {f"layer{i}": PL.zero_stacks(3, 4, DIMS) for i in range(2)}
        PL.install_adapter(host, s1, PW.init_lora(2, DIMS, 4, seed=2), scaling=1.0)
        want = torch.cat([torch.from_numpy(host[l][t][h][s1]).flatten()
                          for l in sorted(host) for t in sorted(host[l]) for h in "ab"])
        assert torch.equal(_device_slot(cm, s1), want)
        before = _device_slot(cm, s1).clone()
        assert await mgr.detach("gpt2", "t0")
        assert not _device_slot(cm, s0).any() and torch.equal(_device_slot(cm, s1), before)
        assert not await mgr.detach("gpt2", "t0")  # cold: nothing to detach
        stacks = cm.servable.module.tree()["__adapters__"]
        assert ptrs == [t.data_ptr() for l in stacks.values() for n in l.values()
                        for t in n.values()]
    _run(scenario())


def test_concurrent_cold_attaches_into_a_full_pool_take_distinct_slots():
    """Two cold tenants (their trees already loaded) arriving together at a
    full pool: each evicts its own victim and owns a slot of its own, and
    each device slot holds its own tenant's factors."""
    async def scenario():
        mgr, server, clock = _fake_stack(n=4)
        cm = server.engine.models["gpt2"]
        await mgr.ensure_attached("gpt2", "t0")
        clock.advance(1)
        await mgr.ensure_attached("gpt2", "t1")
        clock.advance(1)
        recs = [mgr.get("gpt2", t) for t in ("t2", "t3")]
        for rec in recs:
            rec.tree = PW.init_lora(2, DIMS, 4, seed=int(rec.spec["seed"]))
        slots = await asyncio.gather(*[mgr.ensure_attached("gpt2", r.name) for r in recs])
        assert sorted(slots) == [1, 2]
        pool = mgr._pools["gpt2"]
        for rec, slot in zip(recs, slots):
            assert rec.state == ACTIVE and rec.slot == slot and pool.owners[slot] is rec
            host = {f"layer{i}": PL.zero_stacks(3, 4, DIMS) for i in range(2)}
            PL.install_adapter(host, slot, rec.tree, scaling=1.0)
            want = torch.cat([torch.from_numpy(host[l][t][h][slot]).flatten()
                              for l in sorted(host) for t in sorted(host[l]) for h in "ab"])
            assert torch.equal(_device_slot(cm, slot), want)
        assert {mgr.get("gpt2", t).state for t in ("t0", "t1")} == {COLD}
        assert set(server.engine.runner.resident_bytes()) == {"gpt2", "gpt2:t2", "gpt2:t3"}
    _run(scenario())


def test_demotion_and_rebuild_leave_adapters_cold():
    """A base's demotion resets its tenants to cold and the next attach
    zeroes every device slot of the restored base first; a rebuilt engine
    (another CompiledModel) resets the pool at its next use."""
    async def scenario():
        mgr, server, clock = _fake_stack()
        cm = server.engine.models["gpt2"]
        await mgr.ensure_attached("gpt2", "t0")
        await mgr.ensure_attached("gpt2", "t1")
        mgr.on_base_demoted("gpt2")
        assert {mgr.get("gpt2", t).state for t in ("t0", "t1")} == {COLD}
        assert set(server.engine.runner.resident_bytes()) == {"gpt2"}
        assert _device_slot(cm, 2).any()  # the restored weights kept the old values
        await mgr.ensure_attached("gpt2", "t1")
        assert mgr.get("gpt2", "t1").slot == 1 and not _device_slot(cm, 2).any()
        server.engine.models["gpt2"] = SimpleNamespace(servable=cm.servable)
        await mgr.ensure_attached("gpt2", "t2")
        assert mgr.get("gpt2", "t1").state == COLD and mgr.get("gpt2", "t2").slot == 1
    _run(scenario())


def test_default_load_imports_then_streams_from_the_checkpoint_store(tmp_path):
    """An adapter with a PEFT checkpoint: the first load converts the file
    (the JAX package's tree, byte for byte) and seeds the checkpoint store
    under (base, adapter); a later load streams it from the store; a
    checkpoint of another rank than the pool's is refused at attach."""
    from safetensors.numpy import save_file

    from pytorch_zappa_serverless_tpu_torch.serving.ckptstore import CheckpointStore

    g = np.random.default_rng(8)
    sd = {}
    for i in range(2):
        pre = f"base_model.model.transformer.h.{i}.attn.c_attn"
        sd[f"{pre}.lora_A.weight"] = g.standard_normal((4, 32)).astype(np.float32)
        sd[f"{pre}.lora_B.weight"] = g.standard_normal((96, 4)).astype(np.float32)
    ckpt = tmp_path / "tenant.safetensors"
    save_file(sd, str(ckpt))
    mgr, server, _ = _fake_stack()
    server.ckpt_store = CheckpointStore(tmp_path / "store")
    meta = {**server.engine.models["gpt2"].servable.meta["adapters"],
            "dims": {"q": (32, 32), "k": (32, 32), "v": (32, 32)}}
    want = JW.import_adapter(ckpt)
    first = mgr._default_load("gpt2", "t0", {"checkpoint": str(ckpt)}, meta)
    assert server.ckpt_store.has("gpt2", adapter="t0")
    again = mgr._default_load("gpt2", "t0", {"checkpoint": str(ckpt)}, meta)
    for tree in (first, again):
        for lname, layer in want.items():
            for t, node in layer.items():
                for h in "ab":
                    assert np.asarray(tree[lname][t][h]).tobytes() == node[h].tobytes()
    assert isinstance(again["layer0"]["q"]["a"], torch.Tensor)  # streamed: torch leaves
    with pytest.raises(ValueError, match="exceeds the configured adapter_rank"):
        mgr._default_load("gpt2", "t1", {"checkpoint": str(ckpt)}, {**meta, "rank": 2})


@pytest.mark.parametrize("pkg", [FaultInjector, jfaults.FaultInjector], ids=["port", "jax"])
def test_adapter_fault_rule_targets_attach_only(pkg):
    inj = pkg()
    inj.configure(model="gpt2:t0", fail_every_n=1, count=1, kind="adapter")
    inj.configure(model="gpt2", fail_every_n=1, count=1, kind="transient")
    assert len(inj.snapshot()["rules"]) == 2
    with pytest.raises(RuntimeError, match="adapter"):
        inj.on_adapter("gpt2:t0")
    assert inj.injected["adapter"] == 1
    inj.on_adapter("gpt2:t0")   # count spent
    inj.on_adapter("gpt2:t1")   # another tenant
    inj.on_dispatch("gpt2:t0")  # never on a dispatch
    inj.configure(model="gpt2", fail_every_n=1, count=2, kind="adapter")
    for key in ("gpt2:t1", "gpt2:t2"):
        with pytest.raises(RuntimeError):
            inj.on_adapter(key)


# ---------------------------------------------------------------------------
# HTTP: the port's serving stack on the CPU
# ---------------------------------------------------------------------------

def _http_cfg(kv_cache="slot", **kw):
    return ServeConfig(warmup_at_boot=False, models=[ModelConfig(
        name="gpt2", dtype="float32", batch_buckets=(1, 2, 4), seq_buckets=(8,),
        coalesce_ms=60.0, adapter_slots=2, adapter_rank=4, kv_cache=kv_cache,
        kv_block_size=4,
        adapters={"tenant-a": {"seed": 1, "alpha": ALPHA, "tenants": ["alice"]},
                  "tenant-b": {"seed": 2, "alpha": ALPHA}},
        extra={"max_new_tokens": 4, "arch": TINY_ARCH, "gen_slots": 2,
               "segment_tokens": 2})], **kw)


def _serve(cfg):
    return BackgroundServer(cfg, device="cpu")


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request(method, path, body=json.dumps(body).encode() if body is not None else None,
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        raw = r.read()
        heads = dict(r.getheaders())
        try:
            return r.status, json.loads(raw), heads
        except ValueError:
            return r.status, raw.decode(), heads
    finally:
        conn.close()


def _predict(port, adapter=None, headers=None, ids=(5, 6, 7)):
    h = dict(headers or {})
    if adapter:
        h["X-Adapter"] = adapter
    return _call(port, "POST", "/v1/models/gpt2:predict", {"input_ids": list(ids)}, h)


def _jax_tokens(slot_seeds: dict, slot: int, ids, max_new=4, seq=8):
    """The JAX package's greedy tokens for ``ids`` at ``slot`` of a pool
    holding ``slot_seeds`` {slot: adapter seed}, the port's seed weights."""
    import jax

    cfg = _jcfg()
    stacks = {f"layer{i}": JL.zero_stacks(3, 4, DIMS) for i in range(cfg.layers)}
    for s, seed in slot_seeds.items():
        JL.install_adapter(stacks, s, JW.init_lora(cfg.layers, DIMS, 4, seed=seed),
                           scaling=ALPHA / 4)
    params = jax.tree.map(jnp.asarray, {**JG.init_gpt2_params(0, cfg), "__adapters__": stacks})
    toks = np.zeros((1, seq), np.int32)
    toks[0, :len(ids)] = ids
    out = np.asarray(JG.generate(params, jnp.asarray(toks), jnp.asarray([len(ids)], jnp.int32),
                                 jnp.zeros((1,), jnp.float32), jnp.zeros((1,), jnp.int32),
                                 max_new, cfg, jnp.float32,
                                 adapter_idx=jnp.asarray([slot], jnp.int32)))[0].tolist()
    return out[:out.index(cfg.eos_id)] if cfg.eos_id in out else out


def _spans(node):
    yield node
    for c in node.get("children", []):
        yield from _spans(c)


def test_two_tenants_cobatch_one_dispatch():
    """Two tenants' adapters on one resident base serve from one co-batched
    dispatch (the trace's batch mates and the head span's adapter mix), each
    row its solo run's and the JAX package's tokens at its slot, distinct
    from the base; the per-tenant ring and served counts on /metrics."""
    with _serve(_http_cfg()) as srv:
        port = srv.port
        st, body, _ = _predict(port)
        assert st == 200, body
        base = body["predictions"]["tokens"]
        solo = {}
        for name in ("tenant-a", "tenant-b"):
            st, body, heads = _predict(port, adapter=name)
            assert st == 200 and heads["X-Adapter"] == name, body
            solo[name] = body["predictions"]["tokens"]
        assert solo["tenant-a"] != solo["tenant-b"] and solo["tenant-a"] != base
        _, snap, _ = _call(port, "GET", "/admin/adapters")
        slots = {n: s["slot"] for n, s in snap["models"]["gpt2"].items()}
        seeds = {slots["tenant-a"]: 1, slots["tenant-b"]: 2}
        for name in ("tenant-a", "tenant-b"):
            assert solo[name] == _jax_tokens(seeds, slots[name], [5, 6, 7])
        assert base == _jax_tokens(seeds, 0, [5, 6, 7])

        res = {}

        def go(name):
            res[name] = _predict(port, adapter=name)

        import threading

        threads = [threading.Thread(target=go, args=(n,)) for n in ("tenant-a", "tenant-b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        (sa, ba, ha), (sb, bb, hb) = res["tenant-a"], res["tenant-b"]
        assert sa == 200 and sb == 200
        assert ba["predictions"]["tokens"] == solo["tenant-a"]
        assert bb["predictions"]["tokens"] == solo["tenant-b"]
        ta, tb = ha["X-Trace-Id"], hb["X-Trace-Id"]
        linked = mixed = False
        for tid, mate in ((ta, tb), (tb, ta)):
            _, tr, _ = _call(port, "GET", f"/admin/trace/{tid}")
            for sp in _spans(tr["trace"]["tree"]):
                attrs = sp.get("attrs", {})
                linked |= mate in (attrs.get("batch_mates") or [])
                mixed |= set(attrs.get("adapters") or ()) == {"tenant-a", "tenant-b"}
        assert linked and mixed
        _, m, _ = _call(port, "GET", "/metrics")
        assert m["adapters"]["multi_adapter_batches"] >= 1
        assert m["models"]["gpt2:tenant-a"]["requests"] >= 2
        assert m["adapters"]["models"]["gpt2"]["tenant-a"]["served"] >= 2


def test_idle_detach_cold_503_and_reattach():
    cfg = _http_cfg(adapter_idle_unload_s=0.15, adapter_attach_estimate_ms=800.0)
    with _serve(cfg) as srv:
        port = srv.port
        st, body, _ = _predict(port, adapter="tenant-a")
        assert st == 200, body
        _, m, _ = _call(port, "GET", "/metrics")
        assert m["hbm"]["by_model"].get("gpt2:tenant-a", 0) > 0
        deadline = time.monotonic() + WAIT_S
        while True:
            _, snap, _ = _call(port, "GET", "/admin/adapters")
            if snap["models"]["gpt2"]["tenant-a"]["state"] == "cold":
                break
            assert time.monotonic() < deadline, "the idle adapter never detached"
            time.sleep(0.05)
        _, m, _ = _call(port, "GET", "/metrics")
        assert "gpt2:tenant-a" not in m["hbm"]["by_model"]
        st, body, heads = _predict(port, adapter="tenant-b", headers={"X-Deadline-Ms": "100"})
        assert st == 503, body
        assert body["adapter_cold"] is True and body["adapter"] == "tenant-b"
        assert body["estimated_attach_ms"] > 100 and int(heads["Retry-After"]) >= 1
        assert body["request_id"] and body["trace_id"]
        st, body, _ = _predict(port, adapter="tenant-a")
        assert st == 200, body
        _, snap, _ = _call(port, "GET", "/admin/adapters")
        assert snap["models"]["gpt2"]["tenant-a"]["state"] == "active"
        assert snap["models"]["gpt2"]["tenant-a"]["attaches"] >= 2


def test_adapter_chaos_one_tenant_poisoned():
    with _serve(_http_cfg()) as srv:
        port = srv.port
        st, base, _ = _predict(port)
        st, body, _ = _call(port, "POST", "/admin/faults",
                            {"model": "gpt2:tenant-b", "fail_every_n": 1, "kind": "adapter"})
        assert st == 200, body
        st, body, heads = _predict(port, adapter="tenant-b")
        assert st == 503 and body.get("adapter_attach_failed") and "Retry-After" in heads
        st, body, _ = _predict(port, adapter="tenant-a")
        assert st == 200, body
        st, again, _ = _predict(port)
        assert st == 200 and again["predictions"] == base["predictions"]
        _, snap, _ = _call(port, "GET", "/admin/adapters")
        assert snap["models"]["gpt2"]["tenant-b"]["state"] == "cold"
        st, _, _ = _call(port, "POST", "/admin/faults", {"clear": True, "model": "gpt2:tenant-b"})
        assert st == 200
        st, body, _ = _predict(port, adapter="tenant-b")
        assert st == 200, body


def test_unknown_adapter_404_ladder_discovery_and_admin():
    with _serve(_http_cfg()) as srv:
        port = srv.port
        _, models, _ = _call(port, "GET", "/v1/models")
        assert models["models"]["gpt2"]["adapters"] == {"tenant-a": "cold", "tenant-b": "cold"}
        for kw in ({"adapter": "nope"}, {"headers": {"X-Tenant": "stranger"}}):
            st, body, _ = _predict(port, **kw)
            assert st == 404 and body["model"] == "gpt2", body
            assert set(body["adapters"]) == {"tenant-a", "tenant-b"}
            assert body["adapters"]["tenant-a"]["tenants"] == ["alice"]
            assert body["request_id"] and body["trace_id"]
        st, body, _ = _call(port, "POST", "/v1/models/gpt2:predict",
                            {"input_ids": [5, 6], "adapter": "tenant-a"})
        assert st == 200, body
        st, body, heads = _predict(port, headers={"X-Tenant": "alice"})
        assert st == 200 and heads["X-Adapter"] == "tenant-a"
        _, models, _ = _call(port, "GET", "/v1/models")
        assert models["models"]["gpt2"]["adapters"]["tenant-a"] == "active"
        _, one, _ = _call(port, "GET", "/admin/models/gpt2")
        assert one["model"]["adapters"]["tenant-a"] == "active"
        _, root, _ = _call(port, "GET", "/")
        assert root["adapters"] == {"gpt2": ["tenant-a", "tenant-b"]}
        # The admin routes: attach, detach, 409 on a cold adapter, 400, 404.
        st, body, _ = _call(port, "POST", "/admin/adapters/gpt2/tenant-b", {"action": "attach"})
        assert st == 200 and body["adapter"]["state"] == "active", body
        st, body, _ = _call(port, "POST", "/admin/adapters/gpt2/tenant-b", {"action": "detach"})
        assert st == 200 and body["adapter"]["state"] == "cold", body
        assert _call(port, "POST", "/admin/adapters/gpt2/tenant-b", {"action": "detach"})[0] == 409
        assert _call(port, "POST", "/admin/adapters/gpt2/tenant-b", {"action": "x"})[0] == 400
        assert _call(port, "POST", "/admin/adapters/gpt2/nope", {"action": "attach"})[0] == 404


def test_adapter_jobs_keyed_by_model_adapter():
    with _serve(_http_cfg()) as srv:
        port = srv.port
        st, body, _ = _predict(port, adapter="tenant-a", ids=(9, 10, 11))
        want = body["predictions"]["tokens"]
        st, ack, heads = _call(port, "POST", "/v1/models/gpt2:submit",
                               {"input_ids": [9, 10, 11], "adapter": "tenant-a"})
        assert st == 202 and ack["adapter"] == "tenant-a" and heads["X-Adapter"] == "tenant-a"
        deadline = time.monotonic() + WAIT_S
        while True:
            _, job, _ = _call(port, "GET", f"/v1/jobs/{ack['job']['id']}")
            if job["job"]["status"] in ("done", "error", "failed"):
                break
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert job["job"]["status"] == "done", job
        assert job["job"]["result"]["tokens"] == want


def test_paged_generate_per_stream_adapter_and_prefix_invalidation():
    """An adapter stream on the paged lane gives the fixed route's tokens
    at its slot, a base stream beside it the base's; the slot lane refuses
    an adapter stream naming paged; a detach drops its slot's prefix
    tree, and the prefix tree keeps the tenants apart."""
    with _serve(_http_cfg(kv_cache="paged")) as srv:
        port = srv.port
        ids = [4, 5, 6, 7, 8]
        st, body, _ = _predict(port, adapter="tenant-a", ids=ids)
        want = body["predictions"]["tokens"]
        st, body, heads = _call(port, "POST", "/v1/models/gpt2:generate",
                                {"input_ids": ids, "stream": False},
                                {"X-Adapter": "tenant-a"})
        assert st == 200 and heads["X-Adapter"] == "tenant-a", body
        got = body["predictions"]["tokens"]
        assert got == want
        st, body, _ = _call(port, "POST", "/v1/models/gpt2:generate",
                            {"input_ids": ids, "stream": False})
        base = body["predictions"]["tokens"]
        assert base == _predict(port, ids=ids)[1]["predictions"]["tokens"] and base != got
        # The same prompt again under the tenant: its own prefix tree (a hit
        # under slot 1, never the base's pages), the same tokens.
        st, body, _ = _call(port, "POST", "/v1/models/gpt2:generate",
                            {"input_ids": ids, "stream": False}, {"X-Adapter": "tenant-a"})
        assert body["predictions"]["tokens"] == got
        assert body["predictions"]["stats"].get("prefix_cached_tokens", 0) > 0
        _, pre, _ = _call(port, "GET", "/admin/prefix")
        nodes = pre["models"]["gpt2"]["nodes"]
        assert _call(port, "POST", "/admin/adapters/gpt2/tenant-a", {"action": "detach"})[0] == 200
        _, pre, _ = _call(port, "GET", "/admin/prefix")
        assert pre["models"]["gpt2"]["nodes"] < nodes
        st, body, _ = _call(port, "POST", "/v1/models/gpt2:generate",
                            {"input_ids": ids, "stream": False}, {"X-Adapter": "tenant-a"})
        assert st == 200 and body["predictions"]["tokens"] == got
    with _serve(_http_cfg()) as srv:
        st, body, _ = _call(srv.port, "POST", "/v1/models/gpt2:generate",
                            {"input_ids": [4, 5], "stream": False}, {"X-Adapter": "tenant-a"})
        assert st == 400 and "paged" in body["error"], body


def test_adapter_metrics_families_and_manifest():
    with _serve(_http_cfg()) as srv:
        port = srv.port
        assert _predict(port, adapter="tenant-a")[0] == 200
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        conn.request("GET", "/metrics?format=prometheus")
        text = conn.getresponse().read().decode()
        conn.close()
    assert 'tpuserve_adapter_residency{adapter="tenant-a",model="gpt2"} 2' in text
    assert 'tpuserve_adapter_served_total{adapter="tenant-a",model="gpt2"}' in text
    assert "tpuserve_adapter_attach_ms_bucket" in text
    assert "tpuserve_adapter_multi_batches_total" in text
    spec = importlib.util.spec_from_file_location("check_metrics",
                                                  ROOT / "tools" / "check_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.check(text, mod.load_manifest()) == []


class _SSE:
    def __init__(self, port, method, path, body=None, headers=None):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        self.conn.request(method, path,
                          body=json.dumps(body).encode() if body is not None else None,
                          headers={"Content-Type": "application/json", **(headers or {})})
        self.resp = self.conn.getresponse()
        self.headers = dict(self.resp.getheaders())

    def events(self, n=None):
        out = []
        while n is None or len(out) < n:
            line = self.resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                out.append(json.loads(line[6:]))
        return out

    def close(self):
        self.conn.close()


def _mig_cfg():
    cfg = _http_cfg(kv_cache="paged")
    mc = cfg.models[0]
    mc.extra = {**mc.extra, "max_new_tokens": 16}
    mc.seq_buckets = (16,)
    return cfg


def test_adapter_stream_migrates_byte_equal():
    """An adapter stream exported mid-decode from one server and imported
    on another: the manifest names the adapter, the importer attaches it at
    its own slot (1, where the source held it at 2) before it places the
    pages, and the stream ends byte-equal to the one left in place."""
    payload = {"input_ids": list(range(5, 15)), "max_new_tokens": 16}
    with _serve(_mig_cfg()) as src, _serve(_mig_cfg()) as dst:
        for port in (src.port, dst.port):
            st, body, _ = _call(port, "POST", "/admin/faults", {"model": "gpt2",
                                                               "latency_ms": 15.0})
            assert st == 200, body
        # On the source tenant-b takes slot 1, so tenant-a streams from 2.
        assert _call(src.port, "POST", "/admin/adapters/gpt2/tenant-b",
                     {"action": "attach"})[0] == 200
        st, body, _ = _call(src.port, "POST", "/v1/models/gpt2:generate",
                            {**payload, "stream": False}, {"X-Adapter": "tenant-a"})
        assert st == 200, body
        want = body["predictions"]["tokens"]
        s = _SSE(src.port, "POST", "/v1/models/gpt2:generate", payload, {"X-Adapter": "tenant-a"})
        sid = s.headers["X-Stream-Id"]
        head = [ev["token"] for ev in s.events(3)]
        st, snap, _ = _call(src.port, "POST", f"/admin/streams/{sid}/export",
                            {"phase": "snapshot"})
        assert st == 200, snap
        pages = {p["i"]: p for p in snap["pages"]}
        st, cut, _ = _call(src.port, "POST", f"/admin/streams/{sid}/export",
                           {"phase": "cutover", "have": sorted(pages)})
        assert st == 200 and cut["manifest"]["adapter"] == "tenant-a", cut
        pages.update({p["i"]: p for p in cut["pages"]})
        st, imp, _ = _call(dst.port, "POST", "/admin/streams/mv-1/import",
                           {"manifest": cut["manifest"], "pages": list(pages.values())})
        assert st == 200 and imp["imported"], imp
        _, snap, _ = _call(dst.port, "GET", "/admin/adapters")
        assert snap["models"]["gpt2"]["tenant-a"]["slot"] == 1
        st, commit, _ = _call(src.port, "POST", f"/admin/streams/{sid}/export",
                              {"phase": "commit"})
        assert st == 200, commit
        tail = s.events()
        s.close()
        src_tokens = head + [ev["token"] for ev in tail if "token" in ev]
        assert tail[-1].get("migrated") is True and len(src_tokens) == commit["watermark"]
        att = _SSE(dst.port, "GET", f"/admin/streams/mv-1/attach?from={len(src_tokens)}")
        evs = att.events()
        att.close()
        got = src_tokens + [ev["token"] for ev in evs if "token" in ev]
        assert got == want and evs[-1].get("done") is True
        # The stream held its adapter on the target until it ended.
        _, snap, _ = _call(dst.port, "GET", "/admin/adapters")
        assert snap["models"]["gpt2"]["tenant-a"]["inflight"] == 0
        assert _call(dst.port, "POST", "/admin/adapters/gpt2/tenant-a",
                     {"action": "detach"})[0] == 200


def test_speculation_falls_back_while_an_adapter_stream_is_active():
    """A paged lane with a draft: while an adapter stream is active every
    tick decodes plain (counted in ``spec_fallback_ticks``, nothing
    proposed), and the adapter and base streams give their fixed routes'
    tokens; with the base alone it speculates."""
    eng = build_engine(ServeConfig(warmup_at_boot=False, models=[
        ModelConfig(name="gpt2", dtype="float32", batch_buckets=(1, 2), seq_buckets=(8,),
                    kv_cache="paged", kv_block_size=4, spec_draft="gpt2_draft", spec_k=2,
                    adapter_slots=2, adapter_rank=4,
                    extra={"max_new_tokens": 8, "arch": TINY_ARCH, "gen_slots": 2,
                           "segment_tokens": 2}),
        ModelConfig(name="gpt2_draft", builder="gpt2", dtype="float32", batch_buckets=(1, 2),
                    seq_buckets=(8,), extra={"max_new_tokens": 8, "arch": TINY_ARCH,
                                             "gen_slots": 2, "segment_tokens": 2})]),
        device="cpu")
    try:
        cm, dcm = eng.model("gpt2"), eng.model("gpt2_draft")
        host = {f"layer{i}": PL.zero_stacks(3, 4, DIMS) for i in range(2)}
        PL.install_adapter(host, 1, PW.init_lora(2, DIMS, 4, seed=1), scaling=ALPHA / 4)
        eng.runner.run_fn_sync(PL.write_slot, cm.servable.module.tree()["__adapters__"], host, 1)

        def sample(ids, slot=0):
            s = cm.servable.preprocess({"input_ids": ids})
            s["adapter_idx"] = np.int32(slot)
            return s

        fixed = {k: eng.runner.run_fn_sync(cm.run_batch, [sample([5, 6, 7], k)])[0][0]["tokens"]
                 for k in (0, 1)}
        assert fixed[0] != fixed[1]

        async def scenario():
            sched = PagedGenerationScheduler(cm, eng.runner, cm.cfg,
                                             draft=DraftGate("gpt2_draft", lambda: dcm)).start()
            try:
                reqs = [sched.submit(sample([5, 6, 7], 1)), sched.submit(sample([5, 6, 7], 0))]
                got = [await asyncio.wait_for(r.done, WAIT_S) for r in reqs]
                assert sched.spec_fallback_ticks > 0 and sched.spec_proposed == 0
                assert got == [fixed[1], fixed[0]]
                alone = await asyncio.wait_for(sched.submit(sample([5, 6, 7], 0)).done, WAIT_S)
                assert alone == fixed[0] and sched.spec_proposed > 0
            finally:
                await sched.stop()

        _run(scenario())
    finally:
        eng.shutdown()
