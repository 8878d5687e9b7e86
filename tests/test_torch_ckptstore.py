"""The port's streaming checkpoint store and disk tier
(pytorch_zappa_serverless_tpu_torch/serving/ckptstore.py, engine/streamio.py),
on the CPU: the JAX package's ``tests/test_ckptstore.py`` case for case, under
the same names.

Store half: content-addressed put/load round trips, chunk dedup across
variants and adapters, write-once staging, a torn chunk recovered by one
re-read against a persistent tear naming its chunk, the slow mode, and the
accounting snapshot.  The port's loads return torch tensors (bfloat16 too,
with no ``ml_dtypes``), compared here byte for byte with the numpy trees put
in.  Lifecycle half: the disk rung against the fake stack of
``tests/test_torch_lifecycle.py``, then the port's HTTP server over a lazy
48 px ResNet-18: ``demote to=disk`` over ``/admin/models``, byte-identical
predictions after the disk restore, the 409/400 admin answers, and
``kind="ckpt"`` chaos degrading to the full rebuild, never a dead
activation.
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_lifecycle import FakeCM, FakeClock, FakeServer, _http, _model, _png, _unit_cfg

from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import streamio
from pytorch_zappa_serverless_tpu_torch.engine import weights as W
from pytorch_zappa_serverless_tpu_torch.faults import FaultInjector
from pytorch_zappa_serverless_tpu_torch.serving.ckptstore import (CheckpointStore,
                                                                   checkpoint_fingerprint,
                                                                   store_key)
from pytorch_zappa_serverless_tpu_torch.serving.lifecycle import ACTIVE, COLD, LifecycleManager
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer


def _tree(seed=0, kib=64):
    """A small multi-tensor tree with deterministic bytes."""
    rng = np.random.default_rng(seed)
    n = kib * 1024 // 4 // 4
    return {"wte": rng.standard_normal((n,)).astype(np.float32),
            "h0": {"w": rng.standard_normal((n,)).astype(np.float32)},
            "h1": {"w": rng.standard_normal((n,)).astype(np.float32)},
            "ln_f": {"scale": rng.standard_normal((n,)).astype(np.float32)}}


def _bytes(x) -> tuple[str, tuple, bytes]:
    """(dtype name, shape, bytes) of a numpy array or a torch tensor."""
    return streamio.leaf_bytes(x)[0], tuple(x.shape), bytes(streamio.leaf_bytes(x)[2])


def _assert_identical(expected, got):
    eflat, gflat = W.flatten_tree(expected), W.flatten_tree(got)
    assert set(eflat) == set(gflat)
    for name, e in eflat.items():
        assert _bytes(gflat[name]) == _bytes(e), name


# -- store: round trip, dedup, accounting -------------------------------------

def test_put_load_round_trip_write_once(tmp_path):
    store = CheckpointStore(tmp_path / "s", chunk_bytes=8192)
    tree = _tree(0)
    out = store.put("m", tree)
    assert out["skipped"] is False and out["chunks_written"] > 0
    assert store.has("m")
    got, stats = store.load("m")
    _assert_identical(tree, got)
    assert all(isinstance(v, torch.Tensor) for v in W.flatten_tree(got).values())
    assert stats.chunks_streamed == len(store.index_for("m").chunks)
    assert stats.torn_retries == 0

    # Write-once: re-staging an unchanged checkpoint is a no-op.
    again = store.put("m", _tree(1))
    assert again["skipped"] is True and again["chunks_written"] == 0
    _assert_identical(tree, store.load("m")[0])
    forced = store.put("m", _tree(1), force=True)
    assert forced["skipped"] is False
    _assert_identical(_tree(1), store.load("m")[0])


def test_chunk_dedup_across_variants_and_adapters(tmp_path):
    """Two variants sharing early layers share those chunk files, and an
    adapter manifest under ``(base, adapter)`` holds only the delta."""
    store = CheckpointStore(tmp_path / "s", chunk_bytes=4096)
    base = _tree(0)
    variant = dict(base, ln_f={"scale": _tree(9)["ln_f"]["scale"]})
    store.put("m", base)
    out = store.put("m-v2", variant)
    assert out["dedup_hits"] > 0

    delta = {"lora": {"a": np.ones((4, 2), np.float32), "b": np.zeros((2, 4), np.float32)}}
    store.put("m", delta, adapter="t1")
    assert store.has("m", "t1") and store_key("m", "t1") == "m+t1"
    assert sorted(store.keys()) == [("m", ""), ("m", "t1"), ("m-v2", "")]
    _assert_identical(delta, store.load("m", "t1")[0])
    assert store.manifest_nbytes("m", "t1") == 4 * 2 * 4 * 2

    snap = store.snapshot()
    assert snap["manifests"] == 3
    assert snap["physical_bytes"] < snap["logical_bytes"]
    assert snap["dedup_ratio"] > 1.0
    assert snap["dedup_hits_total"]["m-v2"] == out["dedup_hits"]
    assert store.load("m")[0] is not None
    assert store.snapshot()["chunks_streamed_total"]["m"] > 0

    # Dropping one manifest keeps the shared chunks for the others.
    assert store.delete("m-v2") and not store.delete("m-v2")
    _assert_identical(base, store.load("m")[0])


def test_consumer_failure_does_not_deadlock(tmp_path):
    """A consumer-side failure (place_fn out of memory) with the staging ring
    full propagates instead of hanging the join on a reader blocked on the
    bounded queue."""
    store = CheckpointStore(tmp_path / "s", chunk_bytes=4096)
    tree = _tree(0, kib=256)  # many more chunks than the pipeline's depth
    store.put("m", tree)

    def boom(arr):
        raise RuntimeError("device OOM")

    done = []

    def run():
        with pytest.raises(RuntimeError, match="device OOM"):
            store.load("m", place_fn=boom)
        done.append(True)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=15.0)
    assert done, "stream_load deadlocked on a consumer-side failure"
    _assert_identical(tree, store.load("m")[0])


def test_fingerprint_invalidates_stale_manifest(tmp_path):
    """A manifest staged from an older source checkpoint reads as a miss: a
    swapped checkpoint never serves its predecessor's bytes."""
    ckpt = tmp_path / "m.bin"
    ckpt.write_bytes(b"v1-weights")
    fp1 = checkpoint_fingerprint(str(ckpt))
    store = CheckpointStore(tmp_path / "s", chunk_bytes=8192)
    assert store.put("m", _tree(0), fingerprint=fp1)["skipped"] is False
    assert store.has("m") and store.has("m", fingerprint=fp1)
    assert store.put("m", _tree(1), fingerprint=fp1)["skipped"] is True
    _assert_identical(_tree(0), store.load("m")[0])

    ckpt.write_bytes(b"v2-weights-longer")
    fp2 = checkpoint_fingerprint(str(ckpt))
    assert fp2 != fp1
    assert store.has("m") and not store.has("m", fingerprint=fp2)
    assert store.put("m", _tree(1), fingerprint=fp2)["skipped"] is False
    _assert_identical(_tree(1), store.load("m")[0])
    assert store.has("m", fingerprint=fp2)
    assert not store.has("m", fingerprint=fp1)

    assert checkpoint_fingerprint(None) == ""
    assert checkpoint_fingerprint("") == ""
    assert checkpoint_fingerprint(str(tmp_path / "ghost.bin")).startswith("missing:")


def test_corrupt_manifest_keeps_accounting_alive(tmp_path):
    """One bad manifest file does not take down snapshot()/admin/models:
    it accounts as 0 bytes and misses every has() probe."""
    store = CheckpointStore(tmp_path / "s", chunk_bytes=8192)
    store.put("m", _tree(0))
    store.put("ok", _tree(1))

    store._manifest_path("m", "").write_text("{not json")
    assert store.manifest_nbytes("m") == 0
    assert not store.has("m", fingerprint="anything")
    snap = store.snapshot()
    assert snap["manifests"] == 1
    assert snap["logical_bytes"] == store.manifest_nbytes("ok")

    store._manifest_path("m", "").write_text(json.dumps(
        {"manifest_version": 99, "base": "m", "adapter": ""}))
    assert store.manifest_nbytes("m") == 0
    assert not store.has("m", fingerprint="anything")
    store.snapshot()


# -- store: chaos --------------------------------------------------------------

def _ckpt_faults(model="*", mode="torn", fail_every_n=1, count=None, latency_ms=0.0):
    inj = FaultInjector()
    inj.configure(model=model, fail_every_n=fail_every_n, count=count, kind="ckpt", mode=mode,
                  latency_ms=latency_ms)
    return inj


def test_torn_chunk_recovers_with_one_reread(tmp_path):
    store = CheckpointStore(tmp_path / "s", chunk_bytes=4096, faults=_ckpt_faults(count=1))
    tree = _tree(0)
    store.put("m", tree)
    got, stats = store.load("m")
    _assert_identical(tree, got)
    assert stats.torn_retries == 1
    assert store.faults.snapshot()["injected"]["ckpt"] == 1


def test_persistent_tear_names_the_chunk(tmp_path):
    store = CheckpointStore(tmp_path / "s", chunk_bytes=4096, faults=_ckpt_faults())
    store.put("m", _tree(0))
    with pytest.raises(streamio.ChunkIntegrityError) as ei:
        store.load("m")
    assert ei.value.chunk_index == 0
    assert "chunk 0" in str(ei.value)
    store.note_degraded()
    assert store.snapshot()["degraded_loads_total"] == 1


def test_slow_mode_injects_per_chunk_latency(tmp_path):
    store = CheckpointStore(tmp_path / "s", chunk_bytes=1 << 20)
    store.put("m", _tree(0))  # one chunk
    t0 = time.perf_counter()
    store.load("m")
    clean_s = time.perf_counter() - t0
    store.faults = _ckpt_faults(mode="slow", latency_ms=80.0)
    t0 = time.perf_counter()
    got, _ = store.load("m")
    assert time.perf_counter() - t0 >= clean_s + 0.05
    _assert_identical(_tree(0), got)


def test_missing_chunk_surfaces_for_degrade(tmp_path):
    store = CheckpointStore(tmp_path / "s", chunk_bytes=4096)
    store.put("m", _tree(0))
    store._chunk_path(store.index_for("m").chunks[0].hash).unlink()
    with pytest.raises(FileNotFoundError):
        store.load("m")
    with pytest.raises(FileNotFoundError):
        store.load("ghost")


# -- acceptance smoke: parity with the whole-file path --------------------------

def test_stream_parity_with_import_params(tmp_path):
    """A streamed load of a converted torch checkpoint lands byte-equal to
    the whole-file ``import_params`` path (parse + the converter's layout
    pass), with placement through the pipeline's ``place_fn``."""
    rng = np.random.default_rng(3)
    sd = {f"h.{i}.weight": torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
          for i in range(12)}
    ckpt = tmp_path / "m.pt"
    torch.save(sd, ckpt)

    def convert(state):
        # The usual converter layout pass: torch (out, in) → (in, out).
        return {f"h{i}": {"w": np.ascontiguousarray(np.asarray(state[f"h.{i}.weight"]).T)}
                for i in range(12)}

    legacy = W.import_params(ckpt, convert)
    stream = tmp_path / f"m{W.STREAM_SUFFIX}"
    W.save_stream(tree := convert({k: v.numpy() for k, v in sd.items()}), stream,
                  chunk_bytes=1 << 16)
    streamed, stats = W.open_stream(stream, place_fn=streamio.device_placer("cpu"))
    assert stats.chunks_streamed > 1 and stats.tensors == 12
    _assert_identical(legacy, streamed)
    _assert_identical(tree, streamed)
    _assert_identical(tree, W.import_params(stream, convert))  # the stream fast path


# -- lifecycle: the disk rung (fake stack) -------------------------------------

class DiskCM(FakeCM):
    """FakeCM with the disk-tier hand-offs and a real param tree, so the
    demotion runs the REAL store.put/store.load."""

    def __init__(self, params, nbytes=100):
        super().__init__(nbytes)
        self.params = params
        self.disk_offloads = 0
        self.disk_restores = 0

    def disk_offload(self, save_fn):
        save_fn(self.params)
        self.params = None
        self.disk_offloads += 1

    def disk_restore(self, load_fn):
        self.params = load_fn()
        assert self.params is not None
        self.disk_restores += 1


def _mgr_store(tmp_path, names=("m",), nbytes=100, **cfg_kw):
    cfg = _unit_cfg(tmp_path, names, **cfg_kw)
    server = FakeServer(cfg)
    clock = FakeClock()
    store = CheckpointStore(tmp_path / "store", chunk_bytes=8192)
    builds = {}
    trees = {n: _tree(seed=i, kib=16) for i, n in enumerate(names)}

    def build(name, from_tier, host_cm):
        builds[name] = builds.get(name, 0) + 1
        if from_tier == "disk" and host_cm is not None:
            host_cm.disk_restore(lambda: store.load(name)[0])
            return host_cm
        if from_tier == "host" and host_cm is not None:
            host_cm.device_restore()
            return host_cm
        return DiskCM(trees[name], nbytes)

    mgr = LifecycleManager(server, cfg, build_fn=build, clock=clock, store=store)
    return mgr, server, clock, builds, store, trees


def test_demote_active_to_disk_seeds_store(tmp_path):
    async def scenario():
        mgr, server, clock, builds, store, trees = _mgr_store(tmp_path)
        await mgr.ensure_active("m")
        res = mgr.residency("m")
        assert not store.has("m")

        assert await mgr.demote("m", to="disk", cause="admin")
        assert res.state == COLD and res.tier == "disk"
        assert res.cm_host is not None and res.cm_host.disk_offloads == 1
        assert server.engine.runner.resident_bytes() == {}
        assert store.has("m")
        _assert_identical(trees["m"], store.load("m")[0])
        assert mgr.demotions_by_cause["m"]["admin"] == 1
        assert mgr.estimate_warm_ms("m") == 1000.0  # the disk prior

        cm = await mgr.ensure_active("m")
        assert res.state == ACTIVE and cm.disk_restores == 1
        assert builds["m"] == 2  # a restore, not a cold rebuild
        _assert_identical(trees["m"], cm.params)
        await mgr.demote("m", to="disk")
        assert mgr.estimate_warm_ms("m") < 1000.0  # the observed restore
    asyncio.run(scenario())


def test_demote_to_disk_without_store_lands_none(tmp_path):
    from test_torch_lifecycle import _mgr

    async def scenario():
        mgr, server, clock, builds = _mgr(tmp_path)
        await mgr.ensure_active("m")
        assert await mgr.demote("m", to="disk", cause="admin")
        res = mgr.residency("m")
        assert res.tier == "none" and res.cm_host is None
    asyncio.run(scenario())


def test_cold_ladder_host_disk_none(tmp_path):
    async def scenario():
        mgr, server, clock, builds, store, trees = _mgr_store(tmp_path)
        await mgr.ensure_active("m")
        res = mgr.residency("m")
        assert await mgr.demote("m", to="host")
        assert res.tier == "host"
        assert await mgr.demote("m", to="disk")  # COLD host → disk
        assert res.tier == "disk" and store.has("m")
        assert await mgr.demote("m", to="none")  # COLD disk → none
        assert res.tier == "none" and res.cm_host is None
        assert not await mgr.demote("m", to="none")  # already at the floor
    asyncio.run(scenario())


def test_idle_ladder_lands_on_disk_with_store(tmp_path):
    """The reaper's cold ladder: with a store, host-tier idle drops land on
    disk instead of none."""
    async def scenario():
        mgr, server, clock, builds, store, trees = _mgr_store(
            tmp_path, idle_unload_s=10.0, host_idle_drop_s=30.0)
        await mgr.ensure_active("m")
        res = mgr.residency("m")
        clock.advance(11)
        await mgr.tick_once()
        assert res.tier == "host"
        clock.advance(35)
        await mgr.tick_once()
        assert res.tier == "disk" and store.has("m")
        assert mgr.estimate_warm_ms("m") == 1000.0
    asyncio.run(scenario())


def test_host_budget_demotes_lru_to_disk(tmp_path):
    async def scenario():
        mgr, server, clock, builds, store, trees = _mgr_store(
            tmp_path, names=("a", "b"), nbytes=100, host_budget_bytes=150)
        await mgr.ensure_active("a")
        clock.advance(1)
        await mgr.ensure_active("b")
        clock.advance(1)
        await mgr.demote("a", to="host")
        await mgr.demote("b", to="host")  # 200 host bytes > 150
        await mgr.enforce_host_budget()
        ra, rb = mgr.residency("a"), mgr.residency("b")
        assert ra.tier == "disk"  # the LRU
        assert rb.tier == "host"
        assert store.has("a") and not store.has("b")
        assert mgr.demotions_by_cause["a"]["host_budget"] == 1
    asyncio.run(scenario())


def test_disk_offload_failure_falls_back_to_host(tmp_path):
    """A full or broken disk during demotion never strands the model in
    DRAINING_IDLE: ACTIVE → disk lands on the host rung, and COLD host →
    disk stays on host."""
    async def scenario():
        mgr, server, clock, builds, store, trees = _mgr_store(tmp_path)
        await mgr.ensure_active("m")
        res = mgr.residency("m")

        def full_disk(*a, **kw):
            raise OSError(28, "No space left on device")
        store.put = full_disk

        assert await mgr.demote("m", to="disk", cause="admin")
        assert res.state == COLD and res.tier == "host"
        assert res.cm_host is not None
        assert res.cm_host.params is not None

        assert not await mgr.demote("m", to="disk")
        assert res.tier == "host" and res.cm_host.params is not None

        cm = await mgr.ensure_active("m")
        assert res.state == ACTIVE and res.tier == "device"
        _assert_identical(trees["m"], cm.params)
    asyncio.run(scenario())


# -- HTTP: the port's server -----------------------------------------------------

def _http_cfg(**kw):
    base = dict(warmup_at_boot=True, lazy_load=True, activation_max_wait_s=120.0,
                models=[ModelConfig(name="resnet18", batch_buckets=(1, 2), dtype="float32",
                                    coalesce_ms=2.0,
                                    extra={"image_size": 48, "resize_to": 56})])
    base.update(kw)
    return ServeConfig(**base)


def _predict(port):
    status, body, _ = _http(port, "/v1/models/resnet18:predict", raw=_png(0))
    assert status == 200, body
    return body["predictions"]


def test_disk_tier_restore_serves_identical_bytes(tmp_path):
    with BackgroundServer(_http_cfg(ckpt_store_dir=str(tmp_path / "store")),
                          device="cpu") as srv:
        port = srv.port
        before = _predict(port)
        # The first cold build seeded the store (write-once staging).
        snap = _http(port, "/admin/models")[1]
        assert snap["ckpt_store"]["manifests"] == 1
        row = snap["models"]["resnet18"]
        assert row["disk_bytes"] > 0
        legacy = row["last_activation_phases"]  # the cold build
        assert legacy["tier"] == "none" and legacy["load_ms"] > 0

        status, body, _ = _http(port, "/admin/models/resnet18", {"action": "demote", "to": "disk"})
        assert status == 200, body
        row = _model(port)
        assert row["state"] == "cold" and row["tier"] == "disk"
        assert row["estimated_warm_ms"] <= 1000.0  # the disk prior, not a rebuild

        assert _predict(port) == before
        phases = _model(port)["last_activation_phases"]
        assert phases["tier"] == "disk" and phases["streamed"] is True
        assert phases["compile_ms"] == 0.0  # nothing to capture on the CPU
        # The streamed disk rung beats the whole-file build it replaces.
        assert phases["load_ms"] < legacy["load_ms"], (phases, legacy)

        snap = _http(port, "/admin/models")[1]
        assert snap["ckpt_store"]["chunks_streamed_total"]["resnet18"] > 0
        assert snap["ckpt_store"]["degraded_loads_total"] == 0


def test_admin_demote_contracts(tmp_path):
    # Without a store, to="disk" is a 409 (no rung to land on) ...
    with BackgroundServer(_http_cfg(), device="cpu") as srv:
        _predict(srv.port)
        assert _http(srv.port, "/admin/models/resnet18",
                     {"action": "demote", "to": "disk"})[0] == 409
        # ... and a made-up tier is a 400.
        assert _http(srv.port, "/admin/models/resnet18",
                     {"action": "demote", "to": "tape"})[0] == 400


def test_ckpt_chaos_degrades_never_kills(tmp_path):
    """kind="ckpt" mode="torn" on EVERY chunk read breaks the stream past
    its one re-read: the activation degrades to the full rebuild and still
    serves the same bytes."""
    with BackgroundServer(_http_cfg(ckpt_store_dir=str(tmp_path / "store")),
                          device="cpu") as srv:
        port = srv.port
        before = _predict(port)
        assert _http(port, "/admin/models/resnet18", {"action": "demote", "to": "disk"})[0] == 200
        status, body, _ = _http(port, "/admin/faults", {"model": "resnet18", "kind": "ckpt",
                                                        "mode": "torn", "fail_every_n": 1})
        assert status == 200, body
        assert _predict(port) == before  # degraded, not dead
        snap = _http(port, "/admin/models")[1]
        assert snap["ckpt_store"]["degraded_loads_total"] >= 1
        row = snap["models"]["resnet18"]
        assert row["state"] == "active"
        assert row["last_activation_phases"].get("streamed") is not True
        _http(port, "/admin/faults", {"clear": True})
