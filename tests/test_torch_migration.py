"""Live KV migration in the port, on the CPU: the twins of the JAX
package's ``tests/test_migration.py`` at its tiny arch (fp32, ``gen_slots``
2, ``segment_tokens`` 3, ``kv_block_size`` 4).

- The ``migration`` fault: validation, its own target, drop, corrupt and
  slow modes, as the JAX package's injector answers them.
- Scheduler level: a stream moved mid-decode between two paged pools
  (snapshot → cutover → import → commit) finishes with the tokens of the
  stream left in place, greedy and sampled, with no duplicate; an import
  dedupes the prompt pages against the target's prefix tree; an abort
  resumes in place.
- Pressure: two streams that must collide swap the newest to host and
  resume it from its own pages, with no eviction and both outputs exact;
  ``kv_migrate: false`` evicts instead; a drop on every swap falls back to
  eviction; a corrupt swap is caught and read again.

Greedy streams are held against the JAX package's fixed route on the same
seeded weights (its engine at fp32, the same arch), sampled ones against
the port's own (the port draws from its counter-based hash, not JAX's
PRNG).
- HTTP: export, import and attach with no token lost or repeated; a
  corrupt page caught by the importer and fetched again; a drop answers a
  retryable 503; the 409s and 400s; ``/admin/streams``, ``/admin/prefix``
  and the migration families through ``tools/check_metrics.py``.

Every wait is bounded.
"""

import asyncio
import http.client
import importlib.util
import json
from pathlib import Path

import pytest

from pytorch_zappa_serverless_tpu import faults as jfaults
from pytorch_zappa_serverless_tpu.config import ModelConfig as JModelConfig
from pytorch_zappa_serverless_tpu.config import ServeConfig as JServeConfig
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.faults import FaultInjector
from pytorch_zappa_serverless_tpu_torch.serving.generation import PagedGenerationScheduler
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

TINY_ARCH = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128,
             "vocab_size": 500, "max_positions": 96}
WAIT_S = 60
ROOT = Path(__file__).resolve().parents[1]
IDS_A, IDS_B = [5, 6, 7, 8, 9, 10, 11, 12], [9, 10, 11, 12, 13, 14]


def _model_cfg(**over):
    extra = {"max_new_tokens": 24, "arch": TINY_ARCH, "gen_slots": 2, "segment_tokens": 3}
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


@pytest.fixture(scope="module")
def jax_fixed(tmp_path_factory):
    """``want(ids, max_new)``: the JAX package's fixed-route greedy tokens
    for ``ids`` at the tiny arch (fp32, the same seeded weights), one JAX
    engine per ``max_new``."""
    from pytorch_zappa_serverless_tpu.engine.loader import build_engine as jax_build

    cache = tmp_path_factory.mktemp("xla-torch-migration")
    engines = {}

    def want(ids, max_new=24):
        if max_new not in engines:
            mc = JModelConfig(name="gpt2", dtype="float32", batch_buckets=(1, 2),
                              seq_buckets=(16,), extra={"max_new_tokens": max_new,
                                                        "arch": TINY_ARCH})
            engines[max_new] = jax_build(JServeConfig(compile_cache_dir=str(cache),
                                                      warmup_at_boot=False, models=[mc]))
        jcm = engines[max_new].model("gpt2")
        out = jcm.run_batch([jcm.servable.preprocess({"input_ids": list(ids)})])[0][0]
        return [int(t) for t in out["tokens"]]

    yield want
    for eng in engines.values():
        eng.shutdown()


def _pace(eng, latency_ms=15.0):
    """Slow every device dispatch (a latency rule, no failure), so decode
    cannot outrun the handshake: each command lands between two ticks."""
    eng.runner.faults.configure(model="gpt2", latency_ms=latency_ms)


async def _tokens_at_least(req, n, timeout_s=WAIT_S):
    deadline = asyncio.get_running_loop().time() + timeout_s
    while len(req.tokens) < n:
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError(f"stream stuck at {len(req.tokens)} tokens")
        await asyncio.sleep(0.005)


def _drain(req) -> int:
    """Events in the request's queue, up to the end marker."""
    n = 0
    while True:
        ev = req.events.get_nowait()
        if ev is None:
            return n
        n += 1


# ---------------------------------------------------------------------------
# The migration fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", [FaultInjector, jfaults.FaultInjector], ids=["port", "jax"])
def test_migration_fault_rule_validation_and_targeting(pkg):
    inj = pkg()
    with pytest.raises(ValueError, match="kind='prefix'/'migration'"):
        inj.configure(kind="transient", mode="drop")
    with pytest.raises(ValueError, match="drop"):
        inj.configure(kind="migration", mode="bogus")
    inj.configure(model="gpt2", fail_every_n=1, kind="migration")
    assert inj.on_migration("gpt2") == ("drop", 0.0)  # the default mode
    inj.on_dispatch("gpt2")                           # its own target
    assert inj.on_migration("other") == ("", 0.0)
    inj.configure(model="gpt2", fail_every_n=1, kind="migration", mode="slow",
                  latency_ms=40.0)
    mode, lat = inj.on_migration("gpt2")
    assert mode == "slow" and lat == pytest.approx(0.04)
    assert inj.snapshot()["injected"]["migration"] == 2
    rule = inj.snapshot()["rules"][0]
    assert rule["kind"] == "migration" and rule["mode"] == "slow"
    inj.configure(model="gpt2", fail_every_n=2, kind="spec_mismatch")
    assert [inj.on_spec("gpt2") for _ in range(4)] == [False, True, False, True]
    assert inj.snapshot()["injected"]["spec"] == 2


# ---------------------------------------------------------------------------
# Scheduler level: migrated == left in place
# ---------------------------------------------------------------------------

async def _migrate_between(src, dst, req, cause="admin"):
    snap = await src.migrate_snapshot(req)
    cut = await src.migrate_cutover(req, have_idx=list(snap["pages"]))
    pages = {**snap["pages"], **cut["pages"]}
    new_req, hits, copied = await dst.migrate_import(cut["ids"], cut["emitted"], cut["state"],
                                                     pages, max_new=cut["max_new"], cause=cause)
    await src.migrate_commit(req, cause)
    return new_req, cut, hits, copied


def test_migrated_stream_parity_greedy_and_sampled(jax_fixed):
    eng = _engine(_model_cfg())
    try:
        cm = eng.model("gpt2")
        _pace(eng)
        payloads = ({"input_ids": list(range(5, 15))},
                    {"input_ids": list(range(30, 40)), "temperature": 1.3, "seed": 11,
                     "top_k": 5, "top_p": 0.9})
        wants = [jax_fixed(payloads[0]["input_ids"]),
                 _fixed(eng, cm.servable.preprocess(payloads[1]))]

        async def run():
            src = PagedGenerationScheduler(cm, eng.runner, cm.cfg).start()
            dst = PagedGenerationScheduler(cm, eng.runner, cm.cfg).start()
            try:
                for payload, want in zip(payloads, wants):
                    req = src.submit(cm.servable.preprocess(payload))
                    await _tokens_at_least(req, 3)
                    new_req, cut, hits, copied = await _migrate_between(src, dst, req)
                    assert copied > 0 and req.migrated
                    with pytest.raises(RuntimeError, match="migrated"):
                        await req.done
                    full = await asyncio.wait_for(new_req.done, WAIT_S)
                    assert full == want                     # the same chain
                    assert new_req.emitted_base == len(cut["emitted"])
                    assert _drain(new_req) == len(want) - new_req.emitted_base
                return src.migration.snapshot(), dst.migration.snapshot()
            finally:
                await src.stop()
                await dst.stop()

        ssnap, dsnap = asyncio.run(run())
        assert ssnap["by_cause"]["admin"] == 2 and dsnap["by_cause"]["admin"] == 2
    finally:
        eng.shutdown()


def test_migration_dedups_against_the_target_prefix_tree(jax_fixed):
    eng = _engine(_model_cfg())
    try:
        cm = eng.model("gpt2")
        _pace(eng)
        payload = {"input_ids": list(range(50, 60))}
        want = jax_fixed(payload["input_ids"])

        async def run():
            src = PagedGenerationScheduler(cm, eng.runner, cm.cfg).start()
            dst = PagedGenerationScheduler(cm, eng.runner, cm.cfg).start()
            try:
                warm = dst.submit(cm.servable.preprocess(payload))  # the target's tree
                assert await asyncio.wait_for(warm.done, WAIT_S) == want
                req = src.submit(cm.servable.preprocess(payload))
                await _tokens_at_least(req, 2)
                new_req, _, hits, copied = await _migrate_between(src, dst, req)
                assert hits >= 1 and copied >= 1
                assert await asyncio.wait_for(new_req.done, WAIT_S) == want
                return dst.migration.snapshot()
            finally:
                await src.stop()
                await dst.stop()

        assert asyncio.run(run())["pages"]["hit"] >= 1
    finally:
        eng.shutdown()


def test_abort_resumes_the_stream_in_place(jax_fixed):
    eng = _engine(_model_cfg())
    try:
        cm = eng.model("gpt2")
        _pace(eng)
        payload = {"input_ids": list(range(70, 80))}
        want = jax_fixed(payload["input_ids"])

        async def run():
            src = PagedGenerationScheduler(cm, eng.runner, cm.cfg).start()
            try:
                req = src.submit(cm.servable.preprocess(payload))
                await _tokens_at_least(req, 2)
                await src.migrate_cutover(req, have_idx=())
                assert src.gen_snapshot()["migration"]["detached"] == 1
                await src.migrate_abort(req)
                got = await asyncio.wait_for(req.done, WAIT_S)
                return got, src.gen_snapshot()["migration"]
            finally:
                await src.stop()

        got, snap = asyncio.run(run())
        assert got == want and snap["detached"] == 0 and snap["failed"] == 1
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# Pressure: swap to host before eviction
# ---------------------------------------------------------------------------

def _collide(mc, jax_fixed, rule=None):
    """Two streams on a pool of 7 pages of 4 that must collide; returns
    (each stream's tokens and migrations and evictions, the lane's snapshot,
    the JAX package's fixed-route tokens, the injected counts)."""
    eng = _engine(mc)
    try:
        cm = eng.model("gpt2")
        if rule:
            eng.runner.faults.configure(model="gpt2", fail_every_n=1, kind="migration", **rule)
        mk = lambda ids: cm.servable.preprocess({"input_ids": ids})  # noqa: E731

        async def run():
            sched = PagedGenerationScheduler(cm, eng.runner, cm.cfg).start()
            try:
                a, b = sched.submit(mk(IDS_A), max_new=12), sched.submit(mk(IDS_B), max_new=12)
                await asyncio.wait_for(asyncio.gather(a.done, b.done), 120)
                return a, b, sched.gen_snapshot()
            finally:
                await sched.stop()

        a, b, snap = asyncio.run(run())
        wants = [jax_fixed(ids, 12) for ids in (IDS_A, IDS_B)]
        return [a, b], snap, wants, eng.runner.faults.snapshot()["injected"]
    finally:
        eng.shutdown()


def test_pressure_migrates_out_before_eviction(jax_fixed):
    reqs, snap, wants, _ = _collide(_model_cfg(kv_num_blocks=8, extra={"max_new_tokens": 12}),
                                    jax_fixed)
    assert snap["kv"]["evictions"] == 0 and sum(r.evictions for r in reqs) == 0
    assert snap["migration"]["by_cause"]["pressure"] >= 1
    assert snap["migration"]["pages"]["copied"] >= 1
    assert sum(r.migrations for r in reqs) >= 1
    for req, want in zip(reqs, wants):
        assert req.tokens == want                 # byte-identical, no recompute


def test_kv_migrate_off_keeps_the_eviction_ladder(jax_fixed):
    reqs, snap, wants, _ = _collide(_model_cfg(kv_num_blocks=8, kv_migrate=False,
                                               extra={"max_new_tokens": 12}), jax_fixed)
    assert snap["kv"]["evictions"] > 0 and snap["migration"]["by_cause"]["pressure"] == 0
    assert snap["migration"]["enabled"] is False
    for req, want in zip(reqs, wants):
        assert req.tokens and req.tokens == want[:len(req.tokens)]


def test_pressure_drop_chaos_falls_back_to_eviction(jax_fixed):
    reqs, snap, wants, injected = _collide(
        _model_cfg(kv_num_blocks=8, extra={"max_new_tokens": 12}), jax_fixed, {"mode": "drop"})
    assert snap["kv"]["evictions"] > 0
    assert snap["migration"]["by_cause"]["pressure"] == 0 and snap["migration"]["failed"] >= 1
    assert injected["migration"] >= 1
    for req, want in zip(reqs, wants):
        assert req.tokens and req.tokens == want[:len(req.tokens)]


def test_pressure_corrupt_chaos_is_caught_and_read_again(jax_fixed):
    reqs, snap, wants, injected = _collide(
        _model_cfg(kv_num_blocks=8, extra={"max_new_tokens": 12}), jax_fixed,
        {"mode": "corrupt"})
    assert snap["kv"]["evictions"] == 0 and snap["migration"]["by_cause"]["pressure"] >= 1
    assert injected["migration"] >= 1
    for req, want in zip(reqs, wants):
        assert req.tokens == want


# ---------------------------------------------------------------------------
# HTTP: export → import → attach
# ---------------------------------------------------------------------------

def _call(port, method, path, body=None, timeout=WAIT_S):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=json.dumps(body).encode() if body is not None else None,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _json(port, method, path, body=None):
    status, heads, raw = _call(port, method, path, body)
    return status, json.loads(raw), heads


class _SSE:
    """An SSE reader over a raw connection: ``events(n)`` reads until ``n``
    events (or the end of the stream) arrived."""

    def __init__(self, port, method, path, body=None):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        self.conn.request(method, path,
                          body=json.dumps(body).encode() if body is not None else None,
                          headers={"Content-Type": "application/json"})
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


def _migrate_http(port, sid, new_sid, cause="admin"):
    """The importer's loop: snapshot → cutover → import (fetching the pages
    it names again) → commit.  Returns (watermark, the import's answer,
    the import attempts)."""
    status, snap, _ = _json(port, "POST", f"/admin/streams/{sid}/export", {"phase": "snapshot"})
    assert status == 200, snap
    pages = {p["i"]: p for p in snap["pages"]}
    status, cut, _ = _json(port, "POST", f"/admin/streams/{sid}/export",
                           {"phase": "cutover", "have": sorted(pages)})
    assert status == 200, cut
    pages.update({p["i"]: p for p in cut["pages"]})
    for attempt in range(1, 4):
        status, body, _ = _json(port, "POST", f"/admin/streams/{new_sid}/import",
                                {"manifest": cut["manifest"], "pages": list(pages.values()),
                                 "cause": cause})
        if status == 200:
            break
        assert status == 409 and body.get("need"), body
        status, again, _ = _json(port, "POST", f"/admin/streams/{sid}/export",
                                 {"phase": "pages", "indices": body["need"]})
        assert status == 200, again
        pages.update({p["i"]: p for p in again["pages"]})
    else:
        raise AssertionError(f"the import never succeeded: {body}")
    status, commit, _ = _json(port, "POST", f"/admin/streams/{sid}/export",
                              {"phase": "commit", "cause": cause})
    assert status == 200, commit
    return commit["watermark"], body, attempt


def _serve(**over):
    return BackgroundServer(ServeConfig(warmup_at_boot=False, models=[_model_cfg(**over)]),
                            device="cpu")


def _pace_http(port, latency_ms=15.0):
    status, body, _ = _json(port, "POST", "/admin/faults", {"model": "gpt2",
                                                            "latency_ms": latency_ms})
    assert status == 200, body


def _migrate_and_attach(port, payload, new_sid, rule=None):
    """A stream moved over HTTP on one server and attached from the tokens
    its client got; returns (all tokens, the fixed route's, the import
    attempts, the attach's last event, the source's terminal event)."""
    status, body, _ = _json(port, "POST", "/v1/models/gpt2:generate",
                            {**payload, "stream": False})
    assert status == 200, body
    want = body["predictions"]["tokens"]
    src = _SSE(port, "POST", "/v1/models/gpt2:generate", payload)
    sid = src.headers["X-Stream-Id"]
    head = [ev["token"] for ev in src.events(3)]
    if rule:
        status, body, _ = _json(port, "POST", "/admin/faults",
                                {"model": "gpt2", "fail_every_n": 1, "count": 1,
                                 "kind": "migration", **rule})
        assert status == 200, body
    watermark, imp, attempts = _migrate_http(port, sid, new_sid)
    assert imp["imported"] and imp["watermark"] >= len(head)
    tail = src.events()
    src.close()
    src_tokens = head + [ev["token"] for ev in tail if "token" in ev]
    assert tail[-1].get("migrated") is True and tail[-1]["watermark"] == watermark
    assert len(src_tokens) == watermark
    att = _SSE(port, "GET", f"/admin/streams/{new_sid}/attach?from={len(src_tokens)}")
    assert att.resp.status == 200 and att.headers["X-Stream-Id"] == new_sid
    evs = att.events()
    att.close()
    rest = [ev["token"] for ev in evs if "token" in ev]
    return src_tokens + rest, want, attempts, evs[-1], sid


def test_http_export_import_attach_zero_duplicates(jax_fixed):
    with _serve() as srv:
        port = srv.port
        _pace_http(port)
        got, want, attempts, last, sid = _migrate_and_attach(
            port, {"input_ids": list(range(5, 15)), "max_new_tokens": 16}, "mig-1")
        assert got == want and attempts == 1           # no loss, no repeat
        assert want == jax_fixed(range(5, 15), 16)
        assert last.get("done") is True and last["tokens"] == want
        status, body, _ = _json(port, "GET", "/admin/streams")
        assert body["streams"][sid]["state"] == "migrated"
        assert body["streams"]["mig-1"]["imported"] is True
        assert body["streams"]["mig-1"]["state"] == "done"
        status, body, _ = _json(port, "GET", "/metrics")
        mig = body["generation"]["gpt2"]["migration"]
        assert mig["by_cause"]["admin"] >= 2 and mig["pages"]["copied"] >= 1
        status, _, raw = _call(port, "GET", "/metrics?format=prometheus")
        prom = raw.decode()
        for fam in ("tpuserve_migrations_total", "tpuserve_migration_pages_total",
                    "tpuserve_migration_ms"):
            assert fam in prom, fam
        spec = importlib.util.spec_from_file_location("check_metrics",
                                                      ROOT / "tools" / "check_metrics.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.check(prom, mod.load_manifest()) == []
        # A second attach while the first holds the stream, and a stream
        # that was not imported, are refused.
        assert _json(port, "GET", f"/admin/streams/{sid}/attach")[0] == 409


def test_http_corrupt_chaos_is_caught_and_fetched_again():
    with _serve() as srv:
        _pace_http(srv.port)
        got, want, attempts, _, _ = _migrate_and_attach(
            srv.port, {"input_ids": list(range(30, 40)), "max_new_tokens": 16,
                       "temperature": 1.1, "seed": 7, "top_k": 6}, "mig-c",
            {"mode": "corrupt"})
        assert got == want and attempts == 2            # one retry of the bad page
        faults = _json(srv.port, "GET", "/admin/faults")[1]["faults"]
        assert faults["injected"]["migration"] >= 1


def test_http_drop_chaos_answers_a_retryable_503():
    with _serve() as srv:
        port = srv.port
        _pace_http(port)
        src = _SSE(port, "POST", "/v1/models/gpt2:generate",
                   {"input_ids": list(range(60, 70)), "max_new_tokens": 16})
        sid = src.headers["X-Stream-Id"]
        src.events(2)
        _json(port, "POST", "/admin/faults", {"model": "gpt2", "fail_every_n": 1, "count": 1,
                                              "kind": "migration", "mode": "drop"})
        status, body, heads = _json(port, "POST", f"/admin/streams/{sid}/export",
                                    {"phase": "snapshot"})
        assert status == 503 and heads.get("Retry-After") and body["retryable"] is True
        # The rule is spent: the retry works and the stream is unharmed.
        status, body, _ = _json(port, "POST", f"/admin/streams/{sid}/export",
                                {"phase": "snapshot"})
        assert status == 200 and body["phase"] == "snapshot"
        rest = src.events()
        src.close()
        assert rest[-1].get("done") is True


def test_http_refusals():
    with _serve(kv_migrate=False) as srv:
        port = srv.port
        status, body, _ = _json(port, "POST", "/v1/models/gpt2:generate",
                                {"input_ids": [5, 6, 7], "max_new_tokens": 4, "stream": False})
        sid = next(iter(_json(port, "GET", "/admin/streams")[1]["streams"]))
        status, body, _ = _json(port, "POST", f"/admin/streams/{sid}/export",
                                {"phase": "snapshot"})
        assert status == 409 and "kv_migrate" in body["error"]
        status, body, _ = _json(port, "POST", "/admin/streams/x/import",
                                {"manifest": {"version": 1, "model": "gpt2", "prompt": [1],
                                              "emitted": [], "state": {}, "page_shape": [2, 4, 32],
                                              "dtype": "float32", "max_new": 4, "npages": 1}})
        assert status == 409 and "kv_migrate" in body["error"]
    with _serve() as srv:
        port = srv.port
        assert _json(port, "POST", "/admin/streams/nope/export", {"phase": "cutover"})[0] == 404
        status, body, _ = _json(port, "POST", "/admin/streams/x/import",
                                {"manifest": {"version": 99}})
        assert status == 400 and "version" in body["error"]
        status, body, _ = _json(port, "POST", "/admin/streams/x/import",
                                {"manifest": {"version": 1, "model": "gpt2", "prompt": [1],
                                              "emitted": [], "state": {}, "page_shape": [9],
                                              "dtype": "float32", "max_new": 4, "npages": 1}})
        assert status == 400 and "geometry" in body["error"]
        status, body, _ = _json(port, "POST", "/admin/streams/x/import",
                                {"manifest": {"version": 1, "model": "bert", "prompt": [1],
                                              "emitted": [], "state": {}, "page_shape": [9],
                                              "dtype": "float32", "max_new": 4, "npages": 1}})
        assert status == 400 and "paged" in body["error"]
        status, body, _ = _json(port, "POST", "/v1/models/gpt2:generate",
                                {"input_ids": [5, 6, 7], "max_new_tokens": 4, "stream": False})
        sid = next(iter(_json(port, "GET", "/admin/streams")[1]["streams"]))
        status, body, _ = _json(port, "POST", f"/admin/streams/{sid}/export", {"phase": "nope"})
        assert status == 400
        status, body, _ = _json(port, "POST", f"/admin/streams/{sid}/export",
                                {"phase": "cutover"})
        assert status == 409 and "not active" in body["error"]  # it has finished
        status, body, _ = _json(port, "GET", "/admin/prefix")
        assert status == 200 and body["models"]["gpt2"]["hits"] == 0
        assert body["models"]["gpt2"]["pages_total"] >= 0


def test_slot_lane_streams_refuse_migration():
    cfg = ServeConfig(warmup_at_boot=False, models=[_model_cfg(kv_cache="slot")])
    with BackgroundServer(cfg, device="cpu") as srv:
        _json(srv.port, "POST", "/v1/models/gpt2:generate",
              {"input_ids": [5, 6, 7], "max_new_tokens": 4, "stream": False})
        sid = next(iter(_json(srv.port, "GET", "/admin/streams")[1]["streams"]))
        status, body, _ = _json(srv.port, "POST", f"/admin/streams/{sid}/export", {})
        assert status == 400 and "paged" in body["error"]


def test_two_process_migration_tool(tmp_path):
    """``tools/streammove.py`` on the CPU: two ``cli serve`` processes, a
    stream moved fresh, moved again with its prompt pages deduped, moved
    through a corrupt page, and a drop answered 503 then aborted in place;
    every continuation equals the source's control, no token lost or
    repeated."""
    from pytorch_zappa_serverless_tpu_torch.tools import streammove as SM

    model = {**SM.MODEL, "dtype": "float32",
             "extra": {**SM.MODEL["extra"], "params_dtype": "",
                       "arch": {**TINY_ARCH, "max_positions": 256}}}
    out = SM.run_streammove(tmp_path, "cpu", model, boot_timeout_s=120.0)
    ctl = out["control"]
    for case in ("fresh", "dedup", "corrupt"):
        c = out[case]
        assert c["tokens"] == ctl[case] and c["source_end"]["migrated"] is True
        assert c["source_end"]["watermark"] == c["watermark"] == len(c["source_tokens"])
        assert c["attach_end"]["done"] is True and c["attach_end"]["tokens"] == c["tokens"]
    assert out["fresh"]["dedup_pages"] == 0 and out["dedup"]["dedup_pages"] >= 1
    assert out["fresh"]["attempts"] == 1 and out["corrupt"]["attempts"] == 2
    d = out["drop"]
    assert d["status"] == 503 and int(d["retry_after"]) >= 1 and d["body"]["retryable"]
    assert d["cutover"] == d["abort"] == 200 and d["tokens"] == ctl["drop"]
    assert out["target"]["migration"]["by_cause"]["admin"] == 3
    assert out["target"]["migration"]["pages"]["hit"] == out["dedup"]["dedup_pages"]
    assert out["source"]["streams"] and all(
        e["imported"] for e in out["target"]["streams"].values())


def test_registry_lets_a_replaced_engine_go():
    """The stream registry forgets a stopped lane's streams: after a reload
    the replaced engine (whose lane served a stream) is unreachable."""
    import gc
    import weakref

    with _serve() as srv:
        status, body, _ = _json(srv.port, "POST", "/v1/models/gpt2:generate",
                                {"input_ids": [5, 6, 7], "max_new_tokens": 4, "stream": False})
        assert status == 200 and len(_json(srv.port, "GET", "/admin/streams")[1]["streams"]) == 1
        old = weakref.ref(srv.server.engine)
        assert _json(srv.port, "POST", "/admin/reload", {})[0] == 200
        gc.collect()
        assert old() is None, "the replaced engine is still reachable"
        assert _json(srv.port, "GET", "/admin/streams")[1]["streams"] == {}
