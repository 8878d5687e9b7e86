"""The port's slot-pool :generate lane against the JAX package's and its own
fixed-batch route, on the CPU at tests/test_generation_stream.py's tiny
arch (fp32, ``gen_slots`` 2, ``segment_tokens`` 3).

- The port's segment chain equals the JAX one-shot ``generate`` (greedy, and
  sampled with JAX's own Gumbel draws handed to the port), and a frozen slot
  does not disturb its neighbour, against the JAX ``decode_segment`` on the
  same inputs: tokens identical, as the JAX tests assert.
- The scheduler against the fixed batch (``run_batch``): the same tokens,
  greedy and sampled with top-k/top-p; mid-flight joins, slot reuse,
  coalesced and mixed-bucket bursts, the mid-round pool reset, backpressure
  and cancel, as the JAX tests drive them.
- SSE over the port's HTTP server, ``stream: false``, and the error answers.

Every wait is bounded by ``asyncio.wait_for`` so that a hung scheduler fails
instead of stalling the run.
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
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import gpt2 as PG
from pytorch_zappa_serverless_tpu_torch.ops import sampling as PS
from pytorch_zappa_serverless_tpu_torch.serving.generation import GenerationScheduler
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

TINY_ARCH = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128,
             "vocab_size": 500, "max_positions": 64}
WAIT_S = 60


def _tiny_cfg():
    return dataclasses.replace(JG.SMALL, **TINY_ARCH, eos_id=499)


def _model_cfg(**extra):
    return ModelConfig(name="gpt2", dtype="float32", batch_buckets=(1, 2), seq_buckets=(8,),
                       coalesce_ms=1.0,
                       extra={"max_new_tokens": 12, "arch": TINY_ARCH, "gen_slots": 2,
                              "segment_tokens": 3, **extra})


def _trees(cfg, seed=3):
    np_params = JG.init_gpt2_params(seed, cfg)
    return (jax.tree.map(jnp.asarray, np_params),
            PW.ParamTree(PW.tree_state_from_jax(np_params, torch.float32)).tree())


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's Gumbel draws replaced by JAX's own for each (seed, step)."""
    def noise(seeds, t, V, device):
        return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
            jax.random.fold_in(jax.random.key(int(s)), int(tt)), (V,), jnp.float32))
            for s, tt in zip(seeds.tolist(), t.tolist())])).to(device)

    monkeypatch.setattr(PS, "gumbel_noise", noise)


# ---------------------------------------------------------------------------
# The segment functions against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 4.0])
def test_segment_chain_matches_one_shot_generate(jax_noise, temperature):
    cfg = _tiny_cfg()
    pcfg = PG.GPT2Config(**dataclasses.asdict(cfg))
    jp, pp = _trees(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 400, (2, 6)).astype(np.int32)
    lens = np.asarray([6, 4], np.int32)
    temp = np.full((2,), temperature, np.float32)
    seeds = np.asarray([5, 9], np.int32)
    max_new = 9
    want = np.asarray(JG.generate(jp, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(temp),
                                  jnp.asarray(seeds), max_new, cfg, jnp.float32))

    T = torch.from_numpy
    first, ck, cv = PG.prefill_start(pp, T(toks), T(lens), T(temp), T(seeds), 6 + max_new,
                                     pcfg, torch.float32)
    tok, pos = first, T(lens)
    step = torch.zeros((2,), dtype=torch.int32)
    fin = torch.zeros((2,), dtype=torch.bool)
    got = []
    for _ in range(3):  # 3 segments x 3 tokens = max_new
        emits, ck, cv, tok, pos, step, fin = PG.decode_segment(
            pp, ck, cv, tok, pos, step, fin, T(temp), T(seeds), 3, pcfg, torch.float32)
        got.append(emits.numpy())
    np.testing.assert_array_equal(np.concatenate(got, axis=1), want)


def test_segment_frozen_rows_do_not_disturb_neighbors():
    """A finished slot rides along without changing an active row's chain,
    in the port and in the JAX package alike."""
    cfg = _tiny_cfg()
    pcfg = PG.GPT2Config(**dataclasses.asdict(cfg))
    jp, pp = _trees(cfg)
    toks = np.asarray([[7, 8, 9, 0]], np.int32)
    lens = np.asarray([3], np.int32)
    z1, s1 = np.zeros((1,), np.float32), np.zeros((1,), np.int32)
    total = 4 + 6
    T = torch.from_numpy
    first, ck, cv = PG.prefill_start(pp, T(toks), T(lens), T(z1), T(s1), total, pcfg,
                                     torch.float32)
    solo, *_ = PG.decode_segment(pp, ck.clone(), cv.clone(), first, T(lens), T(s1),
                                 torch.zeros((1,), dtype=torch.bool), T(z1), T(s1), 6, pcfg,
                                 torch.float32)
    L = cfg.layers
    ck2 = torch.zeros((L, 2, total, cfg.d_model))
    cv2 = torch.zeros_like(ck2)
    ck2[:, :1], cv2[:, :1] = ck, cv
    state = (np.asarray([int(first[0]), cfg.eos_id], np.int32), np.asarray([3, 0], np.int32),
             np.zeros((2,), np.int32), np.asarray([False, True]),
             np.zeros((2,), np.float32), np.zeros((2,), np.int32))
    pooled, *_ = PG.decode_segment(pp, ck2, cv2, *map(T, state), 6, pcfg, torch.float32)
    assert (pooled.numpy()[0] == solo.numpy()[0]).all()
    assert (pooled.numpy()[1] == cfg.eos_id).all()
    jk, jv = jnp.asarray(ck2.numpy() * 0), jnp.asarray(cv2.numpy() * 0)
    jf, jck, jcv = JG.prefill_start(jp, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(z1),
                                    jnp.asarray(s1), total, cfg, jnp.float32)
    jk, jv = jk.at[:, :1].set(jck), jv.at[:, :1].set(jcv)
    want, *_ = JG.decode_segment(jp, jk, jv, *map(jnp.asarray, state), 6, cfg, jnp.float32)
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The scheduler (engine + scheduler, no HTTP)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    eng = build_engine(ServeConfig(warmup_at_boot=False, models=[_model_cfg()]), device="cpu")
    yield eng
    eng.shutdown()


def _fixed(eng, sample, name="gpt2"):
    """The fixed-batch route's tokens for one sample, on the dispatch thread."""
    cm = eng.model(name)
    return eng.runner.run_fn_sync(cm.run_batch, [sample])[0][0]["tokens"]


def _mk(cm):
    return lambda *ids: cm.servable.preprocess({"input_ids": list(ids)})


def test_scheduler_matches_fixed_batch(engine):
    cm = engine.model("gpt2")
    sample = cm.servable.preprocess({"input_ids": [5, 6, 7]})

    async def drive():
        sched = GenerationScheduler(cm, engine.runner, cm.cfg).start()
        try:
            return await asyncio.wait_for(sched.submit(sample).done, WAIT_S)
        finally:
            await sched.stop()

    got = asyncio.run(drive())
    assert got == _fixed(engine, sample)


def test_request_joins_mid_generation(engine):
    """B admits while A decodes, in the free slot; C queues until a slot
    frees, then completes."""
    cm = engine.model("gpt2")
    mk = _mk(cm)

    async def drive():
        sched = GenerationScheduler(cm, engine.runner, cm.cfg).start()
        try:
            a = sched.submit(mk(5, 6, 7), max_new=12)
            first_a = await asyncio.wait_for(a.events.get(), WAIT_S)
            assert first_a is not None and not a.done.done()
            b = sched.submit(mk(9, 10), max_new=3)
            toks_b = await asyncio.wait_for(b.done, WAIT_S)
            assert len(toks_b) <= 3
            assert b.slot is not None and a.slot is not None and b.slot != a.slot
            c = sched.submit(mk(11, 12, 13), max_new=2)
            assert (await asyncio.wait_for(c.done, WAIT_S)) is not None
            await asyncio.wait_for(a.done, WAIT_S)
        finally:
            await sched.stop()

    asyncio.run(drive())


def test_slots_reused_across_many_requests(engine):
    """More requests than slots: all complete, each the fixed-batch chain
    cut at its budget."""
    cm = engine.model("gpt2")
    samples = [cm.servable.preprocess({"input_ids": [3 + i, 4 + i]}) for i in range(5)]

    async def drive():
        sched = GenerationScheduler(cm, engine.runner, cm.cfg).start()
        try:
            reqs = [sched.submit(s, max_new=4) for s in samples]
            return await asyncio.wait_for(asyncio.gather(*[r.done for r in reqs]), 120)
        finally:
            await sched.stop()

    for s, got in zip(samples, asyncio.run(drive())):
        want = _fixed(engine, s)
        assert got and len(got) <= 4 and got == want[: len(got)]


def test_burst_admissions_coalesce_into_one_prefill(engine):
    """A burst of same-bucket requests admits with ONE batched prefill, one
    admission round and one segment round to the first token, and the
    chains still match the fixed batch."""
    cm = engine.model("gpt2")
    samples = [cm.servable.preprocess({"input_ids": [3 + i, 4 + i]}) for i in range(2)]

    async def drive():
        sched = GenerationScheduler(cm, engine.runner, cm.cfg).start()
        try:
            reqs = [sched.submit(s, max_new=4) for s in samples]
            outs = await asyncio.wait_for(asyncio.gather(*[r.done for r in reqs]), 120)
            return sched.prefill_dispatches, reqs, outs
        finally:
            await sched.stop()

    dispatches, reqs, outs = asyncio.run(drive())
    assert dispatches == 1
    for s, got in zip(samples, outs):
        assert got and got == _fixed(engine, s)[: len(got)]
    assert [r.rounds_to_first_token for r in reqs] == [2, 2]


def _two_bucket_engine():
    return build_engine(ServeConfig(warmup_at_boot=False, models=[ModelConfig(
        name="gpt2", dtype="float32", batch_buckets=(1, 2), seq_buckets=(4, 8), coalesce_ms=1.0,
        extra={"max_new_tokens": 6, "arch": TINY_ARCH, "gen_slots": 4,
               "segment_tokens": 3})]), device="cpu")


def test_mixed_bucket_burst_admits_per_bucket():
    eng = _two_bucket_engine()
    try:
        cm = eng.model("gpt2")
        short = [cm.servable.preprocess({"input_ids": [5 + i]}) for i in range(2)]
        long = [cm.servable.preprocess({"input_ids": list(range(1, 7))}) for _ in range(2)]

        async def drive():
            sched = GenerationScheduler(cm, eng.runner, cm.cfg).start()
            try:
                reqs = [sched.submit(s, max_new=4) for s in short + long]
                await asyncio.wait_for(asyncio.gather(*[r.done for r in reqs]), 120)
                return sched.prefill_dispatches
            finally:
                await sched.stop()

        assert asyncio.run(drive()) == 2  # 4 requests, 2 buckets
    finally:
        eng.shutdown()


def test_mid_round_pool_reset_requeues_unprocessed_groups():
    """An insert that faults part-way tears the pool mid-round; the requests
    of the round's later groups re-queue and admit cleanly on the reset
    pool, on distinct slots, with the fixed-batch chains."""
    eng = _two_bucket_engine()
    try:
        cm = eng.model("gpt2")
        ids_long = list(range(1, 7))

        async def drive():
            sched = GenerationScheduler(cm, eng.runner, cm.cfg)
            real_insert_from = sched._insert_from
            state = {"faulted": False}

            def bad_insert_from(j, slot):
                if not state["faulted"]:
                    state["faulted"] = True
                    sched.kernels.torn = True  # faulted after writing the pool
                    raise RuntimeError("injected post-donation fault")
                return real_insert_from(j, slot)

            sched._insert_from = bad_insert_from
            sched.start()
            try:
                short = [sched.submit(cm.servable.preprocess({"input_ids": [5 + i]}),
                                      max_new=4) for i in range(2)]
                long = [sched.submit(cm.servable.preprocess({"input_ids": ids_long}),
                                     max_new=4) for _ in range(2)]
                for r in short:
                    with pytest.raises(RuntimeError, match="post-donation"):
                        await asyncio.wait_for(r.done, WAIT_S)
                outs = [await asyncio.wait_for(r.done, WAIT_S) for r in long]
                return outs, {r.slot for r in long}
            finally:
                await sched.stop()

        outs, slots = asyncio.run(drive())
        want = _fixed(eng, cm.servable.preprocess({"input_ids": ids_long}))
        for got in outs:
            assert got and got == want[: len(got)]
        assert len(slots) == 2
    finally:
        eng.shutdown()


def test_sampled_top_k_top_p_stream_matches_fixed_batch(engine):
    cm = engine.model("gpt2")
    knobs = {"input_ids": [5, 6, 7], "temperature": 1.3, "top_k": 5, "top_p": 0.9}
    sample = cm.servable.preprocess({**knobs, "seed": 11})
    other = cm.servable.preprocess({**knobs, "seed": 12})
    assert sample["top_k"] == 5 and abs(sample["top_p"] - 0.9) < 1e-6

    async def drive():
        sched = GenerationScheduler(cm, engine.runner, cm.cfg).start()
        try:
            got = await asyncio.wait_for(sched.submit(sample).done, WAIT_S)
            got2 = await asyncio.wait_for(sched.submit(other).done, WAIT_S)
            return got, got2
        finally:
            await sched.stop()

    got, got2 = asyncio.run(drive())
    assert got and got == _fixed(engine, sample)
    assert got2 != got  # the seed binds


def test_backpressure_and_cancel(engine):
    cm = engine.model("gpt2")

    async def drive():
        sched = GenerationScheduler(cm, engine.runner, cm.cfg)
        sched._max_pending = 2
        sched.start()
        mk = lambda seed: cm.servable.preprocess({"input_ids": [5, seed]})  # noqa: E731
        try:
            a = sched.submit(mk(1), max_new=12)
            b = sched.submit(mk(2), max_new=12)
            with pytest.raises(OverflowError):
                sched.submit(mk(3))
            sched.cancel(b)
            with pytest.raises(RuntimeError, match="cancelled"):
                await asyncio.wait_for(b.done, WAIT_S)
            await asyncio.wait_for(a.done, WAIT_S)
            assert sched.gen_snapshot()["active"] == 0
        finally:
            await sched.stop()

    asyncio.run(drive())


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------

TINY_BERT = ModelConfig(name="bert_base", dtype="float32", seq_buckets=(8,), batch_buckets=(1,),
                        extra={"arch": {"num_layers": 1, "num_heads": 2, "head_dim": 8,
                                        "mlp_dim": 32, "vocab_size": 128, "max_position": 16}})


def _post(port, path, body, timeout=WAIT_S):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)
    with r:
        ctype = r.headers.get("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            events = [json.loads(line[len(b"data: "):]) for line in r
                      if line.startswith(b"data: ")]
            return r.status, events, dict(r.headers)
        return r.status, json.loads(r.read()), dict(r.headers)


def test_sse_streams_tokens():
    cfg = ServeConfig(warmup_at_boot=False, models=[_model_cfg(), TINY_BERT])
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            status, events, headers = _post(srv.port, "/v1/models/gpt2:generate",
                                            {"input_ids": [5, 6, 7], "max_new_tokens": 6})
            assert status == 200 and headers["Content-Type"] == "text/event-stream"
            assert headers["Cache-Control"] == "no-cache" and headers["X-Stream-Id"]
            assert headers["Transfer-Encoding"] == "chunked"
            final = events[-1]
            assert final.get("done") is True
            streamed = [e["token"] for e in events[:-1]]
            assert streamed == final["tokens"] and 1 <= len(streamed) <= 6
            assert final["stats"]["rounds_to_first_token"] >= 2

            # stream=false returns one JSON body with the same tokens.
            status, body, _ = _post(srv.port, "/v1/models/gpt2:generate",
                                    {"input_ids": [5, 6, 7], "max_new_tokens": 6,
                                     "stream": False})
            assert status == 200, body
            assert body["model"] == "gpt2"
            assert body["predictions"]["tokens"] == final["tokens"]

            # The JAX handler's error answers.
            for req, code, word in (
                    ({"input_ids": [5], "repetition_penalty": 1.5}, 400, "repetition_penalty"),
                    ({"input_ids": [5], "max_new_tokens": "six"}, 400, "integer"),
                    ({"input_ids": list(range(1, 12))}, 400, "seq bucket")):
                status, body, _ = _post(srv.port, "/v1/models/gpt2:generate", req)
                assert status == code and word in body["error"], body
            status, body, _ = _post(srv.port, "/v1/models/nope:generate", {"text": "x"})
            assert status == 404
            status, body, _ = _post(srv.port, "/v1/models/bert_base:generate", {"text": "x"})
            assert status == 405 and ":predict" in body["error"]

            # /metrics: the lane's ring and snapshot; /v1/models names the route.
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics") as r:
                m = json.loads(r.read())
            gen = m["generation"]["gpt2"]
            assert gen["mode"] == "slot" and gen["tokens_emitted"] >= 12
            assert gen["latency"]["ttft_ms"]["count"] == 2
            assert m["models"]["gpt2:generate"]["requests"] == 2
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/models") as r:
                assert json.loads(r.read())["models"]["gpt2"]["generate"].endswith(":generate")

            # A full backlog sheds 429 with Retry-After; a stopped lane 503.
            sched = srv.server.schedulers["gpt2"]
            sched._max_pending = 0
            status, body, headers = _post(srv.port, "/v1/models/gpt2:generate",
                                          {"input_ids": [5]})
            assert status == 429 and headers["Retry-After"] == "1"
            assert body["backlog"] == 0 and body["active"] == 0
            sched._stopped = True
            status, body, headers = _post(srv.port, "/v1/models/gpt2:generate",
                                          {"input_ids": [5]})
            assert status == 503 and headers["Retry-After"] == "1"
            sched._stopped = False
            sched._max_pending = 256
    finally:
        eng.shutdown()


def test_sse_client_disconnect_cancels_its_stream():
    """A client that closes its socket mid-stream frees its slot: the lane
    drains to idle with the stream failed as cancelled."""
    import socket
    import time

    long = ModelConfig(name="gpt2", dtype="float32", batch_buckets=(1,), seq_buckets=(8,),
                       extra={"max_new_tokens": 400, "gen_slots": 2, "segment_tokens": 1,
                              "arch": {**TINY_ARCH, "max_positions": 512}})
    cfg = ServeConfig(warmup_at_boot=False, models=[long])
    eng = build_engine(cfg, device="cpu")
    try:
        with BackgroundServer(cfg, eng) as srv:
            sched = srv.server.schedulers["gpt2"]
            body = json.dumps({"input_ids": [5, 6, 7]}).encode()
            with socket.create_connection(("127.0.0.1", srv.port), timeout=WAIT_S) as sock:
                sock.sendall(b"POST /v1/models/gpt2:generate HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Type: application/json\r\n"
                             + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
                head = sock.recv(4096)
                assert b"200 OK" in head and b"text/event-stream" in head
            deadline = time.monotonic() + WAIT_S
            while (sched.active or sched.depth) and time.monotonic() < deadline:
                time.sleep(0.02)
            assert sched.active == sched.depth == 0
            assert sched.tokens_emitted < 400  # it did not decode to the end
    finally:
        eng.shutdown()


def test_generate_rides_the_latency_lane_and_leaves_device_seconds():
    """The reference runs every prefill, insert and segment on the latency
    lane and keeps them out of ``RunStats.device_seconds``; so does the
    port, even for a model whose QoS class is ``throughput``."""
    mc = dataclasses.replace(_model_cfg(), latency_class="throughput")
    cfg = ServeConfig(warmup_at_boot=False, models=[mc])
    eng = build_engine(cfg, device="cpu")
    try:
        runner = eng.runner
        calls = []
        real = runner.run_fn

        def spy(fn, *args, **kw):
            calls.append(kw)
            return real(fn, *args, **kw)

        runner.run_fn = spy
        with BackgroundServer(cfg, eng) as srv:
            status, _, _ = _post(srv.port, "/v1/models/gpt2:predict", {"input_ids": [5, 6]})
            assert status == 200
            lanes = runner.lane_stats()
            seconds = runner.stats["gpt2"].device_seconds
            status, events, _ = _post(srv.port, "/v1/models/gpt2:generate",
                                      {"input_ids": [5, 6, 7], "max_new_tokens": 6})
            assert status == 200 and events[-1]["done"] is True
            after = runner.lane_stats()
            rounds = srv.server.schedulers["gpt2"].device_rounds
        assert calls and all(kw == {"model": "gpt2"} for kw in calls)
        assert after["latency"]["dispatches"] - lanes["latency"]["dispatches"] == len(calls)
        assert len(calls) >= rounds >= 2
        assert after["throughput"]["dispatches"] == lanes["throughput"]["dispatches"]
        assert runner.stats["gpt2"].device_seconds == seconds
    finally:
        eng.shutdown()
