"""The port's resilience primitives beside the JAX package's
(``tests/test_resilience.py``, case for case, on the port's classes).

The breaker on a fake clock, the transient classification (and its CUDA
counterpart), the fault injector's cadence, the batcher's deadline shedding,
transient retry and queue-wait forecast, and the job queue's sweeper and
drain, all with fake models and runners.  The pure-Python classes are also
driven beside the JAX package's with the same seeded rng and clock: the same
backoff sequences, breaker state trajectories and injector fire patterns.
"""

import asyncio
import random
from types import SimpleNamespace

import pytest
import torch

from pytorch_zappa_serverless_tpu import faults as jfaults
from pytorch_zappa_serverless_tpu.config import ServeConfig as JServeConfig
from pytorch_zappa_serverless_tpu.serving import resilience as jres
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.faults import (
    REFUSED_KINDS, FaultInjector, TransientFault, is_transient)
from pytorch_zappa_serverless_tpu_torch.serving.batcher import DynamicBatcher
from pytorch_zappa_serverless_tpu_torch.serving.jobs import JobQueue
from pytorch_zappa_serverless_tpu_torch.serving.metrics import LatencyRing
from pytorch_zappa_serverless_tpu_torch.serving.resilience import (
    CircuitBreaker, DeadlineExceeded, ModelResilience, ResilienceHub, RetryPolicy,
    run_with_retry)


def _run(coro, timeout=30):
    async def bounded():
        return await asyncio.wait_for(coro, timeout)
    return asyncio.run(bounded())


# -- classification ----------------------------------------------------------

def test_transient_classification_table():
    assert is_transient(TransientFault("boom"))
    assert is_transient(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert is_transient(RuntimeError("backend UNAVAILABLE, retrying"))
    assert not is_transient(RuntimeError("shape mismatch [4] vs [8]"))
    assert not is_transient(ValueError("bad payload"))


# The CUDA counterpart of the reference's status table: (exception, transient).
CUDA_TABLE = [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    (RuntimeError("CUDA error: device-side assert triggered\nCUDA kernel errors might be "
                  "asynchronously reported"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (RuntimeError("CUDA error: an illegal instruction was encountered"), False),
    (RuntimeError("int8_matmul kernel launch failed: the kernel was built with too few "
                  "registers for its setmaxnreg split (M=8)"), False),
    # A fatal CUDA marker wins over a transient word in the same message.
    (RuntimeError("CUDA error: transient-looking text, still fatal"), False),
    (TransientFault("injected"), True),
]


@pytest.mark.parametrize("exc,transient", CUDA_TABLE,
                         ids=[f"{type(e).__name__}-{i}" for i, (e, _) in enumerate(CUDA_TABLE)])
def test_cuda_transient_table(exc, transient):
    assert is_transient(exc) is transient


@pytest.mark.parametrize("msg", ["RESOURCE_EXHAUSTED: hbm", "backend UNAVAILABLE",
                                 "ABORTED by peer", "CANCELLED_BY_PREEMPTION",
                                 "a transient blip", "shape mismatch", ""])
def test_classification_matches_the_reference_off_cuda(msg):
    """Messages without a CUDA marker classify as the reference does."""
    assert is_transient(RuntimeError(msg)) == jfaults.is_transient(RuntimeError(msg))


# -- circuit breaker ---------------------------------------------------------

def _breaker(cls=CircuitBreaker, **kw):
    now = [0.0]
    kw.setdefault("threshold", 0.5)
    kw.setdefault("window", 8)
    kw.setdefault("min_samples", 4)
    kw.setdefault("open_s", 10.0)
    b = cls(clock=lambda: now[0], **kw)
    return b, now


def test_breaker_trips_open_then_half_open_then_closes():
    b, now = _breaker()
    for ok in (True, False, False, False):  # 75% errors over min_samples
        assert b.allow()
        b.record(ok)
    assert b.state == "open" and not b.allow() and b.opens == 1
    assert 0 < b.retry_after_s() <= 10.0

    now[0] = 10.1  # cooldown over: one probe admitted, the rest fast-fail
    assert b.state == "half_open"
    assert b.allow()
    assert not b.allow()
    b.record(True)
    assert b.state == "closed" and b.allow() and b.error_rate() == 0.0


def test_breaker_failed_probe_reopens():
    b, now = _breaker()
    for ok in (False, False, False, False):
        b.record(ok)
    assert b.state == "open"
    now[0] = 10.1
    assert b.allow()
    b.record(False)
    assert b.state == "open" and not b.allow()
    now[0] = 15.0
    assert b.state == "open"


def test_breaker_needs_min_samples():
    b, _ = _breaker(min_samples=4)
    for _ in range(3):
        b.record(False)
    assert b.state == "closed" and b.allow()


def test_hub_breakers_are_per_model_and_gated_by_config():
    hub = ResilienceHub(ServeConfig(breaker_threshold=0.5, breaker_min_samples=1,
                                    breaker_window=4))
    sick, healthy = hub.model("sick"), hub.model("healthy")
    assert sick.breaker is not None and sick.breaker is not healthy.breaker
    sick.breaker.record(False)
    assert sick.breaker.state == "open" and healthy.breaker.state == "closed"
    assert ResilienceHub(ServeConfig()).model("m").breaker is None


def test_retry_policy_backoff_capped_and_jittered():
    p = RetryPolicy(max_attempts=5, base_ms=10.0, max_ms=40.0)
    for attempt, cap in [(0, 10.0), (1, 20.0), (2, 40.0), (6, 40.0)]:
        for _ in range(20):
            d = p.backoff_ms(attempt)
            assert cap * 0.5 <= d <= cap


def test_retry_policy_rng_is_injectable_and_deterministic():
    a = RetryPolicy(max_attempts=3, base_ms=10.0, max_ms=100.0, rng=random.Random(42))
    b = RetryPolicy(max_attempts=3, base_ms=10.0, max_ms=100.0, rng=random.Random(42))
    seq_a = [a.backoff_ms(k) for k in range(6)]
    assert seq_a == [b.backoff_ms(k) for k in range(6)]
    hub = ResilienceHub(ServeConfig(retry_max_attempts=2))
    assert hub.retry.rng is not random  # noqa: SIM300
    c = RetryPolicy.from_config(ServeConfig(retry_max_attempts=2, retry_base_ms=10.0,
                                            retry_max_ms=100.0), rng=random.Random(42))
    assert [c.backoff_ms(k) for k in range(6)] == seq_a


# -- fault injector ----------------------------------------------------------

def test_fault_injector_cadence_and_count():
    inj = FaultInjector()
    inj.configure(model="m", fail_every_n=2, count=2, kind="transient")
    outcomes = []
    for _ in range(8):
        try:
            inj.on_dispatch("m")
            outcomes.append("ok")
        except TransientFault:
            outcomes.append("fail")
    assert outcomes == ["ok", "fail", "ok", "fail", "ok", "ok", "ok", "ok"]
    assert inj.snapshot()["injected"]["dispatch"] == 2
    inj.clear()
    assert inj.snapshot()["rules"] == []


def test_fault_injector_kinds_and_scope():
    inj = FaultInjector()
    inj.configure(model="a", fail_every_n=1, kind="fatal")
    with pytest.raises(RuntimeError) as ei:
        inj.on_dispatch("a")
    assert not isinstance(ei.value, TransientFault)
    inj.on_dispatch("b")
    inj.configure(model="*", fail_every_n=1, kind="transient")
    with pytest.raises(TransientFault):
        inj.on_dispatch("b")
    with pytest.raises(ValueError):
        inj.configure(kind="nonsense")


def test_fault_injector_preprocess_rules_are_separate():
    inj = FaultInjector()
    inj.configure(model="m", fail_every_n=1, preprocess=True)
    inj.on_dispatch("m")
    with pytest.raises(TransientFault):
        inj.on_preprocess("m")
    assert inj.snapshot()["injected"]["preprocess"] == 1


def test_poison_takes_precedence_over_rules():
    inj = FaultInjector()
    inj.configure(model="*", fail_every_n=1, kind="transient")
    inj.poison_exc = RuntimeError("wedged")
    with pytest.raises(RuntimeError, match="wedged"):
        inj.on_dispatch("m")


@pytest.mark.parametrize("kind", ["adapter", "demand"])
def test_kinds_without_a_plane_are_refused_naming_the_module(kind):
    """The reference accepts these.  A kind whose plane the port has not
    yet (``demand``, the autoscaler's) is refused with the module still to
    port instead of accepted and never fired; ``adapter`` is served since
    the port has serving/adapters.py: a rule of its own target that fires
    on an attach, as the reference's does."""
    jfaults.FaultInjector().configure(model="m", fail_every_n=1, kind=kind)
    if kind in REFUSED_KINDS:
        with pytest.raises(ValueError, match="does not have yet") as ei:
            FaultInjector().configure(model="m", fail_every_n=1, kind=kind)
        assert REFUSED_KINDS[kind].split()[0] in str(ei.value)
        return
    assert kind == "adapter" and sorted(REFUSED_KINDS) == ["demand"]
    for inj in (jfaults.FaultInjector(), FaultInjector()):
        inj.configure(model="m:alice", fail_every_n=1, kind=kind)
        inj.on_dispatch("m")  # never fires on a dispatch
        inj.on_adapter("m:bob")  # another tenant's attach
        with pytest.raises(RuntimeError, match="injected adapter fault"):
            inj.on_adapter("m:alice")
        assert inj.snapshot()["injected"]["adapter"] == 1


@pytest.mark.parametrize("kind,mode", [("migration", ""), ("migration", "drop"),
                                       ("migration", "corrupt"), ("migration", "slow"),
                                       ("spec_mismatch", "")])
def test_migration_and_spec_kinds_are_accepted_as_the_reference(kind, mode):
    """Served since the port has live migration and speculation: each kind
    and mode is a rule of its own target in both injectors."""
    for inj in (jfaults.FaultInjector(), FaultInjector()):
        rule = inj.configure(model="m", fail_every_n=1, kind=kind, mode=mode, latency_ms=5)
        assert (rule.kind, rule.mode) == (kind, mode)
        inj.on_dispatch("m")  # never fires on a dispatch
        fired = inj.on_migration("m") if kind == "migration" else inj.on_spec("m")
        assert fired == ((mode or "drop", 0.005 if mode == "slow" else 0.0)
                         if kind == "migration" else True)
    assert kind not in REFUSED_KINDS


def test_prefix_rules_are_their_own_target():
    inj = FaultInjector()
    inj.configure(model="m", fail_every_n=1, kind="transient")
    inj.configure(model="m", fail_every_n=2, kind="prefix", mode="cow")
    assert [inj.on_prefix("m") for _ in range(4)] == ["", "cow", "", "cow"]
    with pytest.raises(TransientFault):  # the dispatch rule was not displaced
        inj.on_dispatch("m")
    with pytest.raises(ValueError, match="prefix mode"):
        inj.configure(kind="prefix", mode="drop")
    with pytest.raises(ValueError, match="mode is a"):
        inj.configure(kind="transient", mode="cow")


# -- the port's classes beside the reference's, seeded alike -----------------

@pytest.mark.parametrize("seed", [0, 7, 42])
def test_backoff_sequences_equal_the_reference(seed):
    kw = dict(max_attempts=4, base_ms=3.0, max_ms=50.0)
    port = RetryPolicy(rng=random.Random(seed), **kw)
    ref = jres.RetryPolicy(rng=random.Random(seed), **kw)
    assert [port.backoff_ms(k) for k in range(10)] == [ref.backoff_ms(k) for k in range(10)]
    cfg = dict(retry_max_attempts=3, retry_base_ms=7.0, retry_max_ms=90.0)
    port = RetryPolicy.from_config(ServeConfig(**cfg), rng=random.Random(seed))
    ref = jres.RetryPolicy.from_config(JServeConfig(**cfg), rng=random.Random(seed))
    assert [port.backoff_ms(k) for k in range(8)] == [ref.backoff_ms(k) for k in range(8)]


# (clock, action) scripts: "ok"/"fail" record an outcome, "allow" asks.
BREAKER_SCRIPTS = {
    "trip_probe_close": [(0, "ok"), (0, "fail"), (1, "fail"), (1, "fail"), (2, "allow"),
                         (11, "allow"), (11, "allow"), (11.5, "ok"), (12, "allow")],
    "probe_fails": [(0, "fail")] * 4 + [(10.5, "allow"), (10.5, "fail"), (12, "allow"),
                                        (21, "allow"), (21.1, "allow"), (21.3, "ok")],
    "window_slides": [(i, "ok" if i % 3 else "fail") for i in range(20)] + [(20, "allow")],
}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_trajectories_equal_the_reference(script):
    pb, pnow = _breaker()
    jb, jnow = _breaker(jres.CircuitBreaker)
    traj = {"port": [], "ref": []}
    for t, action in BREAKER_SCRIPTS[script]:
        for b, now, key in ((pb, pnow, "port"), (jb, jnow, "ref")):
            now[0] = t
            out = b.allow() if action == "allow" else b.record(action == "ok")
            traj[key].append((b.state, out, round(b.error_rate(), 6), b.opens,
                              round(b.retry_after_s(), 6)))
    assert traj["port"] == traj["ref"]


INJECTOR_RULES = [
    dict(model="m", fail_every_n=3, count=2, kind="transient"),
    dict(model="*", fail_every_n=1, kind="fatal"),
    dict(model="m", fail_every_n=2, preprocess=True),
    dict(model="m", fail_every_n=2, count=3, kind="poison"),
    dict(model="m", fail_every_n=1, count=2, kind="prefix", mode="cow"),
]


@pytest.mark.parametrize("rule", INJECTOR_RULES, ids=lambda r: r["kind"] if "kind" in r
                         else "preprocess")
def test_injector_fire_patterns_equal_the_reference(rule):
    def drive(inj, transient_cls):
        inj.configure(**rule)
        out = []
        for i in range(9):
            model = "m" if i % 4 else "other"
            for hook in ("on_dispatch", "on_preprocess"):
                try:
                    getattr(inj, hook)(model)
                    out.append("ok")
                except transient_cls:
                    out.append("transient")
                except RuntimeError as e:
                    out.append(f"fatal:{e}")
            out.append(inj.on_prefix(model))
        snap = inj.snapshot()
        counts = {k: snap["injected"][k] for k in ("dispatch", "preprocess", "prefix")}
        return out, counts, snap["poisoned"], snap["rules"]

    assert drive(FaultInjector(), TransientFault) == drive(jfaults.FaultInjector(),
                                                           jfaults.TransientFault)


def test_run_with_retry_equals_the_reference():
    """The job lane's retry loop: the same attempts, sleeps and counters."""
    async def drive(mod, transient):
        script = [transient("a"), transient("b"), RuntimeError("fatal")]
        mr = mod.ModelResilience(name="m", retry=mod.RetryPolicy(
            max_attempts=5, base_ms=1.0, max_ms=4.0, rng=random.Random(3)))
        slept, calls = [], []

        async def factory():
            calls.append(1)
            if script:
                raise script.pop(0)
            return "done"

        async def sleep(s):
            slept.append(s)
        try:
            await mod.run_with_retry(factory, mr, None, clock=lambda: 0.0, sleep=sleep)
        except RuntimeError as e:
            return len(calls), slept, mr.stats.snapshot(), mr.last_error_fatal, str(e)

    port = _run(drive(SimpleNamespace(ModelResilience=ModelResilience, RetryPolicy=RetryPolicy,
                                      run_with_retry=run_with_retry), TransientFault))
    ref = _run(drive(jres, jfaults.TransientFault))
    assert port == ref and port[0] == 3 and port[3] is True


# -- batcher: deadlines, retry, estimation -----------------------------------

class FakeModel:
    def __init__(self, max_batch=4):
        self.servable = SimpleNamespace(name="fake", bucket_axes=("batch",))
        self.buckets = [(b,) for b in (1, max_batch)]
        self.max_batch = max_batch


class ScriptedRunner:
    """Raises the scripted exceptions in order, then succeeds."""

    def __init__(self, script=(), delay_s=0.0):
        self.script = list(script)
        self.delay_s = delay_s
        self.dispatches = 0

    async def run(self, model, samples, seq=None, span=None):
        self.dispatches += 1
        if self.delay_s:
            await asyncio.sleep(self.delay_s)
        if self.script:
            raise self.script.pop(0)
        return ["ok"] * len(samples)


def _mr(retries=0, breaker=None):
    return ModelResilience(name="fake",
                           retry=RetryPolicy(max_attempts=retries, base_ms=1.0, max_ms=4.0),
                           breaker=breaker)


def test_batcher_retries_transient_and_succeeds():
    async def drive():
        runner = ScriptedRunner(script=[TransientFault("flaky")])
        mr = _mr(retries=2)
        b = DynamicBatcher(FakeModel(), runner, ModelConfig(name="fake", coalesce_ms=1.0),
                           resilience=mr).start()
        try:
            result, _ = await b.submit({"x": 1})
            assert result == "ok" and runner.dispatches == 2
            assert mr.stats.retries == 1 and mr.stats.retry_successes == 1
        finally:
            await b.stop()
    _run(drive())


def test_batcher_does_not_retry_fatal_errors():
    async def drive():
        runner = ScriptedRunner(script=[ValueError("bad shapes")])
        mr = _mr(retries=3)
        b = DynamicBatcher(FakeModel(), runner, ModelConfig(name="fake", coalesce_ms=1.0),
                           resilience=mr).start()
        try:
            with pytest.raises(ValueError):
                await b.submit({"x": 1})
            assert runner.dispatches == 1 and mr.stats.retries == 0
            assert mr.last_error_fatal
        finally:
            await b.stop()
    _run(drive())


def test_batcher_sheds_expired_request_before_dispatch():
    """A request whose deadline passed while queued is 504-shed at pop time:
    the counter moves and the device never sees it."""
    async def drive():
        runner = ScriptedRunner(delay_s=0.15)
        mr = _mr()
        b = DynamicBatcher(FakeModel(max_batch=1), runner,
                           ModelConfig(name="fake", coalesce_ms=0.0), resilience=mr).start()
        try:
            loop = asyncio.get_running_loop()
            first = asyncio.ensure_future(b.submit({"x": 1}))
            await asyncio.sleep(0.02)
            doomed = asyncio.ensure_future(b.submit({"x": 2}, deadline=loop.time() + 0.05))
            await asyncio.sleep(0)
            result, _ = await first
            assert result == "ok"
            with pytest.raises(DeadlineExceeded) as ei:
                await doomed
            assert ei.value.stage == "queue"
            assert mr.stats.deadline_queue == 1
            assert runner.dispatches == 1
        finally:
            await b.stop()
    _run(drive())


def test_batcher_retry_stops_at_deadline():
    async def drive():
        runner = ScriptedRunner(script=[TransientFault("flaky")] * 10)
        mr = _mr(retries=10)
        mr.retry = RetryPolicy(max_attempts=10, base_ms=100.0, max_ms=100.0)
        b = DynamicBatcher(FakeModel(), runner, ModelConfig(name="fake", coalesce_ms=0.0),
                           resilience=mr).start()
        try:
            loop = asyncio.get_running_loop()
            with pytest.raises((TransientFault, DeadlineExceeded)):
                await b.submit({"x": 1}, deadline=loop.time() + 0.03)
            assert runner.dispatches <= 2
        finally:
            await b.stop()
    _run(drive())


def test_estimate_wait_uses_depth_times_p50():
    ring = LatencyRing()
    for _ in range(8):
        ring.record(0.0, 50.0, 50.0)
    runner = ScriptedRunner()
    b = DynamicBatcher(FakeModel(max_batch=2), runner, ModelConfig(name="fake"), ring=ring)
    for _ in range(4):
        b._queue.put_nowait(SimpleNamespace(sample={}, seq_len=None, fut=None,
                                            t_enq=0.0, deadline=None))
    assert b.estimate_wait_ms(1) == pytest.approx(150.0)
    cold = DynamicBatcher(FakeModel(), runner, ModelConfig(name="fake"))
    assert cold.estimate_wait_ms() == 0.0


# -- job queue ---------------------------------------------------------------

def test_job_sweeper_survives_gc_exception():
    async def drive():
        now = [0.0]

        async def run_job(job):
            return {"png_b64": "x" * 10}

        q = JobQueue(run_job, result_ttl_s=0.1, clock=lambda: now[0]).start()
        try:
            real_gc, blows = q._gc, [2]

            def flaky_gc():
                if blows[0] > 0:
                    blows[0] -= 1
                    raise RuntimeError("boom in gc")
                real_gc()

            q._gc = flaky_gc
            job = q.submit("m", None)
            for _ in range(200):
                if job.status == "done":
                    break
                await asyncio.sleep(0.01)
            now[0] = 0.2
            for _ in range(100):
                if job.status == "expired":
                    break
                await asyncio.sleep(0.05)
            assert job.status == "expired"
        finally:
            await q.stop()
    _run(drive())


def test_job_queue_drain_waits_for_running_and_queued():
    async def drive():
        release = asyncio.Event()

        async def run_job(job):
            await release.wait()
            return {"ok": 1}

        q = JobQueue(run_job).start()
        try:
            q.submit("m", 1)
            q.submit("m", 2)
            await asyncio.sleep(0.02)
            assert q.active == 1 and q.depth == 1
            assert not await q.drain(0.05)
            release.set()
            assert await q.drain(2.0)
            assert q.active == 0 and q.depth == 0
        finally:
            await q.stop()
    _run(drive())


def test_requeue_failed_since_reruns_outage_victims_only():
    """The watchdog's heal step: jobs that failed at or after the outage
    began run again under their ids; earlier failures stay failed."""
    async def drive():
        now = [100.0]
        fail = [True]

        async def run_job(job):
            if fail[0]:
                raise RuntimeError("device wedged")
            return {"ok": job.payload}

        q = JobQueue(run_job, clock=lambda: now[0]).start()
        try:
            old = q.submit("m", "old")
            while old.status != "error":
                await asyncio.sleep(0.01)
            now[0] = 200.0
            victim = q.submit("m", "victim")
            while victim.status != "error":
                await asyncio.sleep(0.01)
            fail[0] = False
            assert q.requeue_failed_since(150.0) == 1
            while victim.status != "done":
                await asyncio.sleep(0.01)
            assert victim.result == {"ok": "victim"} and old.status == "error"
        finally:
            await q.stop()
    _run(drive())
