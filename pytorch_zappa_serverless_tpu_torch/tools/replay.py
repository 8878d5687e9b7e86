"""Trace-driven load replay: production-shaped traffic against a live stack.

Synthetic traces with the two invocation shapes "Serverless in the Wild"
documents for real serverless fleets:

- **diurnal**: a smooth day/night rate curve (a sinusoidally thinned
  Poisson process), the shape keep-warm policies are tuned against;
- **bursty**: the Azure-functions shape: a heavy-tailed few models take
  most invocations, and arrivals cluster into on/off bursts (exponential
  gaps between episodes, geometric burst sizes, tight spacing inside one)
  over a thin Poisson background.

The replayer fires each request at its trace offset, open-loop (a slow
server does not slow the offered load), and reports attainment (served
within the latency objective over offered), goodput against throughput,
the cold-hit rate (503 ``cold_start``/``adapter_cold`` answers over
offered), latency p50/p99 of served requests, and shed, error and degraded
counts.

The port's copy of the JAX package's root ``tools/replay.py``: the same
pure functions (``synth_trace``, ``replay_async``, ``summarize``,
``retrying_sender``, ``sweep_verdict``, ``POLICIES``), the policy sweep on
the port's server (``serving/server.py``), and a sender on the port's
standard-library client (``serving/httpclient.py``) in place of aiohttp.
The bench's ``replay`` and ``autoscale`` sections run them.  Traces are
deterministic per seed, so reruns are comparable.
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
import time

import numpy as np

SHAPES = ("diurnal", "bursty", "uniform")


def synth_trace(shape: str, duration_s: float, rps: float,
                models: list[str], seed: int = 0,
                period_s: float | None = None) -> list[dict]:
    """Deterministic arrival trace: ``[{"t": offset_s, "model": name}]``.

    ``rps`` is the mean offered rate over the whole trace; ``models`` are
    drawn per arrival (weighted toward the head of the list for the bursty
    shape).  ``period_s`` is the diurnal cycle (default: one a trace)."""
    if shape not in SHAPES:
        raise ValueError(f"shape must be one of {SHAPES}, got {shape!r}")
    if not models:
        raise ValueError("models must be non-empty")
    rng = np.random.default_rng(seed)
    n_total = max(int(duration_s * rps), 1)
    times: list[float] = []
    picks: list[str] = []
    if shape == "uniform":
        times = list(np.sort(rng.uniform(0.0, duration_s, n_total)))
        picks = [models[int(i)] for i in rng.integers(0, len(models), len(times))]
    elif shape == "diurnal":
        # rate(t) = rps * (1 + 0.8 sin(2πt/T)), thinned from 1.8 * rps.
        period = period_s or duration_s
        peak = rps * 1.8
        t, raw = 0.0, []
        while t < duration_s and len(raw) < n_total * 4:
            t += float(rng.exponential(1.0 / peak))
            if rng.random() < (1.0 + 0.8 * math.sin(2.0 * math.pi * t / period)) * rps / peak:
                raw.append(t)
        times = [x for x in raw if x < duration_s]
        picks = [models[int(i)] for i in rng.integers(0, len(models), len(times))]
    else:  # bursty
        weights = np.array([1.0 / (i + 1) ** 1.5 for i in range(len(models))])
        weights /= weights.sum()
        # A background trickle (20 % of the volume) and burst episodes.
        n_bg = max(n_total // 5, 1)
        for t in np.sort(rng.uniform(0.0, duration_s, n_bg)):
            times.append(float(t))
            picks.append(models[int(rng.choice(len(models), p=weights))])
        budget = n_total - n_bg
        t = 0.0
        mean_gap = duration_s / max(budget / 8.0, 1.0)
        while budget > 0:
            t += float(rng.exponential(mean_gap))
            if t >= duration_s:
                break
            model = models[int(rng.choice(len(models), p=weights))]
            size = min(int(rng.geometric(1.0 / 8.0)), budget)
            for j in range(size):
                times.append(min(t + j * float(rng.uniform(0.005, 0.05)), duration_s))
                picks.append(model)
            budget -= size
        order = np.argsort(times)
        times = [times[int(i)] for i in order]
        picks = [picks[int(i)] for i in order]
    return [{"t": round(float(t), 4), "model": m} for t, m in zip(times, picks)]


async def replay_async(send, trace: list[dict], speedup: float = 1.0,
                       clock=time.perf_counter, sleep=asyncio.sleep) -> list[dict]:
    """Fire the trace open-loop; one outcome dict a request.

    ``send(item) -> {"status", "latency_ms", "cold", "degraded",
    "retry_after_s"}`` is the transport.  Arrivals are scheduled at ``t /
    speedup``; a request whose slot has passed fires at once."""
    t0 = clock()
    outcomes: list[dict] = []

    async def one(item: dict):
        delay = item["t"] / max(speedup, 1e-9) - (clock() - t0)
        if delay > 0:
            await sleep(delay)
        started = clock()
        try:
            out = await send(item)
        except Exception as e:  # a transport failure is an errored request
            out = {"status": 599, "latency_ms": (clock() - started) * 1e3,
                   "cold": False, "degraded": False, "error": f"{type(e).__name__}: {e}"}
        out["model"] = item["model"]
        out["t"] = item["t"]
        outcomes.append(out)

    await asyncio.gather(*[one(item) for item in trace])
    outcomes.sort(key=lambda o: o["t"])
    return outcomes


def summarize(outcomes: list[dict], duration_s: float,
              objective_ms: float | None = None) -> dict:
    """The replay report.  A request is good when it was served (2xx)
    within ``objective_ms`` (None: every served request), the rule the
    server's SLO plane applies (``serving/slo.py``)."""
    offered = len(outcomes)
    served = [o for o in outcomes if 200 <= o["status"] < 300]
    shed = [o for o in outcomes if o["status"] in (429, 503, 504)]
    errors = [o for o in outcomes if o["status"] >= 500 and o["status"] != 503]
    cold = [o for o in outcomes if o.get("cold")]
    degraded = [o for o in served if o.get("degraded")]
    good = [o for o in served if objective_ms is None or o["latency_ms"] <= objective_ms]
    lat = sorted(o["latency_ms"] for o in served)

    def pctl(p):
        if not lat:
            return None
        return round(lat[min(int(len(lat) * p / 100), len(lat) - 1)], 2)

    dur = max(duration_s, 1e-9)
    return {
        "offered": offered,
        "served": len(served),
        "good": len(good),
        "degraded": len(degraded),
        "shed": len(shed),
        "errors": len(errors),
        "cold_hits": len(cold),
        "slo_attainment": round(len(good) / offered, 4) if offered else None,
        "cold_hit_rate": round(len(cold) / offered, 4) if offered else None,
        "offered_rps": round(offered / dur, 2),
        "throughput_rps": round(len(served) / dur, 2),
        "goodput_rps": round(len(good) / dur, 2),
        "goodput_vs_throughput": round(len(good) / len(served), 4) if served else None,
        "latency_p50_ms": pctl(50),
        "latency_p99_ms": pctl(99),
        **({"objective_ms": objective_ms} if objective_ms else {}),
    }


def retrying_sender(send, *, max_attempts: int = 12, wait_cap_s: float = 0.25,
                    clock=time.perf_counter, sleep=asyncio.sleep):
    """The client-felt transport: sheds and cold answers retried after
    their ``Retry-After`` (capped at ``wait_cap_s`` an attempt).
    ``latency_ms`` becomes the first send to the final answer, ``cold``
    whether the first attempt hit a cold start, ``attempts`` the sends."""
    async def retry_send(item: dict) -> dict:
        t0 = clock()
        out: dict = {}
        cold_first = False
        attempts = 0
        for attempt in range(max_attempts):
            out = await send(item)
            attempts = attempt + 1
            if attempt == 0:
                cold_first = bool(out.get("cold"))
            if out.get("status") not in (429, 503):
                break
            ra = out.get("retry_after_s")
            await sleep(min(float(ra), wait_cap_s) if ra else wait_cap_s)
        out = dict(out)
        out["latency_ms"] = round((clock() - t0) * 1000.0, 3)
        out["cold"] = cold_first
        out["attempts"] = attempts
        return out
    return retry_send


# -- the policy sweep (the bench's autoscale section) ----------------------------

POLICIES = ("fixed", "histogram", "predictive")

# ServeConfig deltas a scaling policy: everything else (models, budget,
# timers) is held identical, so the comparison isolates the policy.
POLICY_OVERRIDES = {
    "fixed": {"autoscale": "off"},
    "histogram": {"autoscale": "histogram"},
    "predictive": {"autoscale": "predictive"},
}

# Device bytes a torn-down server may leave allocated before the next boots
# (the chip script's phase 15 holds a demotion to the same 8 MiB).
LEAK_BYTES = 8 << 20


def sweep_verdict(per_policy: dict) -> dict:
    """Does the predictive policy beat the fixed-timer baseline on
    cold-hit rate and client p99?"""
    fixed = per_policy.get("fixed") or {}
    pred = per_policy.get("predictive") or {}

    def get(d, k):
        v = d.get(k)
        return float(v) if v is not None else None

    out: dict = {}
    for key, better_low in (("cold_hit_rate", True), ("latency_p99_ms", True),
                            ("goodput_rps", False)):
        f, p = get(fixed, key), get(pred, key)
        out[key] = {"fixed": f, "predictive": p,
                    "predictive_better": (None if f is None or p is None
                                          else (p < f if better_low else p > f))}
    chr_ok = out["cold_hit_rate"]["predictive_better"]
    p99_ok = out["latency_p99_ms"]["predictive_better"]
    out["predictive_beats_fixed"] = bool(chr_ok) and bool(p99_ok)
    return out


def default_payload() -> tuple[bytes, str]:
    """A 64x64 PNG body (the JAX tool's seed-0 image): serves the vision
    models."""
    from ..models.sd15 import png_bytes

    rng = np.random.default_rng(0)
    return png_bytes(rng.integers(0, 256, (64, 64, 3), np.uint8)), "image/png"


def http_sender(pool, url: str, body: bytes, content_type: str,
                deadline_ms: float | None = None, clock=time.perf_counter):
    """A ``send`` for :func:`replay_async` against a live stack, on the
    port's client (``serving.httpclient.ClientPool``)."""
    from ..serving.httpclient import ClientTimeout

    headers = {"Content-Type": content_type}
    if deadline_ms:
        headers["X-Deadline-Ms"] = str(deadline_ms)

    async def send(item: dict) -> dict:
        t0 = clock()
        async with await pool.request(
                "POST", url.rstrip("/") + f"/v1/models/{item['model']}:predict", data=body,
                headers=headers, timeout=ClientTimeout(total=600.0)) as resp:
            raw = await resp.read()
        latency_ms = (clock() - t0) * 1000.0
        cold = False
        if resp.status == 503 and raw[:1] == b"{":
            try:
                j = json.loads(raw)
                cold = bool(j.get("cold_start") or j.get("adapter_cold"))
            except ValueError:
                pass
        ra = resp.headers.get("retry-after")
        return {"status": resp.status, "latency_ms": latency_ms, "cold": cold,
                "degraded": bool(resp.headers.get("x-degraded")),
                "retry_after_s": float(ra) if ra else None}
    return send


def _allocated(device) -> int | None:
    """Device bytes allocated in this process (None off the card), cuBLAS's
    cached workspaces let go first: they are the library's, not a
    server's graphs or weights."""
    import torch

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return int(torch.cuda.memory_allocated())


def policy_sweep(*, duration_s: float = 8.0, rps: float = 8.0, seed: int = 7,
                 shape: str = "bursty", policies: tuple = POLICIES,
                 deadline_ms: float = 1000.0, objective_ms: float = 500.0,
                 idle_unload_s: float = 0.35, hbm_budget_bytes: int = 1 << 30,
                 retry_cap_s: float = 0.25, ckpt_store_dir: str | None = None,
                 device=None) -> dict:
    """Replay one trace against a server a scaling policy and emit the
    comparison and its verdict.

    Each variant boots a fresh server (``BackgroundServer``, owning its
    engine) with a lazy scale-to-zero ResNet-18 at 48 px on a short fixed
    idle timer and an immediate host-tier drop, at equal
    ``hbm_budget_bytes``: fixed timers demote between bursts and pay the
    cold start at each burst head; the histogram policy learns a keep-warm
    window covering the gap; the predictive one also pre-warms ahead of the
    forecast.  The sender retries colds and sheds as a client would
    (:func:`retrying_sender`).

    The port keeps no compile cache, so each server's first activation is
    a full build plus captures, as every later cold one is.  Before the
    trace, each server activates its model once through ``POST
    /admin/models/{name}`` (outside the measured window, the same for every
    policy): that takes the first build out of the trace and teaches the
    lifecycle's activation estimate the measured build, so mid-trace cold
    hits are deadline-infeasible fast fails for every policy alike.  The
    servers run one after another; on the card each frees its graphs and
    weights before the next boots, and the device bytes allocated between
    them are held to :data:`LEAK_BYTES` over the first boot's baseline.

    ``ckpt_store_dir`` turns the checkpoint store on: idle demotions land
    in the disk tier, re-activations stream, and the learned
    ``estimated_warm_ms`` falls."""
    from ..config import ModelConfig, ServeConfig
    from ..engine.loader import resolve_device
    from ..serving.httpclient import ClientPool, ClientTimeout
    from ..serving.server import BackgroundServer

    dev = resolve_device(device)
    model = "rn_burst"
    trace = synth_trace(shape, duration_s, rps, [model], seed=seed)

    def mk_cfg(policy: str) -> ServeConfig:
        return ServeConfig(
            warmup_at_boot=True, idle_unload_s=idle_unload_s,
            # Straight through the host tier: a demotion costs a rebuild.
            host_idle_drop_s=idle_unload_s, hbm_budget_bytes=hbm_budget_bytes,
            activation_estimate_ms=max(4.0 * deadline_ms, 1000.0),
            autoscale_tick_s=0.2, keepwarm_min_s=2.0,
            slo={model: {"latency_objective_ms": objective_ms, "availability_target": 0.99}},
            models=[ModelConfig(
                name=model, builder="resnet18", batch_buckets=(1, 4), dtype="float32",
                coalesce_ms=1.0, lazy_load=True, extra={"image_size": 48, "resize_to": 56})],
            **({"ckpt_store_dir": ckpt_store_dir} if ckpt_store_dir else {}),
            **POLICY_OVERRIDES[policy])

    body, ctype = default_payload()

    async def drive_one(port: int) -> dict:
        pool = ClientPool()
        base = f"http://127.0.0.1:{port}"
        t = ClientTimeout(total=600.0)

        async def call(method, path, body=None):
            async with await pool.request(method, base + path, json_body=body,
                                          timeout=t) as r:
                return r.status, await r.json()

        try:
            status, out = await call("POST", f"/admin/models/{model}", {"action": "activate"})
            if status != 200:
                raise RuntimeError(f"activate {model}: {status} {out}")
            send = http_sender(pool, base, body, ctype, deadline_ms=deadline_ms)
            outcomes = await replay_async(
                retrying_sender(send, max_attempts=20, wait_cap_s=retry_cap_s), trace)
            report = summarize(outcomes, duration_s, objective_ms=objective_ms)
            _, auto = await call("GET", "/admin/autoscale")
            _, models_snap = await call("GET", "/admin/models")
            mrow = (models_snap.get("models") or {}).get(model, {})
            report["activations"] = mrow.get("activations", 0)
            report["demotions_idle"] = (mrow.get("demotions_by_cause") or {}).get("idle", 0)
            # Let the idle timers walk the model down the ladder, then read
            # the warm estimate the next request would see: the floor is
            # the disk tier with the store, no weights without it.
            floor = "disk" if ckpt_store_dir else "none"
            mrow2 = mrow
            for _ in range(80):
                _, m = await call("GET", f"/admin/models/{model}")
                mrow2 = m["model"]
                if mrow2.get("tier") == floor and mrow2.get("state") == "cold":
                    break
                await asyncio.sleep(0.1)
            report["tier_end"] = mrow2.get("tier")
            report["estimated_warm_ms"] = mrow2.get("estimated_warm_ms")
            report["prewarms"] = auto["counters"]["prewarms"]
            report["keepwarm_window_s"] = (auto.get("models", {}).get(model, {})
                                           .get("keepwarm_window_s"))
            for _ in range(100):  # settle an in-flight background activation
                _, m = await call("GET", "/admin/models")
                if (m.get("models") or {}).get(model, {}).get("state") != "warming":
                    break
                await asyncio.sleep(0.1)
            return report
        finally:
            await pool.close()

    per_policy: dict = {}
    base_bytes = _allocated(dev)
    between: list[int] = []
    for policy in policies:
        srv = BackgroundServer(mk_cfg(policy), device=dev)
        with srv:
            per_policy[policy] = asyncio.run(drive_one(srv.port))
        del srv  # the server owns its engine: nothing may hold it past here
        gc.collect()
        after = _allocated(dev)
        if after is not None:
            between.append(after - base_bytes)
            if after - base_bytes > LEAK_BYTES:
                raise RuntimeError(f"policy {policy!r}: {after - base_bytes} device bytes "
                                   f"still allocated after its server stopped "
                                   f"(limit {LEAK_BYTES})")
    return {
        "shape": shape, "duration_s": duration_s, "mean_rps": rps, "seed": seed,
        "deadline_ms": deadline_ms, "objective_ms": objective_ms,
        "idle_unload_s": idle_unload_s, "hbm_budget_bytes": hbm_budget_bytes,
        "ckpt_store": bool(ckpt_store_dir),
        "policies": per_policy,
        "verdict": sweep_verdict(per_policy),
        **({"allocated_bytes_between_servers": between} if between else {}),
        "note": ("one deterministic trace replayed against N scaling policies at equal "
                 "hbm_budget_bytes, one server after another (no compile cache: each "
                 "boot and cold activation is a full build plus captures); latency is "
                 "client-felt time-to-answer (cold/shed retries included, capped), "
                 "cold_hit_rate the fraction of requests whose first attempt hit a cold "
                 "start"),
    }

