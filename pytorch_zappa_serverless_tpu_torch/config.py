"""Declarative configuration for the PyTorch/CUDA port.

The port's own copy of the JAX package's ``ModelConfig`` and ``ServeConfig``,
cut to the fields the port reads; names and defaults are the
same, so a profile written for the JAX package loads here as long as it uses
only these fields.  A file is JSON, or YAML (``yaml`` is imported only when a
YAML file is loaded), optionally with named profiles; :func:`dump_config`
writes one as JSON.  ``TPUSERVE_<FIELD>``
environment variables override the top-level fields after the file is read
(:func:`apply_env_overrides`), and with no file the dev profile
(:func:`default_config`) serves every model the port has.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class ModelConfig:
    """Per-model serving configuration."""

    name: str
    # Checkpoint to import at cold start (torch .pt/.pth or .safetensors).
    # None → random-init from a seed with the real architecture.
    checkpoint: str | None = None
    # Batch-size buckets; requests pad up to the smallest bucket that fits.
    batch_buckets: tuple[int, ...] = (1, 4, 8, 16, 32)
    # Sequence-length buckets (token models only).
    seq_buckets: tuple[int, ...] = (128,)
    # Compute dtype on the device; params stay f32 unless extra.params_dtype.
    dtype: str = "bfloat16"
    # Registered builder this deploy name instantiates ("" → the name itself).
    builder: str = ""
    # Variant family (serving/variants.py): deploys of one family are
    # interchangeable implementations of one task at different quality and
    # cost, and a client may address the family (with an objective) instead
    # of a deploy; the server picks.  "" → the model is its own family.
    family: str = ""
    # Rung on the family's quality ladder (higher = better); the brownout
    # ladder degrades down it before it sheds.
    quality_rank: int = 0
    # Expected device ms a request, ranking variants until live latency
    # evidence exists.  0 → unknown.
    cost_hint_ms: float = 0.0
    # Max requests in flight before 429 (backpressure).
    max_concurrency: int = 256
    # Batcher coalescing window in milliseconds.
    coalesce_ms: float = 2.0
    # QoS class of the dispatch lane ("latency" | "throughput"); "" defers to
    # the class the model family registered.
    latency_class: str = ""
    # Default request deadline in milliseconds: applied when the client sends
    # none; checked at admission, re-checked when the batcher pops the
    # request (expired work is shed with 504, never dispatched), and bounds
    # the await on the device future.  0 -> ServeConfig.deadline_default_ms
    # (0 there too -> no deadline).
    deadline_ms: float = 0.0
    # Serverless residency (serving/lifecycle.py): build this model on its
    # first request instead of at boot.  None defers to
    # ``ServeConfig.lazy_load``; True/False overrides per model.
    lazy_load: bool | None = None
    # PINNED: built at boot even under lazy_load, never idle-unloaded and
    # never evicted by the HBM budget (``POST /admin/models/{name}
    # {"action": "pin"}`` is the runtime twin).
    pinned: bool = False
    # -- the :generate lane ---------------------------------------------------
    # KV-cache engine: "slot" (a fixed pool of max-length rows) or "paged" (a
    # pool of fixed-size pages; sequences hold the pages their tokens need,
    # with chunked prefill and the prefix cache).
    kv_cache: str = "slot"
    # Token positions per KV page (paged only).
    kv_block_size: int = 16
    # Page-pool size (paged only); 0 -> slots x ceil(total / block) + 1, the
    # slot pool's worst-case capacity.
    kv_num_blocks: int = 0
    # Max tokens per prefill dispatch, interleaved with decode segments; 0 ->
    # one (bucketed) chunk per prompt.
    prefill_chunk_tokens: int = 0
    # Speculative decoding (paged only): the deploy that proposes spec_k
    # tokens a tick, verified by this model in one forward with
    # distribution-preserving rejection sampling.  "" -> off; any other
    # value names another deploy of this server, and "auto" the lowest rung
    # of the model's variant family (serving/variants.py).  Falls back to
    # plain decode while the draft is COLD or quarantined.
    spec_draft: str = ""
    spec_k: int = 4
    # Prefix KV cache (paged only): radix-tree reuse of frozen prompt pages,
    # copy-on-write on divergence; idle decay (0 = none) and a page cap (0 =
    # the pool itself).
    prefix_cache: bool = True
    prefix_cache_ttl_s: float = 0.0
    prefix_cache_blocks: int = 0
    # Live KV migration (paged only): under pool pressure the newest
    # stream's pages move to host memory and it resumes from them when
    # pages free (no recompute, no kill) before any stream is evicted and
    # re-prefilled; also gates the /admin/streams export and import routes.
    # False keeps the eviction ladder alone.
    kv_migrate: bool = True
    # -- multi-tenant LoRA adapters (serving/adapters.py, ops/lora.py) --------
    # Device slot pool for co-resident adapters on this base: 0 disables
    # adapters; N reserves N slots beside slot 0, the all-zero adapter (the
    # base itself).  Requests for different adapters co-batch into one
    # dispatch: each row gathers its own low-rank factors by slot index.
    # Not combinable with params_dtype int8 or auto.
    adapter_slots: int = 0
    # The pool's rank (the stacks' shapes are fixed at build): a checkpoint
    # of smaller rank zero-pads up, a larger one is a config error.
    adapter_rank: int = 8
    # Which projections carry deltas; every configured adapter must fit.
    adapter_targets: tuple[str, ...] = ("q", "v")
    # Registered adapters: {name: {checkpoint, alpha, rank, tenants, seed}};
    # no checkpoint -> the seed's random factors (dev mode, like models);
    # ``tenants`` lists the X-Tenant ids that resolve to the adapter.
    adapters: dict[str, dict] = field(default_factory=dict)
    # Free-form per-model extras (arch overrides, params_dtype, labels, ...).
    extra: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kv_cache not in ("slot", "paged"):
            raise ValueError(f"{self.name}: kv_cache must be 'slot' or 'paged', got "
                             f"{self.kv_cache!r}")
        if self.spec_draft == self.name:
            raise ValueError(f"{self.name}: spec_draft must name a different deploy (a model "
                             f"cannot draft for itself)")
        if self.spec_draft and self.kv_cache != "paged":
            raise ValueError(f"{self.name}: speculative decoding (spec_draft "
                             f"{self.spec_draft!r}) runs on the paged lane only; set kv_cache "
                             f"'paged'")
        if int(self.spec_k) < 1:
            raise ValueError(f"{self.name}: spec_k must be >= 1, got {self.spec_k}")


@dataclass
class FleetConfig:
    """The fleet router's profile (``cli fleet``; ``serving/fleet.py``): one
    router in front of N replicas.

    The router polls every replica's ``/healthz`` and ``/admin/models`` and
    sends each request to a replica where its model is resident, least
    forecast queue wait among them, spilling ``cold_start`` 503s to warm
    peers and failing over around dead or partitioned replicas with at most
    ``failover_retries`` extra attempts.  Fields and defaults are the JAX
    package's.
    """

    host: str = "127.0.0.1"
    port: int = 8080
    # Replica base URLs ("http://host:port").  Empty with spawn 0: the fleet
    # command refuses to start (a router with nothing behind it).
    replicas: list = field(default_factory=list)
    # Local replicas of `cli fleet --spawn N`: `cli serve` subprocesses on
    # spawn_base_port + i, each with its own journal (journal_dir/replica-i).
    spawn: int = 0
    spawn_base_port: int = 8100
    # Registry poll cadence: /healthz (liveness, drain flag, queue
    # forecast) and /admin/models (residency, estimated_warm_ms).
    poll_interval_s: float = 1.0
    # Outbound timeouts: connect is short (a dead host fails fast into the
    # failover path), total is one attempt's budget; a client X-Deadline-Ms
    # tightens it per request.
    connect_timeout_s: float = 2.0
    request_timeout_s: float = 120.0
    # Extra attempts against a DIFFERENT replica after the first choice
    # fails (connect error, timeout, cold_start spill, 429/503 shed).
    failover_retries: int = 1
    failover_backoff_ms: float = 25.0
    # Consecutive connect or poll failures before a replica leaves routing
    # (a clean poll readmits it); the per-replica breaker takes
    # request-level failures.
    quarantine_after: int = 3
    breaker_threshold: float = 0.5
    breaker_window: int = 20
    breaker_min_samples: int = 6
    breaker_open_s: float = 5.0
    # Bounded affinity maps: job id -> replica (polls route home) and
    # Idempotency-Key -> replica (resubmits dedupe on the acking journal).
    affinity_capacity: int = 8192
    # Model of the /predict and /classify aliases; "" -> the replica's own
    # default (its first configured model).
    default_model: str = ""
    # Disaggregated prefill/decode: prefill on a prefill-tagged replica,
    # the stream's KV pages migrate to a decode replica at the first token.
    # Needs paged lanes (ModelConfig.kv_cache="paged") on the replicas.
    disagg: bool = False
    # Replica URLs tagged prefill (also in ``replicas``); the rest decode.
    # Empty: any two distinct routable replicas.
    prefill_replicas: list = field(default_factory=list)
    # KV-aware failover of disaggregated streams: the journaled pages and
    # the emitted-token watermark resume a stream on a peer when its decode
    # replica dies.
    kv_failover: bool = True
    stream_journal_capacity: int = 1024
    # The replica scale actuator (POST /admin/fleet/scale): out while the
    # fleet's mean queue-wait forecast exceeds scale_target_wait_ms, in
    # under a quarter of it, one replica a step, within [min, max].
    scale_target_wait_ms: float = 250.0
    scale_min_replicas: int = 1
    scale_max_replicas: int = 8
    # One "auto" scale step every interval (needs a spawn hook); 0: manual.
    autoscale_interval_s: float = 0.0


@dataclass
class ServeConfig:
    """Per-deploy profile."""

    profile: str = "dev"
    host: str = "127.0.0.1"
    port: int = 8000
    # Run every (model × bucket) forward once at boot, so the first request
    # pays no first-dispatch cost (kernel build included).
    warmup_at_boot: bool = True
    # Two-level priority dispatch: latency-class work jumps queued
    # throughput work between device calls.  False = one FIFO.
    priority_dispatch: bool = True
    # Async job lane (:submit): per-model backlog bound (429 past it), done
    # jobs kept, retained-result heap budget, and the result TTL.
    job_max_backlog: int = 64
    job_keep_done: int = 256
    job_result_ttl_s: float = 900.0
    job_max_result_mb: float = 64.0
    # How long the /healthz probe waits for its no-op to clear the dispatch
    # lane before it calls the lane wedged.  Must sit above the longest
    # legitimate occupancy (a lazy capture, a long job chunk).
    dispatch_probe_timeout_s: float = 300.0
    # Device mesh for multi-GPU serving, e.g. {"data": 4, "model": 2}: a
    # world of prod(mesh) ranks, one process a GPU (parallel/mesh.py); rank
    # 0 serves HTTP and leads, the others mirror it (parallel/lockstep.py).
    # Empty -> one process on one device.
    mesh: dict[str, int] = field(default_factory=dict)
    # Multi-host bootstrap: coordinator_address ("host:port" of process 0's
    # rank 0) with num_processes > 1 joins one world of every host's ranks
    # (each host runs the SAME profile, its own process_id); rank
    # process_id x local ranks + local rank.  Empty on one host: a loopback
    # port.
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    # Supervisor: probe the device every interval; after fail_threshold
    # consecutive failures rebuild the engine (one host), or, in a lockstep
    # world, log and keep /healthz failing.  0 -> off.
    supervise_interval_s: float = 0.0
    supervise_fail_threshold: int = 3
    # Lockstep leader only: broadcast a no-op heartbeat to the followers
    # every interval, so an idle follower never waits inside a header
    # broadcast longer than this; it must stay below the process group's
    # timeout (parallel.mesh.COLLECTIVE_TIMEOUT_S, checked at boot).  0 -> off.
    heartbeat_interval_s: float = 0.0
    # Lockstep worlds only: when a generation lane goes fatal (the ranks
    # diverged; the lane cannot recover in place), signal this process so
    # that its shutdown leads OP_SHUTDOWN and a process supervisor restarts
    # the WORLD instead of serving 503s forever.  One process ignores it.
    exit_on_fatal: bool = True
    # -- request resilience: every knob defaults to off (0) ------------------
    # Deadline when neither the client nor ModelConfig.deadline_ms sets one
    # (0 -> none), and the cap on a client's deadline (0 -> no cap).
    deadline_default_ms: float = 0.0
    deadline_max_ms: float = 0.0
    # Transient-fault retry (faults.is_transient): retries per dispatch after
    # the first attempt (0 -> off), capped exponential backoff; a retry
    # never outlives the request's deadline.
    retry_max_attempts: int = 0
    retry_base_ms: float = 10.0
    retry_max_ms: float = 1000.0
    # Per-model circuit breaker: the error rate in [0, 1] that trips it OPEN
    # once min_samples outcomes are in the sliding window (0 -> no breaker);
    # open_s is the cooldown before half-open probes.
    breaker_threshold: float = 0.0
    breaker_window: int = 20
    breaker_min_samples: int = 10
    breaker_open_s: float = 5.0
    # Graceful drain on SIGTERM: health 503, new work 503 + Retry-After, and
    # this long for in-flight work to finish (0 -> stop at once).
    drain_timeout_s: float = 0.0
    # Self-healing watchdog (serving/watchdog.py): probe every interval; a
    # poisoned engine (dead probe, or a breaker open on a fatal cause) is
    # quarantined and rebuilt in the background (0 -> off).  After
    # recover_max_attempts failed rebuilds (backoff from recover_backoff_s)
    # it gives up until POST /admin/recover.
    watchdog_interval_s: float = 0.0
    recover_max_attempts: int = 3
    recover_backoff_s: float = 1.0
    # Boot-time fault rules, {model: FaultInjector.configure kwargs}: the
    # config twin of POST /admin/faults.  File-only.
    faults: dict[str, dict] = field(default_factory=dict)
    # -- serverless residency (serving/lifecycle.py) -------------------------
    # Build models on their first request (one single-flight activation per
    # model) instead of at boot; ModelConfig.lazy_load overrides per model,
    # and PINNED models always build at boot.
    lazy_load: bool = False
    # Scale-to-zero: a model idle this long demotes device -> host (pinned
    # host copies; its CUDA graphs are dropped with the device weights), and
    # after host_idle_drop_s more to disk (with a checkpoint store) or none.
    # 0 -> never unload.
    idle_unload_s: float = 0.0
    # Device-residency budget in bytes (parameters plus each model's CUDA
    # graph pool; a :generate KV pool is its own ledger entry): while the
    # runner's ledger exceeds it, LRU non-PINNED idle models demote to the
    # host tier.  0 -> unlimited.
    hbm_budget_bytes: int = 0
    # Host-tier retention before the next rung down; 0 -> 4 x idle_unload_s.
    host_idle_drop_s: float = 0.0
    # Host-residency budget in bytes: while host-tier bytes exceed it, LRU
    # host copies demote to the disk tier (or none without a store).
    # 0 -> unlimited.
    host_budget_bytes: int = 0
    # Streaming checkpoint store (serving/ckptstore.py): a directory of
    # content-addressed chunks.  Set -> demotions gain the disk tier and a
    # cold build streams the stored weights while it builds.  "" -> off.
    ckpt_store_dir: str = ""
    # The store's chunk size: the unit of hashing, dedup and staging.
    ckpt_chunk_bytes: int = 1 << 20
    # Lifecycle reaper interval; 0 -> idle_unload_s / 4, clamped to [0.05, 5].
    lifecycle_tick_s: float = 0.0
    # Cold admission: a request whose deadline cannot cover the estimated
    # activation answers 503 cold_start + Retry-After + estimated_warm_ms; a
    # request without one waits up to activation_max_wait_s.
    # activation_estimate_ms is the estimate before any activation of the
    # model has been seen (the port has no persistent compile cache to
    # quarter it).
    activation_max_wait_s: float = 120.0
    activation_estimate_ms: float = 15000.0
    # -- multi-tenant adapters (serving/adapters.py) -------------------------
    # Scale-to-zero per tenant: an adapter idle this long detaches from its
    # slot (a re-attach writes the slot again).  0 -> follow idle_unload_s;
    # negative -> never.
    adapter_idle_unload_s: float = 0.0
    # The attach estimate in ms before any attach of an adapter was seen
    # (its history refines it): a request whose deadline is below it answers
    # 503 adapter_cold + Retry-After while the attach goes on.
    adapter_attach_estimate_ms: float = 500.0
    # -- predictive autoscaling (serving/autoscale.py) -----------------------
    # "predictive" learns each key's keep-warm window from its inter-arrival
    # gaps and pre-warms ahead of forecast demand; "histogram" learns the
    # windows only; "off" keeps the fixed timers alone.  The fixed timers
    # stay the fallback while a key's history is thin or the plane has
    # degraded to reactive after mispredictions.
    autoscale: str = "predictive"
    # Control-tick cadence; 0 → 1 s.
    autoscale_tick_s: float = 0.0
    # Keep-warm window = this quantile of the key's gaps, clamped to
    # [keepwarm_min_s, keepwarm_max_s].
    keepwarm_quantile: float = 0.95
    keepwarm_min_s: float = 1.0
    keepwarm_max_s: float = 600.0
    # Gaps a key needs before its learned window and forecast apply.
    autoscale_min_history: int = 8
    # Lead added to the activation estimate, so a pre-warm finishes before
    # the predicted arrival.
    prewarm_margin_s: float = 1.0
    # This many pre-warms in a row that no arrival matches drop the plane to
    # reactive for autoscale_reactive_hold_s.
    autoscale_mispredict_limit: int = 3
    autoscale_reactive_hold_s: float = 30.0
    # -- variant families (serving/variants.py) ------------------------------
    # Brownout of family-addressed requests: "auto" serves a cheaper rung
    # while the preferred one would shed and recovers with hysteresis;
    # "forced" always serves the cheapest satisfying rung; "off" never
    # degrades because of pressure.
    brownout: str = "auto"
    # Hysteresis: pressure-free selections in a row before a family leaves
    # brownout, and the least seconds a brownout holds once entered.
    brownout_exit_ticks: int = 3
    brownout_min_hold_s: float = 5.0
    # -- SLO and goodput (serving/slo.py) ------------------------------------
    # Objectives keyed "model", "model:adapter" or a family:
    # {latency_objective_ms, availability_target}.  File-only.  Other keys
    # take the slo_* defaults below.
    slo: dict[str, dict] = field(default_factory=dict)
    # Default latency objective (0 → served means on time) and availability
    # target (0.999 → a 0.1% error budget).
    slo_latency_objective_ms: float = 0.0
    slo_availability_target: float = 0.999
    # The burn-rate alarm's fast and slow windows and their thresholds.
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    slo_fast_burn_alarm: float = 14.0
    slo_slow_burn_alarm: float = 6.0
    # -- the request plane ---------------------------------------------------
    # Append-only job journal directory ("" = durability off): one JSONL
    # record a job transition.  At boot the job queue replays it, so an
    # acknowledged submit survives a kill -9, done results come back from
    # disk, and Idempotency-Key dedupe works across restarts.
    journal_dir: str = ""
    # Journal fsync policy: "always" fsyncs every record (a 202 means on
    # disk), "interval" at most every ~250 ms, "never" leaves it to the OS.
    journal_fsync: str = "always"
    # Request tracing (serving/tracing.py; GET /admin/trace): the ring of
    # finished span trees; per model the flight recorder also pins the
    # trace_flight_slow slowest and the last trace_flight_errors errored
    # traces; trace_max_spans caps one trace (drops counted, never raised).
    trace_ring: int = 256
    trace_flight_slow: int = 8
    trace_flight_errors: int = 32
    trace_max_spans: int = 512
    # Where POST /debug/trace and POST /admin/profile write their
    # torch.profiler captures (Chrome trace JSON).
    trace_dir: str = "~/.cache/tpuserve/traces"
    # The binary tensor lane (serving/wire.py): application/x-tpuserve-tensor
    # bodies beside the JSON and raw lanes; False answers a frame 415.
    binary_lane: bool = True
    # A frame's byte cap, checked against its DECLARED sizes before any
    # allocation (413 past it); 0 -> the HTTP body cap (64 MiB).
    tensor_max_bytes: int = 0
    # The perf plane (serving/perfplane.py; GET /admin/perf): ingest-stage
    # histograms, the event-loop lag sampler, the thread-stack sampler and
    # the rolling per-model gauges.  False starts no thread and no timer and
    # writes no histogram.
    perfplane: bool = True
    # Lag probe cadence (also the gauges' sampling cadence).
    perf_loop_lag_interval_s: float = 0.25
    # Stack sampler rate in Hz (0: no stack sampling; lag and gauges stay).
    perf_stack_hz: float = 7.0
    # Collapsed-stack table bound (evicted weight folds into "other").
    perf_stack_topk: int = 64
    # Rolling window of the samples/s, tokens/s, step and MFU gauges.
    perf_window_s: float = 30.0
    # SO_REUSEPORT acceptor worker processes (serving/acceptors.py) on
    # ingest_port (0: port + 1), speaking only the binary lane and feeding
    # this process's batchers over shared-memory rings.  0: single-process.
    ingest_workers: int = 0
    ingest_port: int = 0
    # Ring geometry: slots a ring and one slot's bytes (a request, or a
    # batch of responses, must fit one slot; a larger request is 413 at the
    # worker).  Two rings a worker live in /dev/shm: size them to fit it.
    shm_ring_slots: int = 256
    shm_ring_slot_bytes: int = 1 << 20
    # The fleet router's knobs (`cli fleet`; serving/fleet.py), beside the
    # replica profile so one file describes the deployment.  File-only.
    fleet: FleetConfig = field(default_factory=FleetConfig)
    models: list[ModelConfig] = field(default_factory=list)

    def model(self, name: str) -> ModelConfig:
        for m in self.models:
            if m.name == name:
                return m
        raise KeyError(f"model {name!r} not in profile {self.profile!r}")


_ENV_PREFIX = "TPUSERVE_"

# Fields of the JAX package's ServeConfig the port refuses by name (a bare
# TypeError would not say why), each with the reason.
REFUSED_FIELDS = {
    "profiler_port": "jax.profiler's live trace server has no torch counterpart in the "
                     "port; capture with POST /admin/profile or POST /debug/trace "
                     "(ROADMAP Queue 3)",
    "compile_cache_dir": "the port keeps no persistent compile cache: kernels build per "
                         "checkout and CUDA graphs are captured per process "
                         "(ROADMAP Queue 3)",
}


def _refuse_fields(data: dict) -> None:
    for key, why in REFUSED_FIELDS.items():
        if key in data:
            raise ValueError(f"ServeConfig field {key!r} is not served by the port: {why}")


def _coerce(value: str, target_type: Any) -> Any:
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    return value


def apply_env_overrides(cfg: ServeConfig, environ: dict[str, str] | None = None) -> ServeConfig:
    """Override top-level ServeConfig fields from ``TPUSERVE_*`` env vars
    (``TPUSERVE_PORT=9123``), in place, and return ``cfg``.

    Each value is coerced by the type of the field's default, so a float
    field loaded from a file as an int still takes "7.5"; ``mesh`` takes
    JSON (``TPUSERVE_MESH='{"data": 4, "model": 2}'``).  ``models`` is
    file-only, and so are ``faults``, ``slo`` and ``fleet``: structured
    config does not go in an env var.
    """
    environ = os.environ if environ is None else environ
    for f in dataclasses.fields(ServeConfig):
        key = _ENV_PREFIX + f.name.upper()
        if key not in environ or f.name in ("models", "faults", "slo", "fleet"):
            continue
        if f.name == "mesh":
            try:
                mesh = json.loads(environ[key])
                if not isinstance(mesh, dict):
                    raise TypeError(f"expected JSON object, got {type(mesh).__name__}")
                cfg.mesh = {str(k): int(v) for k, v in mesh.items()}
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f'{key} must be a JSON object like {{"data": 4, "model": 2}}: {e}'
                ) from None
            continue
        target = (type(f.default) if f.default is not dataclasses.MISSING
                  else type(getattr(cfg, f.name)))
        setattr(cfg, f.name, _coerce(environ[key], target))
    return cfg


def load_config(path: str | Path | None = None,
                profile: str | None = None) -> ServeConfig:
    """Load a ServeConfig from a JSON or YAML file, or the dev profile
    without one; ``TPUSERVE_*`` env vars override either.

    The file may hold several named profiles::

        profiles:
          dev:  {port: 8000, models: [{name: bert_base}]}
          prod: {port: 80, models: [...]}
    """
    if path is None:
        return apply_env_overrides(default_config())
    raw = Path(path).expanduser().read_text()
    if str(path).endswith(".json"):
        data = json.loads(raw)
    else:
        import yaml

        data = yaml.safe_load(raw)
    if not data:
        return apply_env_overrides(default_config())
    if "profiles" in data:
        profile = profile or data.get("default_profile",
                                      next(iter(data["profiles"])))
        data = dict(data["profiles"][profile], profile=profile)
    _refuse_fields(data)
    models = [ModelConfig(**{**m,
                             "batch_buckets": tuple(m.get("batch_buckets",
                                                          (1, 4, 8, 16, 32))),
                             "seq_buckets": tuple(m.get("seq_buckets", (128,))),
                             "adapter_targets": tuple(m.get("adapter_targets", ("q", "v")))})
              for m in data.pop("models", [])]
    fleet = data.pop("fleet", None)
    cfg = ServeConfig(models=models, **data)
    if fleet:
        cfg.fleet = FleetConfig(**fleet)
    return apply_env_overrides(cfg)


def dump_config(cfg: ServeConfig) -> str:
    """The profiles-style document :func:`load_config` reads back
    (``load_config(path) == cfg``), as JSON: what ``deploy`` renders and
    ``stage`` writes as ``config.json`` (JSON needs no PyYAML on the
    serving host, and :func:`load_config` reads a ``.json`` file as JSON).  Tuples become
    lists, which the loader turns back into the fields' tuples; no field of
    ``REFUSED_FIELDS`` exists here to be written."""
    d = dataclasses.asdict(cfg)
    profile = d.pop("profile")
    return json.dumps({"default_profile": profile, "profiles": {profile: d}}, indent=2) + "\n"


def default_config() -> ServeConfig:
    """The dev profile: the JAX package's dev zoo, random-init, filtered by
    the port's registry, which now holds all eight of its models."""
    from . import models as _zoo  # noqa: F401  (populates the registry)
    from .utils.registry import list_models

    registered = set(list_models())
    cfg = ServeConfig(
        profile="dev",
        # Each bucket's first request pays its first dispatch (kernel builds
        # included); production profiles set warmup_at_boot: true.
        warmup_at_boot=False,
        models=[
            ModelConfig(name="resnet18", batch_buckets=(1, 4, 8)),
            ModelConfig(name="resnet50", batch_buckets=(1, 4, 8, 32)),
            ModelConfig(name="efficientnet_b0", batch_buckets=(1, 4, 8)),
            ModelConfig(name="vit_b16", batch_buckets=(1, 4, 8)),
            ModelConfig(name="bert_base", batch_buckets=(1, 4, 8), seq_buckets=(128,)),
            ModelConfig(name="whisper_tiny", batch_buckets=(1, 4),
                        extra={"max_new_tokens": 64}),
            ModelConfig(name="gpt2", batch_buckets=(1, 4), seq_buckets=(64, 128),
                        extra={"max_new_tokens": 32, "params_dtype": "bfloat16"}),
            # The tiny variant at 64x64: a smoke of the async job lane.
            ModelConfig(name="sd15", batch_buckets=(1,),
                        extra={"variant": "tiny", "num_steps": 4,
                               "height": 64, "width": 64}),
        ],
    )
    cfg.models = [m for m in cfg.models if (m.builder or m.name) in registered]
    return cfg
