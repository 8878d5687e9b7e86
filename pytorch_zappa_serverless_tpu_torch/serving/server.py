"""HTTP serving surface, on asyncio streams from the standard library.

Routes (the JAX package's, for the port's slices):

- ``GET /``, ``/healthz``, ``/v1/models``, ``/metrics`` (JSON, or
  Prometheus text with ``?format=prometheus`` or ``Accept: text/plain``);
- ``POST /admin/drain`` (stop taking work and wait for what is in flight),
  ``GET``/``POST /admin/faults`` (the fault injector's rules),
  ``POST /admin/recover`` (the watchdog's recovery, its budget reset) and
  ``POST /admin/reload`` (rebuild the engine);
- ``GET /admin/models`` (every model's residency), ``GET
  /admin/models/{name}`` and ``POST /admin/models/{name}`` with
  ``{"action": "activate"|"unload"|"demote"|"pin"|"unpin"}`` (``demote``
  takes ``"to": "host"|"disk"|"none"``): 400 for an unknown action or tier,
  404 for an unknown model, 409 for a pinned or busy model (or ``disk``
  without a checkpoint store);
- ``GET /admin/trace`` (trace summaries, newest first; ``model``,
  ``status``, ``min_ms``, ``limit``; the flight recorder's pins) and ``GET
  /admin/trace/{trace_id}`` (one span tree; 404 once evicted);
- ``POST /admin/profile {"seconds", "top"}`` (a ``torch.profiler`` window
  over live traffic and its device ops by time, ``utils/xplane.py``) and
  ``POST /debug/trace {"seconds"}`` (the window as a Chrome trace under
  ``trace_dir``): 409 while a capture runs, 400 outside ``seconds`` ∈
  [0.05, 60], 500 if the profiler does not start;
- ``GET /admin/slo`` (objectives, outcomes, burn rates and the usage
  ledger, ``serving/slo.py``) and ``GET /admin/autoscale`` (each demand
  key's fit, keep-warm window and planned action, ``serving/autoscale.py``);
- ``GET /admin/adapters`` (every tenant's adapter residency) and ``POST
  /admin/adapters/{model}/{adapter}`` with ``{"action": "attach"|"detach"}``:
  404 for an unknown adapter, 409 for a detach of a busy or cold adapter;
- ``GET /admin/prefix`` (each paged lane's prefix-tree counters) and the
  stream registry of live migration: ``GET /admin/streams`` (every
  ``:generate`` stream by id: state, tokens, migrations), ``POST
  /admin/streams/{id}/export`` with ``{"phase": "snapshot"|"cutover"|
  "pages"|"commit"|"abort"}``, ``POST /admin/streams/{id}/import`` with
  ``{"manifest", "pages", "cause"}`` and ``GET
  /admin/streams/{id}/attach?from=N`` (an imported stream's SSE from token
  N).  409 on a lane without ``kv_migrate``, a phase the stream is not in,
  or pages to fetch again (``"need"``); 400 for a stream or a model not on
  a paged lane and for a bad manifest; 503 + Retry-After (``"retryable"``)
  for a dropped step or a pool that cannot take the import now;
- ``POST /v1/models/{name}:predict``, and ``/predict`` / ``/classify`` for
  the first configured model (405 for an async-only model);
- ``POST /v1/models/{name}:submit`` → 202 ``{"job": ...}`` (an
  ``Idempotency-Key`` header dedupes resubmits; a full backlog is 429, a
  queue shut down 503, both with Retry-After), and ``GET /v1/jobs/{id}`` →
  200, 404 unknown, 410 expired;
- ``POST /v1/models/{name}:generate`` on a model whose servable carries the
  continuous contract (GPT-2, Whisper): a server-sent event stream
  (``text/event-stream``, chunked) of ``data: {"token": id}`` events, a
  decode segment's tokens as soon as the segment ends, then ``data:
  {"done": true, "tokens": [...]}``;
  with ``"stream": false`` one JSON body.  A client that disconnects
  cancels its stream.  A stream exported to another server ends with
  ``data: {"migrated": true, "stream_id", "watermark"}`` instead.  A lane
  with a live speculative draft answers ``X-Spec-Draft`` and its final
  event's ``stats`` carry the stream's proposals and acceptances.  Errors: 400 (a bad ``max_new_tokens``, a repetition
  penalty, an over-length prompt, an input of several windows), 405 (no
  lane), 429 with Retry-After (a full backlog, or the paged pool exhausted,
  with ``kv_blocks_free``, ``kv_blocks_needed`` and ``estimated_wait_ms``),
  503 with Retry-After (a stopped lane).

A predict body is JSON: one input (``{"text": ...}``, ``{"input_ids":
[...]}``, ``{"b64": ...}``, ``{"array": [...], "rate": N}`` or a pre-decoded
image array) or ``{"instances": [...]}`` with N inputs that are admitted
together and co-batch on the device; an ``application/x-tpuserve-tensor``
frame (``serving/wire.py``: its blocks are read-only views over the body,
several blocks or ``FLAG_LIST`` the instances); any other body (an image or
WAV file) is the input's raw bytes.  The Content-Type decides the lane: a
frame is never sniffed as JSON.  A binary request gets a binary answer
(``pack_response``: the meta block, then a JSON block a prediction) unless
it sends ``Accept: application/json``; a malformed frame or a ``FLAG_META``
request is 400, a declared size over ``tensor_max_bytes`` 413 (before any
allocation), a frame with ``binary_lane`` off 415, and a multi-instance
frame on ``:submit`` 400.  An input that preprocesses to a list of
samples (Whisper's 30 s windows of long audio) runs them as that many
samples, co-batched up to the bucket, and its answer is the model's
``meta["merge_results"]`` of theirs.  A model whose ``:predict`` decodes
greedily (``meta["predict_ignores_sampling"]``) answers 400 to a sampling
knob.  A ``{"b64": ...}`` input, alone or as an instance, reaches the
model's ``preprocess`` as the decoded bytes, as the JAX server hands them
over.  The answer keeps the JAX server's shape, ``{"model", "timing",
"predictions"}``, with ``X-Queue-Ms`` and ``X-Device-Ms`` headers; errors
are ``{"error": ...}`` with 400, 404, 405, 413, 429 (+ Retry-After) or 500.

Residency (``serving/lifecycle.py``): a lazy model is built on its first
demand.  A work request for a model that is not resident activates it (one
activation for all concurrent callers) and waits for it; one whose
deadline is below the activation's estimate answers 503 with
``cold_start``, ``Retry-After`` and ``estimated_warm_ms`` while the
activation goes on.  A ``:submit`` to a cold model is acknowledged at once
and its job activates the model.  An unknown model's 404 lists every
configured model's residency, and ``/healthz`` and ``/v1/models`` carry it.

Adapters (``serving/adapters.py``): on a base with ``adapters``, a request
names its tenant's LoRA adapter with ``X-Adapter`` (or the body's top-level
``adapter``) or ``X-Tenant``; an unknown one is 404 with the base's
adapters.  The adapter attaches on demand (one attach for all concurrent
callers); a deadline below the attach estimate answers 503 with
``adapter_cold`` and Retry-After while the attach goes on.  Each row
carries its slot, so tenants co-batch on ``:predict`` and co-decode on the
paged ``:generate`` lane (the slot lane answers 400); a ``:submit`` keys its
job by (model, adapter) and the worker attaches.  Answers carry
``X-Adapter``, and each tenant has a latency ring ``{model}:{adapter}``.

Variant families (``serving/variants.py``): a request may address a family
(``ModelConfig.family``) instead of a deploy, with an objective (the body's
``objective`` ``{"max_latency_ms", "min_quality", "prefer_cost"}`` or the
``X-Objective-*`` headers) on ``:predict``, ``:generate`` and ``:submit``.
The server picks the rung from live evidence, degrades down the ladder
under pressure (brownout, with hysteresis) before it sheds, and answers
``X-Served-Variant`` (``X-Degraded: 1`` below the ladder's top; the body's
``family`` and ``degraded``).  An objective on a deploy is 400.  A shed of a
family member reports the family's minimum Retry-After.  Every work
request's arrival feeds the autoscaler's demand model, and its outcome the
SLO plane (``serving/slo.py``), at the one point where its status is known.

Resilience (``serving/resilience.py``): a ``:predict`` carries a deadline
(``X-Deadline-Ms``, else the body's top-level ``deadline_ms``, capped by
``deadline_max_ms``, else the model's and then the server's default); a
spent deadline is 504 at admission, a hopeless one (the queue-wait forecast
exceeds it) 429, and one that passes in the queue 504.  An open circuit
breaker fast-fails ``:predict`` and ``:submit`` with 503 + Retry-After, as a
model the watchdog has quarantined does.  While the server drains, work
routes answer 503 + Retry-After and ``/healthz`` 503; what is in flight,
streams included, runs to its end.

Tracing (``serving/tracing.py``): every work request takes its
``X-Request-Id`` (or gets one) and opens a trace (joining a
``traceparent``); every answer carries ``X-Request-Id`` and work answers
``X-Trace-Id``, error bodies ``request_id`` and ``trace_id``.  A
``:predict`` trace holds admission → queue → batch_form → device (with the
dispatch thread's exec) → respond; a ``:generate`` stream's id is its
request id (``X-Stream-Id``), its trace ends with the stream; a
``:submit``'s trace belongs to the job until its terminal state.  With
``journal_dir`` the job queue is durable (``serving/durability.py``): an
``Idempotency-Key`` header or body field answers the known job, across
restarts too, before any work; ``/healthz`` and ``/metrics`` carry the
replay's ``recovered_jobs``, ``restored_done``, ``replay_ms`` and
``deduped_submits``.

HTTP/1.1 with keep-alive and ``Content-Length`` bodies (no chunked request
bodies; an event stream's response is chunked).  The event loop never
touches a device tensor: batches and the generation lanes' programs go to
the runner's dispatch thread.
"""

from __future__ import annotations

import asyncio
import base64
import contextvars
import gc
import json
import math
import re
import signal
import threading
import time
import uuid
from pathlib import Path
from typing import Any
from urllib.parse import parse_qs

import numpy as np
import torch

from ..config import ServeConfig
from ..engine.loader import Engine, build_engine
from ..utils.logging import current_trace_id, get_logger, log_event
from . import wire
from .adapters import AdapterCold, AdapterManager, UnknownAdapter
from .autoscale import AutoscalePlane
from .batcher import DynamicBatcher, Overloaded
from .durability import JobJournal
from .generation import DraftGate, GenerationScheduler, PagedGenerationScheduler
from .httpframe import MAX_BODY_BYTES, RawBody
from .httpframe import HttpError as _HttpError
from .httpframe import encode as _encode
from .httpframe import head as _head
from .httpframe import keep_alive as _keep_alive
from .httpframe import read_request as _read_request
from .jobs import JobQueue
from .kvcache import KVPoolExhausted
from .kvmigrate import (CAUSES, FORMAT_VERSION, MigrationError, MigrationNeedsPages,
                        PageIntegrityError, check_manifest, dtype_name, pack_page, unpack_page)
from .lifecycle import ColdStart, LifecycleManager
from .metrics import MetricsHub
from .perfplane import PerfPlane, hist_quantile
from .resilience import DeadlineExceeded, ResilienceHub, run_with_retry
from .slo import SLOHub
from .tracing import Tracer, new_request_id
from .variants import Objective, VariantHub
from .watchdog import Watchdog

log = get_logger("serving.server")

_PREDICT = re.compile(r"^/v1/models/([^:/]+):predict$")
_SUBMIT = re.compile(r"^/v1/models/([^:/]+):submit$")
_GENERATE = re.compile(r"^/v1/models/([^:/]+):generate$")
_JOB = re.compile(r"^/v1/jobs/([^/]+)$")
_ADMIN_MODEL = re.compile(r"^/admin/models/([^/]+)$")
_ADMIN_TRACE = re.compile(r"^/admin/trace/([^/]+)$")
_STREAM_EXPORT = re.compile(r"^/admin/streams/([^/]+)/export$")
_STREAM_IMPORT = re.compile(r"^/admin/streams/([^/]+)/import$")
_STREAM_ATTACH = re.compile(r"^/admin/streams/([^/]+)/attach$")
_ADMIN_ADAPTER = re.compile(r"^/admin/adapters/([^/]+)/([^/]+)$")
_KINDS = ((":predict", "predict"), (":generate", "generate"), (":submit", "submit"))
_OBJECTIVE_HEADERS = ("X-Objective-Max-Latency-Ms", "X-Objective-Min-Quality",
                      "X-Objective-Prefer-Cost")

Response = tuple[int, Any, dict[str, str]]
# How often a stream that waits for its next token checks that its client
# is still connected.
_GONE_POLL_S = 0.05


class _ReqCtx:
    """One work request's observability handle: the request id (the
    client's ``X-Request-Id``, or a new one), the trace (joining a
    ``traceparent``), the trace id in the logging context, and whether the
    body came on the binary lane.  ``_handle_conn`` opens it before the
    handler and closes it after the answer: the trace finishes with the
    answer's status, unless the job lane took it over (:meth:`detach`)."""

    def __init__(self, server: "Server", headers: dict[str, str], kind: str,
                 model: str | None, path: str, start: float):
        self.server = server
        self.kind = kind
        self.model = model
        self.request_id = headers.get("x-request-id") or new_request_id()
        self.span = server.tracer.start(
            kind, model=model, traceparent=headers.get("traceparent"), start=start,
            request_id=self.request_id, **({"path": path} if model is None else {}))
        self.trace = self.span.trace
        self._cv_token = current_trace_id.set(self.trace.trace_id)
        self.binary = False
        self.detached = False

    @property
    def trace_id(self) -> str:
        return self.trace.trace_id

    def headers(self) -> dict[str, str]:
        return {"X-Request-Id": self.request_id, "X-Trace-Id": self.trace_id}

    def detach(self):
        """The job lane finishes the trace at the job's terminal state."""
        self.detached = True

    def close(self, status: int):
        if self.detached:
            self.span.end()
        else:
            # The root's own status wins over the HTTP code: a stream that
            # failed mid-way answered 200 but pins as an errored trace.
            err = status >= 400 or self.span.status == "error"
            self.server.tracer.finish(self.trace, "error" if err else "ok")
        current_trace_id.reset(self._cv_token)


# The work request being handled by the current task (set by _handle_conn).
_request_ctx: contextvars.ContextVar[_ReqCtx | None] = contextvars.ContextVar(
    "tpuserve_request_ctx", default=None)
# What admission learned about the current work request, for its later
# steps and for the SLO observation after its answer: "selection" (a family
# request's Selection), "family" (the family of a multi-variant deploy, for
# the shed minima), "adapter" (the tenant's record once its slot is held),
# "payload" and "extract" (a body the variant resolver decoded early),
# "deadline_ms" and "objective_ms" (the bound the selection used).
_request_state: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "tpuserve_request_state", default=None)


def _rstate() -> dict:
    st = _request_state.get()
    return st if st is not None else {}


class _request_scope:
    """Give a handler called outside the connection loop (a direct call) a
    request state of its own; inside a request, the loop's state stands."""

    def __enter__(self):
        self._token = _request_state.set({}) if _request_state.get() is None else None

    def __exit__(self, *exc):
        if self._token is not None:
            _request_state.reset(self._token)


def _objective_headers(headers: dict[str, str]) -> dict[str, str]:
    """The ``X-Objective-*`` headers under their names as sent (the
    connection loop lowercases header names)."""
    return {h: headers[h.lower()] for h in _OBJECTIVE_HEADERS if h.lower() in headers}


def _objective_on_deploy(name: str) -> Response:
    return _error(400, "objective requires addressing the variant family (or the "
                       f"X-Objective-* headers), not concrete variant {name!r}")


def _error(status: int, msg: str, **extra) -> Response:
    """The error envelope.  Inside a work request it carries the request and
    trace ids and emits the matching log record, so no 4xx or 5xx of the
    work surface leaves without ids a client can quote."""
    body = {"error": msg, **extra}
    ctx = _request_ctx.get()
    if ctx is not None:
        body.setdefault("request_id", ctx.request_id)
        body.setdefault("trace_id", ctx.trace_id)
        ctx.span.annotate(http_status=status, error=msg)
        log_event(log, "request error", kind=ctx.kind, model=ctx.model, status=status,
                  error=msg, request_id=ctx.request_id, trace_id=ctx.trace_id)
    return status, body, {}


def _error_retry(status: int, msg: str, retry_after_s: float, **extra) -> Response:
    status, body, _ = _error(status, msg, **extra)
    return status, body, {"Retry-After": str(max(int(math.ceil(retry_after_s)), 1))}


def _substage(stage: str, t0: float, t1: float, **attrs) -> None:
    """One ingest substage of the current work request: a per-(model,
    stage) histogram row on the perf plane and a span on its trace, beside
    (never inside) the admission → queue → device → respond chain."""
    ctx = _request_ctx.get()
    if ctx is None:
        return
    ctx.server.perf.note_stage(ctx.model, stage, (t1 - t0) * 1000.0)
    ctx.span.child(stage, start=t0, **attrs).end(end=t1)


def _unwrap_b64(payload: Any) -> Any:
    """The wire convention for binary in JSON: ``{"b64": ...}`` → raw bytes.
    Shared by the whole-body decode and the per-instance path."""
    if isinstance(payload, dict) and "b64" in payload:
        return base64.b64decode(payload["b64"])
    return payload


class _Refused(Exception):
    """A helper's early answer (a 4xx or 5xx) for its handler to return."""

    def __init__(self, response: Response):
        super().__init__(response[1].get("error"))
        self.response = response


class _BinaryLaneDisabled(Exception):
    """A tensor frame arrived while ``ServeConfig.binary_lane`` is off (415)."""


def _content_type(headers: dict[str, str]) -> str:
    return headers.get("content-type", "").split(";")[0].strip().lower()


def _decode_body(body: bytes, headers: dict[str, str],
                 extract: dict[str, Any] | None = None) -> Any:
    """A work body → the payload: a JSON body (by its Content-Type, or one
    that starts with ``{`` or ``[``) parsed, with a ``{"b64": ...}`` body
    unwrapped to its bytes; any other body as its raw bytes.  ``extract``
    maps top-level fields to defaults: those a JSON object carries are
    popped into it before the unwrap (``idempotency_key`` must not be lost
    when ``{"b64": ..., "idempotency_key": ...}`` collapses to bytes).  A
    body that starts like JSON and does not parse is refused (ValueError),
    where the JAX server would take it as raw bytes: an image file never
    starts so.  The binary lane is decoded before this (``Server._payload``)."""
    ctype = _content_type(headers)
    if ctype == "application/json" or body[:1] in (b"{", b"["):
        t0 = time.perf_counter()
        data = json.loads(body)
        t1 = time.perf_counter()
        _substage("json_decode", t0, t1)
        if extract is not None and isinstance(data, dict):
            for key in list(extract):
                if key in data:
                    extract[key] = data.pop(key)
        if isinstance(data, dict) and "b64" in data:
            data = _unwrap_b64(data)
            _substage("b64_decode", t1, time.perf_counter())
        return data
    return body


def _payload_error(e: Exception) -> Response:
    """A payload that failed to decode → its status: a declared frame past
    the cap 413, a frame on a disabled lane 415, anything else 400."""
    if isinstance(e, wire.FrameTooLarge):
        return _error(413, f"tensor frame too large: {e}")
    if isinstance(e, _BinaryLaneDisabled):
        return _error(415, str(e))
    return _error(400, f"bad request body: {type(e).__name__}: {e}")


class EventStream:
    """A response body of server-sent events: ``_handle_conn`` writes the
    head, then one chunk an event as ``events(reader)`` yields it, draining
    the socket each time; ``cancel()`` runs if the client goes away."""

    def __init__(self, events, cancel):
        self.events = events
        self.cancel = cancel


def _sse_head(status: int, headers: dict[str, str], keep_alive: bool) -> bytes:
    return _head(status, ["Content-Type: text/event-stream", "Cache-Control: no-cache",
                          "Transfer-Encoding: chunked"], headers, keep_alive)


def _sse_chunk(obj: Any) -> bytes:
    data = f"data: {json.dumps(obj, separators=(',', ':'))}\n\n".encode()
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


_GONE = object()  # what _next_or_gone answers for a client that went away


async def _next_or_gone(aw, reader: asyncio.StreamReader):
    """Await ``aw`` (a task), polling the connection meanwhile: the result,
    or ``_GONE`` once the client has closed its side (the reader saw EOF
    with nothing left to read; nothing is consumed)."""
    try:
        while True:
            done, _ = await asyncio.wait({aw}, timeout=_GONE_POLL_S)
            if done:
                return aw.result()
            if reader.at_eof():
                aw.cancel()
                return _GONE
    except asyncio.CancelledError:
        aw.cancel()
        raise


def _is_work(method: str, path: str) -> bool:
    """Work-bearing requests: what a drain refuses and counts in flight.
    Health, metrics, job polls and the admin routes keep answering."""
    return method == "POST" and (path in ("/predict", "/classify")
                                 or path.startswith("/v1/models/"))


class Server:
    """The serving surface over one engine."""

    def __init__(self, cfg: ServeConfig, engine: Engine | None = None, device=None):
        self.cfg = cfg
        # With no engine handed in, the server builds one on ``device`` (CUDA
        # unless asked otherwise) and owns it; one handed in belongs to the
        # caller.  An engine the server owns, and every engine a rebuild
        # makes, is shut down when it is replaced or the server stops.
        self._owns_engine = engine is None
        if engine is None:
            engine = build_engine(cfg, device)
        self.engine = engine
        self.metrics = MetricsHub()
        # Per-request span trees in a bounded ring and a flight recorder,
        # queryable on /admin/trace.
        self.tracer = Tracer(ring=cfg.trace_ring, flight_slow=cfg.trace_flight_slow,
                             flight_errors=cfg.trace_flight_errors,
                             max_spans=cfg.trace_max_spans)
        self.metrics.tracer = self.tracer
        # The perf plane: ingest-stage histograms, the loop-lag and stack
        # samplers, the rolling gauges (GET /admin/perf).  Always made;
        # ``perfplane: false`` makes every record a no-op.
        self.perf = PerfPlane(cfg)
        self.metrics.perf = self.perf
        # Binary-lane requests decoded, by model (event loop only), the
        # answers' serialization scratch, and with ``ingest_workers`` the
        # acceptor supervisor (serving/acceptors.py), made at start.
        self.binary_requests: dict[str, int] = {}  # guarded-by: event-loop
        self.wire_pool = wire.BufferPool()
        self.acceptors = None  # guarded-by: event-loop
        self.metrics.serverpath = self._serverpath_snapshot
        # True while /admin/profile or /debug/trace holds the profiler.
        self._tracing = False  # guarded-by: event-loop
        self.resilience = ResilienceHub(cfg)
        self.metrics.resilience = self.resilience
        self.metrics.faults = engine.runner.faults
        self.watchdog: Watchdog | None = None  # guarded-by: event-loop
        self._inflight = 0  # guarded-by: event-loop
        self._drain_task: asyncio.Task | None = None  # guarded-by: event-loop
        self._rebuild_lock = asyncio.Lock()
        self.batchers: dict[str, DynamicBatcher] = {}  # guarded-by: event-loop
        self.schedulers: dict[str, GenerationScheduler | PagedGenerationScheduler] = {}  # guarded-by: event-loop
        self.jobs: JobQueue | None = None  # guarded-by: event-loop
        # The residency manager and the checkpoint store (ckpt_store_dir),
        # made at start; the manager is there whatever the residency knobs,
        # so /admin/models and the residency metrics always answer.
        self.lifecycle: LifecycleManager | None = None  # guarded-by: event-loop
        self.ckpt_store = None  # guarded-by: event-loop
        # Multi-tenant adapter residency: per-tenant attach and detach,
        # scale-to-zero, ledger entries {base}:{adapter}.  Always made, so the
        # discovery and metrics surfaces exist with no adapter configured; a
        # detach drops its slot's prefix tree on the paged lane.
        self.adapters = AdapterManager(self, cfg)
        self.metrics.adapters = self.adapters
        self.adapters.prefix_invalidate = self._invalidate_prefix
        # The tenancy and control planes: family ladders with the selector
        # and the brownout ladder; per-(key, lane) objectives, burn windows
        # and the usage ledger; the demand models with their keep-warm
        # windows and pre-warms.  Always made, so their routes and metric
        # families exist; ``autoscale: off`` makes every hook a no-op.
        self.variants = VariantHub(cfg)
        self.metrics.variants = self.variants
        self.slo = SLOHub(cfg)
        self.metrics.slo = self.slo
        self.autoscale = AutoscalePlane(cfg)
        self.metrics.autoscale = self.autoscale
        # The stream registry: stream id -> the :generate request behind it,
        # so the export, import and attach routes can address a stream in
        # flight.  Finished streams stay until the cap (oldest dropped
        # first), so a just-migrated or just-finished one can still be
        # inspected or attached.
        self.streams: dict[str, dict] = {}  # guarded-by: event-loop
        self._streams_cap = 1024
        self.default_model = cfg.models[0].name if cfg.models else None
        self._server: asyncio.Server | None = None
        self._conns: set[asyncio.StreamWriter] = set()  # guarded-by: event-loop
        self._handlers: set[asyncio.Task] = set()  # guarded-by: event-loop
        # path -> {method: handler}; each takes (body, headers, query).
        self._routes = {
            "/": {"GET": self.handle_root},
            "/healthz": {"GET": self.handle_healthz},
            "/v1/models": {"GET": self.handle_models},
            "/metrics": {"GET": self.handle_metrics},
            "/predict": {"POST": self.handle_predict_default},
            "/classify": {"POST": self.handle_predict_default},
            "/admin/drain": {"POST": self.handle_drain},
            "/admin/faults": {"GET": self.handle_faults_get, "POST": self.handle_faults},
            "/admin/recover": {"POST": self.handle_recover},
            "/admin/reload": {"POST": self.handle_reload},
            "/admin/models": {"GET": self.handle_admin_models},
            "/admin/adapters": {"GET": self.handle_admin_adapters},
            "/admin/prefix": {"GET": self.handle_admin_prefix},
            "/admin/streams": {"GET": self.handle_admin_streams},
            "/admin/slo": {"GET": self.handle_admin_slo},
            "/admin/autoscale": {"GET": self.handle_admin_autoscale},
            "/admin/perf": {"GET": self.handle_admin_perf},
            "/admin/trace": {"GET": self.handle_trace_list},
            "/admin/profile": {"POST": self.handle_profile},
            "/debug/trace": {"POST": self.handle_debug_trace},
        }

    @property
    def draining(self) -> bool:
        return self.resilience.draining

    @property
    def rebuilding(self) -> bool:
        return self._rebuild_lock.locked()

    def _start_lanes(self):
        """The batchers and ``:generate`` lanes of every model the engine
        holds."""
        for name in list(self.engine.models):
            self._start_model_lanes(name)

    def _start_model_lanes(self, name: str):
        """Start one resident model's lanes (idempotent): at boot, after a
        rebuild, and after the lifecycle activates it.  Async-only models are
        served by the job queue alone."""
        cm = self.engine.model(name)
        if not cm.servable.meta.get("async_only") and name not in self.batchers:
            self.batchers[name] = DynamicBatcher(
                cm, self.engine.runner, cm.cfg, ring=self.metrics.ring(name),
                resilience=self.resilience.model(name), perf=self.perf).start()
            if self.adapters.enabled:
                # Co-batch evidence: each dispatch's adapter mix.
                self.batchers[name].adapter_hook = self.adapters.note_batch
        if "continuous" in cm.servable.meta and name not in self.schedulers:
                # The :generate lane beside :predict, its pool allocated and
                # its graphs captured at first use, as the JAX lanes compile;
                # kv_cache "paged" is the paged scheduler, which refuses a
                # servable without the paged contract (a config error fails
                # the boot), with the speculative draft's gate.
                ring = self.metrics.ring(f"{name}:generate")
                if cm.cfg.kv_cache == "paged":
                    self.schedulers[name] = PagedGenerationScheduler(
                        cm, self.engine.runner, cm.cfg, ring=ring,
                        draft=self._draft_gate(cm.cfg),
                        usage_hook=self._gen_usage_hook(name)).start()
                else:
                    self.schedulers[name] = GenerationScheduler(
                        cm, self.engine.runner, cm.cfg, ring=ring).start()

    async def _stop_lanes(self):
        for b in self.batchers.values():
            await b.stop()
        for sched in self.schedulers.values():
            await sched.stop()
            self._forget_streams(sched)
        self.batchers.clear()
        self.schedulers.clear()

    def _forget_streams(self, sched) -> None:
        """Drop a stopped lane's streams from the registry (they ended with
        the lane), so that it holds no reference to a replaced engine."""
        for sid in [sid for sid, e in self.streams.items() if e["sched"] is sched]:
            del self.streams[sid]

    async def _stop_model_lanes(self, name: str, release: bool = True):
        """Stop and drop one model's lanes (a demotion; the lifecycle calls
        it only for a quiet model).  With ``release`` the ``:generate``
        lane's KV pool and graphs are freed on the dispatch thread now, and
        its ledger entry goes."""
        b = self.batchers.pop(name, None)
        if b is not None:
            await b.stop()
        sched = self.schedulers.pop(name, None)
        if sched is not None:
            await sched.stop()
            self._forget_streams(sched)
            if release:
                try:
                    await self.engine.runner.run_fn(sched.release_kernels)
                except Exception:
                    log.exception("releasing %s's :generate lane failed", name)
            self.engine.runner.untrack_model(f"{name}:kvcache")
            self.engine.runner.untrack_model(f"{name}:draftcache")

    def _draft_gate(self, mc) -> DraftGate | None:
        """The speculative draft of one paged lane: ``spec_draft`` names
        another deploy of this server, or ``"auto"`` the lowest rung of the
        model's family ladder (none below it: speculation off).  The gate
        resolves it every tick
        against the live engine, resilience and lifecycle, so the lane
        decodes plain while the draft is COLD, warming, quarantined or
        mid-rebuild, and marks it busy (the lifecycle's enter and exit, read
        at each call: the manager is made after the boot lanes) so a
        demotion never runs under a tick."""
        draft = self._spec_draft_name(mc)
        if draft is None:
            return None

        def resolve():
            eng = self.engine
            if eng is None or draft not in eng.models:
                return None
            if draft in self.resilience.quarantined:
                return None
            lc = self.lifecycle
            if lc is not None and lc.knows(draft) and lc.state_of(draft) in ("cold",
                                                                              "warming"):
                return None
            return eng.model(draft)

        def enter(name):
            if self.lifecycle is not None:
                self.lifecycle.enter(name)

        def exit_(name):
            if self.lifecycle is not None:
                self.lifecycle.exit(name)

        return DraftGate(draft, resolve, enter=enter, exit=exit_)

    def _spec_draft_name(self, model) -> str | None:
        """A model's speculative draft deploy, or None (no draft, an unknown
        model, the model itself, or "auto" in a family with no other rung):
        "auto" is the family ladder's lowest rung (the ladder is
        quality-descending).  The autoscaler pre-warms it with its target."""
        try:
            mc = model if not isinstance(model, str) else self.cfg.model(model)
        except KeyError:
            return None
        draft = mc.spec_draft
        if draft == "auto":
            below = [m.name for m in self.variants.registry.ladder(mc.family or mc.name)
                     if m.name != mc.name]
            if not below:
                log_event(log, "spec_draft auto found no family sibling; speculation off",
                          model=mc.name)
                return None
            draft = below[-1]
        return draft if draft and draft != mc.name else None

    # -- the autoscaler's actuators and the usage ledger's hooks ------------
    async def _autoscale_activate(self, name: str, cause: str):
        """Pre-warm: the lifecycle's single-flight activation."""
        if self.lifecycle is not None and self.lifecycle.knows(name):
            await self.lifecycle.ensure_active(name, cause=cause)

    async def _autoscale_attach(self, base: str, adapter: str, cause: str):
        """Pre-warm of a tenant: the base first (a slot pool needs its base
        resident), then the adapters' single-flight attach."""
        if self.lifecycle is not None and self.lifecycle.knows(base):
            await self.lifecycle.ensure_active(base, cause=cause)
        await self.adapters.ensure_attached(base, adapter, cause=cause)

    def _autoscale_residency(self, key: str) -> str | None:
        """The residency of a ``model`` or ``model:adapter`` key."""
        base, _, adapter = key.partition(":")
        if adapter:
            rec = self.adapters.get(base, adapter)
            return rec.state if rec is not None else None
        return self.lifecycle.state_of(base) if self.lifecycle is not None else None

    def _autoscale_estimate_ms(self, key: str) -> float:
        """A key's activation cost: the pre-warm lead's base."""
        base, _, adapter = key.partition(":")
        if adapter:
            rec = self.adapters.get(base, adapter)
            return self.adapters.estimate_attach_ms(rec) if rec is not None else 0.0
        if self.lifecycle is not None and self.lifecycle.knows(base):
            return self.lifecycle.estimate_warm_ms(base)
        return 0.0

    def _gen_usage_hook(self, name: str):
        """One paged lane's retire hook: the stream's bill to the usage
        ledger, its adapter slot resolved back to the tenant's name (the
        lane knows slots, the ledger tenants)."""
        def hook(aidx: int, device_ms: float, kv_block_seconds: float, cached_tokens: int):
            adapter = self.adapters.name_of_slot(name, aidx) if aidx else None
            self.slo.usage.note_stream(name, adapter, device_ms, kv_block_seconds,
                                       cached_tokens)
        return hook

    async def start(self, host: str | None = None, port: int | None = None) -> int:
        """Start the lanes, the job queue and the watchdog, and listen;
        returns the bound port."""
        if self.cfg.faults:
            # Boot-time chaos rules (the config twin of POST /admin/faults);
            # a refused rule fails the boot.
            self.engine.runner.faults.apply_config(self.cfg.faults)
            log_event(log, "fault rules installed from config", models=sorted(self.cfg.faults))
        self._start_lanes()
        if self.cfg.ckpt_store_dir:
            from .ckptstore import CheckpointStore

            self.ckpt_store = CheckpointStore(self.cfg.ckpt_store_dir,
                                              chunk_bytes=self.cfg.ckpt_chunk_bytes,
                                              faults=self.engine.runner.faults)
        # Tracks every configured model (COLD/WARMING/ACTIVE/DRAINING_IDLE,
        # PINNED), activates lazy ones on demand, scales idle ones to zero
        # and keeps the HBM and host budgets, LRU first.
        self.lifecycle = LifecycleManager(self, self.cfg).start()
        self.metrics.lifecycle = self.lifecycle
        # The per-tenant reaper (idle detach, the budget's shed); idle with
        # no adapter configured.
        self.adapters.start()
        # The autoscaler's actuators are the single-flight paths demand
        # uses, so a pre-warm and a cold request never race two builds; the
        # reapers consult its learned windows, their fixed timers the
        # fallback.
        self.autoscale.bind(
            activate_fn=self._autoscale_activate, attach_fn=self._autoscale_attach,
            draft_of=self._spec_draft_name, residency_fn=self._autoscale_residency,
            estimate_warm_ms_fn=self._autoscale_estimate_ms,
            resident_bytes_fn=lambda: sum(self.engine.runner.resident_bytes().values()),
            faults=self.engine.runner.faults, model_names=[mc.name for mc in self.cfg.models])
        self.lifecycle.keepwarm_fn = self.autoscale.keepwarm_window_s
        self.adapters.keepwarm_fn = self.autoscale.keepwarm_window_s
        self.autoscale.start()
        self.metrics.generation = lambda: {n: s.gen_snapshot()
                                           for n, s in self.schedulers.items()}
        journal = None
        if self.cfg.journal_dir:
            # The durable job journal: start() below replays it, so an
            # acknowledged submit survives a kill -9.
            journal = JobJournal(self.cfg.journal_dir, fsync=self.cfg.journal_fsync)
        self.jobs = JobQueue(self._run_job, run_jobs=self._run_jobs,
                             batch_of=self._job_batch_of,
                             max_backlog=self.cfg.job_max_backlog,
                             keep_done=self.cfg.job_keep_done,
                             max_result_mb=self.cfg.job_max_result_mb,
                             result_ttl_s=self.cfg.job_result_ttl_s,
                             journal=journal, tracer=self.tracer).start()
        self.metrics.jobs = self.jobs
        if journal is not None:
            log_event(log, "durable jobs recovered", recovered=self.jobs.recovered_jobs,
                      restored_done=self.jobs.restored_done, replay_ms=self.jobs.replay_ms)
        if self.cfg.watchdog_interval_s > 0:
            self.watchdog = Watchdog(self, self.cfg.watchdog_interval_s,
                                     max_attempts=self.cfg.recover_max_attempts,
                                     backoff_s=self.cfg.recover_backoff_s).start()
            self.metrics.watchdog = self.watchdog
        # The perf plane's sources: lambdas that read the live engine and
        # lanes at each tick (a rebuild swaps them).  Its lag timer is armed
        # here, on the server's own loop.
        self.perf.runner_stats = lambda: self.engine.runner.stats
        self.perf.gen_snapshots = lambda: {
            n: {"tokens_emitted": s.tokens_emitted, "segment_rounds": s.segment_rounds}
            for n, s in self.schedulers.items()}
        self.perf.flops_hint = self._flops_hint
        self.perf.device_name = self._device_name
        self.perf.start(asyncio.get_running_loop())
        want = self.cfg.port if port is None else port
        self._server = await asyncio.start_server(self._handle_conn, host or self.cfg.host, want)
        bound = self._server.sockets[0].getsockname()[1]
        if self.cfg.ingest_workers > 0:
            from .acceptors import AcceptorSupervisor

            # Workers that cannot serve fail the boot, with the reason.
            self.acceptors = AcceptorSupervisor(self.cfg, pool=self.wire_pool)
            try:
                await self.acceptors.start(self, bound_port=bound if want else None)
            except Exception:
                self.acceptors = None
                await self.stop()
                raise
        return bound

    async def stop(self):
        if self.acceptors is not None:
            await self.acceptors.stop()
            self.acceptors = None
        self.perf.stop()
        if self._server is not None:
            self._server.close()
            for w in list(self._conns):
                w.close()
            # Handlers still streaming (or waiting on a generation) end now:
            # their streams are cancelled.
            for t in list(self._handlers):
                t.cancel()
            await asyncio.gather(*self._handlers, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None
        if self.watchdog is not None:
            await self.watchdog.stop()
        await self.autoscale.stop()
        if self.lifecycle is not None:
            await self.lifecycle.stop()
        await self.adapters.stop()
        await self._stop_lanes()
        if self.jobs is not None:
            await self.jobs.stop()
        if self._owns_engine:
            await asyncio.get_running_loop().run_in_executor(None, self.engine.shutdown)

    # -- connection loop ----------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        self._conns.add(writer)
        self._handlers.add(asyncio.current_task())
        try:
            while True:
                stamps: dict = {}
                try:
                    req = await _read_request(reader, stamps=stamps)
                except _HttpError as e:
                    status, obj, _ = _error(e.status, str(e))
                    writer.write(_encode(status, obj, {"X-Request-Id": new_request_id()},
                                         keep_alive=False))
                    await writer.drain()
                    break
                if req is None:
                    break
                t_read = time.perf_counter()
                method, path, query, version, headers, body = req
                keep = _keep_alive(version, headers)
                work = _is_work(method, path)
                # Every work request is traced from its first byte; other
                # routes echo (or mint) the request id only.
                ctx = self._open_ctx(headers, path, stamps["t_head"]) if work else None
                token = _request_ctx.set(ctx)
                stoken = _request_state.set({} if work else None)
                if ctx is not None:
                    _substage("payload_read", stamps["t_head"], t_read, bytes=len(body))
                    # The demand journal: every work arrival, served, shed
                    # or drained, is demand the forecaster should see.
                    self.autoscale.note_arrival(ctx.model)
                status = 500
                try:
                    if work and self.draining:
                        status, obj, extra = _error_retry(
                            503, "server is draining; retry against another replica",
                            self.cfg.drain_timeout_s or 1.0, draining=True)
                        writer.write(_encode(status, obj, {**extra, **ctx.headers()}, keep))
                        await writer.drain()
                        continue
                    # Work in flight, what a drain waits for, until its
                    # response (a stream's last event included) is written.
                    self._inflight += int(work)
                    try:
                        status, obj, extra = await self._dispatch(method, path, headers, body,
                                                                  reader, query)
                        ids = (ctx.headers() if ctx is not None else
                               {"X-Request-Id": headers.get("x-request-id") or new_request_id()})
                        extra = {**ids, **extra}
                        if isinstance(obj, EventStream):
                            keep = await self._write_stream(writer, reader, status, obj, extra,
                                                            keep)
                        else:
                            t_enc = time.perf_counter()
                            data = _encode(status, obj, extra, keep)
                            st = _rstate()
                            if st.get("serialize_at_write"):
                                # A JSON answer's encode is its serialize stage.
                                _substage("serialize", t_enc, time.perf_counter())
                            writer.write(data)
                            await writer.drain()
                            if "t_done" in st:
                                # respond: the device's end → the answer written.
                                t_sent = time.perf_counter()
                                if st.get("respond_span") is not None:
                                    st["respond_span"].end(end=t_sent)
                                self.perf.note_stage(ctx.model, "respond",
                                                     (t_sent - st["t_done"]) * 1000.0)
                    finally:
                        self._inflight -= int(work)
                finally:
                    if ctx is not None:
                        rsp = _rstate().get("respond_span")
                        if rsp is not None:
                            rsp.end()  # a write that failed
                        # Before close: close turns the root to error for
                        # every 4xx, and a client's mistake must not count.
                        self._observe_slo(ctx, status)
                    _request_state.reset(stoken)
                    _request_ctx.reset(token)
                    if ctx is not None:
                        ctx.close(status)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass  # client went away or sent an over-long line
        finally:
            self._conns.discard(writer)
            self._handlers.discard(asyncio.current_task())
            writer.close()

    def _observe_slo(self, ctx: _ReqCtx, status: int) -> None:
        """The SLO plane's one classification point: every work request
        leaves through here once its answer (a stream's last event
        included) is written, on every shed, degrade and error path.  A
        stream that fails after its 200 counts as an error by its root
        span's status.  The tenant's arrival feeds the per-tenant demand
        model here too (the adapter is known only after admission).
        Accounting never fails a request."""
        try:
            st = _rstate()
            sel = st.get("selection")
            model = sel.variant if sel is not None and sel.variant else ctx.model
            if model is None:
                return
            arec = st.get("adapter")
            if arec is not None:
                self.autoscale.note_arrival(model, adapter=arec.name)
            wall_ms = (time.perf_counter() - ctx.span.t0) * 1000.0
            self.slo.observe(model, ctx.kind, status, wall_ms,
                             degraded=bool(sel is not None and sel.degraded),
                             adapter=arec.name if arec is not None else None,
                             errored=ctx.span.status == "error")
        except Exception:
            log.exception("slo observation failed")

    def _open_ctx(self, headers: dict[str, str], path: str, start: float) -> _ReqCtx:
        kind = next((k for suffix, k in _KINDS if path.endswith(suffix)), "predict")
        m = re.match(r"^/v1/models/([^:/]+):", path)
        model = m.group(1) if m else self.default_model
        return _ReqCtx(self, headers, kind, model, path, start)

    def note_binary_request(self, model: str | None) -> None:
        """One binary-lane request decoded (event loop only): the counter
        behind ``tpuserve_binary_lane_requests_total``."""
        key = model or ""
        self.binary_requests[key] = self.binary_requests.get(key, 0) + 1

    def _payload(self, body: bytes, headers: dict[str, str],
                 extract: dict[str, Any] | None = None) -> Any:
        """The request's payload by its lane.  The Content-Type decides: an
        ``application/x-tpuserve-tensor`` body is a frame (unpacked to
        read-only views over the body; several blocks, or ``FLAG_LIST``,
        become ``{"instances": [...]}``), never sniffed as JSON; anything
        else goes through :func:`_decode_body`.  Raises
        :class:`wire.FrameError` (400; :class:`wire.FrameTooLarge` 413) or
        :class:`_BinaryLaneDisabled` (415), for :func:`_payload_error`.  A
        body the variant resolver already decoded is answered from its
        stash, with the fields it popped (but ``objective``, the
        resolver's)."""
        st = _rstate()
        if "payload" in st:
            if extract is not None:
                for k in extract:
                    if k != "objective" and st["extract"].get(k) is not None:
                        extract[k] = st["extract"][k]
            return st["payload"]
        if _content_type(headers) != wire.TENSOR_CONTENT_TYPE:
            return _decode_body(body, headers, extract)
        if not self.cfg.binary_lane:
            raise _BinaryLaneDisabled("the binary tensor lane is disabled on this server "
                                      "(ServeConfig.binary_lane=false); send JSON or raw bodies")
        ctx = _request_ctx.get()
        t0 = time.perf_counter()
        items, flags = wire.unpack(body, max_bytes=self.cfg.tensor_max_bytes or MAX_BODY_BYTES)
        if flags & wire.FLAG_META:
            raise wire.FrameError("FLAG_META frames are response-only")
        if ctx is not None:
            ctx.binary = True
            _substage("binary_decode", t0, time.perf_counter(), blocks=len(items))
            self.note_binary_request(ctx.model)
        if flags & wire.FLAG_LIST or len(items) > 1:
            return {"instances": items}
        return items[0]

    async def _write_stream(self, writer: asyncio.StreamWriter, reader, status: int,
                            stream: EventStream, headers: dict[str, str], keep: bool) -> bool:
        """Write an event stream: the head, one chunk an event as it comes,
        the last chunk.  A client that goes away (EOF on its side, or a
        failed write) cancels the stream and ends the connection; returns
        whether the connection stays open."""
        ctx = _request_ctx.get()
        model = ctx.model if ctx is not None else None
        perf = self.perf
        try:
            writer.write(_sse_head(status, headers, keep))
            await writer.drain()
            async for obj in stream.events(reader):
                if obj is _GONE:
                    stream.cancel()
                    return False
                # Per event, histograms only (a span a token would spend
                # the trace's span budget): serialize is the encode,
                # respond the socket write.
                t0 = time.perf_counter()
                chunk = _sse_chunk(obj)
                t1 = time.perf_counter()
                writer.write(chunk)
                await writer.drain()
                perf.note_stage(model, "serialize", (t1 - t0) * 1000.0)
                perf.note_stage(model, "respond", (time.perf_counter() - t1) * 1000.0)
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return keep
        except (ConnectionError, asyncio.CancelledError):
            stream.cancel()
            raise

    async def _dispatch(self, method: str, path: str, headers: dict[str, str],
                        body: bytes, reader: asyncio.StreamReader | None = None,
                        query: str = "") -> Response:
        for pattern, methods, tail in (
                (_PREDICT, {"POST": self._predict}, ()),
                (_SUBMIT, {"POST": self.handle_submit}, ()),
                (_GENERATE, {"POST": self.handle_generate}, (reader,)),
                (_JOB, {"GET": self.handle_job}, ()),
                (_ADMIN_MODEL, {"GET": self.handle_admin_model_get,
                                "POST": self.handle_admin_model_post}, ()),
                (_ADMIN_TRACE, {"GET": self.handle_trace_get}, ()),
                (_STREAM_EXPORT, {"POST": self.handle_stream_export}, ()),
                (_STREAM_IMPORT, {"POST": self.handle_stream_import}, ()),
                (_STREAM_ATTACH, {"GET": self.handle_stream_attach}, (reader, query)),
                (_ADMIN_ADAPTER, {"POST": self.handle_admin_adapter_post}, ())):
            m = pattern.match(path)
            if m is not None:
                args = (*m.groups(), body, headers, *tail)
                break
        else:
            methods = self._routes.get(path)
            if methods is None:
                return _error(404, f"no route {path}")
            args = (body, headers, query)
        if method not in methods:
            return _error(405, f"{path} takes {' or '.join(methods)}")
        handler = methods[method]
        try:
            return await handler(*args)
        except ConnectionError:
            raise  # the client is gone: _handle_conn ends the connection
        except Exception as e:
            log.exception("handler failed for %s %s", method, path)
            return _error(500, f"internal error: {type(e).__name__}")

    # -- handlers -----------------------------------------------------------
    async def handle_root(self, body: bytes, headers=None, query: str = "") -> Response:
        out = {"status": "ok", "framework": "pytorch-zappa-serverless-tpu-torch",
               "profile": self.cfg.profile, "models": sorted(self.engine.models)}
        adapters = {mc.name: self.adapters.names_for(mc.name) for mc in self.cfg.models
                    if self.adapters.names_for(mc.name)}
        if adapters:
            out["adapters"] = adapters
        return 200, out, {}

    async def handle_models(self, body: bytes, headers=None, query: str = "") -> Response:
        """Every configured model: a resident one's buckets and endpoints,
        and each one's residency."""
        models = {}
        residency = self._registered_models()
        for mc in self.cfg.models:
            if mc.name not in self.engine.models:
                models[mc.name] = {"dtype": mc.dtype,
                                   "checkpoint": mc.checkpoint or "random-init"}
        for name, cm in self.engine.models.items():
            is_async = bool(cm.servable.meta.get("async_only"))
            models[name] = {
                "buckets": [list(b) for b in cm.buckets],
                "buckets_compiled": len(cm.warmed_buckets),
                "dtype": cm.cfg.dtype,
                "async_only": is_async,
                "endpoint": f"/v1/models/{name}:{'submit' if is_async else 'predict'}",
                "checkpoint": cm.cfg.checkpoint or "random-init",
            }
            if name in self.schedulers:
                models[name]["generate"] = f"/v1/models/{name}:generate"
        for name in models:
            models[name]["residency"] = residency.get(name, "active")
            if self.adapters.names_for(name):
                # Each tenant's adapter with its residency.
                models[name]["adapters"] = self.adapters.residency_of(name)
        return 200, {"models": models}, {}

    def _probe(self) -> bool:
        """The shared device probe of the live engine (blocking: run it in
        an executor)."""
        return self.engine.runner.probe(self.cfg.dispatch_probe_timeout_s)

    async def handle_healthz(self, body: bytes, headers=None, query: str = "") -> Response:
        alive = await asyncio.get_running_loop().run_in_executor(None, self._probe)
        gen_fatal = {n: s.fatal for n, s in self.schedulers.items() if s.fatal}
        quarantined = sorted(self.resilience.quarantined)
        ok = alive and not gen_fatal and not self.draining and not quarantined
        return (200 if ok else 503), {
            "device_ok": alive,
            "generation_ok": not gen_fatal,
            # Draining and a recovery in progress flip health too, so a load
            # balancer stops routing here.
            "draining": self.draining,
            "quarantined": quarantined,
            **({"recovery": self.watchdog.snapshot()} if self.watchdog is not None else {}),
            "generation": {n: {"active": s.active, "pending": s.depth,
                               **({"fatal": s.fatal} if s.fatal else {})}
                           for n, s in self.schedulers.items()},
            "models": {name: {"buckets_compiled": len(cm.warmed_buckets),
                              "buckets_total": len(cm.buckets)}
                       for name, cm in self.engine.models.items()},
            "queue_depths": {n: b.queue_depth for n, b in self.batchers.items()},
            # Per-model queue-wait forecast (ms), the admission shedder's signal.
            "forecast": self.resilience.queue_forecast(self.batchers),
            "jobs_backlog": self.jobs.depth if self.jobs else 0,
            "jobs_backlog_by_model": self.jobs.depths if self.jobs else {},
            # The journal's replay at boot (absent with durability off).
            **({"durability": d} if self.jobs is not None
               and (d := self.jobs.durability_snapshot()) is not None else {}),
            # A cold model is not a health problem: it activates on demand.
            "residency": self._registered_models(),
            # Burn-rate state: the alarmed keys and the worst burn of each
            # window.  An alarm is evidence, not ill health: no flip.
            "slo": self.slo.health_summary(),
        }, {}

    async def handle_metrics(self, body: bytes, headers=None, query: str = "") -> Response:
        """JSON, or Prometheus text under ``?format=prometheus`` or an
        ``Accept: text/plain`` that does not also take JSON."""
        accept = (headers or {}).get("accept", "")
        if (parse_qs(query).get("format") == ["prometheus"]
                or ("text/plain" in accept and "application/json" not in accept)):
            return 200, self.metrics.render_prometheus(self.engine), {}
        out = self.metrics.render(self.engine)
        if self.jobs is not None:
            out["jobs"] = {"backlog": self.jobs.depth, "active": self.jobs.active,
                           "backlog_by_model": self.jobs.depths}
        return 200, out, {}

    # -- admin: request tracing and device profiles ---------------------------
    async def handle_trace_list(self, body: bytes, headers=None, query: str = "") -> Response:
        """``GET /admin/trace``: trace summaries, newest first, filtered by
        ``model``, ``status`` (ok|error|open), ``min_ms`` and ``limit``
        (default 50), with the flight recorder's pins and the tracer's
        counters."""
        q = {k: v[-1] for k, v in parse_qs(query).items()}
        try:
            min_ms = float(q.get("min_ms", 0.0))
            limit = int(q.get("limit", 50))
        except (TypeError, ValueError):
            return _error(400, "min_ms must be a number, limit an integer")
        return 200, {"traces": self.tracer.list(model=q.get("model"), status=q.get("status"),
                                                min_ms=min_ms, limit=limit),
                     "pinned": self.tracer.pinned(), **self.tracer.snapshot()}, {}

    async def handle_trace_get(self, trace_id: str, body: bytes,
                               headers: dict[str, str]) -> Response:
        """``GET /admin/trace/{id}``: one trace's span tree (404 once the
        ring and the flight recorder have both let it go)."""
        trace = self.tracer.get(trace_id)
        if trace is None:
            return _error(404, "unknown trace id (evicted from the ring, or never traced); "
                               "see GET /admin/trace")
        return 200, {"trace": trace.tree()}, {}

    @staticmethod
    def _capture_args(body: bytes) -> tuple[float, int]:
        """``seconds`` and ``top`` of a capture request; :class:`_Refused`
        with the 400 otherwise."""
        try:
            req = json.loads(body) if body else {}
        except ValueError:
            req = None
        if not isinstance(req, dict):
            raise _Refused(_error(400, "body must be a JSON object"))
        try:
            seconds = float(req.get("seconds", 2.0))
            top = int(req.get("top", 15))
        except (TypeError, ValueError):
            raise _Refused(_error(400, "seconds must be a number, top an integer")) from None
        if not 0.05 <= seconds <= 60.0:  # NaN fails too
            raise _Refused(_error(400, "seconds must be in [0.05, 60]"))
        return seconds, top

    async def _capture(self, seconds: float, prefix: str):
        """A ``torch.profiler`` window of ``seconds`` over live traffic:
        ``(capture, dir)`` with ``dir`` new under ``trace_dir``, or
        :class:`_Refused` with 409 while another capture runs (one profiler
        a process) or 500 if the profiler did not start.  The profiler
        starts and stops on the dispatch thread: a CUDA graph capture (a
        restore, a lazy bucket) refuses other threads' CUDA calls and may
        run there at any time."""
        from ..utils import xplane

        if self._tracing or xplane.busy():
            raise _Refused(_error(409, "a trace capture is already running"))
        out_dir = (Path(self.cfg.trace_dir).expanduser()
                   / f"{prefix}{time.strftime('%Y%m%d-%H%M%S')}-{uuid.uuid4().hex[:6]}")
        self._tracing = True
        runner = self.engine.runner
        cap = xplane.Capture(cuda=self.engine.device.type == "cuda")
        try:
            out_dir.mkdir(parents=True, exist_ok=True)
            try:
                await runner.run_fn(cap.start)
            except xplane.ProfilerBusy as e:
                raise _Refused(_error(409, str(e))) from None
            except Exception as e:
                log.exception("profiler failed to start")
                raise _Refused(_error(500, f"the profiler failed to start: "
                                           f"{type(e).__name__}: {e}")) from None
            try:
                await asyncio.sleep(seconds)
            finally:
                # Stopped even when the client goes away mid-window, and on a
                # runner poisoned meanwhile (run_fn_sync skips the latch but
                # still runs on the dispatch thread).
                try:
                    await runner.run_fn(cap.stop)
                except Exception:
                    await asyncio.get_running_loop().run_in_executor(
                        None, runner.run_fn_sync, cap.stop)
        finally:
            self._tracing = False
        return cap, out_dir

    async def handle_profile(self, body: bytes, headers=None, query: str = "") -> Response:
        """``POST /admin/profile {"seconds": 2, "top": 15}``: a timed
        ``torch.profiler`` capture of live traffic and its device ops by
        time (``utils/xplane.py``: compute ops, with copies and memsets
        apart), in one call.  409 while a capture runs, 400 outside
        ``seconds`` ∈ [0.05, 60]; a window that recorded no op answers 500,
        never an empty list as a success."""
        from ..utils import xplane

        try:
            seconds, top = self._capture_args(body)
            cap, out_dir = await self._capture(seconds, "profile-")
        except _Refused as r:
            return r.response
        loop = asyncio.get_running_loop()
        breakdown = await loop.run_in_executor(None, xplane.top_ops, cap.prof, top)
        if not breakdown["ops"]:
            return _error(500, f"the {seconds:g} s capture recorded no op (no device work "
                               "ran in the window, or the profiler saw none)", dir=str(out_dir))
        log_event(log, "profile captured", dir=str(out_dir), seconds=seconds,
                  ops=len(breakdown["ops"]))
        return 200, {"dir": str(out_dir), "seconds": seconds, **breakdown}, {}

    async def handle_debug_trace(self, body: bytes, headers=None, query: str = "") -> Response:
        """``POST /debug/trace {"seconds": 2}``: a ``torch.profiler`` capture
        of live traffic written as a Chrome trace (chrome://tracing or
        Perfetto) under ``trace_dir``; the same 400 and 409 as
        ``/admin/profile``."""
        try:
            seconds, _ = self._capture_args(body)
            cap, out_dir = await self._capture(seconds, "")
        except _Refused as r:
            return r.response
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, cap.export_chrome_trace, str(out_dir / "trace.json"))
        files = sorted(str(p.relative_to(out_dir)) for p in out_dir.rglob("*") if p.is_file())
        log_event(log, "trace captured", dir=str(out_dir), seconds=seconds, files=len(files))
        return 200, {"dir": str(out_dir), "seconds": seconds, "files": files}, {}

    async def handle_predict_default(self, body: bytes, headers=None,
                                     query: str = "") -> Response:
        if self.default_model is None:
            return _error_retry(503, "no models configured", 30.0)
        return await self._predict(self.default_model, body, headers or {})

    def _registered_models(self) -> dict[str, str]:
        """Every model this deployment knows → its residency state (what an
        unknown model's 404 teaches the caller)."""
        out = {mc.name: "active" for mc in self.cfg.models}
        for name in self.engine.models:
            out.setdefault(name, "active")
        if self.lifecycle is not None:
            for name in out:
                out[name] = self.lifecycle.state_of(name) or out[name]
        return dict(sorted(out.items()))

    def _unknown_model(self, name: str) -> Response:
        """404 naming every model with its residency, and each family's
        ladder (rank and residency, best first): how to address it without
        a deploy name."""
        models = self._registered_models()
        reg = self.variants.registry
        families = {fam: [{"variant": mc.name, "quality_rank": mc.quality_rank,
                           "residency": models.get(mc.name, "cold")} for mc in reg.ladder(fam)]
                    for fam in reg.families()}
        return _error(404, f"model {name!r} not served; available: {sorted(models)}",
                      models=models, families=families)

    async def _residency_gate(self, name: str, headers: dict[str, str]) -> Response | None:
        """Cold admission for a model that is not resident: None once it is
        ACTIVE, else the response.  Only the header's (or the model's)
        deadline counts: the body is not decoded for a model that may
        answer 503 ``cold_start``.  A deadline that covers the activation's
        estimate waits for it; a shorter one answers 503 + Retry-After
        while the activation goes on."""
        lc = self.lifecycle
        if lc is None or not lc.knows(name):
            return self._unknown_model(name)
        try:
            deadline_ms = self._deadline_ms(headers, None, self.cfg.model(name))
        except (ValueError, KeyError) as e:
            return _error(400, str(e))
        ctx = _request_ctx.get()
        t0 = time.perf_counter()
        try:
            await lc.ensure_active(name, deadline_ms=deadline_ms, cause="request")
            waited_ms = (time.perf_counter() - t0) * 1000.0
            if ctx is not None and waited_ms >= 1.0:
                # The request waited for the model's activation: a cold
                # arrival, where a pre-warm would have left none.
                ctx.span.point("activation_wait", waited_ms=round(waited_ms, 1))
        except ColdStart as e:
            if ctx is not None:
                ctx.span.point("cold_start", estimated_warm_ms=round(e.estimated_warm_ms, 1))
            return _error_retry(503, str(e), e.retry_after_s, cold_start=True,
                                estimated_warm_ms=round(e.estimated_warm_ms, 1))
        except Exception as e:
            log.exception("activation failed for %s", name)
            return _error_retry(503, f"model {name!r} activation failed: {type(e).__name__}: "
                                     f"{e}", self.cfg.recover_backoff_s or 1.0,
                                activation_failed=True)
        return None

    def _overloaded(self, e: Overloaded, batcher: DynamicBatcher) -> Response:
        extra: dict[str, Any] = {"queue_depth": batcher.queue_depth,
                                 "in_flight": batcher.in_flight}
        retry_s = self._family_floor(e.retry_after_s, extra, wait="set")
        return _error_retry(429, str(e), retry_s, **extra)

    def _unavailable(self, name: str) -> Response | None:
        """503 + Retry-After for a quarantined model or an open breaker,
        before any decode work: while the circuit is open a sick model costs
        its callers no dispatch-lane time and the other models keep serving."""
        if name in self.resilience.quarantined:
            extra: dict[str, Any] = {"quarantined": True}
            retry_s = self._family_floor(self.cfg.recover_backoff_s or 1.0, extra)
            return _error_retry(503, f"model {name!r} is quarantined while the engine "
                                     "recovers", retry_s, **extra)
        mr = self.resilience.model(name)
        if mr.breaker is not None and not mr.breaker.allow():
            mr.stats.breaker_fast_fails += 1
            extra = {"breaker": mr.breaker.state}
            retry_s = self._family_floor(mr.breaker.retry_after_s(), extra)
            return _error_retry(503, f"model {name!r} circuit breaker is {mr.breaker.state} "
                                     f"(recent error rate {mr.breaker.error_rate():.0%}); "
                                     "failing fast", retry_s, **extra)
        return None

    def _family_floor(self, retry_s: float, extra: dict, wait: str = "") -> float:
        """A shed of a family member: its Retry-After capped by the family's
        minimum (a sibling may serve sooner), ``family`` in ``extra``, and
        with ``wait`` the family's minimum queue wait as
        ``estimated_wait_ms`` ("set") or the smaller of it and the one in
        ``extra`` ("min").  A request with no multi-variant family keeps
        ``retry_s``."""
        fam = _rstate().get("family")
        if fam is None:
            return retry_s
        floor_s, floor_ms = self.variants.family_floor(self, fam)
        extra["family"] = fam
        if wait and floor_ms is not None:
            extra["estimated_wait_ms"] = (min(extra["estimated_wait_ms"], floor_ms)
                                          if wait == "min" else floor_ms)
        return min(retry_s, floor_s)

    def _resolve_variant(self, name: str, body: bytes,
                         headers: dict[str, str]) -> tuple[str, Response | None]:
        """Family-addressed admission: (the deploy to serve, or an error).

        A request is family-addressed when its name is a family that is not
        itself a deploy, or when it states an objective in the
        ``X-Objective-*`` headers (a body objective rides a family name).
        Any other request passes as it is; a deploy of a multi-variant
        family remembers the family for the shed minima.  A family request
        has its body decoded here (it may carry the objective; the later
        steps read the stash), its objective parsed, its bound computed
        once, and the selection run (evidence, brownout, select), with a
        ``variant_select`` point on its trace.  No satisfying variant sheds
        with the family's minimum evidence: 503 when every rung is blocked,
        else 429."""
        reg = self.variants.registry
        st = _rstate()
        family_only = reg.is_family(name) and not reg.is_model(name)
        if not family_only and not any(h.lower() in headers for h in _OBJECTIVE_HEADERS):
            fam = reg.family_of(name)
            if fam is not None and len(reg.ladder(fam)) > 1:
                st["family"] = fam
            return name, None
        fam = name if family_only else reg.family_of(name)
        if fam is None:
            return name, self._unknown_model(name)
        extract = {"objective": None, "idempotency_key": None,
                   **(self._adapter_extract() or {})}
        try:
            payload = self._payload(body, headers, extract)
        except (ValueError, TypeError, UnicodeDecodeError, _BinaryLaneDisabled) as e:
            return name, _payload_error(e)
        st["payload"], st["extract"] = payload, extract
        try:
            objective = Objective.parse(_objective_headers(headers), extract["objective"])
        except ValueError as e:
            return name, _error(400, str(e))
        if objective.max_latency_ms is not None:
            st["objective_ms"] = objective.max_latency_ms
        try:
            deadline_ms = self._deadline_ms(headers, payload, reg.ladder(fam)[0])
        except ValueError as e:
            return name, _error(400, str(e))
        st["deadline_ms"] = deadline_ms
        bounds = [b for b in (objective.max_latency_ms, deadline_ms) if b is not None and b > 0]
        sel = self.variants.resolve(self, fam, objective, min(bounds) if bounds else None)
        ctx = _request_ctx.get()
        if ctx is not None:
            ctx.span.point("variant_select", family=fam, variant=sel.variant,
                           degraded=sel.degraded, brownout=sel.brownout,
                           **({"shed": sel.shed_reason} if sel.shed_reason else {}),
                           candidates=sel.candidates)
        if sel.variant is None:
            extra: dict[str, Any] = {"family": fam, "variant_shed": sel.shed_reason,
                                     "candidates": sel.candidates}
            if sel.estimated_wait_ms is not None:
                extra["estimated_wait_ms"] = sel.estimated_wait_ms
            if sel.estimated_warm_ms is not None:
                extra["estimated_warm_ms"] = sel.estimated_warm_ms
            return name, _error_retry(503 if sel.shed_reason == "all_blocked" else 429,
                                      f"no variant of family {fam!r} satisfies the objective "
                                      f"({sel.shed_reason}); shedding", sel.retry_after_s,
                                      **extra)
        st["selection"], st["family"] = sel, fam
        if ctx is not None:
            ctx.span.annotate(variant=sel.variant, family=fam)
        return sel.variant, None

    @staticmethod
    def _served_variant(name: str, heads: dict[str, str], out: dict | None = None) -> None:
        """A family request's served-variant evidence: ``X-Served-Variant``
        (and ``X-Degraded: 1`` below the ladder's top), and in ``out`` the
        family and whether the serve was degraded."""
        sel = _rstate().get("selection")
        if sel is None:
            return
        heads["X-Served-Variant"] = name
        if sel.degraded:
            heads["X-Degraded"] = "1"
        if out is not None:
            out["family"] = sel.family
            out["degraded"] = sel.degraded

    def _deadline_ms(self, headers: dict[str, str], payload: Any, mc) -> float | None:
        """The request's deadline in ms, or None: the client's (the
        ``X-Deadline-Ms`` header, else the body's top-level ``deadline_ms``,
        popped so preprocess never sees it) capped by ``deadline_max_ms``;
        else the model's ``deadline_ms``, else ``deadline_default_ms``.  A
        client value <= 0 is returned as it is, for the admission check to
        504.  A family request's objective ``max_latency_ms`` stands in for
        a client deadline (an overrun answers 504 rather than break the
        objective), and its bound, computed once by the variant resolver,
        is the one every later step reads.  ValueError on junk."""
        st = _rstate()
        if "deadline_ms" in st:
            return st["deadline_ms"]
        raw = headers.get("x-deadline-ms")
        if raw is None and isinstance(payload, dict):
            raw = payload.pop("deadline_ms", None)
        if raw is None:
            raw = st.get("objective_ms")
        if raw is not None:
            try:
                ms = float(raw)
            except (TypeError, ValueError):
                raise ValueError("deadline_ms must be a number (milliseconds)") from None
            if math.isnan(ms):
                raise ValueError("deadline_ms must be a number (milliseconds)")
            if self.cfg.deadline_max_ms > 0:
                ms = min(ms, self.cfg.deadline_max_ms)
            return ms
        default = mc.deadline_ms or self.cfg.deadline_default_ms
        return default if default > 0 else None

    def _preprocess(self, cm, payload):
        """The chaos hook, then the servable's preprocess: an injected fault
        fails this request as a malformed payload would."""
        self.engine.runner.faults.on_preprocess(cm.servable.name)
        return cm.servable.preprocess(payload)

    # -- multi-tenant adapter admission --------------------------------------
    def _adapter_extract(self) -> dict[str, Any] | None:
        """The body fields a decode pops for adapter routing (None: no
        adapter is configured, the body goes to preprocess as it is)."""
        return {"adapter": None} if self.adapters.enabled else None

    def _unknown_adapter(self, base: str, requested: str) -> Response:
        """404 naming the base's adapters, each with its residency and
        tenants."""
        ladder = self.adapters.base_snapshot(base)
        adapters = {a: {"residency": s["state"], "tenants": s["tenants"]}
                    for a, s in sorted(ladder.items())}
        return _error(404, f"adapter {requested!r} not served on model {base!r}; available: "
                           f"{sorted(adapters)}", model=base, adapters=adapters)

    def _adapter_of(self, name: str, headers: dict[str, str], payload: Any,
                    extract: dict[str, Any] | None):
        """Tenant to adapter: (record | None, error | None).  The
        ``X-Adapter`` header wins, then the body's top-level ``adapter``,
        then ``X-Tenant`` against the registry."""
        mgr = self.adapters
        if not mgr.enabled:
            return None, None
        aname = headers.get("x-adapter")
        if aname is None and extract is not None and extract.get("adapter") is not None:
            aname = str(extract["adapter"])
        if aname is None and isinstance(payload, dict) and "adapter" in payload:
            aname = str(payload.pop("adapter"))
        tenant = headers.get("x-tenant")
        if aname is None and not tenant:
            return None, None
        try:
            rec = mgr.resolve(name, aname, tenant)
        except UnknownAdapter as e:
            return None, self._unknown_adapter(name, e.args[0])
        ctx = _request_ctx.get()
        if rec is not None and ctx is not None:
            ctx.span.annotate(adapter=rec.name)
        return rec, None

    async def _adapter_gate(self, name: str, rec, deadline_ms: float | None) -> Response | None:
        """Cold admission for one tenant's adapter: None once attached
        (``rec.slot`` valid), else the response.  The model's residency gate
        one level down: a deadline below the learned attach estimate answers
        503 ``adapter_cold`` + Retry-After while the attach goes on."""
        ctx = _request_ctx.get()
        t0 = time.perf_counter()
        try:
            await self.adapters.ensure_attached(name, rec.name, deadline_ms=deadline_ms,
                                                cause="request")
            waited_ms = (time.perf_counter() - t0) * 1000.0
            if ctx is not None and waited_ms >= 1.0:
                ctx.span.point("adapter_attach", adapter=rec.name, waited_ms=round(waited_ms, 1))
        except AdapterCold as e:
            if ctx is not None:
                ctx.span.point("adapter_cold", adapter=rec.name,
                               estimated_attach_ms=round(e.estimated_attach_ms, 1))
            return _error_retry(503, str(e), e.retry_after_s, adapter_cold=True,
                                adapter=rec.name,
                                estimated_attach_ms=round(e.estimated_attach_ms, 1))
        except Exception as e:
            log.exception("adapter attach failed for %s:%s", name, rec.name)
            return _error_retry(503, f"adapter {rec.name!r} attach failed: {type(e).__name__}: "
                                     f"{e}", self.cfg.recover_backoff_s or 1.0,
                                adapter_attach_failed=True, adapter=rec.name)
        return None

    @staticmethod
    def _stamp_adapter(samples, rec) -> None:
        """Route preprocessed samples through the tenant's slot (the row's
        gather index) and name the tenant for the batcher's evidence."""
        for s in samples:
            if isinstance(s, dict):
                s["adapter_idx"] = np.int32(rec.slot)
                s["_adapter"] = rec.name

    def _adapter_served(self, name: str, rec, heads: dict[str, str], timing=None) -> None:
        """The served tenant's evidence: ``X-Adapter``, its served count,
        and its own latency ring ``{model}:{adapter}``."""
        heads["X-Adapter"] = rec.name
        self.adapters.note_served(rec)
        if timing is not None:
            self.metrics.ring(f"{name}:{rec.name}").record(
                timing["queue_ms"], timing["device_ms"], timing["total_ms"])

    @staticmethod
    def _job_adapter_split(payload):
        """(adapter name | None, inner payload): the :submit wrapper that
        keys a durable job by (model, adapter)."""
        if isinstance(payload, dict) and "_adapter" in payload and "payload" in payload:
            return str(payload["_adapter"]), payload["payload"]
        return None, payload

    async def _predict(self, name: str, body: bytes, headers: dict[str, str]) -> Response:
        with _request_scope():
            name, refused = self._resolve_variant(name, body, headers)
            if refused is not None:
                return refused
            return await self._predict_resident(name, body, headers)

    async def _predict_resident(self, name: str, body: bytes,
                                headers: dict[str, str]) -> Response:
        if name not in self.engine.models:
            refused = await self._residency_gate(name, headers)
            if refused is not None:
                return refused
        # The in-flight window: no demotion while the request is here.
        lc = self.lifecycle
        if lc is not None:
            lc.enter(name)
        try:
            return await self._predict_admitted(name, body, headers)
        finally:
            if lc is not None:
                lc.exit(name)

    async def _predict_admitted(self, name: str, body: bytes,
                                headers: dict[str, str]) -> Response:
        cm = self.engine.models.get(name)
        if cm is not None and cm.servable.meta.get("async_only"):
            # Multi-second programs (SD-1.5's denoise loop) must not occupy
            # the latency-sensitive batcher lane; route them through jobs.
            return _error(405, f"model {name!r} is async-only; use "
                               f"POST /v1/models/{name}:submit and poll /v1/jobs/{{id}}")
        batcher = self.batchers.get(name)
        if batcher is None:
            return self._unknown_model(name)
        refused = self._unavailable(name)
        if refused is not None:
            return refused
        mr = self.resilience.model(name)
        ctx = _request_ctx.get()
        # The admission stage, anchored at the root's start, so that the
        # stage chain (admission → queue → device → respond) tiles the
        # request's wall time.
        adm = ctx.span.child("admission", start=ctx.span.t0) if ctx is not None else None
        extract = {"objective": None, **(self._adapter_extract() or {})}
        try:
            payload = self._payload(body, headers, extract)
        except (ValueError, TypeError, _BinaryLaneDisabled) as e:
            return _payload_error(e)
        t_val0 = time.perf_counter()
        if extract["objective"] is not None:
            # Selection happens at the family: an objective sent to a deploy
            # would be ignored in silence, so it is refused.
            return _objective_on_deploy(name)
        cm = batcher.model
        try:
            deadline_ms = self._deadline_ms(headers, payload, cm.cfg)
        except ValueError as e:
            return _error(400, str(e))
        loop = asyncio.get_running_loop()
        deadline = None
        if deadline_ms is not None:
            if deadline_ms <= 0:
                # The client's budget is already spent: never queue it.
                mr.stats.deadline_admission += 1
                return _error(504, f"deadline_ms={deadline_ms:g} already expired at "
                                   "admission", stage="admission")
            deadline = loop.time() + deadline_ms / 1000.0
        # Tenant resolution and the adapter's attach gate: the base is
        # resident, so a small slot write is all that can stand between this
        # request and its slot.
        arec, aerr = self._adapter_of(name, headers, payload, extract)
        if aerr is not None:
            return aerr
        if arec is not None:
            refused = await self._adapter_gate(name, arec, deadline_ms)
            if refused is not None:
                return refused
            _rstate()["adapter"] = arec
            # The slot cannot be detached or evicted while this request is in.
            self.adapters.enter(arec)
        try:
            instances = None
            if isinstance(payload, dict) and "instances" in payload:
                instances = payload["instances"]
                if not isinstance(instances, list) or not instances:
                    return _error(400, '"instances" must be a non-empty list')
                try:
                    batcher.check_capacity(len(instances))
                except Overloaded as e:
                    return self._overloaded(e, batcher)
                t_b64 = time.perf_counter()
                n_b64 = sum(1 for p in instances if isinstance(p, dict) and "b64" in p)
                try:
                    instances = [_unwrap_b64(p) for p in instances]
                except (ValueError, TypeError) as e:
                    return _error(400, f"bad instance: {type(e).__name__}: {e}")
                if n_b64:
                    _substage("b64_decode", t_b64, time.perf_counter(), instances=n_b64)
            if deadline_ms is not None:
                # Admission-time shedding: a queue-wait forecast past the
                # deadline is refused now (429) rather than queued to die a 504.
                est_ms = batcher.estimate_wait_ms(len(instances) if instances is not None else 1)
                if est_ms > deadline_ms:
                    mr.stats.shed_predicted += 1
                    extra: dict[str, Any] = {"estimated_wait_ms": round(est_ms, 1),
                                             "queue_depth": batcher.queue_depth}
                    retry_s = self._family_floor(est_ms / 1000.0, extra, wait="min")
                    return _error_retry(429, f"estimated queue wait {est_ms:.0f} ms exceeds "
                                             f"deadline {deadline_ms:.0f} ms; shedding",
                                        retry_s, **extra)
            meta = cm.servable.meta
            payloads = instances if instances is not None else [payload]
            ignored = meta.get("predict_ignores_sampling", ())
            knobs = sorted({k for p in payloads if isinstance(p, dict) for k in ignored if k in p})
            if knobs:
                return _error(400, f"model {name!r} ignores sampling knobs {knobs} on :predict "
                                   f"(greedy decode); send the request without them")
            # validate: from the decoded payload to preprocess (deadline,
            # tenant, instances and knob checks, the shed forecast).
            _substage("validate", t_val0, time.perf_counter())
            try:
                if meta.get("heavy_preprocess") or any(isinstance(p, bytes) for p in payloads):
                    # Image or audio decoding: off the event loop, the instances
                    # at once.  Other inputs preprocess inline.
                    per_input = await asyncio.gather(
                        *[loop.run_in_executor(None, self._preprocess, cm, p) for p in payloads])
                else:
                    per_input = [self._preprocess(cm, p) for p in payloads]
            except Exception as e:
                return _error(400, f"preprocess failed: {type(e).__name__}: {e}")
            # An input may preprocess to a list of samples: flatten for one
            # atomic admission, regroup after.
            widths = [len(s) if isinstance(s, list) else 1 for s in per_input]
            samples = [x for s in per_input for x in (s if isinstance(s, list) else [s])]
            if arec is not None:
                # The per-row slot that lets this request co-batch with other
                # tenants' rows.
                self._stamp_adapter(samples, arec)
                if adm is not None:
                    adm.point("adapter_gather", adapter=arec.name, slot=arec.slot)
            seq_of = meta.get("seq_len_of")
            seqs = [seq_of(s) if seq_of else None for s in samples]
            # The await is bounded by what is left of the deadline: a client
            # gone at T gets its 504 at T, not when the batch lands.
            remaining = max(deadline - loop.time(), 0.001) if deadline is not None else None
            span = ctx.span if ctx is not None else None
            if adm is not None:
                adm.end()
            try:
                if len(samples) == 1 and instances is None:
                    result, timing = await asyncio.wait_for(
                        batcher.submit(samples[0], seqs[0], deadline=deadline, span=span),
                        remaining)
                    t_done = timing.pop("t_done")
                else:
                    futs = batcher.submit_many(samples, seqs, deadline=deadline, span=span)
                    pairs = await asyncio.wait_for(asyncio.gather(*futs), remaining)
                    grouped, i = [], 0
                    for width in widths:
                        part = [r for r, _ in pairs[i: i + width]]
                        grouped.append(meta["merge_results"](part) if width > 1 else part[0])
                        i += width
                    result = grouped if instances is not None else grouped[0]
                    t_done = max(t.pop("t_done") for _, t in pairs)
                    timing = {k: max(t[k] for _, t in pairs)
                              for k in ("queue_ms", "device_ms", "total_ms", "batch_size")}
                    timing["samples"] = len(pairs)
            except Overloaded as e:
                return self._overloaded(e, batcher)
            except DeadlineExceeded as e:
                # Shed by the batcher before dispatch (counted there).
                return _error(504, str(e), stage=e.stage)
            except (asyncio.TimeoutError, TimeoutError):
                mr.stats.deadline_await += 1
                batcher.ring.record_error()
                return _error(504, f"deadline ({deadline_ms:g} ms) expired while awaiting the "
                                   "device", stage="await")
            except Exception as e:
                log.exception("predict failed for %s", name)
                return _error(500, f"inference failed: {type(e).__name__}")
            # The respond stage, stitched to the device's end: grouping and the
            # answer's encode.
            rsp = ctx.span.child("respond", start=t_done) if ctx is not None else None
            out_meta = {"model": name, "timing": timing}
            heads = {"X-Queue-Ms": str(timing["queue_ms"]), "X-Device-Ms": str(timing["device_ms"])}
            self._served_variant(name, heads, out_meta)
            answer: Any
            st = _rstate()
            st["t_done"] = t_done
            if (ctx is not None and ctx.binary
                    and "application/json" not in headers.get("accept", "")):
                # A binary answer: the meta block, then a block a prediction
                # (structured predictions as JSON blocks), in one frame.
                # ``Accept: application/json`` opts back into a JSON answer.
                preds = result if instances is not None else [result]
                t_ser = time.perf_counter()
                answer = RawBody(bytes(wire.pack_response(out_meta, preds,
                                                          list_frame=instances is not None)),
                                 wire.TENSOR_CONTENT_TYPE)
                _substage("serialize", t_ser, time.perf_counter())
            else:
                # Encoded (and its serialize stage stamped) at the write.
                answer = {**out_meta, "predictions": result}
                st["serialize_at_write"] = True
            # The respond span ends once the answer is written
            # (_handle_conn).
            st["respond_span"] = rsp
            if arec is not None:
                self._adapter_served(name, arec, heads, timing)
            # The usage ledger: the device time this request spent, billed
            # to its tenant.
            self.slo.usage.note_request(name, arec.name if arec is not None else None,
                                        timing["device_ms"])
            return 200, answer, heads
        finally:
            if arec is not None:
                self.adapters.exit(arec)

    # -- streaming generation -----------------------------------------------
    async def handle_generate(self, name: str, body: bytes, headers: dict[str, str],
                              reader: asyncio.StreamReader | None = None) -> Response:
        """Continuous-batching generation: ``{"text"|"input_ids": ...,
        "temperature", "seed", "top_k", "top_p", "max_new_tokens",
        "stream"}`` (Whisper: the audio bodies of ``:predict``).  The request
        joins its model's pool at once; ``stream`` (default true) answers
        ``text/event-stream``, else one JSON body once it is done."""
        with _request_scope():
            name, refused = self._resolve_variant(name, body, headers)
            if refused is not None:
                return refused
            return await self._generate_resident(name, body, headers, reader)

    async def _generate_resident(self, name: str, body: bytes, headers: dict[str, str],
                                 reader: asyncio.StreamReader | None) -> Response:
        sched = self.schedulers.get(name)
        if sched is None and name not in self.engine.models:
            # Not resident: activation starts the generation lane.
            refused = await self._residency_gate(name, headers)
            if refused is not None:
                return refused
            sched = self.schedulers.get(name)
        if sched is None:
            if name not in self.engine.models:
                return self._unknown_model(name)
            return _error(405, f"model {name!r} has no generation lane; use "
                               f"POST /v1/models/{name}:predict")
        lc = self.lifecycle
        if lc is not None:
            lc.enter(name)
        try:
            return await self._generate_admitted(name, sched, body, headers, reader)
        finally:
            if lc is not None:
                lc.exit(name)

    async def _generate_admitted(self, name: str, sched, body: bytes, headers: dict[str, str],
                                 reader: asyncio.StreamReader | None) -> Response:
        ctx = _request_ctx.get()
        adm = ctx.span.child("admission", start=ctx.span.t0) if ctx is not None else None
        extract = {"objective": None, **(self._adapter_extract() or {})}
        try:
            payload = self._payload(body, headers, extract)
        except (ValueError, TypeError, _BinaryLaneDisabled) as e:
            return _payload_error(e)
        if extract["objective"] is not None:
            return _objective_on_deploy(name)
        arec, aerr = self._adapter_of(name, headers, payload, extract)
        if aerr is not None:
            return aerr
        if arec is not None:
            if not isinstance(sched, PagedGenerationScheduler):
                # The slot pool's rows carry no adapter index: refuse rather
                # than serve the base.
                return _error(400, f"adapter-addressed generation requires kv_cache='paged' "
                                   f"on model {name!r}")
            try:
                deadline_ms = self._deadline_ms(headers, None, sched.cm.cfg)
            except ValueError as e:
                return _error(400, str(e))
            refused = await self._adapter_gate(name, arec, deadline_ms)
            if refused is not None:
                return refused
            _rstate()["adapter"] = arec
            # Held for the stream's life: its slot is not detached under it.
            self.adapters.enter(arec)
        try:
            resp = await self._generate_stream(name, sched, payload, headers, reader, ctx, adm,
                                               arec)
        except BaseException:
            if arec is not None:
                self.adapters.exit(arec)
            raise
        gen = resp[3] if len(resp) > 3 else None
        if arec is not None:
            if gen is None:
                self.adapters.exit(arec)
            else:
                gen.done.add_done_callback(lambda _f: self.adapters.exit(arec))
        return resp[:3]

    async def _generate_stream(self, name: str, sched, payload, headers: dict[str, str],
                               reader: asyncio.StreamReader | None, ctx, adm, arec):
        """The stream of an admitted ``:generate``: its response, and the
        GenRequest as a fourth item once the lane took it."""
        stream, max_new = True, None
        if isinstance(payload, dict):
            stream = bool(payload.get("stream", True))
            if "max_new_tokens" in payload:
                try:
                    max_new = int(payload["max_new_tokens"])
                except (TypeError, ValueError):
                    return _error(400, "max_new_tokens must be an integer")
            try:
                rep = float(payload.get("repetition_penalty", 1.0))
            except (TypeError, ValueError):
                return _error(400, "repetition_penalty must be a number")
            if rep != 1.0:
                return _error(400, "repetition_penalty is not supported on the streaming "
                                   f"lane; use POST /v1/models/{name}:predict (batch API)")
        try:
            if sched.cm.servable.meta.get("heavy_preprocess") or isinstance(payload, bytes):
                sample = await asyncio.get_running_loop().run_in_executor(
                    None, self._preprocess, sched.cm, payload)
            else:
                sample = self._preprocess(sched.cm, payload)
        except Exception as e:
            return _error(400, f"preprocess failed: {type(e).__name__}: {e}")
        if isinstance(sample, list):
            # Long audio's windows have no single token stream: that work
            # belongs to :predict's chunk-and-merge.
            return _error(400, "input fans out to multiple windows; use "
                               f"POST /v1/models/{name}:predict for long inputs")
        if arec is not None:
            # The stream's slot: the paged lane carries it a row, so tenants
            # co-decode in one program.
            sample["adapter_idx"] = np.int32(arec.slot)
            if adm is not None:
                adm.point("adapter_gather", adapter=arec.name, slot=arec.slot)
        try:
            gen = sched.submit(sample, max_new, span=ctx.span if ctx is not None else None)
        except KVPoolExhausted as e:
            extra: dict[str, Any] = {"kv_blocks_free": e.free_blocks,
                                     "kv_blocks_needed": e.needed_blocks,
                                     "estimated_wait_ms": round(e.retry_after_s * 1000, 1)}
            return _error_retry(429, str(e), self._family_floor(e.retry_after_s, extra),
                                **extra)
        except OverflowError as e:
            extra = {"backlog": sched.depth, "active": sched.active}
            return _error_retry(429, str(e), self._family_floor(1.0, extra, wait="set"),
                                **extra)
        except ValueError as e:  # over-length prompt, checked at submit
            return _error(400, str(e))
        except RuntimeError as e:  # the lane is stopped
            extra = {}
            return _error_retry(503, str(e), self._family_floor(1.0, extra), **extra)
        if adm is not None:
            adm.end()
        # The stream is named by its request id (the client's X-Request-Id
        # when it sent one), as the reference names it, and registered so
        # the export and attach routes can address it.
        stream_id = ctx.request_id if ctx is not None else new_request_id()
        self._register_stream(stream_id, name, sched, gen, imported=False)
        heads = {"X-Stream-Id": stream_id}
        self._served_variant(name, heads)
        if arec is not None:
            self._adapter_served(name, arec, heads)
        draft = getattr(sched, "spec_draft_name", None)
        if draft and sched.spec_live():
            # Which draft speculation runs with (decided at admission: the
            # head goes before any tick); the stream's acceptance rides the
            # final body's stats.
            heads["X-Spec-Draft"] = draft

        def final_body(tokens: list[int]) -> dict:
            out: dict = {"done": True, "tokens": tokens}
            if sched.detokenize is not None:
                out["text"] = sched.detokenize(tokens)
            if gen.rounds_to_first_token is not None:
                out["stats"] = {"rounds_to_first_token": gen.rounds_to_first_token,
                                "segments_to_first_token": gen.segments_to_first_token}
            if gen.spec_proposed:
                out.setdefault("stats", {}).update(
                    spec_draft=sched.spec_draft_name, spec_proposed=gen.spec_proposed,
                    spec_accepted=gen.spec_accepted)
            if gen.cached_tokens:
                out.setdefault("stats", {})["prefix_cached_tokens"] = gen.cached_tokens
            if ctx is not None:
                out.setdefault("stats", {})["trace_id"] = ctx.trace_id
            return out

        if not stream:
            done = asyncio.ensure_future(asyncio.shield(gen.done))
            try:
                got = await _next_or_gone(done, reader) if reader is not None else await done
            except asyncio.CancelledError:
                sched.cancel(gen)  # the server stops: free the slot
                raise
            if got is _GONE:
                sched.cancel(gen)
                raise ConnectionResetError("client closed the connection")
            try:
                tokens = gen.done.result()
            except RuntimeError as e:
                return (*_error(500, f"generation failed: {e}"), gen)
            out = final_body(tokens)
            out.pop("done")
            answer = {"model": name, "predictions": out}
            self._served_variant(name, {}, answer)
            return 200, answer, heads, gen

        async def events(reader):
            while True:
                get = asyncio.ensure_future(gen.events.get())
                ev = await _next_or_gone(get, reader) if reader is not None else await get
                if ev is _GONE:
                    yield _GONE
                    return
                if ev is None:
                    break
                yield {"token": ev}
            if gen.migrated:
                # The stream left by a committed export: a terminal marker,
                # never an error; the importer resumes it from the watermark.
                yield {"migrated": True, "stream_id": stream_id, "watermark": len(gen.tokens),
                       **({"request_id": ctx.request_id, "trace_id": ctx.trace_id}
                          if ctx is not None else {})}
            elif gen.done.exception() is not None:
                err = str(gen.done.exception())
                out = {"error": err}
                if ctx is not None:
                    # The 200 is already sent: the event carries the ids and
                    # the root turns to error, so the trace pins as errored.
                    out.update(request_id=ctx.request_id, trace_id=ctx.trace_id)
                    ctx.span.status = "error"
                    ctx.span.annotate(error=err)
                    log_event(log, "request error", kind=ctx.kind, model=name, status=200,
                              error=err, request_id=ctx.request_id, trace_id=ctx.trace_id)
                yield out
            else:
                yield final_body(gen.done.result())

        def cancel():
            if ctx is not None:
                ctx.span.annotate(cancelled=True)
            sched.cancel(gen)

        return 200, EventStream(events, cancel), heads, gen

    # -- async job lane -----------------------------------------------------
    async def handle_submit(self, name: str, body: bytes,
                            headers: dict[str, str]) -> Response:
        """``:submit``: 202 ``{"job": ...}`` at once.  An ``Idempotency-Key``
        header (or the body's ``idempotency_key``) that names a known job,
        this process's or one the journal replayed, answers that job
        (``"deduped": true``) before any work.  A multi-instance tensor
        frame is 400: a job runs one payload."""
        with _request_scope():
            name, refused = self._resolve_variant(name, body, headers)
            if refused is not None:
                return refused
            return await self._submit_resolved(name, body, headers)

    async def _submit_resolved(self, name: str, body: bytes,
                               headers: dict[str, str]) -> Response:
        ctx = _request_ctx.get()
        adm = ctx.span.child("admission", start=ctx.span.t0) if ctx is not None else None
        lc = self.lifecycle
        if name not in self.engine.models and (lc is None or not lc.knows(name)):
            return self._unknown_model(name)
        if lc is not None:
            # Never blocks on activation: the 202 is immediate, and the job
            # activates a cold model when it runs (cause "job").
            lc.note_use(name)
        # An Idempotency-Key that matches a known job answers it at once: the
        # work already ran (or is running), even while the model is sick.
        idem_key = headers.get("idempotency-key")
        prior = self.jobs.dedupe(idem_key)
        if prior is not None:
            return self._deduped(prior, ctx)
        # The job lane shares the dispatch lane: a quarantined model or an
        # open breaker refuses submits too.
        refused = self._unavailable(name)
        if refused is not None:
            return refused
        extract: dict[str, Any] = {"idempotency_key": None, "objective": None,
                                   **(self._adapter_extract() or {})}
        try:
            payload = self._payload(body, headers, extract)
        except (ValueError, TypeError, UnicodeDecodeError, _BinaryLaneDisabled) as e:
            return _payload_error(e)
        if extract["objective"] is not None:
            return _objective_on_deploy(name)
        # The tenant: the job is keyed (model, adapter) by a wrapper, so the
        # journal replays it onto its tenant and the worker attaches then.
        arec, aerr = self._adapter_of(name, headers, payload, extract)
        if aerr is not None:
            return aerr
        if arec is not None:
            if isinstance(payload, bytes):
                return _error(400, "adapter-addressed submits require a JSON (or text) body")
            payload = {"_adapter": arec.name, "payload": payload}
        if ctx is not None and ctx.binary and isinstance(payload, dict) and "instances" in payload:
            # The journal replays one payload a job; several instances are
            # :predict's.
            return _error(400, "multi-instance tensor frames are :predict-only; submit one "
                               "block per job")
        if extract["idempotency_key"] is not None:
            # The body field twin of the header, checked again after the
            # decode; dedupe and submit below run with no await between them.
            idem_key = idem_key or str(extract["idempotency_key"])
            prior = self.jobs.dedupe(idem_key)
            if prior is not None:
                return self._deduped(prior, ctx)
        if adm is not None:
            adm.end()
        try:
            job = self.jobs.submit(name, payload, idempotency_key=idem_key,
                                   span=ctx.span if ctx is not None else None,
                                   request_id=ctx.request_id if ctx is not None else None)
        except OverflowError as e:
            extra: dict[str, Any] = {"backlog": self.jobs.depths.get(name, 0),
                                     "max_backlog": self.jobs.max_backlog}
            return _error_retry(429, str(e), self._family_floor(1.0, extra), **extra)
        except RuntimeError as e:
            # Shut down: the client should go elsewhere, with an honest
            # horizon for probing this process again.
            return _error_retry(503, str(e), 1.0)
        if ctx is not None:
            # The trace now belongs to the job: the worker adds its queue,
            # run, device and journal spans and finishes it at the job's
            # terminal state, so /admin/trace/{id} shows submit → done.
            ctx.detach()
        ack: dict[str, Any] = {"job": job.public()}
        heads: dict[str, str] = {}
        self._served_variant(name, heads, ack)
        if arec is not None:
            ack["adapter"] = arec.name
            heads["X-Adapter"] = arec.name
        return 202, ack, heads

    @staticmethod
    def _deduped(prior, ctx: _ReqCtx | None) -> Response:
        if ctx is not None:
            ctx.span.point("idempotent_dedupe", job=prior.id)
        ids = {"request_id": ctx.request_id, "trace_id": ctx.trace_id} if ctx is not None else {}
        return 200, {"job": prior.public(), "deduped": True, **ids}, {}

    async def handle_job(self, job_id: str, body: bytes,
                         headers: dict[str, str]) -> Response:
        """A job poll.  Not traced (it would churn the ring), but correlated:
        the body carries the poll's request id and the job's trace id, and
        ``X-Trace-Id`` names the job's trace."""
        request_id = headers.get("x-request-id") or new_request_id()
        job = self.jobs.get(job_id)
        if job is None:
            log_event(log, "request error", kind="job_poll", status=404,
                      error="unknown job id", request_id=request_id)
            return 404, {"error": "unknown job id", "request_id": request_id,
                         "trace_id": None}, {"X-Request-Id": request_id}
        out = {"job": job.public(), "request_id": request_id, "trace_id": job.trace_id}
        ids = {"X-Request-Id": request_id, **({"X-Trace-Id": job.trace_id}
                                              if job.trace_id else {})}
        if job.status == "expired":
            # 410 Gone, not a 200 that looks like a live job: the result was
            # evicted by the retention budget; the client resubmits.
            out["expired"] = {"finished": job.finished,
                              "result_ttl_s": self.jobs.result_ttl_s}
            return 410, out, ids
        return 200, out, ids

    async def _finalize(self, cm, results: list) -> list:
        """The servable's host-side ``finalize`` (SD-1.5: PNG + base64) in
        the loop's executor, never on the dispatch thread nor the loop; a
        failure lands on its own job."""
        finalize = cm.servable.meta.get("finalize")
        if finalize is None:
            return results
        loop = asyncio.get_running_loop()
        return await asyncio.gather(*[loop.run_in_executor(None, finalize, r)
                                      for r in results], return_exceptions=True)

    async def _run_job(self, job):
        [result] = await self._run_jobs([job])
        if isinstance(result, BaseException):
            raise result
        return result

    def _job_batch_of(self, model: str) -> int:
        """Max same-model jobs one device batch may carry (JobQueue
        coalescing): the largest batch bucket, capped (default 1) when
        latency-class models share the engine, since a coalesced batch makes
        every chunk longer, which is the uninterruptible occupancy the
        chunked path exists to bound.  ``extra.job_batch_mixed_cap`` raises
        the cap."""
        cm = self.engine.models.get(model)
        if cm is None:
            return 1
        cap = cm.max_batch
        if (cm.latency_class == "throughput"
                and any(m.latency_class == "latency" for m in self.engine.models.values())):
            cap = min(cap, int(cm.cfg.extra.get("job_batch_mixed_cap", 1)))
        return max(cap, 1)

    async def _run_jobs(self, jobs):
        """Batched job lane: N single-sample jobs → ONE engine batch.

        One entry per job, in order; an Exception entry fails that job alone
        (a bad payload must not take down its batch-mates).  Preprocess and
        finalize fan out on the executor; only the device batch is one call.
        """
        model = jobs[0].model
        if len(jobs) > 1 and any(self._job_adapter_split(j.payload)[0] is not None
                                 for j in jobs):
            # Tenant-addressed jobs run one by one: a failed attach fails its
            # own job alone (the batcher is the adapters' co-batching lane).
            return [r for j in jobs for r in await self._run_jobs([j])]
        lc = self.lifecycle if self.lifecycle is not None and self.lifecycle.knows(model) else None
        if lc is not None:
            # The job lane tolerates latency: no deadline on the activation.
            await lc.ensure_active(model, cause="job")
            lc.enter(model)
        try:
            return await self._run_jobs_admitted(self.engine.model(model), jobs)
        finally:
            if lc is not None:
                lc.exit(model)

    async def _run_jobs_admitted(self, cm, jobs):
        loop = asyncio.get_running_loop()
        arec = None
        aname = self._job_adapter_split(jobs[0].payload)[0]
        if aname is not None:
            # Journal-replayed or fresh, the job attaches its tenant's adapter
            # on demand (cause "job": the async lane waits).
            try:
                await self.adapters.ensure_attached(cm.servable.name, aname, cause="job")
            except Exception as e:
                return [e]
            arec = self.adapters.get(cm.servable.name, aname)
            self.adapters.enter(arec)
        try:
            out = await self._run_jobs_samples(cm, jobs, arec)
        finally:
            if arec is not None:
                self.adapters.exit(arec)
        if arec is not None and not isinstance(out[0], BaseException):
            self.adapters.note_served(arec)
        return out

    async def _run_jobs_samples(self, cm, jobs, arec):
        loop = asyncio.get_running_loop()
        samples = await asyncio.gather(
            *[loop.run_in_executor(None, cm.servable.preprocess,
                                   self._job_adapter_split(j.payload)[1]) for j in jobs],
            return_exceptions=True)
        if arec is not None:
            self._stamp_adapter([s for s in samples if not isinstance(s, BaseException)], arec)
        good = [i for i, s in enumerate(samples) if not isinstance(s, BaseException)]
        out: list = list(samples)  # failed slots already hold their Exception
        if good:
            # The device span on the head job's trace (its batch-mates
            # named), parenting the runner's per-slice spans.
            spans = [getattr(j, "run_span", None) or getattr(j, "span", None) for j in jobs]
            head = next((i for i in good if spans[i] is not None), None)
            parent = spans[head] if head is not None else None
            dev = None
            if parent is not None:
                mates = [jobs[i].trace_id for i in good if i != head and jobs[i].trace_id]
                dev = parent.child("device", batch_size=len(good),
                                   **({"batch_mates": mates[:8]} if mates else {}))
            # The batcher's contract: transient faults retry, every outcome
            # feeds the model's breaker.
            batch = [samples[i] for i in good]
            try:
                results = await run_with_retry(
                    lambda: self.engine.runner.run_chunked(cm, batch, span=dev),
                    self.resilience.model(cm.servable.name), None,
                    clock=loop.time, sleep=asyncio.sleep)
            except BaseException as e:
                if dev is not None:
                    dev.end(status="error", error=f"{type(e).__name__}: {e}")
                raise
            if dev is not None:
                dev.end()
            fin = parent.child("finalize") if parent is not None else None
            finals = await self._finalize(cm, results)
            if fin is not None:
                fin.end()
            for i, r in zip(good, finals, strict=True):
                out[i] = r
        return out


    # -- drain, recovery and the admin routes --------------------------------
    def begin_drain(self):
        """Flip to draining: /healthz answers 503, new work 503 + Retry-After.
        What is in flight (requests, streams, jobs) keeps running; follow
        with :meth:`wait_drained`.  Idempotent."""
        if not self.draining:
            self.resilience.draining = True
            log_event(log, "drain started", inflight=self._inflight,
                      jobs_backlog=self.jobs.depth if self.jobs else 0)

    async def wait_drained(self, timeout_s: float) -> bool:
        """Wait for in-flight work and queued or running jobs to finish: True
        when all did within the budget, False when it expired first."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while True:
            jobs_idle = self.jobs is None or (self.jobs.depth == 0 and self.jobs.active == 0)
            if self._inflight == 0 and jobs_idle:
                return True
            if loop.time() >= deadline:
                log.warning("drain budget expired (inflight=%d jobs=%d)", self._inflight,
                            self.jobs.depth if self.jobs else 0)
                return False
            await asyncio.sleep(0.02)

    def on_sigterm(self, stop: asyncio.Event):
        """SIGTERM: with ``drain_timeout_s > 0`` drain, then set ``stop``;
        without a budget, or on a second SIGTERM, set it at once."""
        if self.cfg.drain_timeout_s <= 0 or self.draining:
            stop.set()
            return
        self._drain_task = asyncio.get_running_loop().create_task(
            self._drain_then_stop(stop), name="drain")

    async def _drain_then_stop(self, stop: asyncio.Event):
        self.begin_drain()
        clean = await self.wait_drained(self.cfg.drain_timeout_s)
        log_event(log, "drain finished; stopping", clean=clean)
        stop.set()

    async def rebuild_engine(self, cause: str = "reload"):
        """Stop the lanes, build a fresh engine on the same device, swap it
        in, free the old one, and restart the lanes.

        The lanes' pools and graphs belong to the engine, so the batchers and
        the ``:generate`` schedulers stop and restart with it: in-flight work
        fails, and work racing the rebuild gets 429/503 from stopped lanes.
        The new engine builds and captures its graphs on its own runner's
        dispatch thread, and nothing else may touch the device meanwhile (a
        graph capture refuses other threads' CUDA calls): the old runner is
        poisoned for the rebuild, so its dispatches and probes fail fast with
        no device work, and quiesced, so what it was running has ended.  If
        the build fails, the old engine stays live under fresh lanes (it
        never moves to another device) and the error propagates.  After the
        swap the old engine's dispatch thread is joined off the loop, every
        reference to it dropped, and the CUDA caching allocator emptied on
        the new dispatch thread before any lane can capture, so a recovery
        does not leave a second engine's memory behind.  Serialized: a
        reload overlapping a recovery waits its turn.
        """
        async with self._rebuild_lock:
            old = self.engine
            await self._stop_lanes()
            loop = asyncio.get_running_loop()
            prev = old.runner.faults.poison_exc
            old.runner.poison(prev or RuntimeError("the engine is being rebuilt"))
            try:
                timeout = self.cfg.dispatch_probe_timeout_s
                if not await loop.run_in_executor(None, old.runner.quiesce, timeout):
                    raise RuntimeError(f"the engine's dispatch thread did not go idle in "
                                       f"{timeout:g} s")
                new = await loop.run_in_executor(None, build_engine, self.cfg, old.device)
            except Exception:
                old.runner.poison(prev)
                self._start_lanes()
                raise
            old.runner.poison(prev)  # a lent engine goes back to its caller as it was
            self.engine = new
            # /metrics and the store's chaos hook follow the fresh injector
            # (the old one's rules and counters went with its runner).
            self.metrics.faults = new.runner.faults
            self.autoscale.faults = new.runner.faults
            if self.ckpt_store is not None:
                self.ckpt_store.faults = new.runner.faults
            for name in set(self.batchers) | set(self.schedulers):
                # Lanes of a model activated on the old engine while it was
                # being replaced: the model is cold in the new one.
                await self._stop_model_lanes(name, release=False)
            if self.lifecycle is not None:
                # The rebuild is a residency transition: the new engine's
                # models count as activations under ``cause``, a lazy model
                # goes back to COLD (never ACTIVE on a dead engine), and
                # host and disk copies survive.
                self.lifecycle.rebind(cause=cause)
            owned, self._owns_engine = self._owns_engine, True
            if owned:
                await loop.run_in_executor(None, old.shutdown)
            del old
            await loop.run_in_executor(None, new.runner.run_fn_sync, _release_device_memory,
                                       new.device)
            self._start_lanes()
            log_event(log, "engine rebuilt", cause=cause, models=sorted(new.models),
                      cold_start_seconds=round(new.cold_start_seconds, 3))

    async def handle_drain(self, body: bytes, headers=None, query: str = "") -> Response:
        """Drain over HTTP: flip to draining, wait up to ``timeout_s`` (the
        body's, else ``drain_timeout_s``) for in-flight work, and report
        whether it finished.  The process keeps running."""
        try:
            req = json.loads(body) if body else {}
        except ValueError:
            req = {}
        timeout_s = 5.0
        if isinstance(req, dict):
            timeout_s = float(req.get("timeout_s", self.cfg.drain_timeout_s or 5.0))
        self.begin_drain()
        drained = await self.wait_drained(timeout_s)
        return 200, {"draining": True, "drained": drained, "inflight": self._inflight,
                     "jobs_backlog": self.jobs.depth if self.jobs else 0}, {}

    async def handle_faults_get(self, body: bytes, headers=None, query: str = "") -> Response:
        return 200, {"faults": self.engine.runner.faults.snapshot()}, {}

    async def handle_faults(self, body: bytes, headers=None, query: str = "") -> Response:
        """Configure the fault injector: ``{"clear": true}`` (optionally
        scoped by ``"model"``) removes rules; any other body is one rule,
        ``{"model", "fail_every_n", "count", "kind", "latency_ms",
        "preprocess", "mode"}``."""
        try:
            req = json.loads(body) if body else {}
        except ValueError:
            return _error(400, "body must be a JSON object")
        if not isinstance(req, dict):
            return _error(400, "body must be a JSON object")
        faults = self.engine.runner.faults
        if req.get("clear"):
            # A typo in a clear must not clear everything.
            unknown = set(req) - {"clear", "model"}
            if unknown:
                return _error(400, f"unknown fault fields {sorted(unknown)}; "
                                   "allowed with clear: ['clear', 'model']")
            faults.clear(req.get("model"))
        else:
            allowed = {"model", "fail_every_n", "count", "kind", "latency_ms",
                       "preprocess", "mode"}
            unknown = set(req) - allowed
            if unknown:
                return _error(400, f"unknown fault fields {sorted(unknown)}; "
                                   f"allowed: {sorted(allowed)}")
            try:
                faults.configure(**req)
            except (TypeError, ValueError) as e:
                return _error(400, str(e))
        log_event(log, "fault rules updated", **faults.snapshot()["injected"])
        return 200, {"faults": faults.snapshot()}, {}

    async def handle_recover(self, body: bytes, headers=None, query: str = "") -> Response:
        """The watchdog's recovery over HTTP, its attempt budget reset (so it
        works after ``gave_up``); a one-shot watchdog when none runs."""
        wd = self.watchdog
        if wd is None:
            wd = self.watchdog = Watchdog(self, self.cfg.watchdog_interval_s or 1.0,
                                          max_attempts=self.cfg.recover_max_attempts,
                                          backoff_s=self.cfg.recover_backoff_s)
            self.metrics.watchdog = wd
        snap = await wd.recover(reason="admin", manual=True)
        return (200 if snap["state"] == "healthy" else 503), {"recovery": snap}, {}

    async def handle_reload(self, body: bytes, headers=None, query: str = "") -> Response:
        await self.rebuild_engine()
        return 200, {"status": "reloaded",
                     "cold_start_seconds": round(self.engine.cold_start_seconds, 3)}, {}

    # -- admin: model residency ----------------------------------------------
    async def handle_admin_models(self, body: bytes, headers=None, query: str = "") -> Response:
        """``GET /admin/models``: every model's residency, the budgets and
        the checkpoint store's accounting."""
        return 200, self.lifecycle.snapshot(), {}

    async def handle_admin_model_get(self, name: str, body: bytes,
                                     headers: dict[str, str]) -> Response:
        snap = self.lifecycle.model_snapshot(name)
        if snap is None:
            return _error(404, f"model {name!r} not configured; available: "
                               f"{sorted(self.lifecycle.names)}")
        return 200, {"model": {"name": name, **snap}}, {}

    async def handle_admin_model_post(self, name: str, body: bytes,
                                      headers: dict[str, str]) -> Response:
        """``POST /admin/models/{name} {"action": ...}``: ``activate`` (the
        shared single-flight activation), ``unload`` (to none; 409 if pinned
        or busy), ``demote`` (one rung, ``"to"`` host, disk or none; 409 if
        pinned, busy or not active, or disk without a store), ``pin`` (and
        activate), ``unpin``."""
        lc = self.lifecycle
        if not lc.knows(name):
            return _error(404, f"model {name!r} not configured; available: {sorted(lc.names)}")
        try:
            req = json.loads(body) if body else {}
        except ValueError:
            return _error(400, "body must be a JSON object")
        if not isinstance(req, dict):
            return _error(400, "body must be a JSON object")
        action = req.get("action")
        allowed = ("activate", "unload", "demote", "pin", "unpin")
        if action not in allowed:
            return _error(400, f"action must be one of {list(allowed)}, got {action!r}")
        try:
            if action == "activate":
                await lc.ensure_active(name, cause="admin")
            elif action == "unload":
                if not await lc.unload(name, cause="admin"):
                    return _error(409, f"model {name!r} cannot unload (pinned or busy)",
                                  model=lc.model_snapshot(name))
            elif action == "demote":
                to = req.get("to", "host")
                if to not in ("host", "disk", "none"):
                    return _error(400, f"demote 'to' must be one of ['host', 'disk', 'none'], "
                                       f"got {to!r}")
                if to == "disk" and lc.store is None:
                    return _error(409, "disk tier requires ckpt_store_dir")
                if not await lc.demote(name, to=to, cause="admin"):
                    return _error(409, f"model {name!r} cannot demote (pinned, busy, or not "
                                       "active)", model=lc.model_snapshot(name))
            elif action == "pin":
                await lc.pin(name)
            else:
                lc.unpin(name)
        except ColdStart as e:
            return _error_retry(503, str(e), e.retry_after_s,
                                estimated_warm_ms=round(e.estimated_warm_ms, 1))
        except Exception as e:
            log.exception("admin lifecycle action %s failed for %s", action, name)
            return _error(503, f"{action} failed for {name!r}: {type(e).__name__}: {e}")
        return 200, {"action": action, "model": {"name": name, **lc.model_snapshot(name)}}, {}

    # -- admin: the SLO plane and the autoscaler ----------------------------
    async def handle_admin_slo(self, body: bytes, headers=None, query: str = "") -> Response:
        """``GET /admin/slo``: objectives, outcome counts, goodput, the fast
        and slow burn windows with their alarms, and the usage ledger."""
        return 200, self.slo.snapshot(), {}

    async def handle_admin_autoscale(self, body: bytes, headers=None,
                                     query: str = "") -> Response:
        """``GET /admin/autoscale``: the plane's mode (and whether it has
        degraded to reactive), its counters and knobs, and each demand
        key's fit, learned keep-warm window and planned action."""
        return 200, self.autoscale.snapshot(), {}

    # -- admin: the perf plane -------------------------------------------------
    async def handle_admin_perf(self, body: bytes, headers=None, query: str = "") -> Response:
        """``GET /admin/perf?top=N``: event-loop lag (histogram, max), the
        top-N collapsed thread stacks by wall time, each model's rolling
        gauges (samples/s, tokens/s, step ms, dispatch-lane occupancy, MFU
        where hinted; a ``:generate`` lane's TTFT and inter-token p50), and
        the per-(model, stage) ingest histograms.  The ``perf`` CLI renders
        it."""
        try:
            top = int(parse_qs(query).get("top", ["20"])[-1])
        except (TypeError, ValueError):
            return _error(400, "top must be an integer")
        snap = self.perf.snapshot(top_stacks=max(top, 1))
        for n, sched in self.schedulers.items():
            row = snap["models"].setdefault(f"{n}:generate", {})
            ttft = hist_quantile(sched.ttft_hist.snapshot(), 0.5)
            itl = hist_quantile(sched.itl_hist.snapshot(), 0.5)
            if ttft is not None:
                row["ttft_p50_ms"] = ttft
            if itl is not None:
                row["itl_p50_ms"] = itl
        return 200, snap, {}

    def _flops_hint(self, name: str) -> float | None:
        """A model's FLOPs a sample for the MFU gauge
        (``ModelConfig.extra.flops_per_sample``); None omits the gauge."""
        try:
            v = self.cfg.model(name).extra.get("flops_per_sample")
        except KeyError:
            return None
        try:
            return float(v) if v else None
        except (TypeError, ValueError):
            return None

    def _device_name(self) -> str | None:
        """The card's name, the key of the perf plane's peak table (None off
        CUDA)."""
        dev = self.engine.device
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else None

    def _serverpath_snapshot(self) -> dict:
        """The fast path's evidence for /metrics: live acceptor workers,
        ring depths, binary-lane requests, the serialization pool, and with
        workers the pump's counters and the acceptor telemetry."""
        sup = self.acceptors
        out = {"ingest_workers": sup.alive_workers() if sup is not None else 0,
               "ring_depth": sup.ring_depths() if sup is not None else {},
               "binary_requests": dict(self.binary_requests),
               "wire_pool": self.wire_pool.snapshot()}
        if sup is not None:
            snap = sup.snapshot()
            out["pump"] = {k: snap[k] for k in ("served", "resp_drops", "resp_oversize",
                                                "resp_backlog", "degraded_reason",
                                                "ingest_port", "spawn_seconds")}
            out["acceptor"] = sup.telemetry_snapshot()
        return out

    async def serve_frame(self, name: str, body: bytes, deadline_raw: str, telem: dict | None,
                          t_pop: float, cap: int) -> tuple[int, bytes, str]:
        """One acceptor-lane request (serving/acceptors.py) through the
        binary lane's admission, preprocess and batcher: ``(status, answer
        frame or JSON error body, the trace's traceparent)``.

        The reference's order: 404, quarantine 503, breaker 503, 413 or 400,
        deadline, preprocess, ``submit_many``, then 504 or 429.  A
        configured model that is not resident answers 503 ``cold_start``
        (its activation starts; the pump never waits for it).  The trace is
        anchored at the worker's accept (``telem``), joins the client's
        ``traceparent``, and carries the worker's ``sock_read``,
        ``frame_validate`` and ``ring_wait`` beside ``binary_decode``; every
        path leaves through the autoscaler's arrival, the SLO observation
        and (served) the usage ledger."""
        t_accept = telem["t_accept"] if telem else t_pop
        request_id = telem["request_id"] if telem and telem["request_id"] else new_request_id()
        root = self.tracer.start("predict", model=name,
                                 traceparent=(telem["traceparent"] or None) if telem else None,
                                 start=t_accept, request_id=request_id, lane="binary",
                                 ingest="acceptor")
        trace_id = root.trace.trace_id
        try:
            self.autoscale.note_arrival(name)
        except Exception:  # noqa: BLE001 — accounting never fails a request
            log.exception("autoscale arrival failed")

        def sub(stage, t0, t1, **attrs):
            self.perf.note_stage(name, stage, (t1 - t0) * 1000.0)
            root.child(stage, start=t0, **attrs).end(end=t1)

        if telem is not None:
            # Worker stamps: perf_counter is CLOCK_MONOTONIC, system-wide.
            sub("sock_read", telem["t_accept"], telem["t_read"])
            sub("frame_validate", telem["t_read"], telem["t_validate"])
            sub("ring_wait", telem["t_push"], t_pop)
        adm = root.child("admission", start=t_accept)

        def finish(status: int):
            adm.end()
            self.tracer.finish(root.trace, "error" if status >= 400 else "ok")
            try:
                self.slo.observe(name, "predict", status,
                                 (time.perf_counter() - t_accept) * 1000.0)
            except Exception:  # noqa: BLE001
                log.exception("slo observation failed")

        def err(status: int, message: str, retry_after_s: float | None = None, **extra):
            out = {"error": message, **extra, "request_id": request_id, "trace_id": trace_id}
            if retry_after_s is not None:
                out["retry_after_s"] = retry_after_s
            root.annotate(http_status=status, error=message)
            log_event(log, "request error", kind="predict", model=name, status=status,
                      error=message, lane="acceptor", request_id=request_id, trace_id=trace_id)
            finish(status)
            return status, wire._json_bytes(out), root.traceparent

        if self.draining:
            return err(503, "server is draining; retry against another replica",
                       self.cfg.drain_timeout_s or 1.0, draining=True)
        batcher = self.batchers.get(name)
        lc = self.lifecycle
        if batcher is None and lc is not None and lc.knows(name) and name not in self.engine.models:
            try:
                await lc.ensure_active(name, cause="request", wait=False)
            except ColdStart as e:
                root.point("cold_start", estimated_warm_ms=round(e.estimated_warm_ms, 1))
                return err(503, str(e), e.retry_after_s, cold_start=True,
                           estimated_warm_ms=round(e.estimated_warm_ms, 1))
            except Exception as e:
                log.exception("activation failed for %s", name)
                return err(503, f"model {name!r} activation failed: {type(e).__name__}: {e}",
                           self.cfg.recover_backoff_s or 1.0, activation_failed=True)
            batcher = self.batchers.get(name)
        if batcher is None:
            return err(404, f"unknown model {name!r}")
        if lc is not None:
            lc.enter(name)  # no demotion while the request is here
        try:
            return await self._serve_frame_admitted(name, batcher, body, deadline_raw, cap,
                                                    root, adm, sub, finish, err)
        finally:
            if lc is not None:
                lc.exit(name)

    async def _serve_frame_admitted(self, name, batcher, body, deadline_raw, cap, root, adm, sub,
                                    finish, err):
        refused = self._unavailable(name)
        if refused is not None:
            status, obj, heads = refused
            extra = {k: v for k, v in obj.items() if k != "error"}
            return err(status, obj["error"], float(heads["Retry-After"]), **extra)
        t0 = time.perf_counter()
        try:
            items, flags = wire.unpack(body, max_bytes=cap)
            if flags & wire.FLAG_META:
                raise wire.FrameError("FLAG_META frames are response-only")
        except wire.FrameTooLarge as e:
            return err(413, f"tensor frame too large: {e}")
        except wire.FrameError as e:
            return err(400, f"bad tensor frame: {e}")
        t1 = time.perf_counter()
        sub("binary_decode", t0, t1, blocks=len(items))
        self.note_binary_request(name)
        listy = bool(flags & wire.FLAG_LIST) or len(items) > 1
        cm = batcher.model
        mr = self.resilience.model(name)
        try:
            deadline_ms = self._deadline_ms({"x-deadline-ms": deadline_raw} if deadline_raw
                                            else {}, None, cm.cfg)
        except ValueError as e:
            return err(400, str(e))
        loop = asyncio.get_running_loop()
        deadline = None
        if deadline_ms is not None:
            if deadline_ms <= 0:
                mr.stats.deadline_admission += 1
                return err(504, f"deadline_ms={deadline_ms:g} already expired at admission",
                           stage="admission")
            deadline = loop.time() + deadline_ms / 1000.0
        meta = cm.servable.meta
        sub("validate", t1, time.perf_counter())
        try:
            if meta.get("heavy_preprocess") or any(isinstance(p, bytes) for p in items):
                per_input = await asyncio.gather(
                    *[loop.run_in_executor(None, self._preprocess, cm, p) for p in items])
            else:
                per_input = [self._preprocess(cm, p) for p in items]
        except Exception as e:
            return err(400, f"preprocess failed: {type(e).__name__}: {e}")
        widths = [len(x) if isinstance(x, list) else 1 for x in per_input]
        samples = [x for s in per_input for x in (s if isinstance(s, list) else [s])]
        seq_of = meta.get("seq_len_of")
        adm.end()  # admission ends where the batcher queue begins
        try:
            futs = batcher.submit_many(samples, [seq_of(x) if seq_of else None for x in samples],
                                       deadline=deadline, span=root)
            remaining = max(deadline - loop.time(), 0.001) if deadline is not None else None
            pairs = await asyncio.wait_for(asyncio.gather(*futs), remaining)
        except Overloaded as e:
            return err(429, str(e), e.retry_after_s)
        except DeadlineExceeded as e:
            return err(504, str(e), stage=e.stage)
        except (asyncio.TimeoutError, TimeoutError):
            mr.stats.deadline_await += 1
            batcher.ring.record_error()
            return err(504, f"deadline ({deadline_ms:g} ms) expired while awaiting the device",
                       stage="await")
        except Exception as e:
            log.exception("acceptor-lane predict failed for %s", name)
            return err(500, f"inference failed: {type(e).__name__}")
        grouped, i = [], 0
        for width in widths:
            part = [r for r, _ in pairs[i: i + width]]
            grouped.append(meta["merge_results"](part) if width > 1 else part[0])
            i += width
        t_done = max(t.pop("t_done") for _, t in pairs)
        timing = {k: max(t[k] for _, t in pairs)
                  for k in ("queue_ms", "device_ms", "total_ms", "batch_size")}
        timing["samples"] = len(pairs)
        rsp = root.child("respond", start=t_done)
        t_ser = time.perf_counter()
        frame = wire.pack([{"model": name, "timing": timing}] + grouped,
                          flags=wire.FLAG_META | (wire.FLAG_LIST if listy else 0),
                          pool=self.wire_pool)
        out = bytes(frame)
        self.wire_pool.release(frame)  # copied out: back in the same tick
        sub("serialize", t_ser, time.perf_counter())
        rsp.end()
        self.perf.note_stage(name, "respond", (time.perf_counter() - t_done) * 1000.0)
        try:
            self.slo.usage.note_request(name, None, timing["device_ms"])
        except Exception:  # noqa: BLE001
            log.exception("usage accounting failed")
        finish(200)
        return 200, out, root.traceparent

    # -- admin: multi-tenant adapters ------------------------------------------
    async def handle_admin_adapters(self, body: bytes, headers=None, query: str = "") -> Response:
        """``GET /admin/adapters``: every tenant's adapter residency."""
        return 200, self.adapters.snapshot(), {}

    async def handle_admin_adapter_post(self, base: str, aname: str, body: bytes,
                                        headers: dict[str, str]) -> Response:
        """``POST /admin/adapters/{model}/{adapter} {"action": ...}``:
        ``attach`` (the shared single-flight attach, the base activated
        first) or ``detach`` (409 while the adapter is busy or not
        attached)."""
        rec = self.adapters.get(base, aname)
        if rec is None:
            return self._unknown_adapter(base, aname)
        try:
            req = json.loads(body) if body else {}
        except ValueError:
            return _error(400, "body must be a JSON object")
        if not isinstance(req, dict):
            return _error(400, "body must be a JSON object")
        action = req.get("action")
        if action not in ("attach", "detach"):
            return _error(400, f"action must be one of ['attach', 'detach'], got {action!r}")
        try:
            if action == "attach":
                if self.lifecycle is not None and self.lifecycle.knows(base):
                    # The base must be resident to hold a slot pool.
                    await self.lifecycle.ensure_active(base, cause="admin")
                await self.adapters.ensure_attached(base, aname, cause="admin")
            elif not await self.adapters.detach(base, aname, cause="admin"):
                return _error(409, f"adapter {aname!r} on {base!r} cannot detach (busy or not "
                                   "attached)", adapter=self.adapters.adapter_snapshot(rec))
        except AdapterCold as e:
            return _error_retry(503, str(e), e.retry_after_s,
                                estimated_attach_ms=round(e.estimated_attach_ms, 1))
        except ColdStart as e:
            return _error_retry(503, str(e), e.retry_after_s,
                                estimated_warm_ms=round(e.estimated_warm_ms, 1))
        except Exception as e:
            log.exception("admin adapter action %s failed for %s:%s", action, base, aname)
            return _error(503, f"{action} failed for {base}:{aname}: {type(e).__name__}: {e}")
        return 200, {"action": action, "adapter": {"model": base, "name": aname,
                                                    **self.adapters.adapter_snapshot(rec)}}, {}

    def _invalidate_prefix(self, base: str, slot: int):
        """The AdapterManager's detach hook: drop the slot's frozen
        prefixes on the base's paged lane."""
        sched = self.schedulers.get(base)
        if isinstance(sched, PagedGenerationScheduler):
            sched.invalidate_prefix(slot)

    # -- admin: the prefix cache and live migration -------------------------
    async def handle_admin_prefix(self, body: bytes, headers=None, query: str = "") -> Response:
        """``GET /admin/prefix``: each paged lane's prefix-tree counters
        (nodes, pages, hits, CoW copies, evictions, cached tokens) with its
        pool's used and shared pages."""
        models = {}
        for name, sched in self.schedulers.items():
            snap = sched.gen_snapshot()
            if "prefix" in snap:
                models[name] = {**snap["prefix"], "kv_blocks_used": snap["kv"]["blocks_used"],
                                "kv_shared_blocks": snap["kv"].get("shared_blocks", 0)}
        return 200, {"models": models}, {}

    def _register_stream(self, stream_id: str, model: str, sched, gen, imported: bool):
        self.streams[stream_id] = {"model": model, "sched": sched, "gen": gen,
                                   "imported": imported, "attached": False,
                                   "created": time.time()}
        while len(self.streams) > self._streams_cap:
            self.streams.pop(next(iter(self.streams)))

    def _stream_entry(self, sid: str) -> tuple[dict | None, Response | None]:
        """(entry, error answer) of one ``/admin/streams/{id}`` call."""
        entry = self.streams.get(sid)
        if entry is None:
            return None, _error(404, f"unknown stream {sid!r}", streams=len(self.streams))
        sched = entry["sched"]
        if not isinstance(sched, PagedGenerationScheduler):
            return None, _error(400, "stream is not on a paged lane; migration requires "
                                     "kv_cache='paged'")
        if not sched.kv_migrate:
            return None, _error(409, f"kv_migrate is disabled on model {entry['model']!r}")
        return entry, None

    @staticmethod
    def _stream_state_of(gen) -> str:
        if gen.migrated:
            return "migrated"
        if gen.done.done():
            return "error" if gen.done.exception() is not None else "done"
        return "live"

    async def handle_admin_streams(self, body: bytes, headers=None, query: str = "") -> Response:
        """``GET /admin/streams``: the stream registry, each stream's model,
        state, tokens and migrations."""
        out = {}
        for sid, e in self.streams.items():
            gen = e["gen"]
            out[sid] = {"model": e["model"], "state": self._stream_state_of(gen),
                        "tokens": len(gen.tokens), "max_new": gen.max_new,
                        "emitted_base": gen.emitted_base, "migrations": gen.migrations,
                        "imported": e["imported"]}
        return 200, {"streams": out}, {}

    async def handle_stream_export(self, sid: str, body: bytes,
                                   headers: dict[str, str]) -> Response:
        """``POST /admin/streams/{id}/export``, the source half of a live
        migration in phases, so decode barely stalls:

        - ``snapshot``: read the stream's complete pages while it decodes on;
          the packed pages and the frontier;
        - ``cutover`` (``"have": [...]``): pause it at a tick boundary and
          answer the manifest (prompt, emitted tokens, sampler state, page
          geometry) and the pages the importer lacks; it stays detached until
          the commit or the abort;
        - ``pages`` (``"indices": [...]``): read given pages again (the
          importer's retry after a failed integrity check);
        - ``commit`` (``"cause"``): the importer has it; the pages go and the
          source stream ends with a ``migrated`` event;
        - ``abort``: resume it in place.

        The ``migration`` fault fires here: ``drop`` answers a retryable
        503, ``corrupt`` flips the first page's bytes after its hash,
        ``slow`` stretches the step."""
        entry, err = self._stream_entry(sid)
        if err is not None:
            return err
        gen, sched, name = entry["gen"], entry["sched"], entry["model"]
        try:
            req = json.loads(body) if body else {}
        except ValueError:
            return _error(400, "body must be a JSON object")
        if not isinstance(req, dict):
            return _error(400, "body must be a JSON object")
        phase = req.get("phase", "cutover")
        if phase not in ("snapshot", "cutover", "pages", "commit", "abort"):
            return _error(400, f"phase must be snapshot|cutover|pages|commit|abort, got "
                               f"{phase!r}")
        mode, lat_s = self.engine.runner.faults.on_migration(name)
        if lat_s:
            await asyncio.sleep(lat_s)
        if mode == "drop":
            sched.migration.failed += 1
            return _error_retry(503, f"injected migration fault (drop, phase={phase})", 1.0,
                                retryable=True)

        def packed(pages: dict) -> list:
            # mode="corrupt": the first page's bytes flipped after its hash.
            return [pack_page(i, k, v, corrupt=(mode == "corrupt" and j == 0))
                    for j, (i, (k, v)) in enumerate(sorted(pages.items()))]

        loop = asyncio.get_running_loop()
        try:
            if phase == "snapshot":
                res = await sched.migrate_snapshot(gen)
                pages = await loop.run_in_executor(None, packed, res["pages"])
                return 200, {"stream_id": sid, "model": name, "phase": phase,
                             "frontier": res["frontier"], "pos": res["pos"],
                             "pages": pages}, {}
            if phase == "cutover":
                have = [int(i) for i in (req.get("have") or ())]
                res = await sched.migrate_cutover(gen, have)
                manifest = {
                    "version": FORMAT_VERSION, "stream_id": sid, "model": name,
                    # The adapter by name: the importer resolves its own slot.
                    "adapter": self.adapters.name_of_slot(name, res["aidx"]),
                    "prompt": [int(t) for t in res["ids"]],
                    "emitted": res["emitted"], "watermark": len(res["emitted"]),
                    "max_new": res["max_new"], "state": res["state"],
                    "npages": res["npages"], "page_shape": list(sched.page_shape),
                    "dtype": dtype_name(sched.cache_dtype)}
                pages = await loop.run_in_executor(None, packed, res["pages"])
                return 200, {"manifest": manifest, "pages": pages}, {}
            if phase == "pages":
                indices = [int(i) for i in (req.get("indices") or ())]
                res = await sched.migrate_pages(gen, indices)
                pages = await loop.run_in_executor(None, packed, res["pages"])
                return 200, {"stream_id": sid, "phase": phase, "pages": pages}, {}
            if phase == "commit":
                cause = req.get("cause", "admin")
                if cause not in CAUSES:
                    return _error(400, f"cause must be one of {CAUSES}, got {cause!r}")
                wm = await sched.migrate_commit(gen, cause)
                return 200, {"committed": True, "stream_id": sid, "watermark": wm}, {}
            await sched.migrate_abort(gen)
            return 200, {"aborted": True, "stream_id": sid}, {}
        except MigrationError as e:
            return _error(409, str(e), stream_id=sid, phase=phase)

    async def handle_stream_import(self, sid: str, body: bytes,
                                   headers: dict[str, str]) -> Response:
        """``POST /admin/streams/{id}/import``, the target half: verify each
        page's hash, adopt the prompt pages the local prefix tree already
        holds, write the rest by value and resume decode from the imported
        sampler state.  409 with ``"need"`` names the pages to fetch again
        (corrupt, or missing); 503 retryable when the pool cannot take the
        stream now."""
        try:
            req = json.loads(body) if body else {}
        except ValueError:
            return _error(400, "body must be a JSON object")
        if not isinstance(req, dict):
            return _error(400, "body must be a JSON object")
        manifest = req.get("manifest")
        try:
            check_manifest(manifest)
        except MigrationError as e:
            return _error(400, str(e))
        name = manifest.get("model")
        sched = self.schedulers.get(name)
        if not isinstance(sched, PagedGenerationScheduler):
            return _error(400, f"model {name!r} has no paged generation lane on this server; "
                               "migration requires kv_cache='paged'")
        if not sched.kv_migrate:
            return _error(409, f"kv_migrate is disabled on model {name!r}")
        local = dtype_name(sched.cache_dtype)
        if (tuple(manifest["page_shape"]) != tuple(sched.page_shape)
                or str(manifest["dtype"]) != local):
            return _error(400, f"incompatible pool geometry: exporter page "
                               f"{manifest['page_shape']}/{manifest['dtype']} vs local "
                               f"{list(sched.page_shape)}/{local}")
        cause = req.get("cause", "admin")
        if cause not in CAUSES:
            return _error(400, f"cause must be one of {CAUSES}, got {cause!r}")
        mode, lat_s = self.engine.runner.faults.on_migration(name)
        if lat_s:
            await asyncio.sleep(lat_s)
        if mode == "drop":
            sched.migration.failed += 1
            return _error_retry(503, "injected migration fault (drop, import)", 1.0,
                                retryable=True)
        shape = tuple(manifest["page_shape"])

        def unpacked():
            page_map, bad = {}, []
            for rec in (req.get("pages") or ()):
                try:
                    i, k, v = unpack_page(rec, shape, manifest["dtype"])
                    page_map[i] = (k, v)
                except PageIntegrityError as e:
                    bad.extend(e.indices)
            return page_map, bad

        page_map, bad = await asyncio.get_running_loop().run_in_executor(None, unpacked)
        if bad:
            return 409, {"error": "page integrity check failed; fetch these pages by value",
                         "need": sorted(bad), "stream_id": sid}, {}
        arec = None
        if manifest.get("adapter"):
            # An adapter stream: attach its adapter here before any page is
            # placed, and hold it for the stream's life.
            arec = self.adapters.get(name, str(manifest["adapter"]))
            if arec is None:
                return self._unknown_adapter(name, str(manifest["adapter"]))
            try:
                await self.adapters.ensure_attached(name, arec.name, cause="migration")
            except Exception as e:
                return _error_retry(503, f"adapter {arec.name!r} attach failed: "
                                         f"{type(e).__name__}: {e}", 1.0, retryable=True,
                                    adapter_cold=True)
            self.adapters.enter(arec)
        span = self.tracer.start("migrate_import", model=name,
                                 traceparent=headers.get("traceparent"))
        try:
            gen, hits, copied = await sched.migrate_import(
                manifest["prompt"], manifest["emitted"], manifest["state"], page_map,
                max_new=manifest["max_new"], cause=cause, span=span,
                aidx=arec.slot if arec is not None else 0)
        except (MigrationNeedsPages, MigrationError) as e:
            self.tracer.finish(span.trace, "error")
            if arec is not None:
                self.adapters.exit(arec)
            if isinstance(e, MigrationNeedsPages):
                return 409, {"error": str(e), "need": sorted(e.indices), "stream_id": sid}, {}
            return _error_retry(503, str(e), 1.0, retryable=True)
        if arec is not None:
            gen.done.add_done_callback(lambda _f: self.adapters.exit(arec))
        self.tracer.finish(span.trace, "ok")
        self._register_stream(sid, name, sched, gen, imported=True)
        return 200, {"imported": True, "stream_id": sid, "model": name,
                     "watermark": gen.emitted_base, "dedup_pages": hits,
                     "copied_pages": copied}, {}

    async def handle_stream_attach(self, sid: str, body: bytes, headers: dict[str, str],
                                   reader: asyncio.StreamReader | None = None,
                                   query: str = "") -> Response:
        """``GET /admin/streams/{id}/attach?from=N``: the SSE of an imported
        stream from token N.  Tokens the client holds are never sent again;
        those it missed replay from the imported history, then the live
        tail streams as decode gives it."""
        entry = self.streams.get(sid)
        if entry is None:
            return _error(404, f"unknown stream {sid!r}")
        if not entry["imported"]:
            return _error(409, "attach takes imported streams; the original :generate "
                               "answer owns this one")
        if entry["attached"]:
            return _error(409, f"stream {sid!r} already has a consumer")
        gen, sched = entry["gen"], entry["sched"]
        try:
            start = max(0, int(parse_qs(query).get("from", [gen.emitted_base])[0]))
        except ValueError:
            return _error(400, "from must be an integer")
        entry["attached"] = True

        async def events(reader):
            try:
                # The imported history [start, emitted_base) is only in
                # ``tokens`` (it never entered the queue) ...
                for t in gen.tokens[start:gen.emitted_base]:
                    yield {"token": int(t)}
                # ... and every later token comes through the queue: skip
                # what the caller holds past the base.
                skip = max(0, start - gen.emitted_base)
                while True:
                    get = asyncio.ensure_future(gen.events.get())
                    ev = await _next_or_gone(get, reader) if reader is not None else await get
                    if ev is _GONE:
                        yield _GONE
                        return
                    if ev is None:
                        break
                    if skip > 0:
                        skip -= 1
                        continue
                    yield {"token": ev}
                if gen.migrated:
                    yield {"migrated": True, "stream_id": sid, "watermark": len(gen.tokens)}
                elif gen.done.exception() is not None:
                    yield {"error": str(gen.done.exception()), "stream_id": sid}
                else:
                    out = {"done": True, "tokens": list(gen.tokens)}
                    if sched.detokenize is not None:
                        out["text"] = sched.detokenize(gen.tokens)
                    yield out
            finally:
                entry["attached"] = False

        return 200, EventStream(events, lambda: sched.cancel(gen)), {"X-Stream-Id": sid}


def _release_device_memory(device: torch.device) -> None:
    """Collect what the dropped engine left and return the caching
    allocator's free blocks (on the dispatch thread, with no capture open)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class BackgroundServer:
    """A :class:`Server` on its own event-loop thread, as a context manager
    (``with BackgroundServer(cfg, engine) as s: ... s.port``) for scripts and
    tests that drive it over HTTP from the calling thread."""

    def __init__(self, cfg: ServeConfig, engine: Engine | None = None, host: str = "127.0.0.1",
                 port: int = 0, device=None):
        self.server = Server(cfg, engine, device)
        self._host, self._want_port = host, port
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="http-loop", daemon=True)
        self.port = 0

    def __enter__(self):
        self._thread.start()
        try:
            self.port = asyncio.run_coroutine_threadsafe(
                self.server.start(self._host, self._want_port), self._loop).result(90)
        except BaseException:
            # A refused boot (Server.start stopped what it started) leaves
            # no loop thread behind.
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=30)
            self._loop.close()
            raise
        return self

    def call(self, fn, *args, timeout: float = 60.0):
        """Run ``fn(*args)`` on the server's loop (awaited when it is a
        coroutine function) and return its result: the loop-confined state
        (drain, the watchdog) is touched from its own thread."""
        async def run():
            out = fn(*args)
            return await out if asyncio.iscoroutine(out) else out
        return asyncio.run_coroutine_threadsafe(run(), self._loop).result(timeout)

    def __exit__(self, *exc):
        try:
            asyncio.run_coroutine_threadsafe(self.server.stop(), self._loop).result(30)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=30)
            self._loop.close()


def run(cfg: ServeConfig, device=None) -> None:
    """Build the engine on ``device`` (CUDA unless asked otherwise) and serve
    until SIGINT or SIGTERM.  With ``drain_timeout_s > 0`` a SIGTERM drains
    first (new work 503, in-flight work given the budget); a second SIGTERM
    stops at once.  The server owns the engine, so a recovery or a reload
    frees the one it replaces."""
    server = Server(cfg, device=device)

    async def main():
        try:
            port = await server.start()
            log_event(log, "serving", host=cfg.host, port=port,
                      device=str(server.engine.device), models=sorted(server.engine.models))
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            loop.add_signal_handler(signal.SIGINT, stop.set)
            loop.add_signal_handler(signal.SIGTERM, server.on_sigterm, stop)
            await stop.wait()
        finally:
            await server.stop()

    asyncio.run(main())
