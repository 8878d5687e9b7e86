"""Request tracing: a span tree for every request, kept in process memory.

The port's copy of the JAX package's ``serving/tracing.py`` (standard
library only).  The rings and counters say that the server is slow; a trace
says where one request spent its time: admission, queue, batch formation,
the dispatch thread's execution, the answer, with shed, retry and breaker
decisions between them.  Spans are plain records, never exported over the
network:

- :class:`Span`: one timed stage, parented into a tree.  Timestamps are
  ``time.perf_counter()``, so stage durations line up with the stamps the
  batcher and the runner already take; the wall-clock anchor is the
  trace's.
- :class:`Trace`: one request's span tree.  Spans are appended from the
  event loop and from the dispatch thread (the ``exec`` span around a
  replay), so the append holds the trace's lock; the span budget
  (``max_spans``) bounds a pathological request (drops are counted, never
  raised).
- :class:`Tracer`: the server's hub.  Finished traces land in a bounded
  ring; a flight recorder also pins the N slowest and the recent errored
  traces of each model, so the trace that matters is still there after
  many healthy requests have rotated the ring.

W3C Trace Context (``traceparent``) is taken in and passed on: a request
arriving with ``traceparent: 00-<trace>-<span>-01`` joins the caller's
trace id and parents its root under the caller's span.  Answers carry
``X-Trace-Id`` (and error bodies ``trace_id``), so the id runs through the
logs (``utils/logging`` stamps ``current_trace_id`` on every record), the
metrics (exemplars on the queue and device histograms) and
``GET /admin/trace/{id}``.
"""

from __future__ import annotations

import re
import threading
import time
import uuid
from collections import deque

# 00-<16-byte trace id>-<8-byte span id>-<flags>, lowercase hex (W3C level 1).
_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """``(trace_id, parent_span_id)`` from a ``traceparent`` header, or None.

    Invalid headers are treated as absent (the W3C-mandated behavior is to
    restart the trace, not to fail the request); the all-zero trace/span
    ids are explicitly invalid per spec.
    """
    if not header:
        return None
    m = _TRACEPARENT.match(header.strip().lower())
    if m is None or m.group(1) == "ff":
        return None
    trace_id, span_id = m.group(2), m.group(3)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """The outbound ``traceparent`` for (trace, span) — always sampled."""
    return f"00-{trace_id}-{span_id}-01"


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed stage of a trace.  Usable as a context manager.

    ``start``/``end`` are ``perf_counter`` seconds; explicit values let
    instrumentation sites stitch spans to timestamps they already measured
    (``_Req.t_enq``, dispatch ``t_start``/``t_end``) so stage durations are
    contiguous and sum to the request wall time.
    """

    __slots__ = ("trace", "name", "span_id", "parent_id", "t0", "t1",
                 "status", "attrs", "recorded")

    def __init__(self, trace: "Trace", name: str, parent_id: str | None,
                 start: float | None = None, attrs: dict | None = None,
                 recorded: bool = True):
        self.trace = trace
        self.name = name
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.t0 = time.perf_counter() if start is None else start
        # One stage owns a span at a time (opened and ended by the same
        # instrumentation site, on whichever thread runs that stage); the
        # handoff between threads rides the awaited dispatch round-trip.
        self.t1: float | None = None  # guarded-by: dispatch-serialized
        self.status = "ok"            # guarded-by: dispatch-serialized
        self.attrs = dict(attrs) if attrs else {}
        self.recorded = recorded  # False once the trace's span budget is spent

    # -- lifecycle -----------------------------------------------------------
    def end(self, status: str | None = None, end: float | None = None,
            **attrs) -> "Span":
        if self.t1 is None:  # idempotent: first end wins
            self.t1 = time.perf_counter() if end is None else end
            if status is not None:
                self.status = status
            if attrs:
                self.attrs.update(attrs)
        return self

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def child(self, name: str, start: float | None = None, **attrs) -> "Span":
        """Open a child span (caller ends it)."""
        return self.trace.new_span(name, parent=self, start=start, attrs=attrs)

    def point(self, name: str, **attrs) -> "Span":
        """Zero-duration annotation span (a decision, not a stage)."""
        now = time.perf_counter()
        sp = self.trace.new_span(name, parent=self, start=now, attrs=attrs)
        sp.end(end=now)
        return sp

    @property
    def duration_ms(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return (end - self.t0) * 1000.0

    @property
    def traceparent(self) -> str:
        """Propagation header for work this span fans out."""
        return format_traceparent(self.trace.trace_id, self.span_id)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end(status="error" if exc_type is not None else None,
                 **({"error": f"{exc_type.__name__}: {exc}"}
                    if exc_type is not None else {}))


class Trace:
    """One request's span tree, with a wall-clock anchor and a span budget."""

    def __init__(self, trace_id: str, name: str, model: str | None = None,
                 max_spans: int = 512, parent_span_id: str | None = None,
                 attrs: dict | None = None, start: float | None = None):
        """``start`` back-dates the root span to a ``perf_counter`` stamp
        taken before the trace object existed (the moment a request was
        read), so the waterfall covers the whole request."""
        self.trace_id = trace_id
        self.name = name
        self.model = model
        self.max_spans = max_spans
        self.started_wall = time.time()
        self._t0 = time.perf_counter() if start is None else start
        self.finished = False                 # guarded-by: event-loop
        self.status = "open"                  # guarded-by: event-loop
        self.duration_ms: float | None = None  # guarded-by: event-loop
        self.dropped_spans = 0                # guarded-by: _lock
        self._lock = threading.Lock()  # spans append from the dispatch thread
        self.spans: list[Span] = []           # guarded-by: _lock
        # The root: parented under the caller's traceparent span if one came
        # in (its id is foreign — not in self.spans — which marks it remote).
        self.remote_parent = parent_span_id
        self.root = self.new_span(name, parent=None, start=start, attrs=attrs)

    def new_span(self, name: str, parent: Span | None,
                 start: float | None = None, attrs: dict | None = None) -> Span:
        parent_id = (parent.span_id if parent is not None
                     else self.remote_parent)
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped_spans += 1
                return Span(self, name, parent_id, start, attrs, recorded=False)
            sp = Span(self, name, parent_id, start, attrs)
            self.spans.append(sp)
            return sp

    def finish(self, status: str | None = None) -> "Trace":
        """Close the trace (idempotent): end the root, freeze the duration.

        Spans may still be appended afterwards (e.g. a watchdog requeue
        annotating a job trace post-mortem) — they show up in the tree but
        don't move the recorded duration.
        """
        if not self.finished:
            self.finished = True
            self.root.end(status=status)
            self.status = status or self.root.status
            with self._lock:
                # Close abandoned stage spans at the root's end (an error
                # return mid-stage): an open span must not keep "growing"
                # every time the tree is rendered.
                for s in self.spans:
                    if s.t1 is None:
                        s.t1 = max(self.root.t1, s.t0)
                last = max((s.t1 for s in self.spans if s.t1 is not None),
                           default=self.root.t1 or self._t0)
            self.duration_ms = round((last - self.root.t0) * 1000.0, 3)
        return self

    # -- export --------------------------------------------------------------
    def _span_dict(self, sp: Span) -> dict:
        out = {
            "name": sp.name,
            "span_id": sp.span_id,
            "start_ms": round((sp.t0 - self.root.t0) * 1000.0, 3),
            "duration_ms": round(sp.duration_ms, 3),
            "status": sp.status,
        }
        if sp.attrs:
            out["attrs"] = dict(sp.attrs)
        return out

    def tree(self) -> dict:
        """The nested span tree (children ordered by start time)."""
        with self._lock:
            spans = list(self.spans)
            dropped = self.dropped_spans
        nodes = {sp.span_id: self._span_dict(sp) for sp in spans}
        roots: list[dict] = []
        for sp in spans:
            node = nodes[sp.span_id]
            parent = nodes.get(sp.parent_id) if sp.parent_id else None
            if parent is None:
                roots.append(node)  # the root (or a remote-parented span)
            else:
                parent.setdefault("children", []).append(node)
        for node in nodes.values():
            if "children" in node:
                node["children"].sort(key=lambda n: n["start_ms"])
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "model": self.model,
            "status": self.status,
            "started": round(self.started_wall, 3),
            "duration_ms": (self.duration_ms if self.duration_ms is not None
                            else round((time.perf_counter() - self.root.t0)
                                       * 1000.0, 3)),
            "spans": len(spans),
            "dropped_spans": dropped,
            **({"remote_parent": self.remote_parent}
               if self.remote_parent else {}),
            "tree": roots[0] if len(roots) == 1 else {"name": "(forest)",
                                                      "children": roots},
        }

    def summary(self) -> dict:
        with self._lock:
            n_spans = len(self.spans)
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "model": self.model,
            "status": self.status,
            "started": round(self.started_wall, 3),
            "duration_ms": (self.duration_ms if self.duration_ms is not None
                            else round((time.perf_counter() - self.root.t0)
                                       * 1000.0, 3)),
            "spans": n_spans,
        }


class Tracer:
    """Per-server trace hub: live registry, ring buffer, flight recorder.

    - ``ring`` bounds the finished-trace history (FIFO eviction).
    - The flight recorder pins, per model: the ``flight_slow`` slowest
      traces (by duration) and the last ``flight_errors`` errored traces —
      the two populations a tail investigation actually needs, immune to
      ring churn from healthy traffic.
    - ``_live`` tracks open traces so an in-flight request is queryable;
      it is capped defensively (an abandoned trace must not leak forever).
    """

    def __init__(self, ring: int = 256, flight_slow: int = 8,
                 flight_errors: int = 32, max_spans: int = 512,
                 max_live: int = 4096):
        self._lock = threading.Lock()
        self._ring: deque[Trace] = deque(maxlen=max(int(ring), 1))  # guarded-by: _lock
        self.flight_slow = max(int(flight_slow), 0)
        self.flight_errors = max(int(flight_errors), 0)
        self.max_spans = max(int(max_spans), 8)
        self._max_live = max(int(max_live), 16)
        self._live: dict[str, Trace] = {}  # guarded-by: _lock
        self._slow: dict[str, list[Trace]] = {}      # guarded-by: _lock
        self._errored: dict[str, deque[Trace]] = {}  # guarded-by: _lock
        self.finished_total = 0      # guarded-by: _lock
        self.dropped_spans_total = 0  # guarded-by: _lock

    # -- lifecycle -----------------------------------------------------------
    def start(self, name: str, model: str | None = None,
              traceparent: str | None = None, start: float | None = None,
              **attrs) -> Span:
        """Open a trace; returns its root span (``span.trace`` is the trace).

        A valid ``traceparent`` joins the caller's trace id and parents the
        root under the caller's span; otherwise a fresh id is minted.
        ``start`` back-dates the root (see :class:`Trace`).
        """
        parsed = parse_traceparent(traceparent)
        trace_id, parent = parsed if parsed else (new_trace_id(), None)
        trace = Trace(trace_id, name, model=model, max_spans=self.max_spans,
                      parent_span_id=parent, attrs=attrs, start=start)
        with self._lock:
            if len(self._live) >= self._max_live:
                # Defensive: evict the oldest live trace (leaked = never
                # finished); finishing it keeps it inspectable in the ring.
                oldest = next(iter(self._live))
                self._record(self._live.pop(oldest).finish("abandoned"))
            self._live[trace.trace_id] = trace
        return trace.root

    def finish(self, trace: Trace, status: str | None = None) -> Trace:
        if trace.finished:  # idempotent: recorded exactly once
            return trace
        trace.finish(status)
        with self._lock:
            self._live.pop(trace.trace_id, None)
            self._record(trace)
        return trace

    def _record(self, trace: Trace):
        """Under the lock: ring append + flight-recorder pinning."""
        self.finished_total += 1
        self.dropped_spans_total += trace.dropped_spans
        self._ring.append(trace)
        model = trace.model or ""
        if trace.status == "error" and self.flight_errors:
            self._errored.setdefault(
                model, deque(maxlen=self.flight_errors)).append(trace)
        if self.flight_slow and trace.duration_ms is not None:
            slow = self._slow.setdefault(model, [])
            slow.append(trace)
            slow.sort(key=lambda t: -(t.duration_ms or 0.0))
            del slow[self.flight_slow:]

    # -- queries -------------------------------------------------------------
    def _all(self) -> list[Trace]:
        """Every known trace, deduped by id (live > ring > flight)."""
        seen: dict[str, Trace] = {}
        with self._lock:
            groups = [list(self._live.values()), list(self._ring),
                      *[list(d) for d in self._errored.values()],
                      *[list(v) for v in self._slow.values()]]
        for group in groups:
            for t in group:
                seen.setdefault(t.trace_id, t)
        return list(seen.values())

    def get(self, trace_id: str) -> Trace | None:
        with self._lock:
            t = self._live.get(trace_id)
        if t is not None:
            return t
        for t in self._all():
            if t.trace_id == trace_id:
                return t
        return None

    def list(self, model: str | None = None, status: str | None = None,
             min_ms: float = 0.0, limit: int = 50) -> list[dict]:
        """Finished+live trace summaries, newest first, filtered."""
        out = []
        for t in self._all():
            if model is not None and t.model != model:
                continue
            if status is not None and t.status != status:
                continue
            s = t.summary()
            if s["duration_ms"] is not None and s["duration_ms"] < min_ms:
                continue
            out.append(s)
        out.sort(key=lambda s: -s["started"])
        return out[: max(int(limit), 1)]

    def pinned(self) -> dict:
        """Flight-recorder census (for /metrics)."""
        with self._lock:
            return {"slow": {m: len(v) for m, v in self._slow.items() if v},
                    "errored": {m: len(v) for m, v in self._errored.items()
                                if v}}

    def snapshot(self) -> dict:
        with self._lock:
            live, ring = len(self._live), len(self._ring)
            finished = self.finished_total
            dropped = self.dropped_spans_total
        pins = self.pinned()
        return {"finished": finished,
                "live": live, "ring": ring,
                "dropped_spans": dropped,
                "pinned_slow": sum(pins["slow"].values()),
                "pinned_errored": sum(pins["errored"].values())}
