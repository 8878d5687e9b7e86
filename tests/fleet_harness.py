"""Shared pieces of the fleet tests: a stdlib fake replica both routers can
reach over HTTP, and a harness that runs either package's router on a
background event loop.

:class:`FakeReplica` is an ``http.server.ThreadingHTTPServer`` with just
enough of a replica's contract (the ``/healthz`` forecast block,
``/admin/models`` residency, predict, submit, job polls, the activation
route, ``:generate`` event streams, ``/metrics`` JSON with an SLO hub) to
drive every router path without an engine; the JAX package's
``tests/test_fleet.py`` fakes are aiohttp apps, this one is reachable from
the port's stdlib router and the JAX package's aiohttp router alike.

:class:`RouterHarness` starts one router (``"jax"``: the JAX package's
aiohttp app through an ``AppRunner``; ``"port"``: the port's
``FleetRouter.start``) on a loop thread of its own; requests go through
``http.client`` from the test's thread.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class FakeReplica:
    """Scripted replica: ``mode`` ok | overloaded | cold | error for
    predict; ``stream`` "ok" (tokens then done) or "die" (two tokens, then
    the connection reset) for ``:generate``; ``submit`` "ok" or "die" (the
    ``:submit`` is read and recorded, then the replica stops listening and
    resets the connection without an answer: a kill -9 after the journal
    took the job); ``slo`` an SLO hub whose
    health summary and snapshot ``/healthz`` and ``/metrics`` carry.  Every
    fake still open is closed with the next router harness."""

    live: list = []
    made = 0  # fakes made since the last harness closed: their job-id prefix

    def __init__(self, model="m", mode="ok", state="active", warm_ms=750.0, forecast_ms=0.0,
                 retry_after="3", wait_ms=None, activate_delay_s=0.0, stream="ok",
                 tokens=(7, 9, 11), slo=None, metrics_models=None, submit="ok",
                 activate_gate=None):
        self.model = model
        self.mode = mode
        self.state = state
        self.warm_ms = warm_ms
        self.forecast_ms = forecast_ms
        self.retry_after = retry_after
        self.wait_ms = wait_ms
        self.activate_delay_s = activate_delay_s
        # A threading.Event an activation waits on (up to 10 s) before it
        # answers: a scenario holds the activation open until it sets it.
        self.activate_gate = activate_gate
        self.stream = stream
        self.submit = submit
        self.tokens = list(tokens)
        self.slo = slo
        self.metrics_models = metrics_models
        self.predicts = 0
        self.generates = 0
        self.submits: list = []       # idempotency keys seen
        self.activations: list = []   # models the router asked to activate
        self.drains = 0
        self.jobs: dict[str, str] = {}  # key -> job id
        self._next_job = 0
        self.serial = FakeReplica.made
        FakeReplica.made += 1
        self._lock = threading.Lock()
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                fake._handle(self, "GET")

            def do_POST(self):
                fake._handle(self, "POST")

        class Quiet(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                pass  # a reset the test provoked, or a router that hung up

        self.httpd = Quiet(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        FakeReplica.live.append(self)

    def close(self):
        if self in FakeReplica.live:
            FakeReplica.live.remove(self)
            self.httpd.shutdown()
            self.httpd.server_close()

    # -- the handler ---------------------------------------------------------
    @staticmethod
    def _reply(h, status: int, obj, headers: dict | None = None):
        data = json.dumps(obj).encode()
        h.send_response(status)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(data)

    @staticmethod
    def _trace_headers(h) -> dict:
        parts = (h.headers.get("traceparent") or "").split("-")
        return {"X-Trace-Id": parts[1]} if len(parts) == 4 else {}

    def _handle(self, h, method: str):
        n = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(n) if n else b""
        path = h.path.split("?")[0]
        corr = self._trace_headers(h)
        if method == "GET" and path == "/healthz":
            out = {"device_ok": True, "draining": False, "quarantined": [],
                   "forecast": {self.model: self.forecast_ms}, "jobs_backlog": 0}
            if self.slo is not None:
                out["slo"] = self.slo.health_summary()
            return self._reply(h, 200, out)
        if method == "GET" and path == "/admin/models":
            return self._reply(h, 200, {"models": {self.model: {
                "state": self.state, "pinned": False, "estimated_warm_ms": self.warm_ms}}})
        if method == "GET" and path == "/metrics":
            if self.slo is None:
                return self._reply(h, 200, {"models": {}})
            return self._reply(h, 200, {"models": self.metrics_models or {},
                                        "slo": self.slo.snapshot()})
        if method == "POST" and path.startswith("/admin/models/"):
            req = json.loads(body or b"{}")
            if req.get("action") == "activate":
                with self._lock:
                    self.activations.append(path.rsplit("/", 1)[1])
                if self.activate_gate is not None:
                    self.activate_gate.wait(10.0)
                if self.activate_delay_s:
                    time.sleep(self.activate_delay_s)
                elif self.activate_gate is None:
                    self.state = "active"
            return self._reply(h, 200, {"action": req.get("action")})
        if method == "POST" and path == "/admin/drain":
            self.drains += 1
            return self._reply(h, 200, {"drained": True})
        if method == "POST" and path.endswith(":predict"):
            with self._lock:
                self.predicts += 1
            name = path[len("/v1/models/"):-len(":predict")]
            if self.mode == "cold":
                return self._reply(h, 503, {"error": "cold start", "cold_start": True,
                                            "estimated_warm_ms": self.warm_ms},
                                   {"Retry-After": self.retry_after, **corr})
            if self.mode == "overloaded":
                out = {"error": "overloaded"}
                if self.wait_ms is not None:
                    out["estimated_wait_ms"] = self.wait_ms
                return self._reply(h, 429, out, {"Retry-After": self.retry_after, **corr})
            if self.mode == "error":
                return self._reply(h, 500, {"error": "boom"}, corr)
            return self._reply(h, 200, {"model": name, "predictions": [1],
                                        "timing": {"queue_ms": 0.1, "device_ms": 0.2}}, corr)
        if method == "POST" and path.endswith(":submit"):
            key = h.headers.get("Idempotency-Key")
            with self._lock:
                self.submits.append(key)
                if self.submit == "die":
                    return self._die(h)
                if key is not None and key in self.jobs:
                    return self._reply(h, 200, {"job": {"id": self.jobs[key], "status": "done"},
                                                "deduped": True}, corr)
                jid = f"job-{self.serial}-{self._next_job}"
                self._next_job += 1
                self.jobs[key if key is not None else jid] = jid
            return self._reply(h, 202, {"job": {"id": jid, "status": "queued"}}, corr)
        if method == "GET" and path.startswith("/v1/jobs/"):
            jid = path.rsplit("/", 1)[1]
            if jid in self.jobs.values() or jid in self.jobs:
                return self._reply(h, 200, {"job": {"id": jid, "status": "done"}})
            return self._reply(h, 404, {"error": "unknown job id"})
        if method == "POST" and path.endswith(":generate"):
            return self._generate(h, corr)
        return self._reply(h, 404, {"error": f"no route {path}"})

    def _die(self, h):
        """Stop listening (a reconnect is refused), then reset this
        connection with nothing answered."""
        self.httpd.shutdown()
        self.httpd.server_close()
        h.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        h.connection.close()
        h.close_connection = True

    def _generate(self, h, corr: dict):
        with self._lock:
            self.generates += 1
        if self.mode in ("overloaded", "cold"):
            extra = {"cold_start": True, "estimated_warm_ms": self.warm_ms} \
                if self.mode == "cold" else {}
            return self._reply(h, 429 if self.mode == "overloaded" else 503,
                               {"error": self.mode, **extra}, {"Retry-After": self.retry_after})
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Transfer-Encoding", "chunked")
        h.send_header("X-Stream-Id", "s-1")
        for k, v in corr.items():
            h.send_header(k, v)
        h.end_headers()

        def chunk(data: bytes):
            h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            h.wfile.flush()

        if self.stream == "die":
            chunk(b'data: {"token": 7}\n\ndata: {"token": 9}\n\n')
            time.sleep(0.05)
            # The replica dies: the connection reset, no terminal event.
            h.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))
            h.connection.close()
            h.close_connection = True
            return
        for t in self.tokens:
            chunk(f'data: {{"token": {t}}}\n\n'.encode())
        chunk(f'data: {{"done": true, "tokens": {json.dumps(self.tokens)}}}\n\n'.encode())
        chunk(b"")  # the last chunk


class Reply:
    """One answer as the test thread saw it."""

    def __init__(self, status: int, headers, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def header(self, name: str):
        return self.headers.get(name)

    def json(self):
        return json.loads(self.body)


class RouterHarness:
    """One router (``kind`` "jax" or "port") in front of ``fakes``, on a
    loop thread of its own."""

    def __init__(self, kind: str, fakes: list, router_kw: dict | None = None, **cfg_kw):
        self.kind = kind
        self.fakes = fakes
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()
        base = dict(poll_interval_s=0.0, failover_backoff_ms=0.0, connect_timeout_s=1.0,
                    quarantine_after=2, breaker_threshold=0.5, breaker_min_samples=4)
        base.update(cfg_kw)
        base["replicas"] = [f.url for f in fakes]
        if kind == "jax":
            from pytorch_zappa_serverless_tpu.config import FleetConfig
            from pytorch_zappa_serverless_tpu.serving.fleet import FleetRouter
        else:
            from pytorch_zappa_serverless_tpu_torch.config import FleetConfig
            from pytorch_zappa_serverless_tpu_torch.serving.fleet import FleetRouter
        self.router = FleetRouter(FleetConfig(**base), **(router_kw or {}))
        self._runner = None
        self.port = self.call(self._start())
        self.poll()

    async def _start(self) -> int:
        if self.kind == "port":
            return await self.router.start("127.0.0.1", 0)
        from aiohttp import web

        self._runner = web.AppRunner(self.router.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        return site._server.sockets[0].getsockname()[1]

    async def _stop(self):
        if self.kind == "port":
            await self.router.stop()
        else:
            await self._runner.cleanup()

    def call(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def run(self, fn, timeout: float = 30.0):
        """``fn()`` on the router's loop (state the loop owns)."""
        async def go():
            return fn()
        return self.call(go(), timeout)

    def poll(self):
        self.call(self.router.poll_once())

    def rid_of(self, fake) -> str:
        for rid, r in self.router.registry.replicas.items():
            if r.url == fake.url:
                return rid
        raise KeyError(fake.url)

    def req(self, method: str, path: str, body: bytes | None = None, json_body=None,
            headers: dict | None = None, timeout: float = 30.0) -> Reply:
        hdrs = dict(headers or {})
        if json_body is not None:
            body = json.dumps(json_body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            return Reply(resp.status, resp.headers, data)
        finally:
            conn.close()

    def close(self):
        try:
            self.call(self._stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(10)
            self.loop.close()
            for fake in list(FakeReplica.live):
                fake.close()
            FakeReplica.made = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
