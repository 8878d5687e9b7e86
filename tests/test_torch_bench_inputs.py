"""The plane sections send the reference's requests: the same paths, bodies,
payload images, headers and order, for the same seeds.

Each package's section runs against one scripted transport that answers
every route at once (no model is built: each package's ``build_engine``
and server are stubbed, the reference's aiohttp ``TestClient`` and the
port's ``_Client`` replaced), records the first ``limit`` requests, and
stops the section at the last of them.  A PNG body compares by its decoded pixels
(the reference encodes with Pillow, the port with its own encoder), a JSON
body by its value.  The replay traces are held to the reference's by
``tests/test_torch_bench_wiring.py``.
"""

import asyncio
import base64
import io
import json
import types

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu_torch import benchmark as B


class _Stop(Exception):
    """The transport has recorded its ``limit``."""


def _norm_body(body, ctype: str):
    if isinstance(body, (dict, list)):
        if isinstance(body, dict) and "b64" in body:  # a PNG inside JSON
            return ("json", {**body, "b64": _norm_body(base64.b64decode(body["b64"]), "")})
        return ("json", body)
    if body is None:
        return None
    body = bytes(body)
    if body[:8] == b"\x89PNG\r\n\x1a\n":
        from PIL import Image

        px = np.asarray(Image.open(io.BytesIO(body)))
        return ("png", px.shape, px.tobytes())
    if "json" in ctype:
        return _norm_body(json.loads(body), "")
    return ("bytes", body)


_KEPT = ("content-type", "x-adapter", "x-deadline-ms", "x-objective-max-latency-ms")


class Transport:
    """Scripted answers for every route a section calls; records requests."""

    def __init__(self, limit: int):
        self.limit = limit
        self.seen: list[tuple] = []

    def record(self, method, path, body=None, json_body=None, headers=None):
        if len(self.seen) >= self.limit:
            raise _Stop
        headers = {k.lower(): str(v) for k, v in (headers or {}).items()}
        if json_body is not None:
            headers.setdefault("content-type", "application/json")
            body = json_body
        ctype = headers.get("content-type", "")
        self.seen.append((method, path, _norm_body(body, ctype),
                          {k: v for k, v in headers.items() if k in _KEPT}))
        if len(self.seen) >= self.limit:
            raise _Stop

    @staticmethod
    def answer(method, path) -> tuple[int, dict, dict]:
        hdrs = {"X-Trace-Id": "t1", "X-Fleet-Replica": "r0"}
        if path.endswith(":submit"):
            return 202, {"job": {"id": "j1"}}, hdrs
        if path.startswith("/v1/jobs/"):
            return 200, {"job": {"id": "j1", "status": "done"}}, hdrs
        if path.startswith("/admin/models/"):
            return 200, {"model": {"last_activation_ms": 5.0, "tier": "none", "state": "cold",
                                   "last_activation_phases": {"load_ms": 1.0, "compile_ms": 1.0,
                                                              "streamed": True}}}, hdrs
        if path.startswith("/admin/adapters/"):
            return 200, {"adapter": {"last_attach_ms": 2.0}}, hdrs
        if path == "/admin/perf":
            return 200, {"loop_lag": {"max_ms": 0.0}, "ingest": {}}, hdrs
        if path == "/metrics":
            return 200, {"generation": {"gpt2": {"kv": {"blocks_used": 1, "utilization": 0.1},
                                                 "prefix": {}, "mode": "slot"}}}, hdrs
        return 200, {"timing": {"queue_ms": 1.0, "device_ms": 1.0, "total_ms": 2.0,
                                "batch_size": 1}, "predictions": {}}, hdrs


SSE = [{"token": 1}, {"done": True, "stats": {}}]


# -- the reference's side: aiohttp's TestClient replaced ---------------------------------

class _RefResp:
    def __init__(self, status, body, headers):
        self.status, self._body, self.headers = status, body, headers

        async def lines():
            for ev in SSE:
                yield f"data: {json.dumps(ev)}\n".encode()
        self.content = lines()

    async def json(self):
        return self._body

    async def text(self):
        return json.dumps(self._body)

    async def read(self):
        return json.dumps(self._body).encode()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return None


class _RefReq:
    def __init__(self, t, method, path, data=None, json=None, headers=None):
        self.t, self.args = t, (method, path, data, json, headers)

    def _resp(self):
        method, path, data, json_body, headers = self.args
        self.t.record(method, path, data, json_body, headers)
        return _RefResp(*Transport.answer(method, path))

    def __await__(self):
        async def go():
            return self._resp()
        return go().__await__()

    async def __aenter__(self):
        return self._resp()

    async def __aexit__(self, *exc):
        return None


def _ref_client(t: Transport):
    class TestServer:
        def __init__(self, app):
            self.app = app

        def make_url(self, p):
            return f"http://fake{p}"

    class TestClient:
        def __init__(self, server):
            self.server = server

        async def __aenter__(self):
            return self

        async def __aexit__(self, *exc):
            return None

        async def start_server(self):
            return None

        async def close(self):
            return None

        def post(self, path, data=None, json=None, headers=None):
            return _RefReq(t, "POST", path, data, json, headers)

        def get(self, path):
            return _RefReq(t, "GET", path)

    return TestClient, TestServer


# -- the port's side: _Client and the server replaced -------------------------------------

def _port_client(t: Transport):
    class Client:
        def __init__(self, port):
            self.base, self.pool = "http://fake", None

        async def post(self, path, data=None, json=None, headers=None):
            t.record("POST", path, data, json, headers)
            status, body, hdrs = Transport.answer("POST", path)
            return B._Answer(status, {k.lower(): v for k, v in hdrs.items()},
                             __import__("json").dumps(body).encode())

        async def get(self, path):
            t.record("GET", path)
            status, body, hdrs = Transport.answer("GET", path)
            return B._Answer(status, {k.lower(): v for k, v in hdrs.items()},
                             __import__("json").dumps(body).encode())

        async def events(self, path, body):
            t.record("POST", path, None, body, None)

            async def it():
                for ev in SSE:
                    yield ev
            return 200, it()

        async def close(self):
            return None

    return Client


class _Busy:
    """SD-1.5's run stats, moving at every read: the job stream is live."""

    def __init__(self):
        self.batches, self._n = 0, 0

    @property
    def chunks(self):
        self._n += 1
        return self._n


class _Runner:
    def __init__(self):
        self.stats = {"sd15": _Busy()}
        self.faults = types.SimpleNamespace(configure=lambda **k: None, clear=lambda: None)

    def set_priority(self, on):
        return None

    def lane_stats(self):
        return {}

    def resident_bytes(self):
        return {}


class _Engine:
    def __init__(self, *a, **k):
        self.runner = _Runner()
        self.device = types.SimpleNamespace(type="cpu")
        self._meta = {"chunked": {"num_chunks": 5}}

    def model(self, name):
        return types.SimpleNamespace(servable=types.SimpleNamespace(meta=self._meta))

    def shutdown(self):
        return None


class _Srv:
    def __init__(self, *a, **k):
        self.port = 0
        self.server = types.SimpleNamespace(engine=_Engine())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


@pytest.fixture
def fakes(monkeypatch):
    """Patch both packages' transports; returns ``capture(run, limit)``."""
    import aiohttp.test_utils

    from pytorch_zappa_serverless_tpu import benchmark as JB
    from pytorch_zappa_serverless_tpu.engine import loader as jloader
    from pytorch_zappa_serverless_tpu.serving import server as jserver
    from pytorch_zappa_serverless_tpu_torch.engine import loader as ploader

    monkeypatch.setattr(JB, "_relay_floor_ms", lambda iters=10: 0.0)
    monkeypatch.setattr(jloader, "build_engine", lambda *a, **k: _Engine())
    monkeypatch.setattr(jserver, "create_app", lambda *a, **k: object())
    monkeypatch.setattr(jserver, "Server", lambda *a, **k: types.SimpleNamespace(
        app=object(), engine=_Engine()))
    monkeypatch.setattr(ploader, "build_engine", lambda *a, **k: _Engine())
    monkeypatch.setattr(B, "_serve", lambda *a, **k: _Srv())
    monkeypatch.setattr(B, "_launch_record", lambda before, device: {})

    def capture(run, limit: int, port: bool) -> list:
        t = Transport(limit)
        if port:
            monkeypatch.setattr(B, "_Client", _port_client(t))
        else:
            client, server = _ref_client(t)
            monkeypatch.setattr(aiohttp.test_utils, "TestClient", client)
            monkeypatch.setattr(aiohttp.test_utils, "TestServer", server)
        try:
            run()
        except _Stop:
            pass
        assert len(t.seen) == limit, t.seen
        return t.seen

    return JB, capture


CASES = {
    # name: (reference call, port call, env, requests held)
    "mixed_path": (lambda JB: JB.bench_mixed_path(n_latency=3),
                   lambda: B.bench_mixed_path(n_latency=3, device="cpu"), {}, 2 + 6 + 1),
    "trace_path": (lambda JB: JB.bench_trace_path(n_requests=4, concurrency=2),
                   lambda: B.bench_trace_path(n_requests=4, concurrency=2, device="cpu"), {},
                   1 + 4 + 4),
    "serverpath": (lambda JB: JB.bench_serverpath(),
                   lambda: B.bench_serverpath(device="cpu"), {"BENCH_SERVERPATH_TINY": "1"},
                   # off, on (+ 12 traces and the perf read), three lanes
                   13 + 13 + 12 + 1 + 3 * 13),
    "lifecycle": (lambda JB: JB.bench_lifecycle(trials=2, steady_requests=3),
                  lambda: B.bench_lifecycle(trials=2, steady_requests=3, device="cpu"), {},
                  4 + 1 + 4 + 1 + 3),
    "adapters": (lambda JB: JB.bench_adapters(n_requests=4),
                 lambda: B.bench_adapters(n_requests=4, device="cpu"),
                 {"BENCH_ADAPTERS_TINY": "1"}, 1 + 12 + 4 + 4 + 1 + 3 + 1),
    "generation_v2": (lambda JB: JB.bench_generation_v2(),
                      lambda: B.bench_generation_v2(device="cpu"),
                      {"BENCH_GENERATION_TINY": "1"}, 3 + 10),
    "prefix": (lambda JB: JB.bench_prefix(), lambda: B.bench_prefix(device="cpu"),
               {"BENCH_PREFIX_TINY": "1", "BENCH_PREFIX_REQS": "4"}, 2 + 1 + 4 + 2 + 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_section_requests_are_the_references(fakes, monkeypatch, name):
    JB, capture = fakes
    ref_run, port_run, env, limit = CASES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if name == "generation_v2":
        # The measured load's poller reads /metrics on its own clock: hold
        # the request streams alone.
        limit = 3 + 8 + 2
    extra = 0
    if name == "lifecycle":
        # The reference's warm_cache tier (populate, unload, then an
        # activate and unload a trial) has no counterpart: no compile cache.
        extra = 2 + 2 * 2
    want = capture(lambda: ref_run(JB), limit + extra, port=False)
    if extra:
        assert [r[2][1]["action"] for r in want[4:4 + extra]] == ["activate", "unload"] * 3
        want = want[:4] + want[4 + extra:]
    got = capture(port_run, limit, port=True)
    if name == "generation_v2":
        want = [r for r in want if r[1] != "/metrics"]
        got = [r for r in got if r[1] != "/metrics"]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[2] == w[2], (name, i, g[1])
        assert g[3] == w[3], (name, i, g[1], g[3], w[3])


def test_disagg_streams_are_the_references(fakes, monkeypatch):
    """``disagg`` drives three pools, no client: the samples it submits (the
    warm-up pair a pool, then the colocated streams) are the reference's."""
    from pytorch_zappa_serverless_tpu.serving import generation as jgen
    from pytorch_zappa_serverless_tpu_torch.serving import generation as pgen

    JB, _ = fakes
    monkeypatch.setenv("BENCH_DISAGG_TINY", "1")

    def run(mod_gen, call, engine_patch):
        seen = []

        class Sched:
            def __init__(self, *a):
                pass

            def start(self):
                return self

            def submit(self, sample):
                seen.append(sample["input_ids"])
                if len(seen) >= 6 + 3:
                    raise _Stop
                fut = asyncio.get_running_loop().create_future()
                fut.set_result([1])
                return types.SimpleNamespace(done=fut, tokens=[1])

            async def stop(self):
                return None

        monkeypatch.setattr(mod_gen, "PagedGenerationScheduler", Sched)
        engine_patch()
        try:
            call()
        except _Stop:
            pass
        return seen

    def cm_engine(*a, **k):
        e = _Engine()
        e.model = lambda name: types.SimpleNamespace(
            servable=types.SimpleNamespace(preprocess=lambda p: dict(p)))
        return e

    from pytorch_zappa_serverless_tpu.engine import loader as jloader
    from pytorch_zappa_serverless_tpu_torch.engine import loader as ploader

    want = run(jgen, JB.bench_disagg,
               lambda: monkeypatch.setattr(jloader, "build_engine", cm_engine))
    got = run(pgen, lambda: B.bench_disagg(device="cpu"),
              lambda: monkeypatch.setattr(ploader, "build_engine", cm_engine))
    assert len(want) == 9 and [list(x) for x in got] == [list(x) for x in want]


@pytest.mark.parametrize("size", [48, 64, 224])
def test_payload_images_are_the_references(size):
    """The PNG every image section posts is the reference's Pillow image of
    the same seeded pixels."""
    from PIL import Image

    rng = np.random.default_rng(0)
    want = rng.integers(0, 256, (size, size, 3), np.uint8)
    got = np.asarray(Image.open(io.BytesIO(B._png(size))))
    np.testing.assert_array_equal(got, want)
