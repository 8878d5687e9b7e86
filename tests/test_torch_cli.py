"""The port's command line: its admin tables against the JAX package's.

``list-models`` prints the port's registry; ``models``, ``adapters``,
``prefix``, ``slo``, ``autoscale`` and ``perf`` render the same payload as
the same string in both packages (payloads built from a numpy seed, and
real snapshots of the SLO hub, the autoscaler and the perf plane); each
subcommand is an HTTP client of its route on a running server (a stub
answers here) and ``--json`` prints the body.  ``profile`` posts to
``/debug/trace``; ``tail`` prints the same lines as the reference's over
one log file, filter by filter; ``warm`` builds a tiny profile on the CPU.
"""

import http.server
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu import cli as jcli
from pytorch_zappa_serverless_tpu.serving import slo as JS
from pytorch_zappa_serverless_tpu_torch import cli as pcli
from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch.serving import autoscale as PA
from pytorch_zappa_serverless_tpu_torch.serving import perfplane as PP
from pytorch_zappa_serverless_tpu_torch.serving import slo as PS
from pytorch_zappa_serverless_tpu_torch.utils.registry import list_models


def _num(rng, lo=0.0, hi=1e6):
    return float(np.round(rng.uniform(lo, hi), 3))


def _models_payload(rng) -> dict:
    models = {}
    for i in range(int(rng.integers(1, 6))):
        m = {"state": ["active", "cold", "warming", "draining_idle"][int(rng.integers(0, 4))],
             "tier": ["device", "host", "disk", "none"][int(rng.integers(0, 4))],
             "pinned": bool(rng.random() < 0.2), "hbm_bytes": int(rng.integers(0, 1 << 30)),
             "host_bytes": int(rng.integers(0, 1 << 28)), "disk_bytes": int(rng.integers(0, 1 << 28)),
             "last_used_s_ago": _num(rng, 0, 500), "activations": int(rng.integers(0, 9)),
             "estimated_warm_ms": _num(rng, 0, 20000)}
        if rng.random() < 0.6:
            m["family"] = ["g", "r"][int(rng.integers(0, 2))]
            m["quality_rank"] = int(rng.integers(0, 3))
        models[f"m{i}"] = m
    out = {"models": models}
    if rng.random() < 0.5:
        out["ckpt_store"] = {"manifests": 3, "physical_bytes": int(rng.integers(0, 1 << 30)),
                             "logical_bytes": int(rng.integers(0, 1 << 31)),
                             "dedup_ratio": _num(rng, 1, 3), "degraded_loads_total": 1}
    if rng.random() < 0.7:
        out["hbm_bytes_total"] = int(rng.integers(0, 1 << 33))
        out["hbm_budget_bytes"] = int(rng.choice([0, 1 << 32]))
    return out


def _adapters_payload(rng) -> dict:
    models = {}
    for b in ("gpt2", "g2")[: int(rng.integers(1, 3))]:
        models[b] = {f"t{j}": {"state": ["active", "cold"][int(rng.integers(0, 2))],
                               "slot": None if rng.random() < 0.4 else int(rng.integers(1, 4)),
                               "tenants": [f"u{k}" for k in range(int(rng.integers(0, 3)))],
                               "hbm_bytes": int(rng.integers(0, 1 << 20)),
                               "last_used_s_ago": _num(rng, 0, 60),
                               "attaches": int(rng.integers(0, 5)),
                               "served": int(rng.integers(0, 50)),
                               "estimated_attach_ms": _num(rng, 0, 900)}
                     for j in range(int(rng.integers(1, 4)))}
    out = {"models": models}
    if rng.random() < 0.7:
        out["multi_adapter_batches"] = int(rng.integers(0, 9))
    return out


def _prefix_payload(rng) -> dict:
    return {"models": {f"m{i}": {"nodes": int(rng.integers(0, 90)),
                                 "pages": int(rng.integers(0, 90)),
                                 "hits": int(rng.integers(0, 90)),
                                 "misses": int(rng.integers(0, 90)),
                                 "hit_rate": _num(rng, 0, 1),
                                 "cow_copies": int(rng.integers(0, 9)),
                                 "evictions": int(rng.integers(0, 9)),
                                 "reclaimable_pages": int(rng.integers(0, 9)),
                                 "kv_shared_blocks": int(rng.integers(0, 9))}
                       for i in range(int(rng.integers(0, 4)))}}


def _slo_payload(rng) -> dict:
    clock = [100.0]
    hub = PS.SLOHub(PC.ServeConfig(slo={"m": {"latency_objective_ms": 10.0,
                                              "availability_target": 0.99}}),
                    clock=lambda: clock[0])
    for _ in range(int(rng.integers(1, 60))):
        hub.observe(["m", "g"][int(rng.integers(0, 2))],
                    ["predict", "generate"][int(rng.integers(0, 2))],
                    int(rng.choice([200, 200, 429, 500])), _num(rng, 0, 40),
                    degraded=bool(rng.random() < 0.2),
                    adapter=None if rng.random() < 0.6 else "t1")
        clock[0] += _num(rng, 0, 5)
    hub.usage.note_stream("m", "t1", _num(rng, 0, 90), _num(rng, 0, 9), int(rng.integers(0, 64)))
    hub.usage.note_attach("m", "t1", _num(rng, 0, 20))
    hub.usage.note_request("g", None, _num(rng, 0, 20))
    snap = hub.snapshot()
    return snap if rng.random() < 0.5 else JS.merge_slo_snapshots([snap, snap])


def _autoscale_payload(rng) -> dict:
    clock = [0.0]
    plane = PA.AutoscalePlane(PC.ServeConfig(autoscale_min_history=2),
                              clock=lambda: clock[0])
    plane.bind(residency_fn=lambda k: "cold", estimate_warm_ms_fn=lambda k: 300.0,
               resident_bytes_fn=lambda: 0)
    for _ in range(int(rng.integers(0, 30))):
        clock[0] += _num(rng, 0.1, 3)
        plane.note_arrival(["m", "n"][int(rng.integers(0, 2))],
                           None if rng.random() < 0.7 else "t1")
    plane.prewarms_by_cause["m"] = {"predicted": int(rng.integers(0, 3))}
    if rng.random() < 0.3:
        plane._degraded_until = clock[0] + 7.5
    return plane.snapshot()


def _perf_payload(rng) -> dict:
    now = [0.0]
    perf = PP.PerfPlane(PC.ServeConfig())
    perf.loop_lag = PP.LoopLagSampler(interval_s=0.25, clock=lambda: now[0])
    perf.loop_lag.arm()
    for _ in range(int(rng.integers(0, 20))):
        now[0] += 0.25 + _num(rng, 0, 0.05)
        perf.loop_lag.note()
    for _ in range(int(rng.integers(0, 60))):
        perf.note_stage(["bert_base", "resnet50"][int(rng.integers(0, 2))],
                        PP.INGEST_STAGES[int(rng.integers(0, len(PP.INGEST_STAGES)))],
                        _num(rng, 0, 40))
    frame = None
    for i in range(int(rng.integers(1, 40))):
        frame = SimpleNamespace(f_code=SimpleNamespace(co_filename=f"/srv/m{i % 7}.py",
                                                       co_name=f"f{i}"), f_back=frame)
        perf.stacks._frames = lambda frame=frame: {1: frame}
        perf.stacks.sample_once(_num(rng, 0, 0.2))
    stats = {"bert_base": SimpleNamespace(samples=0, batches=0, device_seconds=0.0)}
    perf.runner_stats = lambda: stats
    perf.gen_snapshots = lambda: {"gpt2": {"tokens_emitted": int(now[0] * 10),
                                           "segment_rounds": int(now[0])}}
    perf.observe_models(now=0.0)
    stats["bert_base"] = SimpleNamespace(samples=int(rng.integers(1, 900)),
                                         batches=int(rng.integers(1, 90)),
                                         device_seconds=_num(rng, 0, 3))
    now[0] += 5.0
    perf.observe_models(now=10.0)
    perf.flops_hint = lambda m: 22.3e9
    perf.peak_flops = 989.4e12
    snap = perf.snapshot(top_stacks=int(rng.integers(1, 12)))
    snap["models"].setdefault("gpt2:generate", {})["ttft_p50_ms"] = _num(rng, 1, 300)
    return snap


PAYLOADS = {"format_models_table": _models_payload,
            "format_adapters_table": _adapters_payload,
            "format_prefix_table": _prefix_payload,
            "format_slo_table": _slo_payload,
            "format_autoscale_table": _autoscale_payload,
            "format_perf_table": _perf_payload}


@pytest.mark.parametrize("fmt", sorted(PAYLOADS))
@pytest.mark.parametrize("seed", range(3))
def test_tables_are_string_equal_to_the_reference(fmt, seed):
    payload = json.loads(json.dumps(PAYLOADS[fmt](np.random.default_rng(seed))))
    got = getattr(pcli, fmt)(payload)
    assert got == getattr(jcli, fmt)(payload)
    assert got.splitlines()[0].split()[0] in ("FAMILY", "MODEL", "KEY", "loop")


def test_list_models_prints_the_registry(capsys):
    assert pcli.main(["list-models"]) == 0
    assert capsys.readouterr().out.split() == list_models()


@pytest.mark.parametrize("cmd,route", [("models", "/admin/models"),
                                       ("adapters", "/admin/adapters"),
                                       ("prefix", "/admin/prefix"), ("slo", "/admin/slo"),
                                       ("autoscale", "/admin/autoscale"),
                                       ("perf", "/admin/perf?top=20")])
def test_admin_subcommands_get_their_route(cmd, route, capsys):
    payload = {"models": {}}
    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(self.path)
            data = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert pcli.main([cmd, "--url", url]) == 0
        table = capsys.readouterr().out
        assert table.rstrip("\n") == pcli.ADMIN_TABLES[cmd][1](payload)
        assert pcli.main([cmd, "--url", url, "--json"]) == 0
        assert json.loads(capsys.readouterr().out) == payload
    finally:
        httpd.shutdown()
        t.join(5)
    assert seen == [route, route]


def test_perf_top_rides_the_query():
    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(self.path)
            data = b'{"models": {}}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert pcli.main(["perf", "--url", f"http://127.0.0.1:{httpd.server_address[1]}",
                          "--top", "3"]) == 0
    finally:
        httpd.shutdown()
        t.join(5)
    assert seen == ["/admin/perf?top=3"]


def test_profile_posts_the_window_to_debug_trace(capsys):
    seen = []
    answer = {"dir": "/tmp/x", "seconds": 0.5, "files": ["trace.json"]}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            seen.append((self.path, json.loads(self.rfile.read(n))))
            data = json.dumps(answer).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert pcli.main(["profile", "--url", f"http://127.0.0.1:{httpd.server_address[1]}",
                          "--seconds", "0.5"]) == 0
    finally:
        httpd.shutdown()
        t.join(5)
    assert seen == [("/debug/trace", {"seconds": 0.5})]
    assert json.loads(capsys.readouterr().out) == answer


LOG_LINES = [
    {"ts": 1760000000.125, "level": "info", "logger": "serving.server", "msg": "server ready",
     "port": 8000},
    {"ts": 1760000001.5, "level": "warning", "logger": "serving.batcher", "msg": "retry",
     "trace_id": "ab" * 16, "attempt": 1},
    {"ts": 1760000002.0, "level": "error", "logger": "serving.server", "msg": "request error",
     "trace_id": "cd" * 16, "status": 500},
    {"ts": "2026-10-18T07:00:00Z", "level": "info", "logger": "proxy", "msg": "foreign ts",
     "trace_id": "ab" * 16},
    {"ts": 1760000003.0, "level": "debug", "logger": "serving.jobs", "msg": "tick"},
]


@pytest.mark.parametrize("flags", [[], ["--level", "warning"], ["--level", "debug"],
                                   ["--grep", "request"], ["--trace", "ab" * 16],
                                   ["--level", "error", "--trace", "cd" * 16]])
def test_tail_prints_the_references_lines(tmp_path, capsys, flags):
    path = tmp_path / "serve.log"
    path.write_text("\n".join([json.dumps(r) for r in LOG_LINES] + ["not json at all", ""]))
    assert pcli.main(["tail", str(path), *flags]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["tail", str(path), *flags]) == 0
    assert got == capsys.readouterr().out
    if flags and flags[0] == "--trace":
        # The two records of the trace (one with a foreign ts, shown as it
        # is) and the line that is no record, which no filter drops.
        assert got.count("\n") == 3 and "2026-10-18T07:00:00Z" in got
        assert got.splitlines()[-1] == "not json at all"


def test_tail_without_a_file(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("TPUSERVE_LOG_FILE", raising=False)
    assert pcli.main(["tail"]) == 2
    assert pcli.main(["tail", str(tmp_path / "missing.log")]) == 2
    monkeypatch.setenv("TPUSERVE_LOG_FILE", str(tmp_path / "env.log"))
    (tmp_path / "env.log").write_text(json.dumps(LOG_LINES[0]) + "\n")
    capsys.readouterr()
    assert pcli.main(["tail"]) == 0
    assert "server ready" in capsys.readouterr().out


def test_warm_builds_every_bucket_on_the_cpu_and_exits(tmp_path, capsys):
    arch = {"num_layers": 1, "num_heads": 2, "head_dim": 16, "mlp_dim": 64, "vocab_size": 512}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"models": [{"name": "bert_base", "seq_buckets": [16],
                                            "batch_buckets": [1, 2], "dtype": "float32",
                                            "extra": {"arch": arch}}]}))
    assert pcli.main(["warm", "--config", str(path), "--platform", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"cold_start_seconds", "compile_seconds", "executables", "models"}
    assert set(out["models"]) == {"bert_base"} and out["executables"] == 2
    assert "compile cache" in pcli.build_parser().format_help() + pcli.__doc__
