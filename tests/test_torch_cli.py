"""The port's command line: its admin tables against the JAX package's.

``list-models`` prints the port's registry; ``models``, ``adapters``,
``prefix``, ``slo`` and ``autoscale`` render the same payload as the same
string in both packages (payloads built from a numpy seed, and real
snapshots of the SLO hub and the autoscaler); each subcommand is an HTTP
client of its route on a running server (a stub answers here) and
``--json`` prints the body.
"""

import http.server
import json
import threading

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu import cli as jcli
from pytorch_zappa_serverless_tpu.serving import slo as JS
from pytorch_zappa_serverless_tpu_torch import cli as pcli
from pytorch_zappa_serverless_tpu_torch import config as PC
from pytorch_zappa_serverless_tpu_torch.serving import autoscale as PA
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


PAYLOADS = {"format_models_table": _models_payload,
            "format_adapters_table": _adapters_payload,
            "format_prefix_table": _prefix_payload,
            "format_slo_table": _slo_payload,
            "format_autoscale_table": _autoscale_payload}


@pytest.mark.parametrize("fmt", sorted(PAYLOADS))
@pytest.mark.parametrize("seed", range(3))
def test_tables_are_string_equal_to_the_reference(fmt, seed):
    payload = json.loads(json.dumps(PAYLOADS[fmt](np.random.default_rng(seed))))
    got = getattr(pcli, fmt)(payload)
    assert got == getattr(jcli, fmt)(payload)
    assert got.splitlines()[0].split()[0] in ("FAMILY", "MODEL", "KEY")


def test_list_models_prints_the_registry(capsys):
    assert pcli.main(["list-models"]) == 0
    assert capsys.readouterr().out.split() == list_models()


@pytest.mark.parametrize("cmd,route", [("models", "/admin/models"),
                                       ("adapters", "/admin/adapters"),
                                       ("prefix", "/admin/prefix"), ("slo", "/admin/slo"),
                                       ("autoscale", "/admin/autoscale")])
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
