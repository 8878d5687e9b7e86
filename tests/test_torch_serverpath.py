"""The binary tensor lane on the port's server, on the CPU.

``tests/test_serverpath_http.py``'s contract for the reference, held on the
port: ``application/x-tpuserve-tensor`` bodies on ``:predict`` and
``:submit`` beside the JSON and raw lanes, predictions that byte-decode
identical to the JSON lane's (BERT-base int8, ResNet-18 at 64 px and GPT-2
at fp32, narrow widths; exact: the same inputs through the same graph),
``Accept: application/json`` opting back into JSON, the error surface (400
for a malformed frame or a ``FLAG_META`` request, 413 for a declared size
over ``tensor_max_bytes`` before any allocation, 415 with the lane off,
every one with the request and trace ids), a multi-instance ``:submit``
frame refused, the lane's 503 keeping Retry-After, and the metrics: the
binary counter, exemplars on the histograms, and ``tools/check_metrics.py``
against the unedited manifest.
"""

import base64
import importlib.util
import io
import json
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pytorch_zappa_serverless_tpu.serving import wire as jwire
from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.ops.preprocessing import preprocess_image_bytes_uint8
from pytorch_zappa_serverless_tpu_torch.serving import wire
from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

ROOT = Path(__file__).resolve().parents[1]
TENSOR = {"Content-Type": wire.TENSOR_CONTENT_TYPE}
BERT_ARCH = {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
             "vocab_size": 512, "max_position": 64}
GPT2_ARCH = {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 64, "vocab_size": 500,
             "max_positions": 64}


def _cfg(**kw):
    return ServeConfig(warmup_at_boot=True, models=[
        ModelConfig(name="resnet18", batch_buckets=(1, 2), dtype="float32", coalesce_ms=5.0,
                    extra={"image_size": 64, "resize_to": 72}),
        ModelConfig(name="bert_base", batch_buckets=(1, 2), seq_buckets=(16,), dtype="float32",
                    coalesce_ms=5.0, extra={"arch": BERT_ARCH, "params_dtype": "int8"}),
        ModelConfig(name="gpt2", batch_buckets=(1, 2), seq_buckets=(16,), dtype="float32",
                    coalesce_ms=5.0, extra={"arch": GPT2_ARCH, "max_new_tokens": 4})], **kw)


@pytest.fixture(scope="module")
def engine():
    eng = build_engine(_cfg(), device="cpu")
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def srv(engine):
    with BackgroundServer(_cfg(), engine) as s:
        yield s


def _png(seed=0) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, (80, 100, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _pixels(seed=0) -> np.ndarray:
    """The crop the server's decode would hand preprocess: what a binary-lane
    client ships instead of the encoded image."""
    return preprocess_image_bytes_uint8(_png(seed), 72, 64)


def _req(port, path, body, headers=None, method="POST", timeout=60.0):
    if isinstance(body, (dict, list)):
        body, headers = json.dumps(body).encode(), {"Content-Type": "application/json",
                                                    **(headers or {})}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _json_preds(port, model, body):
    status, _, raw = _req(port, f"/v1/models/{model}:predict", body)
    assert status == 200, raw
    return json.loads(raw)["predictions"]


def _binary_preds(port, model, items, flags=0):
    status, h, raw = _req(port, f"/v1/models/{model}:predict",
                          bytes(wire.pack(items, flags=flags)), TENSOR)
    assert status == 200, raw
    assert h["Content-Type"] == wire.TENSOR_CONTENT_TYPE
    meta, preds = wire.unpack_response(raw)
    # The reference's client decodes the port's frame the same.
    jmeta, jpreds = jwire.unpack_response(raw)
    assert (jmeta, jpreds) == (meta, preds)
    assert meta["model"] == model and "timing" in meta
    return preds


# -- predictions identical across the lanes -----------------------------------------

def test_resnet18_binary_lane_identical_to_json_lane(srv):
    one = _json_preds(srv.port, "resnet18", {"b64": base64.b64encode(_png(7)).decode()})
    [got] = _binary_preds(srv.port, "resnet18", [_pixels(7)])
    assert got == one and len(got["top_k"]) == 5
    two = _json_preds(srv.port, "resnet18", {"instances": [
        {"b64": base64.b64encode(_png(s)).decode()} for s in (7, 8)]})
    got = _binary_preds(srv.port, "resnet18", [_pixels(7), _pixels(8)], flags=wire.FLAG_LIST)
    assert got == two and got[0] != got[1]


def test_bert_int8_binary_lane_identical_to_json_lane(srv):
    ids = [[2, 17, 99, 311, 5], [7, 8, 9]]
    one = _json_preds(srv.port, "bert_base", {"input_ids": ids[0]})
    assert _binary_preds(srv.port, "bert_base", [{"input_ids": ids[0]}]) == [one]
    both = _json_preds(srv.port, "bert_base", {"instances": [{"input_ids": i} for i in ids]})
    got = _binary_preds(srv.port, "bert_base", [{"input_ids": i} for i in ids])
    assert got == both and len(got) == 2


def test_gpt2_binary_lane_identical_to_json_lane(srv):
    body = {"input_ids": [3, 14, 15, 92, 65]}
    one = _json_preds(srv.port, "gpt2", body)
    [got] = _binary_preds(srv.port, "gpt2", [body])
    assert got == one and got["tokens"]


def test_accept_json_opts_binary_request_back_into_json(srv):
    status, h, raw = _req(srv.port, "/v1/models/resnet18:predict",
                          bytes(wire.pack([_pixels(2)])), {**TENSOR, "Accept": "application/json"})
    assert status == 200 and h["Content-Type"].startswith("application/json")
    assert len(json.loads(raw)["predictions"]["top_k"]) == 5


def test_the_served_pixels_are_never_written_through(srv, engine, monkeypatch):
    """The frame's read-only views reach preprocess and collate as they
    are: the collate copies into its own batch buffer."""
    cm = engine.model("resnet18")
    seen = []
    pre = cm.servable.preprocess

    def spy(payload):
        seen.append(payload)
        return pre(payload)

    monkeypatch.setattr(cm.servable, "preprocess", spy)
    frame = bytes(wire.pack([_pixels(3)]))
    status, _, _ = _req(srv.port, "/v1/models/resnet18:predict", frame, TENSOR)
    assert status == 200
    assert isinstance(seen[0], np.ndarray) and not seen[0].flags.writeable


# -- :submit on the binary lane ------------------------------------------------------

def _poll(port, job_id, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        status, _, raw = _req(port, f"/v1/jobs/{job_id}", None, method="GET")
        job = json.loads(raw)["job"]
        if job["status"] in ("done", "error") or time.monotonic() > deadline:
            return job
        time.sleep(0.02)


def test_submit_matrix_all_three_lanes(srv):
    lanes = [(json.dumps({"b64": base64.b64encode(_png(1)).decode()}).encode(),
              {"Content-Type": "application/json"}),
             (_png(1), {"Content-Type": "image/png"}),
             (bytes(wire.pack([_pixels(1)])), TENSOR)]
    results = []
    for body, headers in lanes:
        status, _, raw = _req(srv.port, "/v1/models/resnet18:submit", body, headers)
        assert status == 202, raw
        job = _poll(srv.port, json.loads(raw)["job"]["id"])
        assert job["status"] == "done", job
        results.append(job["result"])
    assert results[0] == results[1] == results[2]


def test_binary_submit_rejects_multi_instance_frames(srv):
    frame = bytes(wire.pack([_pixels(0), _pixels(1)], flags=wire.FLAG_LIST))
    status, _, raw = _req(srv.port, "/v1/models/resnet18:submit", frame, TENSOR)
    body = json.loads(raw)
    assert status == 400 and ":predict-only" in body["error"]
    assert body["request_id"] and body["trace_id"]


# -- the error surface -----------------------------------------------------------------

def test_malformed_header_400_with_ids(srv):
    status, h, raw = _req(srv.port, "/v1/models/resnet18:predict", b"XXXX" + bytes(8), TENSOR)
    body = json.loads(raw)
    assert status == 400 and "bad magic" in body["error"]
    assert body["request_id"] == h["X-Request-Id"] and body["trace_id"] == h["X-Trace-Id"]


def test_truncated_frame_400(srv):
    frame = bytes(wire.pack([_pixels(3)]))
    status, _, raw = _req(srv.port, "/v1/models/resnet18:predict", frame[:-100], TENSOR)
    body = json.loads(raw)
    assert status == 400 and "truncated" in body["error"]
    assert body["request_id"] and body["trace_id"]


def test_a_frame_is_never_sniffed_as_json(srv):
    """The Content-Type decides the lane: a tensor body that starts with
    ``{`` is a bad frame, not a JSON body."""
    status, _, raw = _req(srv.port, "/v1/models/resnet18:predict", b'{"b64": "AA=="}', TENSOR)
    assert status == 400 and "bad magic" in json.loads(raw)["error"]


def test_oversized_declared_frame_413(srv):
    frame = (wire._HDR.pack(wire.MAGIC, wire.VERSION, 0, 1) + wire._BLK.pack(9, 2, 0)
             + wire._DIM.pack(60000) + wire._DIM.pack(60000))
    status, _, raw = _req(srv.port, "/v1/models/resnet18:predict", frame, TENSOR)
    body = json.loads(raw)
    assert status == 413 and "too large" in body["error"]
    assert body["request_id"] and body["trace_id"]


def test_tensor_max_bytes_caps_a_real_frame(engine):
    with BackgroundServer(_cfg(tensor_max_bytes=1024), engine) as s:
        status, _, raw = _req(s.port, "/v1/models/resnet18:predict",
                              bytes(wire.pack([_pixels(4)])), TENSOR)
        assert status == 413, raw


def test_response_only_meta_flag_rejected_on_requests(srv):
    frame = bytes(wire.pack([{"model": "x"}, _pixels(4)], flags=wire.FLAG_META))
    status, _, raw = _req(srv.port, "/v1/models/resnet18:predict", frame, TENSOR)
    assert status == 400 and "response-only" in json.loads(raw)["error"]


def test_binary_lane_disabled_415(engine):
    with BackgroundServer(_cfg(binary_lane=False), engine) as s:
        for verb in ("predict", "submit"):
            status, _, raw = _req(s.port, f"/v1/models/resnet18:{verb}",
                                  bytes(wire.pack([_pixels(5)])), TENSOR)
            body = json.loads(raw)
            assert status == 415 and body["request_id"] and body["trace_id"]


def test_binary_lane_quarantine_shed_carries_retry_after(engine):
    with BackgroundServer(_cfg(), engine) as s:
        s.server.resilience.quarantined.add("resnet18")
        try:
            status, h, raw = _req(s.port, "/v1/models/resnet18:predict",
                                  bytes(wire.pack([_pixels(6)])), TENSOR)
            body = json.loads(raw)
            assert status == 503 and body["quarantined"] and "Retry-After" in h
            assert body["request_id"] and body["trace_id"]
        finally:
            s.server.resilience.quarantined.discard("resnet18")


# -- metrics ----------------------------------------------------------------------------

def _check_metrics_mod():
    spec = importlib.util.spec_from_file_location("tpuserve_check_metrics",
                                                  ROOT / "tools" / "check_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_binary_counter_exemplars_and_the_manifest(srv):
    status, h, _ = _req(srv.port, "/v1/models/resnet18:predict",
                        bytes(wire.pack([_pixels(9)])), TENSOR)
    assert status == 200
    m = json.loads(_req(srv.port, "/metrics", None, method="GET")[2])
    assert m["serverpath"]["binary_requests"]["resnet18"] >= 1
    assert m["tracing"]["finished"] >= 1
    text = _req(srv.port, "/metrics?format=prometheus", None, method="GET")[2].decode()
    assert "# TYPE tpuserve_binary_lane_requests_total counter" in text
    assert 'tpuserve_binary_lane_requests_total{model="resnet18"} ' in text
    assert "# TYPE tpuserve_traces_finished_total counter" in text
    assert f'# {{trace_id="{h["X-Trace-Id"]}"}}' in text
    mod = _check_metrics_mod()
    assert mod.check(text, mod.load_manifest()) == []
