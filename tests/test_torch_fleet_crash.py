"""The fleet's kill -9 scenarios of the port, end to end on the CPU.

The port's harness (``tools/crashtest.py``) drives the port's real command
line (``cli serve`` replicas behind ``cli fleet``) and holds the JAX
package's assertions (``tests/test_crash_recovery.py``): a replica killed
with a job backlog loses no acknowledged job and its resubmits dedupe; a
killed preferred rung leaves the family serving degraded; a killed decode
replica's stream resumes on a peer with the undisturbed tokens.  Marked
``slow`` as the reference marks them: each boots two or three replica
processes and a router and restarts one; the card runs all three in
``chip_smoke.py`` phase 21.
"""

import pytest

from pytorch_zappa_serverless_tpu_torch.tools import crashtest

BERT_ARCH = {"arch": {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
                      "vocab_size": 30522}, "quantize_min_size": 1024}
GPT2_CPU = {"params_dtype": "float32",
            "arch": {"d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 128, "vocab_size": 500,
                     "max_positions": 96}}


@pytest.mark.slow
def test_fleet_kill9_failover_and_zero_loss(tmp_path):
    out = crashtest.run_fleet_crashtest(tmp_path, n_jobs=6, model="bert_int8", platform="cpu",
                                        model_extra=BERT_ARCH)
    assert out["lost"] == 0 and out["completed"] == 6
    assert out["backlog_at_kill"] >= 1
    assert out["failover_predicts_ok"] >= 1 and max(out["failover_attempts"]) <= 2
    assert out["quarantined_state"] == "quarantined"
    assert out["readmitted_state"] == "healthy"
    assert out["deduped_resubmits"] == 6
    assert sum(out["failovers"].values()) >= 1


@pytest.mark.slow
def test_variant_kill9_fleet_serves_degraded_zero_loss(tmp_path):
    out = crashtest.run_variant_crashtest(tmp_path, n_jobs=5, platform="cpu")
    assert out["lost"] == 0 and out["completed"] == 5
    assert out["backlog_at_kill"] >= 1
    assert out["degraded_predicts_ok"] >= 1
    assert out["quarantined_state"] == "quarantined"
    assert out["readmitted_state"] == "healthy"
    assert out["deduped_resubmits"] == 5
    assert sum(out["fleet_degraded"].values()) >= 1


@pytest.mark.slow
def test_disagg_kill9_stream_resumes_with_zero_token_loss(tmp_path):
    out = crashtest.run_disagg_crashtest(tmp_path, platform="cpu",
                                         model_extra={**GPT2_CPU, "gen_slots": 2})
    assert out["lost"] == 0 and out["duplicates"] == 0
    assert out["tokens_after_kill"] == len(out["reference"]) == 16
    assert out["decode_replica"] != "r0"
    assert out["resumed_on"] != out["decode_replica"]
    assert out["migrations"].get("prefill", 0) >= 2
    assert out["migrations"].get("failover", 0) >= 1
    assert out["failovers"].get("kv_failover", 0) >= 1


def test_fleet_scenarios_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch):
    """Like the plain harness, the three fleet scenarios run on the card
    unless asked for the CPU, and without CUDA raise before they write or
    start anything."""
    import inspect

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (crashtest.run_fleet_crashtest, crashtest.run_variant_crashtest,
               crashtest.run_disagg_crashtest):
        assert inspect.signature(fn).parameters["platform"].default == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(tmp_path / fn.__name__)
        assert not (tmp_path / fn.__name__).exists()
    seen = {}
    monkeypatch.setattr(crashtest, "run_disagg_crashtest",
                        lambda workdir, **kw: seen.update(kw) or {})
    crashtest.main(["--workdir", str(tmp_path / "cli"), "--disagg"])
    assert seen == {"platform": "cuda", "latency_ms": 150.0}
