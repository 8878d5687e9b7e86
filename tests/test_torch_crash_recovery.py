"""kill -9 crash recovery of the port, end to end, on the CPU.

Drives the port's harness (``pytorch_zappa_serverless_tpu_torch/tools/
crashtest.py``) against the port's real command line, as
``tests/test_crash_recovery.py`` drives the reference's: boot with a
journal, submit jobs with idempotency keys, SIGKILL while a backlog waits,
restart, and hold the reference's assertions: no acknowledged job lost, no
job run twice.  ResNet-18 at 64 px, five jobs; every wait in the harness
has a timeout and a ``finally`` kills what is left.
"""

from pytorch_zappa_serverless_tpu_torch.tools import crashtest


def test_kill9_midbacklog_loses_no_acknowledged_jobs(tmp_path):
    out = crashtest.run_crashtest(tmp_path, n_jobs=5, platform="cpu",
                                  boot_timeout_s=240.0, finish_timeout_s=120.0)
    # No acknowledged job lost: every 202'd id reached "done" after the restart.
    assert out["lost"] == 0 and out["completed"] == 5
    # The SIGKILL landed while work waited.
    assert out["backlog_at_kill"] >= 1
    # The replay recovered the journaled work: unfinished jobs re-enqueued,
    # anything the first process finished restored with its result.
    assert out["recovered_jobs"] + out["restored_done"] == 5
    assert out["recovered_jobs"] >= 1
    assert out["replay_ms"] >= 0.0
    # No job run twice: every resubmit with its key deduped to its id.
    assert out["deduped_resubmits"] == 5
    assert out["deduped_submits_metric"] >= 5
    # A recovered job's result equals the same payload run fresh.
    assert out["fresh_equal"] is True
    assert out["boot_ready_s"] > 0 and out["restart_ready_s"] > 0


def test_crashtest_defaults_to_the_card_and_raises_without_one(tmp_path, monkeypatch):
    """Like every entry point of the port, the harness runs on the card
    unless asked for the CPU: its default platform is ``cuda`` (the
    function's and the command line's), and without CUDA it raises before
    it writes or starts anything, rather than serving on the CPU."""
    import inspect

    import pytest
    import torch

    assert inspect.signature(crashtest.run_crashtest).parameters["platform"].default == "cuda"
    seen = {}
    monkeypatch.setattr(crashtest, "run_crashtest", lambda workdir, **kw: seen.update(kw) or {})
    crashtest.main(["--workdir", str(tmp_path / "cli")])
    assert seen["platform"] == "cuda"
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        crashtest.run_crashtest(tmp_path / "ct")
    assert not (tmp_path / "ct").exists()
