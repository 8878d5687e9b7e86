"""The port's bench (``benchmark.py``, ``cli bench``) against the JAX
package's, on the CPU at narrow widths.

- The record's pure helpers give the JAX module's outputs on the same step
  lists and entries, apart from the keys the port drops with the TPU
  figures (``DROPPED``) and a failed batched lane's error, which the
  port's compact entry keeps.
- The core sections' inputs are the JAX sections' inputs: the same seed,
  shapes, dtypes and values (captured by patching the JAX module's
  ``_measure`` and ``_servable``, so no JAX model is built).
- Every core section runs through ``run_section`` at narrow widths, and its
  entry keeps the record's invariants.
- The operation count of ResNet-50 at 224x224 is its published 4.09 GMACs.
- ``cli bench --platform cpu`` prints a last line that parses and fits 2000
  bytes, and writes its full record where it is told.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from pytorch_zappa_serverless_tpu_torch import benchmark as B

ROOT = Path(__file__).resolve().parents[1]

# Keys of the JAX record the port does not carry: its TPU target, the
# compile-cache boot pair and warm-cache tier, and the relay's figures.
DROPPED = set(B.DROPPED)

GPT2_ARCH = {"vocab_size": 512, "d_model": 128, "layers": 2, "heads": 2, "ffn_dim": 256,
             "max_positions": 128, "eos_id": 511}
TINY = {
    "resnet18": {"image_size": 64},
    "resnet50": {"image_size": 64},
    "efficientnet_b0": {"image_size": 64},
    "bert_base": {"arch": {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
                           "vocab_size": 512}},
    "gpt2": {"arch": GPT2_ARCH, "quantize_min_size": 1024, "max_new_tokens": 4},
    "whisper_tiny": {"arch": {"d_model": 128, "encoder_layers": 2, "decoder_layers": 2,
                              "heads": 2, "ffn_dim": 256, "vocab_size": 512,
                              "target_positions": 96},
                     "quantize_min_size": 1024, "max_new_tokens": 4},
    "sd15": {"variant": "tiny", "height": 64, "width": 64, "num_steps": 2, "chunk_steps": 1},
}
TINY_ENV = {"BENCH_BATCH": "2", "BENCH_ITERS": "1", "BENCH_CONFIG_ITERS": "1",
            "BENCH_SD_ITERS": "1", "BENCH_SD_TRIALS": "3", "BENCH_LATENCY_TRIALS": "20",
            "BENCH_BOOT_MODEL": "resnet18", "BENCH_BOOT_EXTRA": json.dumps({"image_size": 64})}


def _tiny_model_config(name, **kw):
    """``B._model_config`` with ``TINY[name]`` merged into ``extra`` last."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig

    return ModelConfig(name=name, **{**kw, "extra": {**kw.get("extra", {}),
                                                     **TINY.get(name, {})}})


@pytest.fixture(scope="module")
def JB():
    from pytorch_zappa_serverless_tpu import benchmark

    return benchmark


def _strip(x):
    """``x`` without the keys in ``DROPPED``, at every depth."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in DROPPED}
    return x


# -- (a) the record's pure helpers --------------------------------------------

STEPS = [list(np.random.default_rng(n).gamma(4.0, 0.5, n)) for n in (1, 5, 19, 20, 24, 40)]


@pytest.mark.parametrize("steps", STEPS, ids=lambda s: f"n{len(s)}")
def test_percentiles_and_tail_labels_match_the_reference(JB, steps):
    for q in (50, 90, 99):
        assert B._pctl(steps, q) == JB._pctl(steps, q)
    for prefix in ("", "step_", "e2e_", "ttft_"):
        assert B._tail_fields(steps, prefix) == JB._tail_fields(steps, prefix)
    label = "p99" if len(steps) >= 20 else "max"
    assert list(B._tail_fields(steps, "step_")) == [f"step_{label}_ms"]


@pytest.mark.parametrize("steps", STEPS[1:], ids=lambda s: f"n{len(s)}")
def test_entry_without_cost_matches_the_reference(JB, steps):
    for batch, e2e, first_s, extra in ((8, steps[::-1], 1.234, {}),
                                       (1, [], 0.5, {"reference_config": "#1"}),
                                       (4, steps[:3], 12.0, {"seq": 128, "max_new_tokens": 32})):
        assert B._entry(batch, steps, e2e, first_s, **extra) == \
            JB._entry(batch, steps, e2e, first_s, **extra)
    assert B._entry(2, [0.0] * 20, [], 0.1)["req_s_chip"] is None


def test_batched_throughput_matches_the_reference(JB):
    for lane, per in (({"batched_factor": 4, "batch4_p50_ms": 3.5}, 256),
                      ({"batched_factor": 2, "batch2_p50_ms": 0.7}, 1),
                      ({"batched_factor": 4, "batch4_p50_ms": 0.0}, 32),
                      ({"batched_lane_error": "x"}, 32), ({}, 1)):
        assert B._batched_throughput(lane, per) == JB._batched_throughput(lane, per)


# The core sections (the plane sections' line is held in
# tests/test_torch_bench_wiring.py).
CORE = [s for s in B._COMPACT_KEYS if s in B.SECTIONS and s != "mixed_path"]


def _section_entries(scale: float = 1.0, pad: int = 0) -> dict:
    """One entry a core section, carrying every compact key of either
    package's core sections (``pad`` long extra strings make the line
    outgrow its budget)."""
    keys = sorted({k for name, ks in JB_KEYS().items() if name in CORE for k in ks}
                  | {"e2e_p50_ms", "batch"})
    out = {}
    for i, name in enumerate(CORE + ["unlisted"]):
        entry = {k: round(scale * (i + 1) * (j + 1.5), 3) for j, k in enumerate(keys)}
        entry["meets_target"] = bool(i % 2)
        if pad:
            entry["p50_ms"] = "x" * pad
        out[name] = entry
    return out


def JB_KEYS():
    from pytorch_zappa_serverless_tpu import benchmark

    return benchmark._COMPACT_KEYS


def test_compact_entry_matches_the_reference_but_for_dropped_keys(JB):
    entries = _section_entries()
    for name, entry in entries.items():
        assert B._compact_entry(name, entry) == _strip(JB._compact_entry(name, entry))
        err = {"error": "Traceback (most recent call last): " + "x" * 200}
        assert B._compact_entry(name, err) == JB._compact_entry(name, err)
    assert B._compact_entry("gpt2", None) is None
    # The one key the port adds: a failed x4 lane's error, which fails the run.
    lane = {**entries["gpt2"], "batched_lane_error": "RuntimeError: " + "x" * 200}
    assert B._compact_entry("gpt2", lane) == {
        **_strip(JB._compact_entry("gpt2", lane)),
        "batched_lane_error": lane["batched_lane_error"][:80]}
    assert B._compact_entry("gpt2", {"p50_ms": None, "tokens_per_s": 3.0}) == \
        JB._compact_entry("gpt2", {"p50_ms": None, "tokens_per_s": 3.0})


def _full(entries: dict) -> dict:
    configs = {k: v for k, v in entries.items()
               if k not in ("cold_start", "server_path", "generate_path", "mixed_path")}
    return {"metric": "resnet50_b8_p50_latency", "value": 1.234, "unit": "ms",
            "vs_baseline": None,
            "extra": {"step_p99_ms": 1.5, "req_s_chip": 6482.9, "mfu_pct": 41.2,
                      "device_trace_ms": 1.1, "step_max_ms": None, "configs": configs,
                      **{k: entries.get(k) for k in ("cold_start", "server_path",
                                                     "generate_path", "mixed_path")}}}


@pytest.mark.parametrize("stage", ["whole", "p50_only", "configs_dropped"])
def test_compact_summary_and_its_trimming_match_the_reference(JB, stage):
    """The three stages of the trimming: the line whole, every config cut to
    its p50, and the configs dropped; each stage gives the JAX package's
    line, apart from the dropped keys."""
    entries = {"whole": _section_entries(0.01), "p50_only": _section_entries(1e12),
               "configs_dropped": _section_entries(1.0, pad=200)}[stage]
    full = _full(entries)
    got = B.compact_summary(copy.deepcopy(full), "build/bench/BENCH_FULL.json")
    want = _strip(JB.compact_summary(copy.deepcopy(full), "build/bench/BENCH_FULL.json"))
    assert got == want
    line = json.dumps(got)
    assert len(line) <= B._TAIL_BYTES - 200
    extra = got["extra"]
    if stage == "whole":
        assert extra["configs"]["gpt2"]["tokens_per_s"] > 0
    elif stage == "p50_only":
        assert extra["configs"]["gpt2"] == {"p50_ms": full["extra"]["configs"]["gpt2"]["p50_ms"]}
    else:
        assert extra == {"configs_dropped": True, "full": "build/bench/BENCH_FULL.json"}


def test_compact_keys_are_the_references_but_the_dropped_and_unported():
    """Every section of the reference's compact line, none left unported;
    each entry the reference's less the dropped keys."""
    from pytorch_zappa_serverless_tpu import benchmark as jb

    assert set(B._COMPACT_KEYS) == set(jb._COMPACT_KEYS)
    for name, keys in B._COMPACT_KEYS.items():
        assert keys == tuple(k for k in jb._COMPACT_KEYS[name] if k not in DROPPED)
    assert set(B.SECTIONS) <= set(B._COMPACT_KEYS)
    assert set(B._COMPACT_KEYS) <= set(B.SECTIONS) | {n for _, n in B.PLANE_SECTIONS}


# -- (b) the sections' inputs are the reference's --------------------------------

def _capture_jax_inputs(JB, monkeypatch) -> dict:
    seen: list[dict] = []

    class Stub:
        params, meta = {}, {}

        @staticmethod
        def apply_fn(params, inputs):
            return inputs

    def measure(fn, params, inputs, iters, fetch, trials=None, e2e_iters=12, extras=True):
        seen.append(inputs)
        return 0.1, [1.0] * 24, [1.0] * 12, {}

    monkeypatch.setattr(JB, "_servable", lambda name, **kw: Stub())
    monkeypatch.setattr(JB, "_measure", measure)
    out = {}
    for key, run in (("resnet18_b1", lambda: JB.bench_image_model("resnet18", 1, 10)),
                     ("efficientnet_b0", lambda: JB.bench_image_model("efficientnet_b0", 8, 10)),
                     ("bert_base", lambda: JB.bench_bert(8, 128, 10)),
                     ("whisper_tiny", lambda: JB.bench_whisper(10)),
                     ("gpt2", lambda: JB.bench_gpt2(8, 10))):
        seen.clear()
        run()
        out[key] = list(seen)
    return out


def _same_arrays(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_core_sections_inputs_equal_the_references(JB, monkeypatch):
    jax_inputs = _capture_jax_inputs(JB, monkeypatch)
    assert [len(v) for v in jax_inputs.values()] == [1, 1, 1, 2, 2]  # + the b4 lanes
    _same_arrays(B._image_inputs(1), jax_inputs["resnet18_b1"][0])
    _same_arrays(B._image_inputs(8), jax_inputs["efficientnet_b0"][0])
    _same_arrays(B._bert_inputs(8, 128), jax_inputs["bert_base"][0])
    mel = B._whisper_inputs()
    _same_arrays(mel, jax_inputs["whisper_tiny"][0])
    _same_arrays(B._repeat(mel, 4), jax_inputs["whisper_tiny"][1])
    ids = B._gpt2_inputs(8, 64)
    _same_arrays(ids, jax_inputs["gpt2"][0])
    _same_arrays(B._repeat(ids, 4), jax_inputs["gpt2"][1])


def test_narrow_vocabularies_keep_ids_inside_them():
    assert B._bert_inputs(2, 16, vocab=512)["input_ids"].max() < 512
    assert B._gpt2_inputs(2, 16, vocab=512)["input_ids"].max() < 512
    assert B._gpt2_inputs(2, 16, vocab=512)["input_ids"].min() >= 1


# -- (c) every core section at narrow widths on the CPU ---------------------------

@pytest.fixture
def tiny(monkeypatch):
    for k, v in TINY_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(B, "_model_config", _tiny_model_config)
    monkeypatch.setattr(B, "_LATENCY_TRIALS", 20)
    monkeypatch.setattr(B, "_E2E_ITERS", 3)


def _check_model_entry(entry: dict, trials: int, e2e: int, batch: int) -> None:
    assert "error" not in entry and not DROPPED & set(entry)
    assert not any("relay" in k or "tpu" in k for k in entry)
    assert entry["clock"] == "wall" and "launches" not in entry
    assert entry["step_trials"] == trials and entry["batch"] == batch
    label, other = ("p99", "max") if trials >= 20 else ("max", "p99")
    assert f"step_{label}_ms" in entry and f"step_{other}_ms" not in entry
    assert entry[f"step_{label}_ms"] >= entry["p50_ms"] > 0
    elabel, eother = ("p99", "max") if e2e >= 20 else ("max", "p99")
    assert f"e2e_{elabel}_ms" in entry and f"e2e_{eother}_ms" not in entry
    assert entry["req_s_chip"] == round(batch * 1000.0 / entry["p50_ms"], 1)
    assert entry["first_call_s"] >= 0 and entry["gflops"] > 0
    assert "mfu_pct" not in entry  # no peak for the CPU


SECTION_BATCH = {"resnet18_b1": 1, "efficientnet_b0": 2, "bert_base": 2, "whisper_tiny": 1,
                 "whisper_int8": 1, "gpt2": 2, "gpt2_int8": 2, "gpt2_auto": 2, "sd15": 1}


# Trials of the latency sections whose CPU call is long (Whisper's encoder
# over 3000 frames): fewer than 20, so their entries take the max label.
SHORT_TRIALS = {"whisper_tiny": 5, "whisper_int8": 5, "sd15": 3}


def _check_cold_start(entry: dict) -> None:
    for phase in ("cold", "staged"):
        boot = entry[f"{phase}_boot_s"]
        assert boot > 0
        assert abs(sum(entry["phases"][phase].values()) - boot) <= 0.03
    assert "warm_boot_s" not in entry and "speedup" not in entry


# cold_start runs in the command line's test below, through the same
# run_section in a process of its own: its two boots are processes anyway.
# mixed_path, a plane section, runs narrow in tests/test_torch_bench_serving.py.
@pytest.mark.parametrize("name", [s for s in B.SECTIONS if s not in ("cold_start",
                                                                     "mixed_path")])
def test_section_runs_at_narrow_widths_on_the_cpu(tiny, monkeypatch, name):
    if name in SHORT_TRIALS:
        monkeypatch.setattr(B, "_LATENCY_TRIALS", SHORT_TRIALS[name])
    entry = B.run_section(name, "cpu")
    assert "error" not in entry and not DROPPED & set(entry), entry
    if name in SECTION_BATCH:
        _check_model_entry(entry, SHORT_TRIALS.get(name, 20), 3, SECTION_BATCH[name])
    if name in ("whisper_tiny", "whisper_int8", "gpt2", "gpt2_int8", "gpt2_auto", "sd15"):
        assert entry["batched_factor"] == 4 and entry["batch4_p50_ms"] > 0, entry
        rate = "images_per_s_batched" if name == "sd15" else "tokens_per_s_batched"
        assert entry[rate] > 0
    if name.startswith(("gpt2", "whisper")):
        assert entry["max_new_tokens"] == 4
        assert entry["tokens_per_s"] == round(
            SECTION_BATCH[name] * 4 * 1000.0 / entry["p50_ms"], 1)
    if name == "sd15":
        assert entry["resolution"] == "64x64" and entry["chunks"] == 2
    if name == "server_path":
        assert entry["n_429"] + round(entry["achieved_rps"]) >= 0
        assert entry["http_wall_p99_ms"] >= entry["http_wall_p50_ms"] > 0
        assert 1 <= entry["batch_occupancy_mean"] <= entry["batch_occupancy_max"] <= 8
    if name == "generate_path":
        assert entry["ttft_p99_ms"] >= entry["ttft_p50_ms"] > 0  # 24 streams: a p99
        assert entry["streamed_tokens_per_s"] > 0 and entry["mean_tokens_per_stream"] == 4
        assert entry["device_rounds_to_first_token_p50"] >= 1


# -- (d) the operation count -----------------------------------------------------

def test_resnet50_operation_count_is_its_published_macs():
    """ResNet-50 at batch 1, 224x224, full width: 4.09 GMACs, 2 operations
    each, within 3 %."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig

    engine, _ = B._engine(ModelConfig(name="resnet50", dtype="float32", batch_buckets=(1,)),
                          "cpu")
    try:
        cm = engine.model("resnet50")
        flops = B.count_flops(engine, lambda: cm.forward_eager(B._image_inputs(1)))
    finally:
        engine.shutdown()
    assert abs(flops - 2 * 4.09e9) <= 0.03 * 2 * 4.09e9, flops


def test_kernel_tallies_equal_the_counted_plain_versions():
    """Each hand kernel's operations from its shapes (what its wrapper adds
    to the tally where it launches) equal what ``torch.utils.flop_counter``
    counts of its plain version on the same shapes."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA
    from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as FD
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    def counted(fn, *args, **kw):
        with FlopCounterMode(display=False) as fc:
            fn(*args, **kw)
        return fc.get_total_flops()

    g = torch.Generator().manual_seed(0)
    x = torch.randn(24, 64, generator=g)
    w_q = torch.randint(-127, 128, (64, 96), dtype=torch.int8, generator=g)
    assert counted(I.int8_matmul_reference, x, w_q, torch.ones(96)) == \
        I.int8_matmul_flops(24, 64, 96)
    q, k = torch.randn(2, 40, 3, 16, generator=g), torch.randn(2, 56, 3, 16, generator=g)
    assert counted(FA.flash_attention_reference, q, k, k) == FA.flash_attention_flops(
        2, 40, 56, 3, 16)
    S, D, T, F, H = 3, 32, 12, 64, 2
    n = torch.randn
    attn = counted(FD.fused_attn_step_reference, n(S, D), torch.ones(D), torch.zeros(D),
                   n(D, 3 * D), torch.zeros(3 * D), n(D, D), torch.zeros(D), n(T, S, D),
                   n(T, S, D), torch.zeros(S, dtype=torch.int32), torch.zeros(T, S, 1),
                   heads=H)
    assert attn == FD.fused_attn_flops(S, D, T)
    mlp = counted(FD.fused_mlp_step_reference, n(S, D), torch.ones(D), torch.zeros(D),
                  n(D, F), torch.zeros(F), n(F, D), torch.zeros(D))
    assert mlp == FD.fused_mlp_flops(S, D, F)


# -- (e) the command line ----------------------------------------------------------

def test_full_record_lands_under_build_by_default():
    assert B.FULL_PATH == ROOT / "build" / "bench" / "BENCH_FULL.json"


def test_cli_bench_on_the_cpu_prints_one_parseable_last_line(tiny, monkeypatch, tmp_path,
                                                             capsys):
    """``cli bench`` in this process, the flagship at ``TINY``'s widths;
    cold_start boots in processes of its own (``BENCH_BOOT_*``)."""
    from pytorch_zappa_serverless_tpu_torch import cli

    full = tmp_path / "full.json"
    monkeypatch.setenv("BENCH_FULL_PATH", str(full))
    monkeypatch.setenv("BENCH_SKIP", ",".join(s for s in B.SECTIONS if s != "cold_start"))
    before = sorted(p.name for p in ROOT.iterdir())
    assert cli.main(["bench", "--all", "--platform", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["config"] == "cold_start"
    last = lines[-1]
    assert len(last.encode()) + 1 <= 2000
    out = json.loads(last)
    assert out["metric"] == "resnet50_b2_p50_latency" and out["value"] > 0
    assert out["vs_baseline"] is None and out["extra"]["full"] == str(full)
    assert out["extra"]["configs"] == {}
    assert out["extra"]["cold_start"]["staged_boot_s"] > 0
    record = json.loads(full.read_text())
    _check_cold_start(record["extra"]["cold_start"])
    assert record["extra"]["clock"] == "wall" and record["extra"]["backend"] == "cpu"
    assert sorted(p.name for p in ROOT.iterdir()) == before


def test_bench_defaults_to_cuda(monkeypatch):
    import torch

    from pytorch_zappa_serverless_tpu_torch import cli

    assert cli.build_parser().parse_args(["bench"]).platform == "cuda"
    assert B.build_parser().parse_args([]).platform == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.bench_image_model("resnet18", 1, 1)


def test_a_section_error_makes_main_exit_non_zero(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("BENCH_FULL_PATH", str(tmp_path / "f.json"))
    full = _full({"cold_start": {"error": "boom"}})
    full["extra"]["configs"] = {"gpt2": {"p50_ms": 1.0}}
    monkeypatch.setattr(B, "run_flagship_bench", lambda emit, device: copy.deepcopy(full))
    assert B.main(device="cpu") == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["extra"][
        "cold_start"] == {"error": "boom"}
    full["extra"]["cold_start"] = {"cold_boot_s": 1.0}
    assert B.main(device="cpu") == 0


def test_a_failed_batched_lane_fails_the_run(tiny, monkeypatch, tmp_path, capsys):
    """A section whose x4 lane raises keeps its primary numbers, carries
    ``batched_lane_error`` into the compact line, and makes ``main`` exit
    non-zero."""
    real = B._bucket_program

    def program(engine, cm, batch, *args, **kw):
        if np.shape(next(iter(batch.values())))[0] == 4 * 2:  # the x4 lane of batch 2
            raise RuntimeError("lane capture failed")
        return real(engine, cm, batch, *args, **kw)

    monkeypatch.setattr(B, "_bucket_program", program)
    entry = B.run_section("gpt2", "cpu")
    assert entry["p50_ms"] > 0 and "batched_factor" not in entry
    assert entry["batched_lane_error"] == "RuntimeError: lane capture failed"
    assert B._compact_entry("gpt2", entry)["batched_lane_error"] == entry["batched_lane_error"]
    monkeypatch.setenv("BENCH_FULL_PATH", str(tmp_path / "f.json"))
    full = _full({})
    full["extra"]["configs"] = {"gpt2": entry, "bert_base": {"p50_ms": 1.0}}
    monkeypatch.setattr(B, "run_flagship_bench", lambda emit, device: copy.deepcopy(full))
    assert B.main(device="cpu") == 1
    out = capsys.readouterr()
    assert "sections with an error: gpt2" in out.err
    assert json.loads(out.out.strip().splitlines()[-1])["extra"]["configs"]["gpt2"][
        "batched_lane_error"] == entry["batched_lane_error"]


def test_step_modes_splits_trials_at_the_midpoint():
    """``tools/step_modes.summary`` (the tool that found the flagship's two
    modes) splits a variant's trials at the midpoint of the fastest and the
    slowest and keeps their order."""
    from pytorch_zappa_serverless_tpu_torch.tools.step_modes import summary

    ms = [1.81, 1.81, 2.04, 2.05, 2.04, 1.80]
    rows = [{"t": i, "ms": m, "mhz_before": 1980.0, "mhz_after": 1990.0 + i,
             "host_ms": 0.5, "spin_ms": 2.7, "copy_gbps": 2600.0 - 400 * (m > 2),
             "mm_tflops": 500.0} for i, m in enumerate(ms)]
    got = summary("bench", rows)
    assert got["order"] == "LLHHHL" and got["t"] == [0, 5]
    assert (got["low_n"], got["high_n"]) == (3, 3)
    assert got["low_median"] == 1.81 and got["high_median"] == 2.04
    assert got["mhz_after_range"] == [1990.0, 1995.0]
    assert (got["copy_gbps_low"], got["copy_gbps_high"]) == (2600.0, 2200.0)

