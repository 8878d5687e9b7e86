"""What lets the port capture each bucket's program as a CUDA graph, checked
on the CPU (the captures themselves run only on the card:
tests/test_torch_kernels_cuda.py).

- ``ops.sampling``: the Gumbel draw is a counter-based hash of (seed, step,
  column) in integer tensor ops, so it needs no host read; pinned bits, the
  mean of its draws, and independence from batch, width and device.
- The host-side gates (``Gates``, ``gates_of``): a gated ``generate`` gives
  the tokens of the all-gates-on one, for every combination of knobs; pad
  rows open no gate.
- No host read of a tensor inside ``apply_fn`` (GPT-2 in every variant,
  BERT) or an SD chunk: those raise during a capture.
- ``ops.counters``: snapshot, delta, restore and add.
- ``models.sd15.denoise`` with the schedule rows as tensors equals the
  float-row loop bit for bit.
- The engine on the CPU stays eager; the graph keys' words; the bench
  lanes' state round trip.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
from pytorch_zappa_serverless_tpu_torch.engine import compiled as EC
from pytorch_zappa_serverless_tpu_torch.engine import weights as W
from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
from pytorch_zappa_serverless_tpu_torch.models import sd15 as S
from pytorch_zappa_serverless_tpu_torch.models.sd_unet import unet_apply
from pytorch_zappa_serverless_tpu_torch.ops import counters
from pytorch_zappa_serverless_tpu_torch.ops import sampling as PS
from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as B

CPU = torch.device("cpu")
ARCH = {"vocab_size": 300, "d_model": 32, "layers": 2, "heads": 2, "ffn_dim": 64,
        "max_positions": 64, "eos_id": 299}


# -- the draw ------------------------------------------------------------------

def test_uniform_bits_pinned():
    """The hash's bits for fixed (seed, step, column): any change to the
    draw shows here (a negative seed is taken mod 2**32)."""
    bits = PS.uniform_bits(torch.tensor([0, 1, -5, 2**31 - 1]), torch.tensor([0, 0, 7, 123]), 4)
    assert bits.dtype == torch.int64
    assert bits.tolist() == [[10233006, 13344322, 1981479, 14249509],
                             [4690710, 6264803, 7885543, 10596729],
                             [16347685, 2562817, 15890791, 7002374],
                             [8098244, 13953825, 13357432, 296333]]


def test_uniform_bits_stay_in_24_bits_and_do_not_depend_on_width():
    seeds, t = torch.tensor([3, -1, 7]), torch.tensor([0, 9, 2**31 - 1])
    wide = PS.uniform_bits(seeds, t, 5000)
    assert int(wide.min()) >= 0 and int(wide.max()) < 2**24
    assert torch.equal(PS.uniform_bits(seeds, t, 17), wide[:, :17])
    # 24 of the 32 bits of a bijection of the column: few ties (~0.75 expected).
    assert len(set(wide[0].tolist())) >= 4995
    top = torch.bincount((wide >> 20).flatten(), minlength=16).double()  # 16 even bins
    assert ((top - top.mean()) ** 2 / top.mean()).sum().item() < 40  # chi-square, 15 dof


def test_gumbel_mean_is_euler_gamma():
    """10^5 draws (10 rows of 10^4): mean within 0.01 of Euler-Mascheroni
    (the standard error is ~0.004)."""
    g = PS.gumbel_noise(torch.arange(10), torch.arange(10) * 3, 10_000, CPU)
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    assert abs(g.double().mean().item() - PS.EULER_GAMMA) < 0.01
    assert abs(g.double().std().item() - np.pi / np.sqrt(6)) < 0.02


def test_gumbel_is_finite_at_the_extreme_bits(monkeypatch):
    """u = (bits + 0.5) / 2**24 is never 0 or 1, so no draw is infinite."""
    monkeypatch.setattr(PS, "uniform_bits",
                        lambda s, t, V, salt=None: torch.tensor([[0, 2**24 - 1]],
                                                                dtype=torch.int64))
    g = PS.gumbel_noise(torch.tensor([0]), torch.tensor([0]), 2, CPU)
    assert torch.isfinite(g).all() and g[0, 0] < g[0, 1]


# -- the gates -----------------------------------------------------------------

def _knobs(temperature, rep, top_k, B_=3):
    temp = np.array([0.0] + [temperature] * (B_ - 1), np.float32)
    return {"temperature": temp, "seed": np.arange(B_, dtype=np.int32) + 11,
            "top_k": np.array([0] + [top_k] * (B_ - 1), np.int32),
            "top_p": np.array([1.0] + [0.9 if top_k else 1.0] * (B_ - 1), np.float32),
            "repetition_penalty": np.array([1.0] + [rep] * (B_ - 1), np.float32)}


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("rep", [1.0, 1.3])
@pytest.mark.parametrize("top_k", [0, 5])
def test_host_gates_give_the_all_gates_on_tokens(temperature, rep, top_k):
    """For every combination of knobs, ``generate`` keyed by the batch's
    host gates gives the tokens of the run with every gate on, and of the
    run gated as before, by reads of the device tensors (a gate only skips
    work)."""
    cfg = G.GPT2Config(**ARCH)
    params = W.ParamTree(W.tree_state_from_jax(G.init_gpt2_params(0, cfg),
                                               torch.float32)).tree()
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 298, (3, 8)).astype(np.int32)
    lengths = np.array([8, 5, 3], np.int32)
    knobs = _knobs(temperature, rep, top_k)
    gates = PS.gates_of(knobs["temperature"], knobs["top_k"], knobs["top_p"],
                        knobs["repetition_penalty"])
    hot = temperature > 0
    assert gates == PS.Gates(hot, rep != 1.0, hot and top_k > 0)
    t = {k: torch.from_numpy(v) for k, v in knobs.items()}
    hot_t = t["temperature"] > 0.0
    device_read = PS.Gates(bool(hot_t.any()), bool((t["repetition_penalty"] != 1.0).any()),
                           bool((hot_t & ((t["top_k"] > 0) | (t["top_p"] < 1.0))).any()))

    def run(g):
        return G.generate(params, torch.from_numpy(toks), torch.from_numpy(lengths),
                          t["temperature"], t["seed"], 6, cfg, torch.float32, top_k=t["top_k"],
                          top_p=t["top_p"], repetition_penalty=t["repetition_penalty"], gates=g)

    assert torch.equal(run(gates), run(PS.ALL_ON))
    assert torch.equal(run(gates), run(device_read))


def test_choose_gates_only_skip_work():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    temperature = torch.tensor([0.0, 0.7, 0.0, 1.3])
    seeds, t = torch.arange(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    greedy = logits.argmax(-1).to(torch.int32)
    assert torch.equal(PS.choose(logits, torch.zeros(4), seeds, t, sampled=False), greedy)
    both = PS.choose(logits, temperature, seeds, t, torch.zeros(4, dtype=torch.int32),
                     torch.ones(4), filtered=True)
    unfiltered = PS.choose(logits, temperature, seeds, t, torch.zeros(4, dtype=torch.int32),
                           torch.ones(4), filtered=False)
    assert torch.equal(both, unfiltered)
    assert torch.equal(both[[0, 2]], greedy[[0, 2]])  # greedy rows of a sampled batch


def _gpt2_servable(**extra):
    return G.make_gpt2_servable("gpt2", ModelConfig(
        name="gpt2", dtype="float32", seq_buckets=(8,), batch_buckets=(1, 4),
        extra={"arch": ARCH, "max_new_tokens": 4, **extra}))


def test_pad_rows_open_no_gate():
    """A greedy request in a 4-row bucket: the pad rows' penalty and top-p
    are neutral, so the batch is the greedy variant warm-up captured."""
    sv = _gpt2_servable()
    samples = [sv.preprocess({"input_ids": [5, 6, 7]})]
    batch = sv.meta["collate"](samples, (4, 8), sv.input_spec((4, 8)))
    assert sv.meta["variant_of"](batch) == sv.meta["default_variant"] == PS.Gates(False, False,
                                                                                 False)
    assert batch["repetition_penalty"].tolist() == [1.0] * 4 and batch["top_p"].tolist() == [1.0] * 4
    hot = sv.meta["collate"](samples + [sv.preprocess({"input_ids": [9], "temperature": 0.5,
                                                       "top_k": 3})], (4, 8),
                             sv.input_spec((4, 8)))
    assert sv.meta["variant_of"](hot) == PS.Gates(True, False, True)
    assert _gpt2_servable(temperature=0.7).meta["default_variant"] == PS.Gates(True, False, False)


@pytest.fixture
def no_host_reads(monkeypatch):
    """A tensor read on the host (``bool``, ``item``, ``tolist``, ``cpu``,
    ``numpy``) raises, as it does during a capture."""
    def refuse(*_, **__):
        raise AssertionError("a tensor was read on the host")

    for name in ("__bool__", "item", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("knobs", [{}, {"temperature": 0.8}, {"repetition_penalty": 1.2},
                                   {"temperature": 0.8, "top_k": 5, "top_p": 0.9,
                                    "repetition_penalty": 1.2}])
def test_gpt2_apply_fn_reads_nothing_on_the_host(knobs, request):
    sv = _gpt2_servable()
    samples = [sv.preprocess({"input_ids": [5, 6, 7], **knobs}), sv.preprocess({"text": "a b"})]
    batch = sv.meta["collate"](samples, (4, 8), sv.input_spec((4, 8)))
    variant = sv.meta["variant_of"](batch)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = sv.apply_fn(sv.module, inputs, variant=PS.ALL_ON)["tokens"].clone()
    request.getfixturevalue("no_host_reads")
    with torch.inference_mode():
        got = sv.apply_fn(sv.module, inputs, variant=variant)["tokens"]
    assert torch.equal(got, want)


def test_bert_apply_fn_reads_nothing_on_the_host(request):
    from pytorch_zappa_serverless_tpu_torch.models.bert import make_bert_servable

    sv = make_bert_servable("bert_base", ModelConfig(
        name="bert_base", dtype="float32", seq_buckets=(16,), batch_buckets=(2,),
        extra={"arch": {"num_layers": 2, "num_heads": 2, "head_dim": 16, "mlp_dim": 64,
                        "vocab_size": 512, "max_position": 64}, "params_dtype": "int8"}))
    inputs = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in sv.input_spec((2, 16)).items()}
    request.getfixturevalue("no_host_reads")
    with torch.inference_mode():
        probs = sv.apply_fn(sv.module, inputs)["probs"]
    assert probs.shape == (2, 2)


def test_sd_chunk_reads_nothing_on_the_host(request):
    sv = S.make_sd15_servable("sd15", ModelConfig(
        name="sd15", dtype="float32", batch_buckets=(1,),
        extra={"variant": "tiny", "height": 64, "width": 64, "num_steps": 4, "chunk_steps": 2}))
    ch = sv.meta["chunked"]
    state = {"latents": torch.ones(1, 8, 8, 4), "context": torch.ones(2, 16, 32),
             "g": torch.full((1, 1, 1, 1), 7.5)}
    rows = {k: torch.from_numpy(v) for k, v in ch["chunk_rows"][0].items()}
    request.getfixturevalue("no_host_reads")
    with torch.inference_mode():
        out = ch["chunk"](sv.module.tree(), state, rows)
    assert out["latents"].shape == (1, 8, 8, 4) and out["context"] is state["context"]


def test_sd_prepare_and_finalize_read_nothing_on_the_host(request):
    """SD-1.5's prepare (the CLIP encode) and finalize (the VAE decode) are
    captured too: neither reads a tensor on the host."""
    sv = S.make_sd15_servable("sd15", ModelConfig(
        name="sd15", dtype="float32", batch_buckets=(1,),
        extra={"variant": "tiny", "height": 64, "width": 64, "num_steps": 4, "chunk_steps": 2}))
    ch = sv.meta["chunked"]
    batch = EC.default_collate([sv.preprocess({"prompt": "a fox", "seed": 3})], (1,),
                               sv.input_spec((1,)))
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    request.getfixturevalue("no_host_reads")
    with torch.inference_mode():
        state = ch["prepare"](sv.module.tree(), inputs)
        image = ch["finalize"](sv.module.tree(), state)["image"]
    assert state["latents"].shape == (1, 8, 8, 4) and image.shape == (1, 64, 64, 3)


def test_sd_edge_graph_keys_in_words():
    assert EC._label(("prepare", (1,))) == "prepare 1"
    key = ("finalize", (("context", (2, 77, 768)), ("g", (1, 1, 1, 1)),
                        ("latents", (1, 64, 64, 4))))
    assert EC._label(key) == "finalize latents[1, 64, 64, 4]"


# -- the counters --------------------------------------------------------------

def test_counter_registry_holds_every_kernel():
    import pytorch_zappa_serverless_tpu_torch.ops.fused_decode  # noqa: F401

    assert set(counters.snapshot()) == {
        "int8_matmul", "flash_attention", "unet_apply", "fused_attn_step",
        "fused_attn_step_int8", "fused_mlp_step", "fused_mlp_step_int8"}


def test_counter_snapshot_delta_restore_add(monkeypatch):
    monkeypatch.setattr(counters, "_REGISTRY", {})

    def kernel():
        pass

    def model():
        pass

    counters.register(kernel)
    counters.register(model, "calls")
    assert kernel.launches == 0 and model.calls == 0
    kernel.launches, model.calls = 5, 1
    before = counters.snapshot()
    kernel.launches += 3  # what a capture's trace would count
    model.calls += 1
    graph = counters.delta(before)
    assert graph == {"kernel": 3, "model": 1}
    counters.restore(before)  # the capture ran nothing
    assert (kernel.launches, model.calls) == (5, 1)
    counters.add(graph)  # one replay
    counters.add(graph)  # and another
    assert (kernel.launches, model.calls) == (11, 3)
    counters.reset()
    assert counters.snapshot() == {"kernel": 0, "model": 0}


# -- the SD schedule rows ----------------------------------------------------------

def test_denoise_tensor_rows_equal_float_rows_bitwise():
    """The rows as tensors (what a chunk graph reads) against the loop that
    read each constant as a Python float, on the CPU: the same bits."""
    cfg = S.TINY
    tree = W.ParamTree(W.params_from_jax(S.init_sd15_params(0, cfg))).tree()
    rows = {k: v[:3] for k, v in S.ddim_schedule(6, cfg).items()}
    rng = np.random.default_rng(0)
    latents = torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    context = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32))
    g = torch.full((1, 1, 1, 1), 7.5)
    want = latents
    for i in range(3):
        lat2 = torch.cat([want, want])
        t2 = torch.full((2,), float(rows["t"][i]), dtype=torch.float32)
        eps_u, eps_c = unet_apply(tree["unet"], lat2, t2, context, cfg.unet,
                                  torch.float32).chunk(2)
        eps = eps_u + g * (eps_c - eps_u)
        x0 = (want - float(rows["sqrt_one_minus_alpha"][i]) * eps) / float(rows["sqrt_alpha"][i])
        want = (float(rows["sqrt_alpha_prev"][i]) * x0
                + float(rows["sqrt_one_minus_alpha_prev"][i]) * eps)
    for as_rows in (lambda r: r, lambda r: {k: torch.from_numpy(v) for k, v in r.items()}):
        got = S.denoise(tree, latents, context, g, as_rows(rows), cfg, torch.float32)
        assert torch.equal(got, want)


# -- the engine and the bench --------------------------------------------------------

def test_cpu_engine_stays_eager():
    cfg = ServeConfig(models=[ModelConfig(
        name="gpt2", dtype="float32", seq_buckets=(8,), batch_buckets=(1,),
        extra={"arch": ARCH, "max_new_tokens": 3})])
    eng = build_engine(cfg, device="cpu")
    try:
        cm = eng.model("gpt2")
        assert not cm.graphed and cm.graphs == []
        samples = [cm.servable.preprocess({"input_ids": [3, 4], "temperature": 0.5, "seed": 2})]
        batch = cm.servable.meta["collate"](samples, (1, 8), cm.servable.input_spec((1, 8)))
        assert np.array_equal(cm.forward(batch)["tokens"], cm.forward_eager(batch)["tokens"])
        assert [e["bucket"] for e in eng.clock.entries] == [[1, 8]]
    finally:
        eng.shutdown()


def test_graph_keys_in_words():
    assert EC._entry(((8, 64), PS.Gates(True, False, True))) == [8, 64, "sampled+filtered"]
    assert EC._entry(((1, 64), PS.Gates(False, False, False))) == [1, 64, "greedy"]
    assert EC._entry(((8, 128), None)) == [8, 128]
    key = ("chunk", (("state.latents", (1, 64, 64, 4)), ("state.g", (1, 1, 1, 1)),
                     ("rows.t", (4,))))
    assert EC._label(key) == "chunk latents[1, 64, 64, 4] t[4]"
    assert EC._label(((8, 64), PS.Gates(True, False, True))) == "(8, 64) sampled+filtered"
    assert EC._label(((1, 128), None)) == "(1, 128)"


def test_bench_lane_state_round_trip_in_place():
    cfg = dataclasses.replace(G.SMALL, **{**ARCH, "vocab_size": 512, "d_model": 128,
                                          "ffn_dim": 256, "max_positions": 128, "eos_id": 511})
    lane = B.build_lanes(cfg, "cpu")["fused"]
    tok, pos, cache = lane.tok, lane.pos, lane.ck[0]
    start = lane.state()
    emits = [B.eager_step(lane, cfg) for _ in range(3)]
    assert lane.tok is tok and lane.pos is pos and lane.ck[0] is cache  # updated in place
    assert not torch.equal(lane.pos, start[-1])
    lane.set_state(start)
    again = [B.step(lane, cfg) for _ in range(3)]  # the CPU's step is the eager one
    assert all(torch.equal(a, b) for a, b in zip(emits, again))
