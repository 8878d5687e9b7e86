"""The port's sampling transforms (pytorch_zappa_serverless_tpu_torch/ops/
sampling.py) held against the JAX package's on the same logits.

Inputs come from a numpy seed.  The filters and the repetition penalty must
give the same masked sets and values exactly (the same f32 operations).
``choose`` draws its Gumbel noise from ``gumbel_noise``; with that function
replaced by JAX's own draws, ``jax.random.gumbel(fold_in(key(seed), t),
(V,))`` (what ``jax.random.categorical`` adds before its argmax), the two
packages must pick identical tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.ops import sampling as JS
from pytorch_zappa_serverless_tpu_torch.ops import sampling as PS

V = 300


def _logits(B=8, seed=0, ties=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 2.0).astype(np.float32)
    if ties:  # exact ties at the top: every tied copy must survive a filter
        x[0, :3] = x[0].max() + 1.0
        x[1, 10:20] = 0.5
    return x


def _knobs(B=8):
    top_k = np.array([1, 0, 5, 40, 0, 3, V + 10, 0][:B], np.int32)
    top_p = np.array([1.0, 1.0, 0.5, 0.9, 0.3, 0.95, 1.0, 0.0][:B], np.float32)
    return top_k, top_p


def _jax_noise(seeds, t):
    """[B, V] f32: what jax.random.categorical adds to row b's logits."""
    return np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(jax.random.key(int(s)), int(tt)), (V,), jnp.float32))
        for s, tt in zip(seeds, t)])


@pytest.fixture
def jax_noise(monkeypatch):
    def noise(seeds, t, n, device):
        assert n == V
        return torch.from_numpy(_jax_noise(seeds.tolist(), t.tolist())).to(device)

    monkeypatch.setattr(PS, "gumbel_noise", noise)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_top_k_top_p_matches_jax(seed):
    x = _logits(seed=seed)
    top_k, top_p = _knobs()
    want = np.asarray(JS.filter_top_k_top_p(jnp.asarray(x), jnp.asarray(top_k),
                                            jnp.asarray(top_p)))
    got = PS.filter_top_k_top_p(torch.from_numpy(x), torch.from_numpy(top_k),
                                torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])
    assert np.isfinite(got).sum(-1).min() >= 1  # every row keeps a token
    assert np.isfinite(got[0]).sum() == 3       # top_k = 1 keeps the three tied maxima


def test_repetition_penalty_matches_jax():
    x = _logits(seed=3)
    rng = np.random.default_rng(3)
    presence = rng.random((8, V)) < 0.2
    penalty = np.array([1.0, 1.3, 0.7, 2.0, 0.0, 1.1, 5.0, 1.0], np.float32)
    want = np.asarray(JS.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(presence),
                                                  jnp.asarray(penalty)))
    got = PS.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(presence),
                                      torch.from_numpy(penalty)).numpy()
    assert got.tobytes() == want.tobytes()


def _choose_both(x, temperature, seeds, t, top_k=None, top_p=None):
    opt = (lambda a: None if a is None else jnp.asarray(a))
    want = np.asarray(JS.choose(jnp.asarray(x), jnp.asarray(temperature), jnp.asarray(seeds),
                                jnp.asarray(t), opt(top_k), opt(top_p)))
    topt = (lambda a: None if a is None else torch.from_numpy(a))
    got = PS.choose(torch.from_numpy(x), torch.from_numpy(temperature),
                    torch.from_numpy(seeds), torch.from_numpy(t), topt(top_k),
                    topt(top_p)).numpy()
    return got, want


def test_choose_greedy_matches_jax():
    x = _logits(seed=4, ties=False)
    z = np.zeros(8, np.float32)
    got, want = _choose_both(x, z, np.arange(8, dtype=np.int32), np.zeros(8, np.int32))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.argmax(-1))


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("step", [0, 5])
def test_choose_sampled_matches_jax_draws(jax_noise, filtered, step):
    """With JAX's Gumbel draws in place of the port's, a mixed batch (greedy
    rows, sampled rows, filtered rows) picks JAX's tokens exactly."""
    x = _logits(seed=5 + step, ties=False)
    temperature = np.array([0.0, 0.8, 1.0, 1.5, 0.3, 0.0, 2.0, 1.0], np.float32)
    seeds = np.array([7, 7, 1, 2, 3, 4, 5, 123456], np.int32)
    t = np.arange(8, dtype=np.int32) + step
    top_k, top_p = _knobs() if filtered else (None, None)
    got, want = _choose_both(x, temperature, seeds, t, top_k, top_p)
    np.testing.assert_array_equal(got, want)
    hot = temperature > 0
    np.testing.assert_array_equal(got[~hot], x[~hot].argmax(-1))


def test_choose_sampled_distribution_follows_temperature(jax_noise):
    """Over many (seed, step) draws a sampled row spreads over tokens, and
    every draw is a token the top-k filter kept."""
    x = np.tile(_logits(B=1, seed=6, ties=False), (64, 1))
    seeds = np.arange(64, dtype=np.int32)
    top_k = np.full(64, 5, np.int32)
    got, want = _choose_both(x, np.ones(64, np.float32), seeds, np.zeros(64, np.int32),
                             top_k, np.ones(64, np.float32))
    np.testing.assert_array_equal(got, want)
    top5 = set(np.argsort(-x[0])[:5].tolist())
    assert set(got.tolist()) <= top5 and len(set(got.tolist())) >= 3


def test_gumbel_noise_rows_are_their_own():
    """A row's noise depends on its (seed, step) alone: the same in a batch of
    8 as alone, different for another step or seed."""
    seeds = torch.tensor([3, 9, 9, 1, 0, 7, 7, 2], dtype=torch.int32)
    t = torch.tensor([0, 0, 1, 4, 2, 5, 5, 9], dtype=torch.int32)
    batch = PS.gumbel_noise(seeds, t, V, torch.device("cpu"))
    assert batch.shape == (8, V) and batch.dtype == torch.float32
    assert torch.isfinite(batch).all()
    for b in range(8):
        alone = PS.gumbel_noise(seeds[b:b + 1], t[b:b + 1], V, torch.device("cpu"))
        assert torch.equal(alone[0], batch[b])
    assert torch.equal(batch[5], batch[6])
    assert not torch.equal(batch[1], batch[2]) and not torch.equal(batch[0], batch[1])
    # Gumbel(0, 1): mean ~0.5772, std ~1.2825 over 2400 draws.
    assert abs(batch.mean().item() - 0.5772) < 0.1
    assert abs(batch.std().item() - 1.2825) < 0.1


def test_choose_row_alone_equals_row_in_batch():
    """With the port's own noise, a sampled row draws the same token alone
    and in a batch of 8."""
    x = torch.from_numpy(_logits(seed=8, ties=False))
    temperature = torch.tensor([0.8, 1.0, 0.0, 1.2, 0.9, 0.5, 1.0, 2.0])
    seeds = torch.arange(8, dtype=torch.int32) * 11
    t = torch.arange(8, dtype=torch.int32)
    top_k = torch.tensor([40, 0, 0, 5, 0, 3, 0, 0], dtype=torch.int32)
    top_p = torch.tensor([0.95, 0.9, 1.0, 1.0, 1.0, 1.0, 0.5, 1.0])
    batch = PS.choose(x, temperature, seeds, t, top_k, top_p)
    for b in range(8):
        s = slice(b, b + 1)
        alone = PS.choose(x[s], temperature[s], seeds[s], t[s], top_k[s], top_p[s])
        assert alone.item() == batch[b].item()
    again = PS.choose(x, temperature, seeds, t, top_k, top_p)
    assert torch.equal(batch, again)
