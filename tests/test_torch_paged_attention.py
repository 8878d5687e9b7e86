"""The port's paged KV primitives (``ops/paged_attention.py``) against the
JAX package's on the same inputs, bit for bit: the virtual-cache gather,
the block math, and the table-routed scatter (whose only colliding writes
go to the trash page, compared apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.ops import paged_attention as JPA
from pytorch_zappa_serverless_tpu_torch.ops import paged_attention as PPA


def _setup(seed, NB=12, BS=4, D=8, S=3, MB=4):
    rng = np.random.default_rng(seed)
    pages = rng.standard_normal((NB, BS, D)).astype(np.float32)
    # Each row owns distinct pages; row 2 is a retired row: all trash.
    tables = np.zeros((S, MB), np.int32)
    tables[0] = [3, 7, 1, 0]
    tables[1] = [2, 5, 9, 11]
    return rng, pages, tables


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_gather_kv_matches_jax(dtype):
    _, pages, tables = _setup(0)
    pages = pages.astype(dtype)
    got = PPA.gather_kv(torch.from_numpy(pages), torch.from_numpy(tables)).numpy()
    want = np.asarray(JPA.gather_kv(jnp.asarray(pages), jnp.asarray(tables)))
    assert got.shape == want.shape == (3, 16, 8) and got.tobytes() == want.tobytes()


def test_paged_index_matches_jax():
    rng, _, tables = _setup(1)
    positions = rng.integers(0, 16, (3, 5)).astype(np.int32)
    got = PPA.paged_index(torch.from_numpy(tables), torch.from_numpy(positions), 4)
    want = JPA.paged_index(jnp.asarray(tables), jnp.asarray(positions), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("T", [1, 6])
def test_scatter_kv_matches_jax(T):
    rng, pages, tables = _setup(2)
    positions = np.stack([rng.permutation(13)[:T] for _ in range(3)]).astype(np.int32)
    values = rng.standard_normal((3, T, 8)).astype(np.float32)
    got = PPA.scatter_kv(torch.from_numpy(pages.copy()), torch.from_numpy(tables),
                         torch.from_numpy(positions), torch.from_numpy(values), 4).numpy()
    want = np.asarray(JPA.scatter_kv(jnp.asarray(pages), jnp.asarray(tables),
                                     jnp.asarray(positions), jnp.asarray(values), 4))
    # Every page but the trash page (0) bit for bit; the trash page only
    # takes writes (row 2's, and row 0's past its pages), in either order.
    assert got[1:].tobytes() == want[1:].tobytes()
    assert not np.array_equal(got[1:], pages[1:])


def test_scatter_kv_writes_in_place_and_casts():
    _, pages, tables = _setup(3)
    t = torch.from_numpy(pages.astype(np.float16))
    out = PPA.scatter_kv(t, torch.from_numpy(tables), torch.tensor([[5], [0], [1]]),
                         torch.ones((3, 1, 8)), 4)
    assert out is t and out.dtype == torch.float16
    assert (t[7, 1] == 1).all() and (t[2, 0] == 1).all()
