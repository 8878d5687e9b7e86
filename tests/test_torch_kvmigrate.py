"""The port's live-migration wire format against the JAX package's
``serving/kvmigrate.py``, on the CPU.

- A page record (index, hash, base64 K/V) packed by either package from the
  same page bytes is the same record, for bf16 pages (the port's CPU
  ``torch.bfloat16`` viewed as int16, the JAX package's ``ml_dtypes``
  array) and f32 ones; each package unpacks the other's records to the same
  bytes, a manifest one writes passes the other's check.
- A corrupt record (the fault's flip after the hash) raises
  ``PageIntegrityError`` naming its page in both; manifests with a foreign
  version, a missing field or no object are refused alike.
- ``MigrationStats`` snapshots equal after the same notes.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.serving import kvmigrate as JM
from pytorch_zappa_serverless_tpu_torch.serving import kvmigrate as PM

SHAPE = (2, 4, 16)  # [layers, block_size, d_model]


def _page_bits(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Two random bf16 pages as their int16 bits (finite values)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(SHAPE).astype(np.float32)
    v = rng.standard_normal(SHAPE).astype(np.float32) * 3
    return ((k.view(np.uint32) >> 16).astype(np.uint16).view(np.int16),
            (v.view(np.uint32) >> 16).astype(np.uint16).view(np.int16))


def _as_jax(bits: np.ndarray) -> np.ndarray:
    return bits.view(ml_dtypes.bfloat16)


def _as_port(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_page_records_are_byte_identical(seed, corrupt):
    kb, vb = _page_bits(seed)
    want = JM.pack_page(3, _as_jax(kb), _as_jax(vb), corrupt=corrupt)
    got = PM.pack_page(3, _as_port(kb), _as_port(vb), corrupt=corrupt)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_f32_page_records_are_byte_identical():
    rng = np.random.default_rng(5)
    k, v = rng.standard_normal(SHAPE).astype(np.float32), rng.standard_normal(SHAPE).astype(
        np.float32)
    assert PM.pack_page(0, torch.from_numpy(k), torch.from_numpy(v)) == JM.pack_page(0, k, v)


def test_jax_packed_pages_unpack_in_the_port_and_back():
    kb, vb = _page_bits(2)
    rec = JM.pack_page(7, _as_jax(kb), _as_jax(vb))
    i, k, v = PM.unpack_page(rec, SHAPE, "bfloat16")
    assert i == 7 and k.dtype == torch.bfloat16 and tuple(k.shape) == SHAPE
    assert np.array_equal(k.view(torch.int16).numpy(), kb)
    assert np.array_equal(v.view(torch.int16).numpy(), vb)
    # The reverse: the port's record decodes in the JAX package to the bytes.
    rec = PM.pack_page(4, k, v)
    j, jk, jv = JM.unpack_page(rec, SHAPE, "bfloat16")
    assert j == 4 and np.array_equal(jk.view(np.int16), kb)
    assert np.array_equal(jv.view(np.int16), vb)


def test_manifests_cross_packages():
    """A manifest either package's export writes (the keys the server
    fills) passes both checks, and its dtype names the pool the same way."""
    manifest = {"version": JM.FORMAT_VERSION, "stream_id": "s", "model": "gpt2",
                "adapter": None, "prompt": [1, 2], "emitted": [3], "watermark": 1,
                "max_new": 8, "state": {"tok": 4, "pos": 3}, "npages": 1,
                "page_shape": list(SHAPE), "dtype": str(np.dtype(ml_dtypes.bfloat16))}
    JM.check_manifest(manifest)
    PM.check_manifest(json.loads(json.dumps(manifest)))
    assert PM.dtype_name(torch.bfloat16) == manifest["dtype"]
    assert PM.dtype_name(torch.float32) == str(np.dtype(np.float32))
    assert PM.FORMAT_VERSION == JM.FORMAT_VERSION and PM.CAUSES == JM.CAUSES
    assert PM.MIGRATION_BUCKETS_MS == JM.MIGRATION_BUCKETS_MS


@pytest.mark.parametrize("pkg", [JM, PM], ids=["jax", "port"])
def test_corrupt_record_raises_integrity_error(pkg):
    kb, vb = _page_bits(3)
    bad = JM.pack_page(5, _as_jax(kb), _as_jax(vb), corrupt=True)
    with pytest.raises(pkg.PageIntegrityError) as ei:
        pkg.unpack_page(bad, SHAPE, "bfloat16")
    assert ei.value.indices == [5]
    assert isinstance(ei.value, pkg.MigrationError)


@pytest.mark.parametrize("change,match", [
    (lambda m: {**m, "version": 99}, "version"),
    (lambda m: {k: v for k, v in m.items() if k != "state"}, "missing field"),
    (lambda m: None, "JSON object"),
])
def test_manifest_validation_matches_jax(change, match):
    good = {"version": PM.FORMAT_VERSION, "prompt": [1], "emitted": [], "state": {},
            "npages": 1, "page_shape": [2, 4, 8], "dtype": "float32", "max_new": 8}
    PM.check_manifest(good)
    with pytest.raises(JM.MigrationError, match=match):
        JM.check_manifest(change(good))
    with pytest.raises(PM.MigrationError, match=match):
        PM.check_manifest(change(good))


def test_migration_stats_snapshot_matches_jax():
    got, want = PM.MigrationStats(), JM.MigrationStats()
    for stats in (got, want):
        stats.note("pressure", 0, 3, 0.7)
        stats.note("admin", 2, 1, 40.0)
        stats.failed += 1
    assert got.snapshot() == want.snapshot()


def test_unknown_page_dtype_is_refused():
    with pytest.raises(PM.MigrationError, match="dtype"):
        PM.torch_dtype("int4")
