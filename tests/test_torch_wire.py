"""The port's binary tensor lane codec (``serving/wire.py``) against the JAX
package's: the codec cases of ``tests/test_tensorlane.py`` on the port's
module, frames byte-identical between the packages for every dtype code in
both directions, the same error classes for malformed and oversized
frames, and the journal's ``__tensor__`` wrapper.  Exact: the codec moves
bytes, so every comparison is byte for byte."""

import base64
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from pytorch_zappa_serverless_tpu.serving import wire as jwire
from pytorch_zappa_serverless_tpu_torch.serving import wire

DTYPES = ["uint8", "int8", "uint16", "int16", "uint32", "int32", "uint64", "int64",
          "float16", "float32", "float64", "bool"]


def _array(dtype: str, shape=(3, 4), seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).random(shape) * 10).astype(dtype)


# -- the codec on the port's module (test_tensorlane.py's cases) ---------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip_every_wire_dtype(dtype):
    arr = _array(dtype)
    items, flags = wire.unpack(bytes(wire.pack([arr])))
    assert flags == 0 and len(items) == 1
    assert items[0].dtype == arr.dtype and np.array_equal(items[0], arr)


def test_roundtrip_multiblock_and_json_blocks():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    b = np.zeros((0, 5), dtype=np.int32)
    meta = {"model": "m", "timing": {"total_ms": 1.5}}
    frame = wire.pack([meta, a, b, {"top_k": [1, 2]}], flags=wire.FLAG_META | wire.FLAG_LIST)
    items, flags = wire.unpack(bytes(frame))
    assert flags == wire.FLAG_META | wire.FLAG_LIST
    assert items[0] == meta
    assert np.array_equal(items[1], a) and items[1].shape == (2, 3, 4)
    assert items[2].shape == (0, 5)
    assert items[3] == {"top_k": [1, 2]}


def test_unpack_is_zero_copy_and_readonly():
    arr = np.arange(64, dtype=np.uint8).reshape(8, 8)
    items, _ = wire.unpack(bytes(wire.pack([arr])))
    view = items[0]
    assert not view.flags.writeable and not view.flags.owndata
    assert np.array_equal(view, arr)


def test_response_frame_roundtrip():
    preds = [np.ones((2, 2), np.float32), {"top_k": [{"label": "x"}]}]
    meta, out = wire.unpack_response(bytes(wire.pack_response({"model": "m"}, preds,
                                                               list_frame=True)))
    assert meta == {"model": "m"}
    assert np.array_equal(out[0], preds[0]) and out[1] == preds[1]
    with pytest.raises(wire.FrameError):
        wire.unpack_response(bytes(wire.pack([np.ones(2, np.uint8)])))


MUTATIONS = [
    (lambda b: b"XXXX" + b[4:], "bad magic"),
    (lambda b: b[:4] + bytes([99]) + b[5:], "bad version"),
    (lambda b: b[:10], "truncated mid-header"),
    (lambda b: b[:-3], "truncated data"),
    (lambda b: b + b"zz", "trailing bytes"),
    (lambda b: b[:8] + bytes([0xEE]) + b[9:], "unknown dtype code"),
    (lambda b: b[:10] + bytes([7]) + b[11:], "nonzero reserved"),
]


@pytest.mark.parametrize("mutate,why", MUTATIONS, ids=[w for _, w in MUTATIONS])
def test_malformed_frames_raise_the_same_class_in_both(mutate, why):
    good = bytes(wire.pack([np.arange(12, dtype=np.uint8).reshape(3, 4)]))
    bad = mutate(good)
    with pytest.raises(jwire.FrameError) as want:
        jwire.unpack(bad)
    with pytest.raises(wire.FrameError) as got:
        wire.unpack(bad)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_declared_oversize_raises_before_allocation_in_both():
    hdr = wire._HDR.pack(wire.MAGIC, wire.VERSION, 0, 1)
    frame = hdr + wire._BLK.pack(9, 2, 0) + wire._DIM.pack(60000) + wire._DIM.pack(60000)
    for mod in (wire, jwire):
        with pytest.raises(mod.FrameTooLarge):
            mod.unpack(frame, max_bytes=1 << 20)
    big = bytes(wire.pack([np.zeros(4096, np.uint8)]))
    with pytest.raises(wire.FrameTooLarge):
        wire.unpack(big, max_bytes=64)


def test_empty_frame_and_unpackable_dtype_rejected():
    with pytest.raises(wire.FrameError):
        wire.pack([])
    with pytest.raises(wire.FrameError):
        wire.pack([np.zeros(2, dtype=np.complex64)])


def test_buffer_pool_reuse_and_caps():
    pool = wire.BufferPool(max_buffers=2, max_bytes=1024)
    pool.release(pool.acquire(100))
    b2 = pool.acquire(40)
    assert len(b2) == 40 and pool.hits == 1 and pool.misses == 1
    pool.release(b2)
    pool.release(bytearray(4096))
    assert pool.snapshot()["free"] == 1
    arr = np.arange(10, dtype=np.int16)
    assert bytes(wire.pack([arr], pool=pool)) == bytes(wire.pack([arr]))


# -- byte identity with the JAX package ----------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("flags", [0, 1])
def test_pack_is_byte_identical_to_the_reference(dtype, flags):
    arrs = [_array(dtype, (2, 3), 1), _array(dtype, (5,), 2), {"k": [1, 2.5, "x"]}]
    assert bytes(wire.pack(arrs, flags=flags)) == bytes(jwire.pack(arrs, flags=flags))


@pytest.mark.parametrize("dtype", DTYPES)
def test_frames_cross_unpack_to_equal_arrays(dtype):
    arr = _array(dtype, (4, 2, 3), 3)
    for packer, unpacker in ((wire, jwire), (jwire, wire)):
        items, flags = unpacker.unpack(bytes(packer.pack([arr, {"a": 1}], flags=1)))
        assert flags == 1 and items[1] == {"a": 1}
        assert items[0].dtype == arr.dtype and np.array_equal(items[0], arr)


def test_bfloat16_blocks_are_byte_identical_both_ways():
    """Code 12: the reference packs an ml_dtypes bfloat16 array, the port a
    torch.bfloat16 tensor of the same bits."""
    bits = np.random.default_rng(4).integers(-2**15, 2**15, (3, 5)).astype(np.int16)
    ref = bits.view(ml_dtypes.bfloat16)
    port = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    frame = bytes(wire.pack([port]))
    assert frame == bytes(jwire.pack([ref]))
    got, _ = wire.unpack(bytes(jwire.pack([ref])))
    assert got[0].dtype == torch.bfloat16 and tuple(got[0].shape) == (3, 5)
    assert np.array_equal(got[0].view(torch.int16).numpy(), bits)
    back, _ = jwire.unpack(frame)
    assert np.array_equal(back[0].view(np.int16), bits)


def test_response_frames_are_byte_identical():
    preds = [{"top_k": [{"label": "cat", "index": 3, "prob": 0.25}]},
             np.arange(6, dtype=np.float32)]
    meta = {"model": "resnet18", "timing": {"queue_ms": 0.5}}
    for list_frame in (False, True):
        assert (bytes(wire.pack_response(meta, preds, list_frame))
                == bytes(jwire.pack_response(meta, preds, list_frame)))


# -- the journal's tensor wrapper ---------------------------------------------

def test_journal_tensor_wrapper_roundtrip():
    from pytorch_zappa_serverless_tpu_torch.serving.durability import _json_default, _revive

    arr = np.arange(12, dtype=np.float16).reshape(3, 4)
    encoded = json.loads(json.dumps({"payload": arr, "raw": b"png"}, default=_json_default))
    assert set(encoded["payload"]) == {"__tensor__"}
    base64.b64decode(encoded["payload"]["__tensor__"])
    revived = _revive(encoded)
    assert revived["raw"] == b"png"
    assert revived["payload"].dtype == arr.dtype and np.array_equal(revived["payload"], arr)
