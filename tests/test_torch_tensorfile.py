"""The port's safetensors reader and writer (``engine/tensorfile.py``)
against the ``safetensors`` package, in both directions: equal arrays, dtype
for dtype and shape for shape (0-d, empty and non-contiguous arrays
included), metadata read past, BF16 read as float32, and a header that does
not describe its file refused."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file, save_file

from pytorch_zappa_serverless_tpu_torch.engine import tensorfile as TF
from pytorch_zappa_serverless_tpu_torch.engine import weights as PW

DTYPES = ["float64", "float32", "float16", "int64", "int32", "int16", "int8", "uint64",
          "uint32", "uint16", "uint8", "bool"]


def _arrays(dtype: str) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(DTYPES.index(dtype))
    dt = np.dtype(dtype)
    if dt.kind == "f":
        full = rng.standard_normal((6, 10)).astype(dt)
    elif dt.kind == "b":
        full = rng.integers(0, 2, (6, 10)).astype(dt)
    else:
        info = np.iinfo(dt)
        full = rng.integers(info.min, info.max, (6, 10), dtype=dt, endpoint=True)
    return {"full": full, "scalar": np.asarray(full[1, 2]), "empty": full[:0],
            "empty_cols": np.zeros((3, 0, 2), dt), "strided": full[::2, 1::3],
            "transposed": full.T}


def _assert_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, g.shape, w.dtype, w.shape)
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_files_load_in_safetensors(tmp_path, dtype):
    arrays = _arrays(dtype)
    TF.save(arrays, tmp_path / "p.safetensors")
    _assert_equal(load_file(str(tmp_path / "p.safetensors")), arrays)
    _assert_equal(TF.load(tmp_path / "p.safetensors"), arrays)


@pytest.mark.parametrize("dtype", DTYPES)
def test_safetensors_files_load_in_the_port(tmp_path, dtype):
    arrays = _arrays(dtype)
    save_file({k: np.array(v, order="C") for k, v in arrays.items()},
              str(tmp_path / "s.safetensors"))
    got = TF.load(tmp_path / "s.safetensors")
    _assert_equal(got, arrays)
    assert all(v.flags.writeable for v in got.values())


def test_mixed_dtypes_both_ways_metadata_read_past(tmp_path):
    arrays = {**{f"{d}/x": _arrays(d)["full"] for d in DTYPES}, "s": np.asarray(np.float16(3.5))}
    TF.save(arrays, tmp_path / "p.safetensors")
    _assert_equal(load_file(str(tmp_path / "p.safetensors")), arrays)
    with safe_open(str(tmp_path / "p.safetensors"), "np") as f:
        assert f.metadata() is None
    # a Hugging Face checkpoint carries {"format": "pt"}: read past
    save_file(arrays, str(tmp_path / "s.safetensors"), metadata={"format": "pt"})
    _assert_equal(TF.load(tmp_path / "s.safetensors"), arrays)


def test_bf16_reads_as_float32(tmp_path):
    from safetensors.torch import save_file as torch_save

    t = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    torch_save({"w": t, "b": torch.arange(4, dtype=torch.int32)}, str(tmp_path / "b.safetensors"))
    got = TF.load(tmp_path / "b.safetensors")
    assert got["w"].dtype == np.float32 and got["w"].shape == (5, 7)
    assert np.array_equal(got["w"], t.float().numpy())
    assert np.array_equal(got["b"], np.arange(4, dtype=np.int32))
    # load_state_dict's .safetensors branch reads through the same reader
    assert np.array_equal(PW.load_state_dict(tmp_path / "b.safetensors")["w"], t.float().numpy())


def _raw(path, header: dict, data: bytes) -> None:
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


def _f32(shape, begin):
    end = begin + 4 * int(np.prod(shape))
    return {"dtype": "F32", "shape": shape, "data_offsets": [begin, end]}


@pytest.mark.parametrize("case,header,nbytes,match", [
    ("overlap", {"a": _f32([2], 0), "b": _f32([2], 4)}, 12, "overlap"),
    ("gap", {"a": _f32([2], 0), "b": _f32([2], 12)}, 20, "gap"),
    ("short file", {"a": _f32([4], 0)}, 12, "cover 16 data bytes, the file holds 12"),
    ("long file", {"a": _f32([2], 0)}, 12, "cover 8 data bytes, the file holds 12"),
    ("unknown dtype", {"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}, 2,
     "unknown dtype"),
    ("byte count", {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, 8,
     "do not hold"),
    ("negative dim", {"a": {"dtype": "F32", "shape": [-1], "data_offsets": [0, 0]}}, 0, "shape"),
])
def test_a_header_that_does_not_describe_its_file_is_refused(tmp_path, case, header, nbytes,
                                                             match):
    path = tmp_path / "bad.safetensors"
    _raw(path, header, bytes(nbytes))
    with pytest.raises(ValueError, match=match):
        TF.load(path)


def test_truncated_header_is_refused(tmp_path):
    path = tmp_path / "t.safetensors"
    path.write_bytes(struct.pack("<Q", 4096) + b"{}")
    with pytest.raises(ValueError, match="header length"):
        TF.load(path)
    path.write_bytes(b"\x01\x02")
    with pytest.raises(ValueError, match="shorter than"):
        TF.load(path)


def test_native_tree_round_trips_through_both_readers(tmp_path):
    """``save_native`` writes through the port's writer; the package reads
    the flattened tree, and the port's ``load_native`` the package's file."""
    tree = {"a": {"kernel": np.ones((3, 2), np.float32), "kernel_q": np.full((2, 2), -3, np.int8)},
            "b": np.arange(3, dtype=np.int64)[::-1], "c": {"d": {"scale": np.float32(2.0)}}}
    path = tmp_path / "t.tpu.safetensors"
    PW.save_native(tree, path)
    flat = {k: np.asarray(v) for k, v in PW.flatten_tree(tree).items()}
    _assert_equal(load_file(str(path)), flat)
    other = tmp_path / "o.tpu.safetensors"
    save_file({k: np.array(v, order="C") for k, v in flat.items()}, str(other))
    _assert_equal(PW.flatten_tree(PW.load_native(other)), flat)
