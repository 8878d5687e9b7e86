"""The port's image preprocessing against the JAX package's, on the CPU.

- ``decode_image`` gives the JAX package's pixels for PNGs of every mode
  Pillow writes, a JPEG, and the port's own PNG writer's output.
- The native ``hostops`` copy (``resize_center_crop_u8``, ``pack_batch_u8``)
  gives the JAX package's own bytes, and the whole host path (bytes →
  uint8 crop) equals the JAX package's.
- ``normalize_on_device``, the labels and the uint8 collate against their
  references.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_zappa_serverless_tpu.ops import hostops as JH
from pytorch_zappa_serverless_tpu.ops import preprocessing as JP
from pytorch_zappa_serverless_tpu.utils import labels as JL
from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate
from pytorch_zappa_serverless_tpu_torch.models.sd15 import png_bytes
from pytorch_zappa_serverless_tpu_torch.ops import hostops as PH
from pytorch_zappa_serverless_tpu_torch.ops import preprocessing as PP
from pytorch_zappa_serverless_tpu_torch.utils import labels as PL


def _encoded(mode: str, fmt: str) -> bytes:
    rng = np.random.default_rng(5)
    img = Image.fromarray(rng.integers(0, 256, (31, 45, 3)).astype(np.uint8))
    img = img.convert(mode) if mode != "P" else img.quantize(64)
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("mode,fmt", [("RGB", "PNG"), ("RGBA", "PNG"), ("L", "PNG"),
                                      ("LA", "PNG"), ("P", "PNG"), ("RGB", "JPEG"),
                                      ("L", "JPEG")])
def test_decode_image_is_the_jax_packages(mode, fmt):
    data = _encoded(mode, fmt)
    got = PP.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (31, 45, 3)
    np.testing.assert_array_equal(got, np.asarray(JP.decode_image(data), np.uint8))


def test_decode_image_reads_the_ports_png_writer():
    pixels = np.random.default_rng(6).integers(0, 256, (20, 30, 3)).astype(np.uint8)
    np.testing.assert_array_equal(PP.decode_image(png_bytes(pixels)), pixels)


def test_native_library_builds_outside_the_source_tree():
    assert PH.native_available(), "g++ is needed to build the host library"
    assert PH.BUILD_DIR.parts[-2:] == ("build", "torch_host")
    assert (PH.BUILD_DIR / "_hostops.so").exists()


@pytest.mark.parametrize("sh,sw,resize_to,crop", [(480, 640, 256, 224), (640, 480, 256, 224),
                                                  (300, 224, 256, 224), (50, 90, 72, 64),
                                                  (64, 64, 72, 64)])
def test_resize_center_crop_u8_is_the_jax_packages(sh, sw, resize_to, crop):
    assert JH.native_available()
    img = np.random.default_rng(sh + sw).integers(0, 256, (sh, sw, 3), np.uint8)
    got = PH.resize_center_crop_u8(img, resize_to, crop)
    np.testing.assert_array_equal(got, JH.resize_center_crop_u8(img, resize_to, crop))


def test_pack_batch_u8_is_the_jax_packages():
    rng = np.random.default_rng(9)
    samples = [rng.integers(0, 256, (8, 8, 3), np.uint8) for _ in range(3)]
    got = PH.pack_batch_u8(samples, 4)
    want = JH.pack_batch_u8(samples, 4)
    assert got.shape == (4, 8, 8, 3) and not got[3].any()
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="sample 1 shape"):
        PH.pack_batch_u8([samples[0], samples[1][:4]], 4)
    with pytest.raises(ValueError, match="exceed capacity"):
        PH.pack_batch_u8(samples, 2)


@pytest.mark.parametrize("sh,sw", [(90, 120), (301, 257)])
def test_host_path_is_the_jax_packages(sh, sw):
    """bytes → uint8 crop: the same bytes as the JAX package's host path."""
    img = np.random.default_rng(sh).integers(0, 256, (sh, sw, 3), np.uint8)
    data = png_bytes(img)
    got = PP.preprocess_image_bytes_uint8(data, 72, 64)
    want = JP.preprocess_image_bytes_uint8(data, 72, 64)
    assert got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)


def test_crop_larger_than_the_image_takes_the_pil_path():
    """Where the native library cannot serve (a crop larger than the resized
    image), the JAX package's PIL path, zero-padded."""
    img = np.random.default_rng(10).integers(0, 256, (40, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="rc=2"):
        PH.resize_center_crop_u8(img, 32, 48)
    got = PP.resize_center_crop(img, 32, 48)
    want = JP.resize_center_crop(Image.fromarray(img), 32, 48)
    assert got.shape == (48, 48, 3) and not got[0].any()
    np.testing.assert_array_equal(got, want)


def test_normalize_on_device_matches_the_jax_package():
    x = np.random.default_rng(11).integers(0, 256, (2, 5, 6, 3), np.uint8)
    want = np.asarray(JP.normalize_on_device(jnp.asarray(x)))
    got = PP.normalize_on_device(torch.from_numpy(x), torch.from_numpy(PP.IMAGENET_MEAN),
                                 torch.from_numpy(PP.IMAGENET_STD))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_labels_are_the_jax_packages(tmp_path):
    assert PL.load_labels(None, 12) == JL.load_labels(None, 12)
    listed = tmp_path / "list.json"
    listed.write_text('["tench", "goldfish"]')
    keyed = tmp_path / "dict.json"
    keyed.write_text('{"0": ["n01440764", "tench"], "1": "goldfish"}')
    holed = tmp_path / "hole.json"
    holed.write_text('{"0": "a", "2": "c"}')
    for path in (listed, keyed):
        assert PL.load_labels(path) == JL.load_labels(path) == ["tench", "goldfish"]
    with pytest.raises(ValueError, match="missing class index 1"):
        PL.load_labels(holed)


def test_uint8_collate_packs_natively_and_pads_with_zeros():
    rng = np.random.default_rng(12)
    samples = [{"image": rng.integers(0, 256, (4, 4, 3), np.uint8)} for _ in range(3)]
    spec = {"image": ((4, 4, 4, 3), torch.uint8)}
    out = default_collate(samples, (4,), spec)["image"]
    assert out.dtype == np.uint8 and out.shape == (4, 4, 4, 3)
    np.testing.assert_array_equal(out[:3], np.stack([s["image"] for s in samples]))
    assert not out[3].any()
