"""Host-side image preprocessing: request bytes → uint8 HWC RGB at the
model's input size; normalization runs on the device.

The reference pipeline is torchvision's ``Resize(256) → CenterCrop(224) →
ToTensor() → Normalize(imagenet)``.  Here, as in the JAX package's
``ops/preprocessing.py``: decode to RGB, shorter-side bilinear resize and
center crop on the host (the native ``hostops`` library, fused), ship uint8
NHWC to the device (4x fewer bytes than f32), and scale and normalize there
(:func:`normalize_on_device`, inside the bucket's captured CUDA graph).

Decoding is the JAX package's: Pillow's ``Image.open(...).convert("RGB")``
(Pillow is a dependency of the package, as it is of the reference).
"""

from __future__ import annotations

import io

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def decode_image(data: bytes) -> np.ndarray:
    """Request bytes → uint8 HWC RGB, as the JAX package decodes them."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), dtype=np.uint8)


def resize_center_crop(img: np.ndarray, resize_to: int = 256, crop: int = 224) -> np.ndarray:
    """uint8 HWC RGB → uint8 [crop, crop, 3]: shorter-side resize (bilinear,
    torchvision's PIL backend numerics) then center crop.

    The native fused resample + crop (``hostops``) serves it where it can;
    where it cannot (no toolchain, or a crop larger than the resized image)
    the JAX package's PIL path does, zero-padding what lies outside."""
    from . import hostops

    img = np.asarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or min(img.shape[:2]) < 1:
        raise ValueError(f"expected a uint8 HWC RGB image, got shape {img.shape}")
    if hostops.native_available():
        try:
            return hostops.resize_center_crop_u8(img, resize_to, crop)
        except ValueError:
            pass
    pil = Image.fromarray(img)
    w, h = pil.size
    # torchvision's long-side truncation and round-half-even crop offsets.
    if w <= h:
        new_w, new_h = resize_to, int(h * resize_to / w)
    else:
        new_w, new_h = int(w * resize_to / h), resize_to
    pil = pil.resize((new_w, new_h), Image.BILINEAR)
    left = int(round((new_w - crop) / 2.0))
    top = int(round((new_h - crop) / 2.0))
    return np.asarray(pil.crop((left, top, left + crop, top + crop)), dtype=np.uint8)


def preprocess_image_bytes_uint8(data: bytes, resize_to: int = 256,
                                 crop: int = 224) -> np.ndarray:
    """Host path stopping at uint8 HWC; normalization happens on device."""
    return resize_center_crop(decode_image(data), resize_to, crop)


def normalize_on_device(x_uint8: torch.Tensor, mean: torch.Tensor,
                        std: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC → f32 NHWC in normalized space, on ``x``'s device: scale
    to [0, 1], subtract ``mean`` and divide by ``std`` (per channel, tensors
    on the same device: a host constant would be a host-to-device copy,
    which a CUDA graph capture refuses)."""
    return (x_uint8.float() / 255.0 - mean) / std
