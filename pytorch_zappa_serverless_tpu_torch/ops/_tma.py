"""What the wrappers of the kernels that read through TMA tensor maps share:
whether a tensor map can describe an operand, the padded copy that makes it
describable, and the error codes the kernels' entry points return besides
``cudaError_t`` values (``csrc/hopper.cuh``)."""

from __future__ import annotations

import torch

LAUNCH_ERRORS = {900001: "cuTensorMapEncodeTiled not found in the driver",
                 900002: "the kernel was built with too few registers for its "
                         "setmaxnreg split",
                 900003: "the kernel has no such tile or split"}


def launch_error(rc: int) -> str:
    """A kernel entry point's nonzero return code, in words."""
    if rc in LAUNCH_ERRORS:
        return LAUNCH_ERRORS[rc]
    if 910000 <= rc < 920000:
        return f"a tensor map was refused (CUresult {rc - 910000})"
    return f"CUDA error {rc}"


def tma_describable(t: torch.Tensor) -> bool:
    """Whether a TMA tensor map can read ``t`` in place: a 16-byte-aligned
    base and strides of every axis but the last that are whole multiples of
    16 bytes (the last axis contiguous is checked separately)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in t.stride()[:-1])


def padded_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous buffer whose last axis is rounded up to
    a multiple of 16 bytes, returned as the ``[..., :n]`` view: the same
    values, with strides a tensor map can describe.  The padding is never
    read: the kernel's tensor map stops at n."""
    n, per16 = t.shape[-1], 16 // t.element_size()
    buf = torch.empty((*t.shape[:-1], -(-n // per16) * per16), dtype=t.dtype, device=t.device)
    view = buf[..., :n]
    view.copy_(t)
    return view
