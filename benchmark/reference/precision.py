"""The reference's arithmetic: float32 with TF32 off, and the control's
TF32 (the nearest precision below it).

``precision("tf32")`` lets the card's matmuls round their operands to
TF32; :func:`tf32` rounds a tensor's values to TF32 (10 explicit mantissa
bits, to nearest, ties to even) for products that no matmul computes, as
the two-loop recursion's inner products.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(mode: str = "float32"):
    """Matmuls in full float32 (``"float32"``), or with TF32 on the card's
    tensor cores (``"tf32"``); restores the caller's settings."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest with ties to even; infinities and NaNs pass."""
    bits = t.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + keep) >> 13) << 13
    finite = torch.isfinite(t)
    return torch.where(finite, rounded.view(torch.float32), t)
