"""Minimum-norm least squares of GMRES's small Hessenberg system, as a
hand-written Hopper kernel and its plain version.

Counterpart of ``jnp.linalg.lstsq(H, beta)`` in
:func:`lbfgs_ffnn_tpu.ops.iterative.gmres_counted`: the minimum-norm
solution through an SVD, singular values below ``eps * max(M, N)`` of the
largest (and exact zeros) treated as zero. :func:`lstsq_plain` is that
formula in torch (``torch.linalg.svd``); :func:`lstsq_min_norm` calls it for
CPU tensors and launches ``lstsq_min_norm_kernel`` (``csrc/lstsq.cu``, a
one-warp Jacobi SVD, whose header says why) for CUDA tensors: on the card
``torch.linalg.lstsq`` has only the QR driver, which a rank-deficient H
(a happy breakdown) defeats, and the SVD routes read a flag on the host,
which a captured GMRES cannot do. A CUDA tensor the kernel does not take
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from lbfgs_ffnn_torch import _build

MAX_DIM = 32  # kMaxDim in the source: rows and columns of H


def lstsq_plain(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``argmin |H y - b|`` of least norm, JAX's ``lstsq`` formula: the SVD
    of ``H``, the singular values kept where ``s > 0`` and ``s >= eps *
    max(m, n) * s[0]``. A non-finite ``H`` gives NaN, as JAX's does
    (``torch.linalg.svd`` would raise)."""
    m, n = H.shape
    finite = torch.isfinite(H).all()
    u, s, vh = torch.linalg.svd(torch.where(finite, H, torch.zeros_like(H)), full_matrices=False)
    rcond = torch.finfo(H.dtype).eps * max(m, n)
    mask = (s > 0) & (s >= rcond * s[0])
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))
    y = vh.T @ (s_inv * (u.T @ b))
    return torch.where(finite, y, torch.full_like(y, float("nan")))


def _lib() -> ctypes.CDLL:
    lib = _build.load("lstsq")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstsq_launch.argtypes = [i, p, p, p, i, i, p, p]
        lib.lstsq_launch.restype = i
        lib.lstsq_error_string.argtypes = [i]
        lib.lstsq_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


class LaunchCount:
    """The kernel's launches, counted on the device (an int32 per device,
    one added by each launch, so replays of a captured launch count as
    eager ones do). ``int(count)`` reads it (a host sync); ``reset()`` sets
    it to 0. ``what`` names the kernel's wrapper in the error a first
    launch under capture raises."""

    def __init__(self, what: str = "lstsq_min_norm"):
        self._device: dict[int, torch.Tensor] = {}
        self._what = what

    def counter(self, device: torch.device) -> torch.Tensor:
        idx = device.index if device.index is not None else torch.cuda.current_device()
        if idx not in self._device:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the launch counter is made by an eager launch; capture "
                                   f"{self._what} only after it has run on the device")
            self._device[idx] = torch.zeros(1, dtype=torch.int32,
                                            device=torch.device("cuda", idx))
        return self._device[idx]

    def __int__(self) -> int:
        return sum(int(c) for c in self._device.values())

    def reset(self) -> None:
        for c in self._device.values():
            c.zero_()

    def __repr__(self) -> str:
        return f"LaunchCount({int(self)})"


def lstsq_min_norm(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution of ``H y = b`` (``H`` of at
    most :data:`MAX_DIM` rows and columns, f32 or f64): :func:`lstsq_plain`
    for CPU tensors, the kernel for CUDA tensors, on the current stream,
    adding one to ``lstsq_min_norm.LAUNCHES`` on the device."""
    if H.device.type == "cpu":
        return lstsq_plain(H, b)
    if H.device.type != "cuda":
        raise ValueError(f"lstsq_min_norm takes CPU or CUDA tensors, got {H.device}")
    if H.dim() != 2 or b.shape != (H.shape[0],):
        raise ValueError(f"H must be (m, n) and b (m,), got {tuple(H.shape)}, {tuple(b.shape)}")
    m, n = H.shape
    if not (1 <= m <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"the kernel takes at most {MAX_DIM} x {MAX_DIM}, got {m} x {n}")
    if H.dtype not in (torch.float32, torch.float64) or b.dtype != H.dtype:
        raise ValueError(f"H and b must be float32 or float64 alike, got {H.dtype}, {b.dtype}")
    if b.device != H.device:
        raise ValueError(f"b is on {b.device}, H on {H.device}")
    lib = _lib()
    with torch.cuda.device(H.device):
        Hc, bc = H.contiguous(), b.contiguous()
        y = torch.empty(n, dtype=H.dtype, device=H.device)
        count = lstsq_min_norm.LAUNCHES.counter(H.device)
        rc = lib.lstsq_launch(H.element_size(), Hc.data_ptr(), bc.data_ptr(), y.data_ptr(), m, n,
                              torch.cuda.current_stream().cuda_stream, count.data_ptr())
    if rc != 0:
        raise RuntimeError(f"lstsq_launch({m} x {n}, {H.dtype}) failed: CUDA error {rc} "
                           f"({lib.lstsq_error_string(rc).decode()})")
    return y


lstsq_min_norm.LAUNCHES = LaunchCount()
