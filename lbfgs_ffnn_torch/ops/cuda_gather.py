"""Minibatch rows gathered from a page-locked host store by indices that
lie on the card: a hand-written Hopper kernel and its plain version.

Counterpart of the host gather in ``ChunkStore.fetch_rows`` of
:mod:`lbfgs_ffnn_tpu.data.outofcore` (``x[idx], y[idx]`` in numpy, reached
through ``io_callback``). The port's S-LBFGS draws its indices on the card
inside a captured CUDA graph, where a copy of them to the host would be a
host sync in every inner step, so ``gather_rows_kernel`` (``csrc/gather.cu``)
reads the rows over the host link through the store's device-mapped
address instead. :func:`gather_rows` launches it for indices on a CUDA
device and calls :func:`gather_rows_plain` for indices on the CPU; a CUDA
call the kernel does not take raises, nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from lbfgs_ffnn_torch import _build
from lbfgs_ffnn_torch.ops.cuda_lstsq import LaunchCount


def gather_rows_plain(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                      device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x[idx], y[idx])`` on ``device`` (idx's by default): one
    ``index_select`` per operand on the host. For indices on the card this
    reads them back first, a host sync: the tests' and chip_smoke.py's
    comparison, never the solvers' route."""
    device = idx.device if device is None else device
    i = idx.cpu()
    return x.index_select(0, i).to(device), y.index_select(0, i).to(device)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    if not getattr(lib, "_argtypes_set", False):
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.gather_device_pointer.argtypes = [p, ctypes.POINTER(p)]
        lib.gather_device_pointer.restype = ctypes.c_int
        lib.gather_launch.argtypes = [p, p, ll, ll, p, p, ll, ll, p, ll, p, p]
        lib.gather_launch.restype = ctypes.c_int
        lib.gather_error_string.argtypes = [ctypes.c_int]
        lib.gather_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.gather_error_string(rc).decode()})")


_MAPPED: dict[int, int] = {}  # host address -> device address of a pinned store


def mapped_pointer(t: torch.Tensor) -> int:
    """The device address of the page-locked host tensor ``t``
    (``cudaHostGetDevicePointer``; the host address is not assumed valid on
    the card), looked up once per address and cached (a
    :class:`~lbfgs_ffnn_torch.data.outofcore.ChunkStore` looks its tensors up
    when it is made, before any capture)."""
    if t.device.type != "cpu":
        raise ValueError(f"the gather kernel reads a host tensor, got one on {t.device}")
    host = t.data_ptr()
    if host not in _MAPPED:
        if not t.is_pinned():
            raise ValueError("the gather kernel reads a page-locked (pinned) host tensor")
        lib = _lib()
        dev = ctypes.c_void_p()
        _check(lib, lib.gather_device_pointer(ctypes.c_void_p(host), ctypes.byref(dev)),
               "cudaHostGetDevicePointer")
        _MAPPED[host] = dev.value
    return _MAPPED[host]


def _rows(t: torch.Tensor, name: str) -> None:
    if t.dim() < 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of rows, got shape "
                         f"{tuple(t.shape)}, contiguous={t.is_contiguous()}")


def gather_rows(x: torch.Tensor, y: torch.Tensor,
                idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x[idx], y[idx])`` on idx's device, x and y host tensors of rows.
    Indices on the CPU: :func:`gather_rows_plain`. Indices on a CUDA device
    (int64, one dimension; each in ``[0, len(x))``, an index outside gives a
    row of zeros): x and y pinned and contiguous, one launch of the kernel on
    the current stream gathers both into new device tensors, adding one to
    ``gather_rows.LAUNCHES`` on the device. Captures into a CUDA graph; the
    store's device addresses come from :func:`mapped_pointer`."""
    if idx.device.type == "cpu":
        return gather_rows_plain(x, y, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"gather_rows takes indices on the CPU or a CUDA device, got "
                         f"{idx.device}")
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"idx must be a 1-D int64 tensor, got {idx.dtype} of shape "
                         f"{tuple(idx.shape)}")
    _rows(x, "x")
    _rows(y, "y")
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"x has {x.shape[0]} rows, y {y.shape[0]}")
    x_src, y_src = mapped_pointer(x), mapped_pointer(y)
    lib = _lib()
    n = idx.shape[0]
    with torch.cuda.device(idx.device):
        xb = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=idx.device)
        yb = torch.empty((n,) + tuple(y.shape[1:]), dtype=y.dtype, device=idx.device)
        if n == 0:
            return xb, yb
        ic = idx.contiguous()
        count = gather_rows.LAUNCHES.counter(idx.device)
        rc = lib.gather_launch(x_src, xb.data_ptr(), x[0].numel() * x.element_size(), x.shape[0],
                               y_src, yb.data_ptr(), y[0].numel() * y.element_size(), y.shape[0],
                               ic.data_ptr(), n, torch.cuda.current_stream().cuda_stream,
                               count.data_ptr())
    _check(lib, rc, f"gather_launch({n} rows)")
    return xb, yb


gather_rows.LAUNCHES = LaunchCount("gather_rows")
