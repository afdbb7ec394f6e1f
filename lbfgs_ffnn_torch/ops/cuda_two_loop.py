"""The two-loop recursion as one hand-written Hopper kernel.

Counterpart of :mod:`lbfgs_ffnn_tpu.ops.pallas_two_loop`: the TPU kernel
``_kernel_resident`` becomes the cooperative CUDA kernel in
``csrc/two_loop.cu`` (its header says how the design maps to the card).
:func:`two_loop_cuda` has the signature of
:func:`lbfgs_ffnn_torch.ops.two_loop.two_loop`. For a CPU tensor it calls
that plain version; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from lbfgs_ffnn_torch import _build
from lbfgs_ffnn_torch.ops.two_loop import RingState, two_loop

# The kernel keeps one slice of the working vector per block in shared
# memory; above this padded length the slices of a one-block-per-SM grid
# outgrow what a block may hold on smaller cards, so dispatch refuses it.
_MAX_N_PAD = 4 * 1024 * 1024
_MAX_M = 1024  # alphas live in shared memory (kMaxM in the source)
_N_PARTIALS = 3  # kNumPartials in the source


def kernel_dispatch(n_pad: int, m: int, dtype, pair_dtype=None) -> tuple[str, str]:
    """Which implementation :func:`two_loop_cuda` uses for a CUDA ring of
    padded row length ``n_pad``, capacity ``m``, working ``dtype`` and
    stored-pair ``pair_dtype`` (defaults to ``dtype``).

    Returns ``(impl, reason)``: ``("cuda-cooperative", "")`` when the kernel
    takes the ring, else ``("unsupported", reason)``, and the wrapper then
    raises with the reason instead of substituting another path.
    """
    pd = pair_dtype if pair_dtype is not None else dtype
    if dtype != torch.float32:
        return "unsupported", f"dtype {dtype} != torch.float32"
    if pd != torch.float32:
        return "unsupported", f"pair dtype {pd} != torch.float32 (narrow pairs are not ported yet)"
    if n_pad % 4:
        return "unsupported", f"padded row length {n_pad} is not a multiple of 4"
    if n_pad > _MAX_N_PAD:
        return "unsupported", (f"padded row length {n_pad} > {_MAX_N_PAD}: the per-block "
                               "slices of the working vector no longer fit shared memory")
    if not 1 <= m <= _MAX_M:
        return "unsupported", f"history size m={m} outside [1, {_MAX_M}]"
    return "cuda-cooperative", ""


def _lib() -> ctypes.CDLL:
    lib = _build.load("two_loop")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.two_loop_config.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.two_loop_config.restype = i
        lib.two_loop_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                     ctypes.c_float, ctypes.c_float, p]
        lib.two_loop_f32.restype = i
        lib.two_loop_error_string.argtypes = [i]
        lib.two_loop_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.two_loop_error_string(rc).decode()})")


_CONFIGS: dict[tuple[int, int, int], tuple[int, int]] = {}


def _config(lib: ctypes.CDLL, device_index: int, n_pad: int, m: int) -> tuple[int, int]:
    """(grid, floats per block) for this device and shape, queried once."""
    key = (device_index, n_pad, m)
    if key not in _CONFIGS:
        grid, slice_ = ctypes.c_int(), ctypes.c_int()
        _check(lib, lib.two_loop_config(n_pad, m, ctypes.byref(grid), ctypes.byref(slice_)),
               "two_loop_config")
        _CONFIGS[key] = (grid.value, slice_.value)
    return _CONFIGS[key]


def two_loop_cuda(
    v: torch.Tensor,
    hist: RingState,
    *,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> torch.Tensor:
    """``r = H_k @ v`` by the two-loop recursion (not negated), as
    :func:`~lbfgs_ffnn_torch.ops.two_loop.two_loop`.

    A CPU ``v`` goes to the plain version. A CUDA ``v`` launches the
    cooperative kernel on the current stream, adds one to
    ``two_loop_cuda.LAUNCHES``, and never reads ``head``, ``count`` or
    ``rho`` back to the host; anything the kernel does not take raises.
    """
    if v.device.type == "cpu":
        return two_loop(v, hist, clamp_gamma=clamp_gamma,
                        gamma_min=gamma_min, gamma_max=gamma_max)
    if v.device.type != "cuda":
        raise ValueError(f"two_loop_cuda takes CPU or CUDA tensors, got {v.device}")
    S, Y, rho, head, count = hist
    m, n_pad = S.shape
    impl, reason = kernel_dispatch(n_pad, m, v.dtype, S.dtype)
    if impl != "cuda-cooperative":
        raise ValueError(f"two_loop_cuda cannot run this ring: {reason}")
    n = v.shape[0]
    if v.dim() != 1 or n > n_pad:
        raise ValueError(f"v must be 1-D with at most {n_pad} entries, got {tuple(v.shape)}")
    if Y.shape != S.shape or rho.shape != (m,) or head.shape != () or count.shape != ():
        raise ValueError("ring shapes disagree: S, Y (m, n_pad); rho (m,); head, count scalars")
    if Y.dtype != torch.float32 or rho.dtype != torch.float32:
        raise ValueError(f"Y and rho must be float32, got {Y.dtype}, {rho.dtype}")
    if head.dtype != torch.int32 or count.dtype != torch.int32:
        raise ValueError(f"head and count must be int32, got {head.dtype}, {count.dtype}")
    for name, t in (("S", S), ("Y", Y), ("rho", rho), ("head", head), ("count", count)):
        if t.device != v.device:
            raise ValueError(f"ring {name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"ring {name} must be contiguous")

    lib = _lib()
    with torch.cuda.device(v.device):
        grid, slice_ = _config(lib, v.device.index, n_pad, m)
        v_pad = torch.nn.functional.pad(v, (0, n_pad - n)).contiguous()
        out = torch.empty(n_pad, dtype=v.dtype, device=v.device)
        partials = torch.empty(2 * _N_PARTIALS * grid, dtype=torch.float32, device=v.device)
        rc = lib.two_loop_f32(
            v_pad.data_ptr(), S.data_ptr(), Y.data_ptr(), rho.data_ptr(),
            head.data_ptr(), count.data_ptr(), out.data_ptr(), partials.data_ptr(),
            n_pad, m, grid, slice_, int(clamp_gamma), gamma_min, gamma_max,
            torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, rc, "two_loop_f32 launch")
    two_loop_cuda.LAUNCHES += 1
    return out[:n]


two_loop_cuda.LAUNCHES = 0
