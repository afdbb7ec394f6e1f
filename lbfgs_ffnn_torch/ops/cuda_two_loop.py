"""The two-loop recursion as hand-written Hopper kernels, and their dispatch.

Counterpart of :mod:`lbfgs_ffnn_tpu.ops.pallas_two_loop`: the TPU kernels
``_kernel_resident``, ``_kernel`` and ``_kernel_blocked`` become the
cooperative CUDA kernels ``cuda-cooperative`` (the history slices resident
in shared memory, the compact form with two grid reductions per call, rings
of at most :data:`RESIDENT_MAX_M` pairs), ``cuda-streaming`` (the rows
streamed in groups of k pairs, one grid reduction per group; k from
:func:`group_size`) and ``cuda-blocked`` (only q in shared memory, the rows
read from global memory in every sweep, each prefetched into L2
:func:`prefetch_rows` rows ahead) in ``csrc/two_loop.cu``, whose header says
how each design maps to the card. :func:`kernel_dispatch` is the size policy of ``pallas_dispatch``; :func:`two_loop_cuda` has the
signature of :func:`lbfgs_ffnn_torch.ops.two_loop.two_loop`. For a CPU
tensor it calls that plain version; for a CUDA tensor it launches the kernel
the dispatch names (through :func:`launch`) or raises.
"""

from __future__ import annotations

import collections.abc
import ctypes

import torch

from lbfgs_ffnn_torch import _build
from lbfgs_ffnn_torch.ops.two_loop import RingState, two_loop

COOPERATIVE, STREAMING, BLOCKED = "cuda-cooperative", "cuda-streaming", "cuda-blocked"
_KIND = {COOPERATIVE: 0, STREAMING: 1, BLOCKED: 2}  # Kind in the source
_RESIDENT_STAMPED = 3  # kResidentStamped: K1 with its phase timestamps
N_STAMPS = 9  # kStamps: K1's phase boundaries, each as (ns, cycles)
_PAIR_DTYPES = (torch.float32, torch.bfloat16)
_MAX_M = 1024  # alphas live in shared memory (kMaxM in the source)
# The resident kernel's cap on m (kResidentMaxM): its first grid reduction
# carries m(m+1)/2 + 2 values, one thread summing each, 138 at 16.
RESIDENT_MAX_M = 16
_N_PARTIALS = RESIDENT_MAX_M * (RESIDENT_MAX_M + 1) // 2 + 2  # kNumPartials: the widest reduction
GROUP_SIZES = (8, 4, 2, 1)  # K2's k (two_loop_grouped_kernel<T, K>), largest first

# Shared memory a one-block-per-SM grid can hold on an H100 SXM (132 SMs,
# 227 KB a block may opt into, less the kernels' 5.5 KB of static arrays,
# rounded down): every kernel keeps each block's slice of the working vector
# and of its (s, y) buffers there, so this bounds the rings they take.
_GRID_SMEM_BYTES = 132 * 220 * 1024

# L2 the blocked kernel's prefetch may fill ahead of its sweeps. Measured on
# an H100 (PERF.md §6): one row ahead is as fast as any distance on the
# m=50 rings, and more rows ahead are evicted from the 50 MB L2 before use
# (a 16 MiB budget, two 8 MB f32 rows ahead, was 4-5% slower at n = 2M).
L2_PREFETCH_BUDGET = 4 * 1024 * 1024

# Rings the streaming kernel takes only at k = 1 go to the blocked kernel
# from this padded row length on (PERF.md §6, on an H100): at m = 50 the
# blocked kernel was 4.6% faster at n = 2M bf16 and 4.6% slower at n = 1M
# f32, where a stage moves the same 8 MB.
_K3_OVER_K2_AT_K1 = 2_000_000


def _bytes_per_element(impl: str, m: int, pair_bytes: int, group: int = 1) -> int:
    """Shared memory per element of a block's slice (the source's
    ``smem_per_element``): q in f32 plus all m (s, y) pairs (cooperative),
    two groups of ``group`` pairs (streaming) or none (blocked) in the pair
    type."""
    pairs = {COOPERATIVE: m, STREAMING: 2 * group, BLOCKED: 0}[impl]
    return 4 + 2 * pairs * pair_bytes


def fits(impl: str, n_pad: int, m: int, pair_bytes: int) -> bool:
    """Whether ``impl``'s slices fit the shared memory of a one-block-per-SM
    grid; the streaming kernel's at its least group, k = 1."""
    return n_pad * _bytes_per_element(impl, m, pair_bytes) <= _GRID_SMEM_BYTES


def group_fits(n_pad: int, m: int, pair_bytes: int, k: int) -> bool:
    """Whether the streaming kernel takes the ring in groups of ``k`` pairs:
    ``k`` one of :data:`GROUP_SIZES`, at most ``m``, and its two buffers of
    ``k`` pairs beside q fit as :func:`fits` counts."""
    return (k in GROUP_SIZES and k <= m
            and n_pad * _bytes_per_element(STREAMING, m, pair_bytes, k) <= _GRID_SMEM_BYTES)


def group_size(n_pad: int, m: int, pair_bytes: int) -> int | None:
    """The streaming kernel's k for a ring: the largest of (8, 4, 2, 1) that
    :func:`group_fits` allows (one grid reduction serves k pairs), None
    where even k = 1 does not fit. The deep m=100 ring takes 4 in f32 and
    8 in bf16; the bf16 ring at n = 2M takes 1."""
    return next((k for k in GROUP_SIZES if group_fits(n_pad, m, pair_bytes, k)), None)


def prefetch_rows(n_pad: int, pair_bytes: int) -> int:
    """How many rows ahead of its sweeps the blocked kernel prefetches into
    L2: the most rows of ``n_pad * pair_bytes`` bytes that fit
    :data:`L2_PREFETCH_BUDGET`, at least 1: 1 at n = 2M and 4M, f32 and
    bf16 (the 4 MB bf16 rows at 2M just fit), and at K3's reach, whose
    29.7 MB f32 rows overrun the budget."""
    return max(1, L2_PREFETCH_BUDGET // (n_pad * pair_bytes))


def _prefetch_of(impl: str, n_pad: int, pair_bytes: int, prefetch: int | None) -> int:
    """The prefetch distance a launch of ``impl`` runs: the blocked kernel's
    ``prefetch`` (:func:`prefetch_rows`'s when None), 0 for the others,
    which take none."""
    if impl != BLOCKED:
        if prefetch is not None:
            raise ValueError(f"{impl} takes no prefetch distance, got prefetch={prefetch}")
        return 0
    if prefetch is None:
        return prefetch_rows(n_pad, pair_bytes)
    if prefetch < 1:
        raise ValueError(f"the blocked kernel's prefetch distance must be >= 1 row, "
                         f"got prefetch={prefetch}")
    return prefetch


def _group_of(impl: str, n_pad: int, m: int, pair_bytes: int, group: int | None) -> int:
    """The group size a launch of ``impl`` runs: the streaming kernel's
    ``group`` (:func:`group_size`'s when None), 1 for the others. Raises on
    one the ring cannot take; never picks a smaller one instead."""
    if impl != STREAMING:
        if group not in (None, 1):
            raise ValueError(f"{impl} takes no group size, got group={group}")
        return 1
    k = group_size(n_pad, m, pair_bytes) if group is None else group
    if k is not None and group_fits(n_pad, m, pair_bytes, k):
        return k
    k = k or 1
    if k not in GROUP_SIZES:
        why = f"k not in {GROUP_SIZES}"
    elif k > m:
        why = f"k > m={m}"
    else:
        why = (f"its slices of q and two groups of {k} pairs need "
               f"{n_pad * _bytes_per_element(STREAMING, m, pair_bytes, k)} bytes of shared "
               f"memory, more than the {_GRID_SMEM_BYTES} of one block per SM")
    raise ValueError(f"the streaming kernel cannot take this ring (n_pad={n_pad}, m={m}, "
                     f"pair bytes {pair_bytes}) in groups of k={k}: {why}")


def kernel_dispatch(n_pad: int, m: int, dtype, pair_dtype=None) -> tuple[str, str]:
    """Which kernel :func:`two_loop_cuda` launches for a CUDA ring of padded
    row length ``n_pad``, capacity ``m``, working ``dtype`` and stored-pair
    ``pair_dtype`` (defaults to ``dtype``).

    Returns ``(impl, reason)``: ``("cuda-cooperative", "")`` wherever its
    slices of the whole ring fit shared memory and m is at most
    :data:`RESIDENT_MAX_M`, else ``("cuda-streaming", reason)`` where the
    streaming kernel's fit, else ``("cuda-blocked", reason)`` where q alone
    fits (n_pad up to ~7.4M), else ``("unsupported", reason)``; the wrapper
    then raises with the reason instead of substituting another path. The
    reason of a streaming or blocked pick is empty, or names the cap where
    only the cap kept the ring from the resident kernel. The order is
    measured: where two kernels take a ring, the one listed first was the
    faster on an H100 (chip_smoke.py phase "table", table in PERF.md); K1
    was the fastest on every m = 10 row. One exception, also
    measured: a ring the streaming kernel takes only in groups of k = 1
    goes to the blocked kernel from n_pad = 2,000,000 on (the large path's
    bf16 ring), where one pair per grid reduction streamed through shared
    memory lost to the blocked kernel's rows read from global memory with
    their L2 prefetch.
    """
    pd = pair_dtype if pair_dtype is not None else dtype
    if dtype != torch.float32:
        return "unsupported", f"dtype {dtype} != torch.float32"
    if pd not in _PAIR_DTYPES:
        return "unsupported", f"pair dtype {pd} not in (torch.float32, torch.bfloat16)"
    if n_pad % 8:
        return "unsupported", f"padded row length {n_pad} is not a multiple of 8"
    if not 1 <= m <= _MAX_M:
        return "unsupported", f"history size m={m} outside [1, {_MAX_M}]"
    pb = pd.itemsize
    why = ""
    if fits(COOPERATIVE, n_pad, m, pb):
        if m <= RESIDENT_MAX_M:
            return COOPERATIVE, ""
        why = f"m={m} is above the resident kernel's cap of {RESIDENT_MAX_M} pairs"
    if fits(STREAMING, n_pad, m, pb) and (group_size(n_pad, m, pb) > 1
                                          or n_pad < _K3_OVER_K2_AT_K1):
        return STREAMING, why
    if fits(BLOCKED, n_pad, m, pb):
        return BLOCKED, why
    return "unsupported", (
        f"padded row length {n_pad}: even the blocked kernel's slices of q alone need "
        f"{4 * n_pad} bytes, more than the {_GRID_SMEM_BYTES} bytes of shared memory of "
        f"one block per SM (n_pad <= {_GRID_SMEM_BYTES // 4})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("two_loop")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        # (kind, pair bytes, group, ...): group is K2's k, 1 for K1 and K3
        lib.two_loop_config.argtypes = [i, i, i, i, i, ip, ip, ip]
        lib.two_loop_config.restype = i
        # (kind, pair bytes, group, prefetch, ...): prefetch is K3's distance, 0 for K1, K2
        # (..., n_pad, n, ..., stream, stamps): stamps only for K1's timestamped build
        # (..., stream, stamps, launches): launches is the kernel's device counter
        lib.two_loop_launch.argtypes = [i, i, i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                        ctypes.c_float, ctypes.c_float, p, p, p]
        lib.two_loop_launch.restype = i
        lib.two_loop_error_string.argtypes = [i]
        lib.two_loop_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.two_loop_error_string(rc).decode()})")


_CONFIGS: dict[tuple, tuple[int, int, int]] = {}


def _config(lib: ctypes.CDLL, device_index: int, kind: int, pair_bytes: int, group: int,
            n_pad: int, m: int) -> tuple[int, int, int]:
    """(grid, elements per block, dynamic shared bytes) of the source's Kind
    ``kind``, queried once per device, kernel, group size and shape."""
    key = (device_index, kind, pair_bytes, group, n_pad, m)
    if key not in _CONFIGS:
        grid, slice_, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        _check(lib, lib.two_loop_config(kind, pair_bytes, group, n_pad, m,
                                        ctypes.byref(grid), ctypes.byref(slice_),
                                        ctypes.byref(smem)),
               f"two_loop_config(kind {kind}, k={group}, n_pad={n_pad}, m={m}, "
               f"pair bytes {pair_bytes})")
        _CONFIGS[key] = (grid.value, slice_.value, smem.value)
    return _CONFIGS[key]


class LaunchCounts(collections.abc.MutableMapping):
    """Launches per kernel, counted on the device: every launch adds one to
    its kernel's int32 counter (block 0's thread 0 does), so a launch
    replayed from a CUDA graph counts as well as an eager one, and a launch
    captured but never replayed does not. Reading a count synchronises with
    the device; ``LAUNCHES[k] = 0`` (before a run) resets the counters of
    every device that has them."""

    def __init__(self):
        self._device: dict[int, torch.Tensor] = {}  # device index -> int32 (3,)

    def counter(self, device: torch.device) -> torch.Tensor:
        """The device's counters, made before any capture (an eager launch
        always comes first: the wrapper queries the launch configuration)."""
        idx = device.index if device.index is not None else torch.cuda.current_device()
        if idx not in self._device:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the launch counters are made by an eager launch; capture "
                                   "a two-loop kernel only after one has run on the device")
            self._device[idx] = torch.zeros(len(_KIND), dtype=torch.int32,
                                            device=torch.device("cuda", idx))
        return self._device[idx]

    def __getitem__(self, impl: str) -> int:
        slot = _KIND[impl]
        return sum(int(c[slot]) for c in self._device.values())

    def __setitem__(self, impl: str, value: int) -> None:
        if impl not in _KIND:
            raise KeyError(impl)
        if value != 0:
            raise ValueError(f"a launch count can only be reset to 0, got {value}")
        for c in self._device.values():
            c[_KIND[impl]] = 0

    def __delitem__(self, impl: str) -> None:
        raise TypeError("launch counts cannot be deleted")

    def __iter__(self):
        return iter((COOPERATIVE, STREAMING, BLOCKED))

    def __len__(self) -> int:
        return len(_KIND)

    def __repr__(self) -> str:
        return repr(dict(self))


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


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

    A CPU ``v`` goes to the plain version. A CUDA ``v`` launches the kernel
    :func:`kernel_dispatch` names for the ring; a ring no kernel takes
    raises with the dispatch's reason, and does not switch to the plain
    loop: ``two_loop_impl="plain"`` runs such a ring (what the JAX
    package's default ``"xla"`` does) when the caller asks for it.
    """
    if v.device.type == "cpu":
        return two_loop(v, hist, clamp_gamma=clamp_gamma,
                        gamma_min=gamma_min, gamma_max=gamma_max)
    if v.device.type != "cuda":
        raise ValueError(f"two_loop_cuda takes CPU or CUDA tensors, got {v.device}")
    impl, reason = kernel_dispatch(hist.S.shape[1], hist.S.shape[0], v.dtype, hist.S.dtype)
    if impl == "unsupported":
        raise ValueError(f"two_loop_cuda cannot run this ring: {reason}; "
                         "LBFGSOptions(two_loop_impl=\"plain\") runs it with the plain loop")
    return launch(impl, v, hist, clamp_gamma=clamp_gamma, gamma_min=gamma_min,
                  gamma_max=gamma_max)


def launch(
    impl: str,
    v: torch.Tensor,
    hist: RingState,
    *,
    group: int | None = None,
    prefetch: int | None = None,
    stamps: torch.Tensor | None = None,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> torch.Tensor:
    """Launch kernel ``impl`` (``"cuda-cooperative"``, ``"cuda-streaming"``
    or ``"cuda-blocked"``) on CUDA tensors, on the current stream; the
    kernel adds one to ``two_loop_cuda.LAUNCHES[impl]`` on the device. :func:`two_loop_cuda` calls it
    with the dispatch's choice; the dispatch's own measurement calls it with
    each kernel in turn. ``group`` is the streaming kernel's k
    (:func:`group_size`'s when None) and ``prefetch`` the blocked kernel's
    distance in rows, >= 1 (:func:`prefetch_rows`'s when None); the other
    kernels take neither. The resident kernel takes rings of at most
    :data:`RESIDENT_MAX_M` pairs. ``stamps``, an int64 CUDA tensor of
    ``2 * N_STAMPS`` entries, launches the resident kernel's timestamped
    build instead, which writes block 0's phase boundaries there as (ns,
    cycles) pairs (a study's instrument, not counted in ``LAUNCHES``).
    Never reads ``head``, ``count`` or ``rho`` back to the host; anything
    the kernel does not take raises, a k the ring cannot take included.
    """
    if impl not in _KIND:
        raise ValueError(f"unknown impl {impl!r}; expected one of {sorted(_KIND)}")
    S, Y, rho, head, count = hist
    m, n_pad = S.shape
    n = v.shape[0]
    if S.dtype not in _PAIR_DTYPES:
        raise ValueError(f"pair dtype {S.dtype} not in (torch.float32, torch.bfloat16)")
    if n_pad % 8 or not 1 <= m <= _MAX_M:
        raise ValueError(f"ring of m={m} rows of {n_pad}: need n_pad % 8 == 0 and "
                         f"1 <= m <= {_MAX_M}")
    if impl == COOPERATIVE and m > RESIDENT_MAX_M:
        raise ValueError(f"the resident kernel takes rings of at most {RESIDENT_MAX_M} pairs "
                         f"(its cap, kResidentMaxM), got m={m}")
    if stamps is not None and (impl != COOPERATIVE or stamps.dtype != torch.int64
                               or stamps.shape != (2 * N_STAMPS,) or stamps.device != v.device):
        raise ValueError(f"stamps go with {COOPERATIVE} as an int64 tensor of {2 * N_STAMPS} "
                         "entries on v's device")
    pb = S.dtype.itemsize
    k = _group_of(impl, n_pad, m, pb, group)
    d = _prefetch_of(impl, n_pad, pb, prefetch)
    if v.device.type != "cuda" or v.dtype != torch.float32:
        raise ValueError(f"v must be a float32 CUDA tensor, got {v.dtype} on {v.device}")
    if v.dim() != 1 or n > n_pad:
        raise ValueError(f"v must be 1-D with at most {n_pad} entries, got {tuple(v.shape)}")
    if Y.shape != S.shape or rho.shape != (m,) or head.shape != () or count.shape != ():
        raise ValueError("ring shapes disagree: S, Y (m, n_pad); rho (m,); head, count scalars")
    if Y.dtype != S.dtype or rho.dtype != torch.float32:
        raise ValueError(f"Y must have S's dtype {S.dtype} and rho float32, got {Y.dtype}, "
                         f"{rho.dtype}")
    if head.dtype != torch.int32 or count.dtype != torch.int32:
        raise ValueError(f"head and count must be int32, got {head.dtype}, {count.dtype}")
    for name, t in (("S", S), ("Y", Y), ("rho", rho), ("head", head), ("count", count)):
        if t.device != v.device:
            raise ValueError(f"ring {name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"ring {name} must be contiguous")
    if not (_aligned(S) and _aligned(Y)):
        raise ValueError("ring S and Y must start on a 16-byte boundary")

    lib = _lib()
    kind = _KIND[impl] if stamps is None else _RESIDENT_STAMPED
    with torch.cuda.device(v.device):
        grid, slice_, smem = _config(lib, v.device.index, kind, pb, k, n_pad, m)
        # the kernels read v's n entries in place (zero beyond), 16 bytes at a time
        v_in = (v if v.is_contiguous() and _aligned(v)
                else v.clone(memory_format=torch.contiguous_format))
        counts = (None if stamps is not None
                  else two_loop_cuda.LAUNCHES.counter(v.device)[_KIND[impl]:])
        out = torch.empty(n_pad, dtype=v.dtype, device=v.device)
        partials = torch.empty(2 * _N_PARTIALS * grid, dtype=torch.float32, device=v.device)
        rc = lib.two_loop_launch(
            kind, pb, k, d, v_in.data_ptr(), S.data_ptr(), Y.data_ptr(), rho.data_ptr(),
            head.data_ptr(), count.data_ptr(), out.data_ptr(), partials.data_ptr(),
            n_pad, n, m, grid, slice_, smem, int(clamp_gamma), gamma_min, gamma_max,
            torch.cuda.current_stream().cuda_stream,
            None if stamps is None else stamps.data_ptr(),
            None if counts is None else counts.data_ptr(),
        )
    _check(lib, rc, f"two_loop_launch({impl}, k={k}, prefetch={d}, stamps={stamps is not None})")
    return out[:n]


two_loop_cuda.LAUNCHES = LaunchCounts()
