"""Minimum-norm least squares of GMRES's small Hessenberg system, as a
hand-written Hopper kernel and its plain version.

Counterpart of ``jnp.linalg.lstsq(H, beta)`` in
:func:`lbfgs_ffnn_tpu.ops.iterative.gmres_counted`: the minimum-norm
solution through an SVD, singular values below ``eps * max(M, N)`` of the
largest (and exact zeros) treated as zero. :func:`lstsq_plain` is that
formula in torch (``torch.linalg.svd``); :func:`lstsq_min_norm` calls it for
CPU tensors and launches ``lstsq_min_norm_kernel`` (``csrc/lstsq.cu``: a
Givens triangle of H's rows, b carried, then a one-sided Jacobi SVD on the
triangle's rows in one block of ceil(min(m, n) / 2) warps, each rotating
one row pair of a round-robin round; its header says why rows) for CUDA
tensors: on the card ``torch.linalg.lstsq`` has only the QR route (gels), which a
rank-deficient H (a happy breakdown) defeats, and the SVD routes read a
flag on the host, which a captured GMRES cannot do. A CUDA tensor the
kernel does not take raises; nothing falls back. :func:`jacobi_mirror` is
the kernel's arithmetic in numpy, in its order (the triangle, the schedule
:func:`round_robin`, the carried norms, the stop test), for the sweeps and
rounds a matrix takes; :func:`hessenberg` makes the seeded GMRES-shaped
matrices the kernel is tested and measured on.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lbfgs_ffnn_torch import _build

MAX_DIM = 32  # kMaxDim in the source: rows and columns of H
MAX_SWEEPS = 60  # kMaxSweeps


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
        lib.lstsq_launch.argtypes = [i, p, p, p, i, i, p, p, p]
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


def launch(H: torch.Tensor, b: torch.Tensor, sweeps: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Launches the kernel on CUDA tensors, on the current stream, counted
    on ``lstsq_min_norm.LAUNCHES``; ``sweeps``, an int32 tensor on ``H``'s
    device, gets the launch's sweeps (the last, which rotates nothing,
    included) added to its first entry."""
    if H.dim() != 2 or b.shape != (H.shape[0],):
        raise ValueError(f"H must be (m, n) and b (m,), got {tuple(H.shape)}, {tuple(b.shape)}")
    m, n = H.shape
    if not (1 <= m <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"the kernel takes at most {MAX_DIM} x {MAX_DIM}, got {m} x {n}")
    if H.dtype not in (torch.float32, torch.float64) or b.dtype != H.dtype:
        raise ValueError(f"H and b must be float32 or float64 alike, got {H.dtype}, {b.dtype}")
    if b.device != H.device:
        raise ValueError(f"b is on {b.device}, H on {H.device}")
    if sweeps is not None and (sweeps.dtype != torch.int32 or sweeps.device != H.device):
        raise ValueError(f"sweeps must be int32 on {H.device}, got {sweeps.dtype} on "
                         f"{sweeps.device}")
    lib = _lib()
    with torch.cuda.device(H.device):
        Hc, bc = H.contiguous(), b.contiguous()
        y = torch.empty(n, dtype=H.dtype, device=H.device)
        count = lstsq_min_norm.LAUNCHES.counter(H.device)
        rc = lib.lstsq_launch(H.element_size(), Hc.data_ptr(), bc.data_ptr(), y.data_ptr(), m, n,
                              torch.cuda.current_stream().cuda_stream, count.data_ptr(),
                              None if sweeps is None else sweeps.data_ptr())
    if rc != 0:
        raise RuntimeError(f"lstsq_launch({m} x {n}, {H.dtype}) failed: CUDA error {rc} "
                           f"({lib.lstsq_error_string(rc).decode()})")
    return y


def lstsq_min_norm(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution of ``H y = b`` (``H`` of at
    most :data:`MAX_DIM` rows and columns, f32 or f64): :func:`lstsq_plain`
    for CPU tensors, the kernel for CUDA tensors, on the current stream,
    adding one to ``lstsq_min_norm.LAUNCHES`` on the device."""
    if H.device.type == "cpu":
        return lstsq_plain(H, b)
    if H.device.type != "cuda":
        raise ValueError(f"lstsq_min_norm takes CPU or CUDA tensors, got {H.device}")
    return launch(H, b)


lstsq_min_norm.LAUNCHES = LaunchCount()


def round_robin(n: int) -> list[list[tuple[int, int]]]:
    """The kernel's schedule over ``n`` rows, a dummy row added where ``n``
    is odd: ``N - 1`` rounds of ``N / 2`` disjoint pairs ``(p, q)``, ``p <
    q``, pair ``w`` of a round being warp ``w``'s; row ``N - 1`` stays, the
    others turn."""
    N = n + n % 2
    M = N - 1
    rounds = []
    for r in range(M):
        pairs = [(r, M) if w == 0 else ((r + w) % M, (r - w) % M) for w in range(N // 2)]
        rounds.append([(min(a, b), max(a, b)) for a, b in pairs])
    return rounds


def _tree_sum(x: np.ndarray) -> np.ndarray:
    """The warp's shuffle-down tree over the last axis of 32 lanes."""
    x = x.copy()
    for off in (16, 8, 4, 2, 1):
        x[..., :off] = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


def _pow2(big: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's ``pow2``: the powers of two ``S`` and ``1 / S`` that
    bring ``big`` (>= 0) to [1, 2), from its exponent bits, clamped so both
    stay normal."""
    big = np.asarray(big)
    if big.dtype == np.float64:
        u, shift, top = np.uint64, 52, 2046
    else:
        u, shift, top = np.uint32, 23, 254
    e = np.clip((big.view(u) >> u(shift)) & u(top + 1), 1, top - 1).astype(u)
    return (((u(top) - e) << u(shift)).view(big.dtype), (e << u(shift)).view(big.dtype))


def _hyp(x, y):
    """The kernel's ``hyp``: ``sqrt(xs^2 + ys^2) / S``, ``xs = x S``, ``ys =
    y S``."""
    S, Sinv = _pow2(np.fmax(np.abs(x), np.abs(y)))
    xs, ys = x * S, y * S
    return np.sqrt(xs * xs + ys * ys) * Sinv


def _triangle(R: np.ndarray, m: int, n: int) -> None:
    """The kernel's Givens triangle on the rows ``R`` (32, 33: H's ``n``
    entries, then b's), in place: for each column ``j < min(n, m - 1)``,
    each row ``i > j`` whose entry ``(i, j)`` is not zero, in increasing
    ``i``, is rotated against row ``j`` so that ``(i, j)`` becomes exactly 0
    and ``(j, j)`` exactly ``hypot``. On GMRES's upper Hessenberg H that is
    one rotation a column, rows ``j`` and ``j + 1``."""
    dt = R.dtype.type
    for j in range(min(n, m - 1)):
        rows = [i for i in range(j + 1, m) if R[i, j] != 0]  # NaN rotates, as in the kernel
        a = R[j, j]
        for i in rows:
            c = R[i, j]
            r = _hyp(a, c)[()]
            inv = dt(1) / r
            cs, sn = a * inv, c * inv
            rj, ri = R[j].copy(), R[i].copy()
            R[j], R[i] = cs * rj + sn * ri, cs * ri - sn * rj
            R[j, j], R[i, j] = r, dt(0)
            a = r


def _sweeps(R: np.ndarray, N: int, n: int) -> tuple[int, int]:
    """The kernel's sweep loop on the first ``N`` rows of ``R`` (H's ``n``
    entries, then b's, which the rotations carry and the dot products leave
    out), in place; returns ``(sweeps, rounds)``."""
    dt = R.dtype.type
    tol = dt(np.finfo(dt).eps) * np.sqrt(dt(n))
    tol2 = tol * tol
    in_h = np.arange(MAX_DIM) < n
    nrm = np.zeros(N, dt)
    schedule = round_robin(N)
    rounds = 0
    with np.errstate(all="ignore"):  # NaNs spread as the kernel's do
        for sweep in range(1, MAX_SWEEPS + 1):
            rotated = False
            for r, pairs in enumerate(schedule):
                P, Q = np.array(pairs).T
                ap, aq = R[P], R[Q]
                hp, hq = np.where(in_h, ap[:, :MAX_DIM], 0), np.where(in_h, aq[:, :MAX_DIM], 0)
                gamma = _tree_sum(hp * hq)
                if r == 0:  # every row once: its norm afresh
                    alpha, beta = _tree_sum(hp * hp), _tree_sum(hq * hq)
                else:
                    alpha, beta = nrm[P], nrm[Q]
                rot = ~((gamma == 0) | (gamma * gamma <= (tol2 * alpha) * beta))
                rounds += 1
                rotated |= bool(rot.any())
                t, c, s = _rotation(alpha, beta, gamma)
                w, cc, ss = rot[:, None], c[:, None], s[:, None]
                R[P], R[Q] = np.where(w, cc * ap - ss * aq, ap), np.where(w, ss * ap + cc * aq, aq)
                nrm[P] = np.where(rot, alpha - t * gamma, alpha)
                nrm[Q] = np.where(rot, beta + t * gamma, beta)
            if not rotated:
                break
    return sweep, rounds


def _rotation(alpha, beta, gamma):
    """The kernel's ``rotation``: ``(t, c, s)`` from ``d = beta - alpha`` and
    ``g = sign(d) 2 gamma``, both scaled by :func:`_pow2`'s ``S``; ``h =
    sqrt(d^2 + g^2)``, ``u = |d| + h``, ``w = sqrt(u^2 + g^2)``, ``q = 1 /
    (u w)``, ``t = g w q``, ``c = u u q``, ``s = g u q``."""
    dt = alpha.dtype.type
    d = beta - alpha
    g2 = dt(2) * gamma
    S, _ = _pow2(np.fmax(np.abs(d), np.abs(g2)))
    ds = d * S
    g = np.where(np.signbit(d), -(g2 * S), g2 * S)
    h = np.sqrt(ds * ds + g * g)
    u = np.abs(ds) + h
    w = np.sqrt(u * u + g * g)
    q = dt(1) / (u * w)
    return (g * w) * q, (u * u) * q, (g * u) * q


def jacobi_mirror(H: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, int, int]:
    """The kernel's arithmetic in numpy, in the kernel's order and in
    ``H``'s dtype (float32 or float64): ``(y, sweeps, rounds)``, ``rounds``
    counting every round of every sweep, the last sweep (which rotates
    nothing) included. The rows of H, b's entry carried after each, go
    through the Givens triangle (:func:`_triangle`), then one-sided Jacobi
    sweeps on the first ``min(m, n)`` rows (the rest are zero in H's
    columns: on GMRES's H the last row is the residual), and ``y`` is the
    sum over the kept rows ``r_i`` of ``r_i c_i / |r_i|^2``, ``c_i`` the
    row's b entry (its column ``n``): no V is formed. The kernel rounds
    every operation on its own, as numpy does, and takes no approximate
    square root or hypot, so its bits and its sweeps are the mirror's."""
    dt = H.dtype.type
    m, n = H.shape
    K = min(m, n)
    N = K + K % 2
    with np.errstate(all="ignore"):  # NaNs spread as the kernel's do
        R = np.zeros((MAX_DIM, MAX_DIM + 1), dt)
        R[:m, :n] = H
        R[:m, n] = b
        _triangle(R, m, n)
        sweeps, rounds = _sweeps(R, N, n)
        rows = R[:K, :MAX_DIM]
        h = np.where(np.arange(MAX_DIM) < n, rows, 0)
        sigma = np.sqrt(_tree_sum(h * h))
        cutoff = dt(np.finfo(dt).eps) * dt(max(m, n)) * sigma.max()
        keep = (sigma > 0) & (sigma >= cutoff)
        safe = np.where(keep, sigma, dt(1))
        coef = np.where(keep, (R[:K, n] / safe) / safe, dt(0))
        y = np.zeros(MAX_DIM, dt)
        for i in range(K):
            y = y + rows[i] * coef[i]
    return y[:n], sweeps, rounds


def hessenberg(seed: int, m: int, n: int, rank: int | None = None,
               graded: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """A seeded ``(m, n)`` upper Hessenberg ``H`` (f64) and ``b``, GMRES's
    ``beta e_1``: the matrices the kernel's tests and measurements use.
    ``rank < n``: a happy breakdown at column ``rank - 1`` (zero columns
    and rows after it). ``graded="columns"``: column j scaled by ``1e-8 **
    (j / (n - 1))``; ``"rows"``: row i by ``1e-5 ** (i / (m - 1))``, as a
    GMRES cycle whose subdiagonal shrinks leaves H (at 21 x 20, seeds
    100-103, condition numbers of about 1e8, and 4e7 to 3e9)."""
    rng = np.random.default_rng(seed)
    H = np.triu(rng.normal(size=(m, n)), -1)
    if rank is not None and rank < n:
        H[:, rank:] = 0.0
        H[rank + 1:, :] = 0.0
        H[rank, rank - 1] = 0.0
    b = np.zeros(m)
    b[0] = rng.normal()
    if graded == "columns":
        H = H * np.geomspace(1.0, 1e-8, n)[None, :]
    elif graded == "rows":
        H = np.geomspace(1.0, 1e-5, m)[:, None] * H
    elif graded is not None:
        raise ValueError(f"graded is 'columns' or 'rows', got {graded!r}")
    return H, b
