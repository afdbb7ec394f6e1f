"""Counted matrix-free linear solvers (CG and restarted GMRES).

Counterpart of :mod:`lbfgs_ffnn_tpu.ops.iterative`: the same algorithms,
returning ``(solution, n_matvecs)`` with the count exact, so Newton-CG's
Hessian-vector products and factor-form BFGS's Krylov steps show in the
solver counters. The iterations decide on the device: JAX's
``lax.while_loop`` is :func:`~lbfgs_ffnn_torch.ops.control.loop` (a CUDA
graph WHILE node under capture, a host loop reading its flag once per pass
outside it) over state in device tensors; ``n_matvecs`` is an int32 device
scalar. ``live``, where given, is the enclosing guard's flag, put in the
loop's condition (outside capture a guard's body runs whatever its flag).

:func:`dense_solve` is the direct solve of dense BFGS and dense Newton,
JAX's ``jnp.linalg.solve``: an LU with partial pivoting and two triangular
solves, none of which reads anything on the host.

GMRES's Arnoldi cycle has a static length and unrolls in Python with static
row indices. Its least-squares step is JAX's ``jnp.linalg.lstsq``: the
minimum-norm solution (a happy breakdown leaves H rank-deficient), on the
card the kernel of :mod:`lbfgs_ffnn_torch.ops.cuda_lstsq`.
"""

from __future__ import annotations

import torch

from lbfgs_ffnn_torch.ops.control import loop
from lbfgs_ffnn_torch.ops.cuda_lstsq import lstsq_min_norm


def _i32(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int32, device=like.device)


def cg_counted(matvec, b: torch.Tensor, *, tol: float, maxiter: int,
               live: torch.Tensor | None = None):
    """Conjugate gradient on ``A x = b`` from ``x0 = 0``: JAX's convergence
    test (squared residual against ``tol^2 * |b|^2``) and breakdown guard (a
    non-positive ``p^T A p`` freezes the iterate and ends the loop). Returns
    ``(x, n_matvecs)``: from zero the first residual is ``b`` for free, so
    the count is the number of iterations."""
    t = torch.full((), tol, dtype=b.dtype, device=b.device)
    atol2 = torch.square(t) * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b.clone()
    gamma = torch.dot(b, b)
    p = b.clone()
    k = _i32(0, b)
    ok = torch.ones((), dtype=torch.bool, device=b.device)

    def more():
        go = ok & (gamma > atol2) & (k < maxiter)
        return go if live is None else go & live

    def body():
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        good = pAp > 0.0
        alpha = torch.where(good, gamma / torch.where(good, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        r_new = r - alpha * Ap
        gamma_new = torch.dot(r_new, r_new)
        beta = torch.where(good, gamma_new / gamma, torch.zeros_like(gamma))
        new = ((x, x + alpha * p), (p, r_new + beta * p), (r, r_new), (gamma, gamma_new),
               (k, k + 1), (ok, good))
        for dst, v in new:  # every new value is computed; now the carry moves
            dst.copy_(v)

    loop(more, body)
    return x, k


LU_BLOCK = 512  # CUDA matrices above this size are factored padded to a multiple of it


def dense_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A^-1 b`` by LU with partial pivoting (``lu_factor_ex``, its error
    check off), the row interchanges as a permutation matrix
    (``lu_unpack``) and two triangular solves; a singular ``A`` gives
    non-finite entries, as JAX's ``jnp.linalg.solve`` does. Nothing is read
    on the host, and every step captures inside CUDA graph conditional
    nodes, where ``torch.linalg.solve_ex`` did not: its ``getrs`` failed
    the capture with "invalid argument" inside a WHILE node (Newton's
    damping loop) on an H100 at n from 16 to 128 and above.

    A CUDA matrix above :data:`LU_BLOCK` is factored as ``[[A, 0], [0, I]]``
    padded to a multiple of :data:`LU_BLOCK`: once cuSOLVER's ``getrf`` had
    run on a second stream (every captured solve's does), its capture in a
    conditional node failed the same way at n = 512 k + r for r in {1, 2,
    4, 8, 16, 64, 65}, k = 1 ... 15 (and at no multiple of 512). Partial
    pivoting never picks a padding row (zero in A's columns), so the
    padded factors hold A's."""
    n = A.shape[0]
    padded = -(-n // LU_BLOCK) * LU_BLOCK if A.is_cuda and n > LU_BLOCK else n
    if padded != n:
        Ap = torch.zeros((padded, padded), dtype=A.dtype, device=A.device)
        Ap[:n, :n] = A
        Ap.diagonal()[n:] = 1.0
        bp = torch.zeros(padded, dtype=b.dtype, device=b.device)
        bp[:n] = b
        A, b = Ap, bp
    LU, piv, _ = torch.linalg.lu_factor_ex(A, check_errors=False)
    P = torch.lu_unpack(LU, piv, unpack_data=False)[0]
    z = torch.linalg.solve_triangular(LU, (P.mT @ b).unsqueeze(1), upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(LU, z, upper=True).squeeze(1)[:n]


def _arnoldi_cycle(matvec, V: torch.Tensor, restart: int):
    """One fixed-length Arnoldi factorization: fills ``V[1:restart + 1]``
    and the ``(restart + 1, restart)`` Hessenberg ``H`` from the unit
    residual in ``V[0]``, with one re-orthogonalization pass. A happy
    breakdown (a zero residual) leaves zero rows of V and zero columns of H,
    which the minimum-norm least squares handles. Returns ``(V, H)``."""
    H = torch.zeros((restart + 1, restart), dtype=V.dtype, device=V.device)
    for j in range(restart):
        w = matvec(V[j])
        h = V @ w  # projection on the whole stack: unfilled rows are zero
        w = w - h @ V
        h2 = V @ w
        w = w - h2 @ V
        h = h + h2
        nrm = torch.linalg.norm(w)
        safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        V[j + 1] = torch.where(nrm > 0, w / safe, torch.zeros_like(w))
        h[j + 1] = nrm
        H[:, j] = h
    return V, H


def gmres_counted(matvec, b: torch.Tensor, *, tol: float, maxiter: int, restart: int = 20,
                  live: torch.Tensor | None = None):
    """Restarted GMRES(restart) on ``A x = b`` from ``x0 = 0``; ``restart``
    is capped at n. ``maxiter`` bounds the restart cycles; each costs
    ``restart`` matvecs for the Arnoldi basis plus one for the true
    residual. Returns ``(x, n_matvecs)`` with the count exact."""
    n = b.shape[0]
    restart = min(restart, n)
    atol = torch.full((), tol, dtype=b.dtype, device=b.device) * torch.linalg.norm(b)
    x = torch.zeros_like(b)
    r = b.clone()
    k = _i32(0, b)
    nmv = _i32(0, b)

    def ls_update(x, r):
        """One GMRES cycle from residual r: the updated iterate."""
        rnorm = torch.linalg.norm(r)
        safe = torch.where(rnorm > 0, rnorm, torch.ones_like(rnorm))
        V = torch.zeros((restart + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / safe
        V, H = _arnoldi_cycle(matvec, V, restart)
        beta = torch.zeros((restart + 1,), dtype=b.dtype, device=b.device)
        beta[0] = rnorm
        y = lstsq_min_norm(H, beta)
        return x + y @ V[:restart]

    def more():
        go = (torch.dot(r, r) > atol * atol) & (k < maxiter)
        return go if live is None else go & live

    def body():
        x_new = ls_update(x, r)
        # the true (not recurrence) residual, for the restart and the stop test
        r_new = b - matvec(x_new)
        for dst, v in ((x, x_new), (r, r_new), (k, k + 1), (nmv, nmv + restart + 1)):
            dst.copy_(v)

    if b.is_cuda:
        # the kernel's launch counter is made here, outside the loop: an
        # eager run whose loop never enters its body (x0 = 0 already meets
        # tol) must still make it before a capture records the body
        lstsq_min_norm.LAUNCHES.counter(b.device)
    loop(more, body)
    return x, nmv
