"""The port's counted Krylov solvers, direct solve and least squares against
the JAX package's (``lbfgs_ffnn_tpu.ops.iterative``) in f64, on the same
numpy-made systems: solutions to rtol 1e-10 (of the largest entry; the two
libraries sum in other orders) and matvec counts exactly equal. The loops
run eagerly here, the same code the card captures: each reads its flag on
the host once per pass."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.ops import iterative as ji
from lbfgs_ffnn_torch.ops import iterative as ti
from lbfgs_ffnn_torch.ops.cuda_lstsq import lstsq_min_norm, lstsq_plain


def _close(t, j, rtol=1e-10):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * np.abs(j).max())


def _spd(rng, n):
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    return Q @ np.diag(rng.uniform(0.5, 20.0, n)) @ Q.T


def _indefinite(rng, n):
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    d = rng.uniform(1.0, 5.0, n)
    d[::3] *= -1.0
    return Q @ np.diag(d) @ Q.T


def _run(solver, A, b, **kw):
    At, Aj = torch.tensor(A), jnp.asarray(A)
    xt, kt = getattr(ti, solver)(lambda v: At @ v, torch.tensor(b), **kw)
    xj, kj = getattr(ji, solver)(lambda v: Aj @ v, jnp.asarray(b), **kw)
    return xt, int(kt), xj, int(kj)


# case -> (matrix maker, n, tol, maxiter)
CG_CASES = {
    "spd-12": (_spd, 12, 1e-12, 100),
    "spd-40": (_spd, 40, 1e-10, 100),
    "spd-40-capped": (_spd, 40, 0.0, 17),
    "three-eigenvalues-30": (lambda rng, n: np.diag(np.repeat([1.0, 3.0, 7.0], 10)), 30, 1e-10,
                             100),
    "indefinite-9": (_indefinite, 9, 1e-12, 50),
}


@pytest.mark.parametrize("case", sorted(CG_CASES))
def test_cg_matches_jax(case):
    """Includes an indefinite matrix, where JAX's breakdown guard (p^T A p
    <= 0) freezes the iterate and ends the loop early."""
    make, n, tol, maxiter = CG_CASES[case]
    rng = np.random.default_rng(n)
    A, b = make(rng, n), rng.normal(size=n)
    xt, kt, xj, kj = _run("cg_counted", A, b, tol=tol, maxiter=maxiter)
    assert kt == kj
    _close(xt, xj)
    if case == "three-eigenvalues-30":
        assert kt == 3
    if case.endswith("capped"):
        assert kt == 17
    if case.startswith("indefinite"):
        assert kt < maxiter and np.linalg.norm(A @ xt.numpy() - b) > 1e-6 * np.linalg.norm(b)


def test_cg_breakdown_at_the_first_step():
    """``p^T A p = 0`` at the first direction: one matvec, x stays zero."""
    A, b = np.diag([1.0, -1.0]), np.array([1.0, 1.0])
    xt, kt, xj, kj = _run("cg_counted", A, b, tol=1e-12, maxiter=10)
    assert kt == kj == 1
    assert np.all(xt.numpy() == 0.0) and np.all(np.asarray(xj) == 0.0)


def test_cg_under_a_false_guard_does_nothing():
    """``live`` false (the enclosing guard's flag): no pass, no matvec."""
    A = _spd(np.random.default_rng(0), 6)
    x, k = ti.cg_counted(lambda v: torch.tensor(A) @ v, torch.ones(6, dtype=torch.float64),
                         tol=1e-12, maxiter=10, live=torch.zeros((), dtype=torch.bool))
    assert int(k) == 0 and torch.all(x == 0)


# case -> (matrix maker, n, tol, maxiter, restart)
GMRES_CASES = {
    "nonsymmetric-30-r10": (lambda rng, n: rng.normal(size=(n, n)) + 6.0 * np.eye(n), 30, 1e-12,
                            50, 10),
    "nonsymmetric-30-capped": (lambda rng, n: rng.normal(size=(n, n)) + 6.0 * np.eye(n), 30, 0.0,
                               3, 10),
    "spd-40-r20": (_spd, 40, 1e-12, 20, 20),
    "nonsymmetric-6-restart-capped": (lambda rng, n: rng.normal(size=(n, n)) + 3.0 * np.eye(n),
                                      6, 1e-12, 10, 20),
}


@pytest.mark.parametrize("case", sorted(GMRES_CASES))
def test_gmres_matches_jax(case):
    """Each cycle costs restart + 1 matvecs (restart capped at n)."""
    make, n, tol, maxiter, restart = GMRES_CASES[case]
    rng = np.random.default_rng(n + restart)
    A, b = make(rng, n), rng.normal(size=n)
    xt, kt, xj, kj = _run("gmres_counted", A, b, tol=tol, maxiter=maxiter, restart=restart)
    assert kt == kj and kt % (min(restart, n) + 1) == 0
    _close(xt, xj)
    if case.endswith("capped") and tol == 0.0:
        assert kt == maxiter * (restart + 1)


@pytest.mark.parametrize("n", [6, 40])
def test_gmres_happy_breakdown_takes_the_minimum_norm_solution(n):
    """A right-hand side in a 2-dimensional Krylov subspace: the second
    Arnoldi residual is exactly zero (binary arithmetic), so H has
    restart - 2 zero columns and the least squares is rank-deficient; the
    minimum-norm solution puts no weight on them. One cycle: x exact, as
    JAX's."""
    A = np.diag(np.arange(1.0, n + 1.0))
    A[:2, :2] = [[0.0, 2.0], [0.5, 0.0]]
    b = np.zeros(n)
    b[0] = 3.0
    xt, kt, xj, kj = _run("gmres_counted", A, b, tol=1e-12, maxiter=5)
    want = np.zeros(n)
    want[1] = 1.5
    assert kt == kj == min(20, n) + 1
    np.testing.assert_allclose(xt.numpy(), want, rtol=0, atol=1e-14)
    _close(xt, xj)


def _hessenberg(rng, m, n, rank):
    H = np.triu(rng.normal(size=(m, n)), -1)
    if rank < n:  # a happy breakdown at column rank - 1
        H[:, rank:] = 0.0
        H[rank + 1:, :] = 0.0
        H[rank, rank - 1] = 0.0
    b = np.zeros(m)
    b[0] = rng.normal()
    return H, b


@pytest.mark.parametrize("rank", [20, 7, 2])
def test_lstsq_matches_jax(rank):
    """The plain least squares (and the wrapper, which takes it for CPU
    tensors) against ``jnp.linalg.lstsq`` on a 21 x 20 Hessenberg matrix,
    full rank and rank-deficient: the minimum-norm solution."""
    H, b = _hessenberg(np.random.default_rng(rank), 21, 20, rank)
    want = jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(b))[0]
    got = lstsq_plain(torch.tensor(H), torch.tensor(b))
    _close(got, want)
    assert torch.equal(lstsq_min_norm(torch.tensor(H), torch.tensor(b)), got)
    assert np.abs(got.numpy()[rank:]).max(initial=0.0) <= 1e-14


@pytest.mark.parametrize("n", [5, 60])
def test_dense_solve_matches_jax(n):
    """The direct solve against ``jnp.linalg.solve``; a singular matrix
    gives non-finite entries in both."""
    rng = np.random.default_rng(n)
    A, b = rng.normal(size=(n, n)), rng.normal(size=n)
    _close(ti.dense_solve(torch.tensor(A), torch.tensor(b)),
           jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b)))
    S = A.copy()
    S[:, 1] = 0.0
    assert not torch.isfinite(ti.dense_solve(torch.tensor(S), torch.tensor(b))).all()
    assert not np.isfinite(np.asarray(jnp.linalg.solve(jnp.asarray(S), jnp.asarray(b)))).all()
