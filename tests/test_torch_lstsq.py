"""The least-squares kernel's arithmetic (``csrc/lstsq.cu``) against JAX's
``jnp.linalg.lstsq``, through its numpy mirror
(:func:`lbfgs_ffnn_torch.ops.cuda_lstsq.jacobi_mirror`: the Givens triangle
with b carried, then the round-robin schedule on the triangle's rows, the
carried norms with their refresh each sweep, the squared stop test and the
dummy row, in the kernel's order): seeded GMRES-shaped Hessenberg matrices,
full rank, after happy breakdowns, graded by columns to a condition number
of about 1e8 and graded by rows (as a GMRES cycle whose subdiagonal
shrinks leaves H) to 6e9, and dense matrices taller and wider than they are
Hessenberg, f64 to 1e-10 of the largest entry, exactly zero weight on the
zero columns, converged within the kernel's sweep limit; the schedule
itself; and in f32 the card test's tolerance (4 times the plain version's
own error in f32, plus 10 eps) on the card test's matrices."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.ops.cuda_lstsq import (
    MAX_DIM, MAX_SWEEPS, hessenberg, jacobi_mirror, lstsq_plain, round_robin,
)

SHAPES = ((4, 3), (5, 4), (7, 6), (21, 20), (32, 31))
CASES = [((m, n), rank) for m, n in SHAPES for rank in sorted({n, 1, 2, 7}) if rank <= n]
GRADED_SEEDS = (100, 101, 102, 103)


def _held_to_jax(H, b, rank, tol=1e-10):
    want = np.asarray(jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(b))[0])
    y, sweeps, rounds = jacobi_mirror(H, b)
    assert y.dtype == np.float64 and y.shape == want.shape
    np.testing.assert_allclose(y, want, rtol=0, atol=tol * np.abs(want).max())
    assert np.all(y[rank:] == 0)  # the zero columns get exactly zero weight
    assert 1 <= sweeps < MAX_SWEEPS
    k = min(H.shape)  # the rows swept: n on GMRES's (n + 1) x n H
    assert rounds == sweeps * (k + k % 2 - 1)


@pytest.mark.parametrize("shape,rank", CASES)
def test_mirror_matches_jax(shape, rank):
    """GMRES's Hessenberg shapes, full rank and after a happy breakdown at
    column rank - 1 (zero columns and rows after it)."""
    H, b = hessenberg(rank, *shape, rank)
    _held_to_jax(H, b, rank)


@pytest.mark.parametrize("seed", GRADED_SEEDS)
def test_mirror_matches_jax_graded(seed):
    """21 x 20 graded by columns to a condition number of about 1e8."""
    H, b = hessenberg(seed, 21, 20, graded="columns")
    assert 1e7 < np.linalg.cond(H) < 1e9
    _held_to_jax(H, b, 20)


@pytest.mark.parametrize("seed", GRADED_SEEDS)
@pytest.mark.parametrize("shape,rank", [((21, 20), 20), ((32, 31), 31), ((21, 20), 7)])
def test_mirror_graded_by_rows(shape, rank, seed):
    """Graded by rows (21 x 20: cond 4e7 to 3e9; 32 x 31: 2e8 to 6e9), as a
    GMRES cycle whose subdiagonal shrinks leaves H, and after a happy
    breakdown at rank 7. One-sided Jacobi on H's columns loses relative
    accuracy on such a matrix (7.2e-9 at 21 x 20); on the rows of the Givens
    triangle it is held to 1e-10, as every other case."""
    H, b = hessenberg(seed, *shape, rank, graded="rows")
    if rank == shape[1]:
        assert 1e7 < np.linalg.cond(H) < 1e10
    _held_to_jax(H, b, rank)


@pytest.mark.parametrize("shape", [(8, 6), (6, 8)])
@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_dense(shape, seed):
    """A dense H, not Hessenberg, taller and wider: the triangle is then a
    Givens QR (several rotations a column, the rows below ``min(m, n)``
    zero), and the minimum-norm solution the same."""
    rng = np.random.default_rng(seed)
    H, b = rng.normal(size=shape), rng.normal(size=shape[0])
    _held_to_jax(H, b, shape[1])


@pytest.mark.parametrize("n", range(1, MAX_DIM + 1))
def test_round_robin_visits_every_pair_once(n):
    """Each sweep of the schedule: N - 1 rounds (N = n rounded up to even),
    each N / 2 disjoint pairs p < q, every pair of the N columns exactly
    once."""
    N = n + n % 2
    rounds = round_robin(n)
    assert len(rounds) == N - 1
    seen = []
    for pairs in rounds:
        assert len(pairs) == N // 2
        cols = [c for pair in pairs for c in pair]
        assert sorted(cols) == list(range(N))
        assert all(p < q for p, q in pairs)
        seen += pairs
    assert sorted(seen) == [(p, q) for p in range(N) for q in range(p + 1, N)]


@pytest.mark.parametrize("shape,rank", [((21, 20), 20), ((21, 20), 2), ((21, 20), 7),
                                        ((5, 4), 4), ((7, 6), 1), ((4, 3), 3), ((22, 21), 21),
                                        ((32, 31), 31)])
def test_mirror_f32_within_the_card_tolerance(shape, rank):
    """In f32, against the plain version in f64: at most 4 times the plain
    version's own f32 error plus 10 eps (of the largest entry), the bound
    ``tests/test_torch_cuda_bfgs_newton.py::test_lstsq_kernel_matches_plain``
    holds the kernel to, on its matrices."""
    H, b = hessenberg(rank, *shape, rank)
    ref = lstsq_plain(torch.tensor(H), torch.tensor(b)).numpy()
    H32, b32 = H.astype(np.float32), b.astype(np.float32)
    own = lstsq_plain(torch.tensor(H32), torch.tensor(b32)).double().numpy()
    y, sweeps, _ = jacobi_mirror(H32, b32)
    scale = np.abs(ref).max()
    assert y.dtype == np.float32 and sweeps < MAX_SWEEPS
    assert np.abs(y - ref).max() / scale <= 4 * np.abs(own - ref).max() / scale + 10 * 2.0**-23
    assert np.all(y[rank:] == 0)
