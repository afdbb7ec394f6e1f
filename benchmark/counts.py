"""Operations and bytes that the cells' work needs, from shapes and counters.

Floating-point operations count a multiply and an add as two; only the
matrix products are counted (the elementwise work is under 1% of them in
every cell here). A value and gradient over ``rows`` rows is the forward
products plus, for each layer, the weight gradient and, for every layer
but the first, the gradient of its input (the input data's gradient is
not needed). A Hessian-vector product by forward over reverse costs two
of those. Bytes count each input read once and each output written once,
in float32.

A model family's work is an object with ``n_params``, ``vag(rows)``,
``trial(rows)`` and ``hvp(rows)`` (operations) and ``vag_bytes(rows)``:
:class:`MLPWork` for the dense MLPs. The solvers' counts below take it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence


def _products(dims: Sequence[int]) -> list[int]:
    return [a * b for a, b in zip(dims[:-1], dims[1:])]


def n_params(dims: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def forward_flops(dims: Sequence[int], rows: int, first_layer: bool = True) -> int:
    """The forward's products; ``first_layer=False`` leaves out the first
    layer's, as a line-search trial needs: the first layer's pre-activation
    is linear in the step length, so it is known from two products made
    once for the direction."""
    prods = _products(dims)
    return 2 * rows * (sum(prods) - (0 if first_layer else prods[0]))


def vag_flops(dims: Sequence[int], rows: int) -> int:
    """A loss and its gradient over ``rows`` rows."""
    prods = _products(dims)
    return 2 * rows * (2 * sum(prods) + sum(prods[1:]))


def hvp_flops(dims: Sequence[int], rows: int) -> int:
    return 2 * vag_flops(dims, rows)


def two_loop_flops(n: int, pairs: int) -> int:
    """The two-loop recursion over ``pairs`` pairs of n-vectors: a dot and
    an update per pair and pass, and the newest pair's two dots for gamma."""
    return 4 * n * (2 * pairs + 1) if pairs else 0


ROW_ALIGN = 128  # elements: the ring pads each row to a multiple of this


def two_loop_bytes(n: int, pairs: int, pair_bytes: int = 4) -> int:
    """The history's rows read once (padded to :data:`ROW_ALIGN` elements,
    as the ring stores them), the vector read and the direction written,
    and the pairs' rho."""
    n_pad = -(-n // ROW_ALIGN) * ROW_ALIGN
    return 2 * pairs * n_pad * pair_bytes + 2 * n * 4 + pairs * 4


def vag_bytes(dims: Sequence[int], rows: int) -> int:
    """Inputs and targets read, parameters read, gradient written."""
    return 4 * (rows * (dims[0] + dims[-1]) + 2 * n_params(dims))


class MLPWork(NamedTuple):
    """The operations and bytes of one dense MLP's calls."""

    dims: tuple

    @property
    def n_params(self) -> int:
        return n_params(self.dims)

    def vag(self, rows: int) -> int:
        return vag_flops(self.dims, rows)

    def trial(self, rows: int) -> int:
        return forward_flops(self.dims, rows, first_layer=False)

    def hvp(self, rows: int) -> int:
        return hvp_flops(self.dims, rows)

    def vag_bytes(self, rows: int) -> int:
        return vag_bytes(self.dims, rows)


def _pairs_sum(iters: int, m: int) -> int:
    """sum over iterations k = 0..iters-1 of min(k, m): the pairs each
    direction uses while the history fills."""
    full = max(iters - m, 0)
    head = min(iters, m)
    return head * (head - 1) // 2 + full * m


def lbfgs_flops(work, rows: int, m: int, n_iters: int, n_fevals: int, n_gevals: int) -> int:
    """A full-batch L-BFGS solve from its counters: every gradient
    evaluation a value and gradient, every other evaluation a line-search
    trial, and a direction per iteration."""
    trials = n_fevals - n_gevals
    return (n_gevals * work.vag(rows) + trials * work.trial(rows)
            + 4 * work.n_params * (2 * _pairs_sum(n_iters, m) + n_iters))


def slbfgs_solve_flops(work, rows: int, b: int, b_h: int, L: int, m: int, epochs: int) -> int:
    """An S-LBFGS solve of ``epochs`` epochs: each epoch the anchor's full
    value and gradient (the gradient is the epoch's mu, the value the
    loss the previous epoch records there), two batch gradients and a
    direction per step, and a Hessian-vector product per pair; once, the
    full value and gradient the last epoch records at its new anchor.
    Nothing is counted twice: the program's record of an epoch and the
    next epoch's mu are one value and gradient. The direction runs over
    the pairs the history holds at each step: from none, one more after
        each pair, up to ``m`` (every pair taken to pass the curvature gate;
    the solve's first pair waits for an earlier average)."""
    if epochs <= 0:
        return 0
    m_inner = rows // b
    nb = (m_inner - 1) // L
    pairs, held, has_u = 0, 0, False
    for _ in range(epochs):
        for t in range(m_inner):
            pairs += held  # step t's direction
            if t >= L and t % L == 0 and t // L <= nb:  # the pair after step t
                held = min(held + 1, m) if has_u else held
                has_u = True
    n = work.n_params
    return ((epochs + 1) * work.vag(rows) + 2 * epochs * m_inner * work.vag(b)
            + epochs * nb * work.hvp(b_h) + 4 * n * (2 * pairs + epochs * m_inner))


def sgd_epoch_flops(work, rows: int, b: int) -> int:
    """One sequential SGD epoch: a value and gradient per batch, the
    ragged tail's included, and the full loss and gradient norm that the
    epoch records."""
    m = rows // b
    return m * work.vag(b) + work.vag(rows - m * b) + work.vag(rows)
