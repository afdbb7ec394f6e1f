"""Full-batch gradient descent: fixed step or classical momentum.

Counterpart of :mod:`lbfgs_ffnn_tpu.solvers.gd`, its fixed-step and momentum
branches: ``x <- x - lr*g``, or ``v <- mu*v - lr*g; x <- x + v`` (the
reference's CudaGD, src/cuda/gd.cuh:73-100). The JAX solve is one
``lax.while_loop``; this one is a host loop whose stop test
``k < max_iters and gnorm >= tol`` syncs the host once per iteration,
counted in ``SolveResult.n_host_syncs``. TF32 is off for the solve.

Not ported yet: the Wolfe branch (``momentum == 0`` with
``use_line_search=True``, the JAX default) raises ``NotImplementedError``
(ROADMAP queue 1 item 5; the Wolfe search itself is ported, for L-BFGS);
``gd_chunked`` and GD on the resident driver are ROADMAP queue 1 item 2.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from lbfgs_ffnn_torch.solvers.common import finalize, full_f32, init_history, record
from lbfgs_ffnn_torch.types import Problem, SolveResult, prepared_aux


class GDOptions(NamedTuple):
    """The JAX package's options that the ported branches read, with the
    same names and defaults."""

    max_iters: int = 1000
    tol: float = 1e-10
    step_size: float = 1e-2
    momentum: float = 0.0
    use_line_search: bool = True


def gradient_descent(
    problem: Problem, x0: torch.Tensor, aux: Any = (), opts: GDOptions | None = None
) -> SolveResult:
    """Run GD from ``x0`` on its device; ``aux`` lives there too."""
    opts = opts or GDOptions()
    if opts.momentum <= 0.0 and opts.use_line_search:
        raise NotImplementedError(
            "gradient_descent with the Wolfe line search is not ported yet (ROADMAP queue 1 "
            "item 5); pass momentum > 0 or use_line_search=False")
    with full_f32(), torch.no_grad():
        aux = prepared_aux(problem, aux)
        f, g = problem.value_and_grad(x0, aux)
        gnorm = torch.linalg.norm(g)
        loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)
        x, v, k = x0, torch.zeros_like(x0), 0
        while k < opts.max_iters and bool(gnorm >= opts.tol):
            if opts.momentum > 0.0:
                v = opts.momentum * v - opts.step_size * g
                x = x + v
            else:
                x = x - opts.step_size * g
            f, g = problem.value_and_grad(x, aux)
            gnorm = torch.linalg.norm(g)
            loss_h, gnorm_h = record(loss_h, gnorm_h, k, f, gnorm)
            k += 1
    # One stop test per iteration, plus the final one when tol (not
    # max_iters) ended the solve; one value-and-gradient per iteration.
    return finalize(x, k, gnorm < opts.tol, f, gnorm, loss_h, gnorm_h,
                    n_fevals=k + 1, n_gevals=k + 1, n_host_syncs=k + int(k < opts.max_iters))
