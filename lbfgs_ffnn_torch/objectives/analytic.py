"""Classic analytic test objectives: Rosenbrock, Ackley, Rastrigin.

Counterpart of :mod:`lbfgs_ffnn_tpu.objectives.analytic`: the same
functions, analytic gradients, dense Hessians and start points, written
vectorized over the parameter axis with the same arithmetic (JAX's
``g.at[:-1].add(a)`` on zeros becomes ``a`` padded by one zero). They take
any n and any device: the extended Rosenbrock at n = 2,000,000 is the
port's large-n L-BFGS path, where the two-loop runs the blocked kernel. The
dense Hessians materialize n x n and are meant for small n.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lbfgs_ffnn_torch.types import Problem, make_problem

_PI = math.pi


# ---------------------------------------------------------------------------
# Rosenbrock:  sum_i 100*(x_{i+1} - x_i^2)^2 + (1 - x_i)^2
# ---------------------------------------------------------------------------

def rosenbrock(w, aux=()):
    a = w[1:] - w[:-1] ** 2
    b = 1.0 - w[:-1]
    return torch.sum(100.0 * a**2 + b**2)


def rosenbrock_grad(w, aux=()):
    inner = w[1:] - w[:-1] ** 2
    # interior coupling terms: the first into g[:-1], the second into g[1:]
    return (F.pad(-2.0 * (1.0 - w[:-1]) - 400.0 * w[:-1] * inner, (0, 1))
            + F.pad(200.0 * inner, (1, 0)))


def rosenbrock_hess(w, aux=()):
    d = (F.pad(2.0 - 400.0 * (w[1:] - 3.0 * w[:-1] ** 2), (0, 1))
         + F.pad(torch.full_like(w[1:], 200.0), (1, 0)))
    off = -400.0 * w[:-1]
    return torch.diag(d) + torch.diag(off, 1) + torch.diag(off, -1)


def rosenbrock_problem(analytic: bool = True) -> Problem:
    if analytic:
        return make_problem(rosenbrock, rosenbrock_grad, rosenbrock_hess)
    return make_problem(rosenbrock)


def _alternating(n: int, even: float, odd: float, dtype, device) -> torch.Tensor:
    x = torch.full((n,), odd, dtype=torch.float64, device=device)
    x[::2] = even
    return x.to(dtype)


def rosenbrock_start(n: int = 4, dtype=torch.float64, device=None) -> torch.Tensor:
    """Alternating (-1.2, 1.0) start, rounded from f64 as in the JAX package."""
    return _alternating(n, -1.2, 1.0, dtype, device)


# ---------------------------------------------------------------------------
# Ackley
# ---------------------------------------------------------------------------

def ackley(w, aux=()):
    n = w.shape[0]
    sum1 = torch.sum(w**2)
    sum2 = torch.sum(torch.cos(2.0 * _PI * w))
    return (-20.0 * torch.exp(-0.2 * torch.sqrt(sum1 / n))
            - torch.exp(sum2 / n) + 20.0 + math.e)


def ackley_grad(w, aux=()):
    n = w.shape[0]
    sum1 = torch.sum(w**2)
    sum2 = torch.sum(torch.cos(2.0 * _PI * w))
    e1 = torch.exp(-0.2 * torch.sqrt(sum1 / n))
    e2 = torch.exp(sum2 / n)
    r = torch.sqrt(sum1 / n)
    g1 = 4.0 * e1 * (w / (n * r))
    g2 = (2.0 * _PI / n) * e2 * torch.sin(2.0 * _PI * w)
    return g1 + g2


def ackley_hess(w, aux=()):
    """Autodiff Hessian of the objective, as the JAX package's
    ``jax.hessian(ackley)``."""
    return torch.func.hessian(ackley)(w, aux)


def ackley_problem(analytic: bool = True) -> Problem:
    if analytic:
        return make_problem(ackley, ackley_grad, ackley_hess)
    return make_problem(ackley)


def ackley_start(dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([10.0, -5.0, 1.0], dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Rastrigin:  A*n + sum_i x_i^2 - A*cos(2*pi*x_i)
# ---------------------------------------------------------------------------

_A = 10.0


def rastrigin(w, aux=()):
    n = w.shape[0]
    return _A * n + torch.sum(w**2 - _A * torch.cos(2.0 * _PI * w))


def rastrigin_grad(w, aux=()):
    return 2.0 * w + 2.0 * _PI * _A * torch.sin(2.0 * _PI * w)


def rastrigin_hess(w, aux=()):
    return torch.diag(2.0 + 4.0 * _PI**2 * _A * torch.cos(2.0 * _PI * w))


def rastrigin_problem(analytic: bool = True) -> Problem:
    if analytic:
        return make_problem(rastrigin, rastrigin_grad, rastrigin_hess)
    return make_problem(rastrigin)


def rastrigin_start(n: int = 500, dtype=torch.float64, device=None) -> torch.Tensor:
    """Alternating (+4, -4) start."""
    return _alternating(n, 4.0, -4.0, dtype, device)
