"""Full-batch L-BFGS with the Armijo search, plainly (the reference CUDA
solver's policy, SignorB/lbfgs-FFNN ``src/cuda/lbfgs.cuh:90-185``).

An iteration: ``p = -H g`` by the two-loop recursion over the newest ``m``
pairs (``gamma = s.y / y.y`` of the newest pair); steepest descent and an
emptied history when ``g.p >= 0``; the Armijo search along ``p`` from
``alpha0 = min(1, 1/||g||)`` on the first iteration and 1 after, trying
``f(x + a p) <= f + c1 a g.p`` and, on a miss, the minimiser of the
quadratic fit when it lies in ``[0.1 a, 0.9 a]``, else ``a * shrink``; a
search that runs out keeps its last trial and empties the history; then
``s = a p``, ``y = g_new - g``, and the pair is kept when ``y.s`` passes the
curvature gate.

Every function takes the loss as an objective (``loss``,
``value_and_grad``), as :class:`benchmark.reference.mlp.Objective`.
"""

from __future__ import annotations

import torch


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def with_rho(rows: list) -> list:
    """``[(s, y, rho), ...]`` of pairs ``[(s, y), ...]``, ``rho = 1 / y.s``."""
    return [(s, y, 1.0 / torch.dot(y, s)) for s, y in rows]


def two_loop(v: torch.Tensor, pairs: list, clamp_gamma: bool = False,
             rnd=_same) -> torch.Tensor:
    """``H v`` over ``pairs`` = [(s, y, rho), ...], oldest first; ``v``
    itself when there are none. ``clamp_gamma``: gamma is 1 where
    ``|y.y| < 1e-12`` and is clipped to [1e-6, 1e6] (the stochastic
    solver's). ``rnd`` rounds each product's vector operands (the
    control's TF32: :func:`benchmark.reference.precision.tf32`)."""
    if not pairs:
        return v.clone()
    q, alphas = v.clone(), []
    for s, y, rho in reversed(pairs):
        a = rho * torch.dot(rnd(s), rnd(q))
        q = q - a * rnd(y)
        alphas.append(a)
    s, y, _ = pairs[-1]
    ys, yy = torch.dot(rnd(s), rnd(y)), torch.dot(rnd(y), rnd(y))
    if clamp_gamma:
        gamma = torch.ones_like(ys) if abs(float(yy)) < 1e-12 else ys / yy
        gamma = torch.clamp(gamma, 1e-6, 1e6)
    else:
        gamma = ys / yy if float(yy) > 0 else torch.ones_like(ys)
    z = gamma * q
    for (s, y, rho), a in zip(pairs, reversed(alphas)):
        z = z + (a - rho * torch.dot(rnd(y), rnd(z))) * rnd(s)
    return z


def armijo(f_at, f0: float, dg0: float, alpha0: float, c1: float, shrink: float,
           max_trials: int) -> tuple[float, bool, int]:
    """``(alpha, accepted, trials)``; ``f_at(a)`` is the loss at ``x + a p``."""
    a = alpha0
    for i in range(max_trials):
        f = float(f_at(a))
        if f <= f0 + c1 * a * dg0:
            return a, True, i + 1
        if i == max_trials - 1:
            break
        denom = 2.0 * (f - f0 - dg0 * a)
        a_quad = -(dg0 * a * a) / denom if denom != 0.0 else float("inf")
        a = a_quad if abs(denom) > 1e-20 and 0.1 * a <= a_quad <= 0.9 * a else a * shrink
    return a, False, max_trials


def steps(obj, w0: torch.Tensor, data: tuple, solve: dict, k: int) -> dict:
    """``k`` iterations from ``w0`` of the loss over ``data`` (the
    objective's arguments after the parameters): ``{"losses": [f_1..f_k], "iterates":
    [w_1..w_k], "g0": the first gradient}``. Step lengths are carried in
    the parameters' dtype, as the solver carries them."""
    dt = w0.dtype
    m, c1 = solve["m"], solve["c1"]
    shrink, trials, eps = solve["ls_shrink"], solve["ls_max_iters"], solve["curvature_eps"]
    x_k = w0.clone()
    f, g = obj.value_and_grad(x_k, *data)
    g0, pairs, losses, iterates = g.clone(), [], [], []
    for it in range(k):
        p = -two_loop(g, pairs)
        dg0 = torch.dot(g, p)
        if float(dg0) >= 0:
            p, dg0, pairs = -g, -torch.dot(g, g), []
        gnorm = torch.linalg.norm(g)
        alpha0 = float(torch.minimum(torch.ones((), dtype=dt, device=g.device), 1.0 / gnorm)) \
            if it == 0 else 1.0
        a, ok, _ = armijo(
            lambda t: obj.loss(x_k + torch.tensor(t, dtype=dt, device=p.device) * p, *data),
            float(f), float(dg0), alpha0, c1, shrink, trials)
        if not ok:
            pairs = []
        alpha = torch.tensor(a, dtype=dt, device=g.device)
        x_new = x_k + alpha * p
        f_new, g_new = obj.value_and_grad(x_new, *data)
        s, yv = alpha * p, g_new - g
        ys = torch.dot(yv, s)
        if float(ys) > eps:
            pairs = (pairs + [(s, yv, 1.0 / ys)])[-m:]
        x_k, f, g = x_new, f_new, g_new
        losses.append(float(f))
        iterates.append(x_k.clone())
    return {"losses": losses, "iterates": iterates, "g0": g0}
