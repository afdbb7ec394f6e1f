"""Damped Newton with adaptive Levenberg regularization.

Counterpart of :mod:`lbfgs_ffnn_tpu.solvers.newton`. Per iteration: try
``(H + mu I) p = -g`` with ``mu`` escalating from ``reg_init`` by
``reg_growth`` up to ``reg_max`` until the solve is finite and ``p`` is a
descent direction; fall back to steepest descent otherwise; then the Wolfe
line search (the reference's src/minimizer/newton.hpp:34-77). Two Hessian
modes:

* ``hess_mode="dense"``: ``problem.hess`` (an objective's own, or
  :func:`~lbfgs_ffnn_torch.types.make_problem`'s autodiff default) forms H
  and each damped system is solved directly
  (:func:`~lbfgs_ffnn_torch.ops.iterative.dense_solve`, which reads
  nothing on the host);
* ``hess_mode="hvp_cg"``: matrix-free Newton-CG, each damped system solved
  by :func:`~lbfgs_ffnn_torch.ops.iterative.cg_counted` whose matvec is
  one exact Hessian-vector product (``Problem.hvp``) plus ``mu v``;
  ``n_hevals`` counts the products, summed over the damping trials.

The solve runs on the resident driver, as :mod:`lbfgs_ffnn_torch.solvers.bfgs`
does: the damping escalation is a device loop
(:func:`~lbfgs_ffnn_torch.ops.control.loop`), and so are CG and the Wolfe
trials; captured on CUDA tensors, Newton-CG's iteration holds a WHILE node
(CG) inside a WHILE node (the damping) inside the iteration's IF node. On
CPU tensors the same body runs eagerly. :func:`_newton_resident_eager` is
the body uncaptured, on any device.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from lbfgs_ffnn_torch.ops.control import assign, guard, loop
from lbfgs_ffnn_torch.ops.iterative import cg_counted, dense_solve
from lbfgs_ffnn_torch.solvers.common import (
    data_key, finalize, full_f32, init_history, lean_gate, prepared, record_at,
    solve_resident, wolfe_step,
)
from lbfgs_ffnn_torch.types import Problem, SolveResult


class NewtonOptions(NamedTuple):
    """The JAX package's options, with its names and defaults."""

    max_iters: int = 1000
    tol: float = 1e-10
    reg_init: float = 1e-6
    reg_max: float = 1e6
    reg_growth: float = 10.0
    ls_max_iters: int = 50
    c1: float = 1e-4
    c2: float = 0.9
    ls_shrink: float = 0.5
    ls_value_only: bool | None = None  # None: lean trials iff the problem has a line restriction
    hess_mode: str = "dense"  # "dense" | "hvp_cg" (matrix-free Newton-CG)
    cg_tol: float = 1e-10
    cg_max_iters: int = 200


class _State(NamedTuple):
    """JAX's solver state, every field a device tensor: ``k``, ``nf``,
    ``ng`` and ``nh`` int32 scalars."""

    k: torch.Tensor
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    gnorm: torch.Tensor
    loss_h: torch.Tensor
    gnorm_h: torch.Tensor
    nf: torch.Tensor
    ng: torch.Tensor
    nh: torch.Tensor  # HVPs (hvp_cg mode; 0 in dense mode)


def _damping(g: torch.Tensor, opts: NewtonOptions, live: torch.Tensor, direction):
    """JAX's damping loop: ``direction(mu) -> (p, n_hvps)`` for ``mu`` from
    ``reg_init`` up, until ``p`` is finite and ``p . g < 0`` or ``mu >
    reg_max``; the steepest-descent fallback ``-g`` otherwise (the
    reference's src/minimizer/newton.hpp:68-70). Returns ``(p, n_hvps)``,
    the products summed over the trials."""
    mu = torch.full((), opts.reg_init, dtype=g.dtype, device=g.device)
    p = torch.zeros_like(g)
    found = torch.zeros((), dtype=torch.bool, device=g.device)
    nh = torch.zeros((), dtype=torch.int32, device=g.device)

    def more():
        return ~found & (mu <= opts.reg_max) & live

    def trial():
        pt, n_hvps = direction(mu)
        ok = torch.isfinite(pt).all() & (torch.dot(pt, g) < 0.0)
        new = ((mu, torch.where(ok, mu, mu * opts.reg_growth)), (p, torch.where(ok, pt, p)),
               (found, ok), (nh, nh + n_hvps))
        for dst, v in new:  # every new value is computed; now the carry moves
            dst.copy_(v)

    loop(more, trial)
    return torch.where(found, p, -g), nh


def _dense_direction(H: torch.Tensor, g: torch.Tensor):
    def direction(mu):
        # H + mu I as JAX forms it, without an n x n identity: only the
        # diagonal changes (H_ij + mu * 0 is H_ij)
        Hd = H.clone()
        Hd.diagonal().add_(mu)
        return dense_solve(Hd, -g), 0

    return direction


def _hvp_direction(problem: Problem, x, g, aux, opts: NewtonOptions):
    def direction(mu):
        def matvec(v):
            return problem.hvp(x, v, aux) + mu * v

        return cg_counted(matvec, -g, tol=opts.cg_tol, maxiter=opts.cg_max_iters)

    return direction


def _check_options(problem: Problem, opts: NewtonOptions) -> None:
    if opts.hess_mode not in ("dense", "hvp_cg"):
        raise ValueError(f"unknown hess_mode {opts.hess_mode!r}")
    if opts.hess_mode == "dense" and problem.hess is None:
        raise ValueError("Newton with hess_mode='dense' requires problem.hess")


def _init_state(problem: Problem, opts: NewtonOptions, x0, aux) -> _State:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=x0.device)

    return _State(k=i32(0), x=x0.clone(), f=f0.clone(), g=g0.clone(),
                  gnorm=torch.linalg.norm(g0), loss_h=loss_h, gnorm_h=gnorm_h, nf=i32(1),
                  ng=i32(1), nh=i32(0))


def _not_done(s: _State, opts: NewtonOptions) -> torch.Tensor:
    return (s.k < opts.max_iters) & (s.gnorm > opts.tol)


def _make_resident_body(problem: Problem, opts: NewtonOptions):
    """``body(s, not_done, aux)``: JAX's iteration on the device state ``s``,
    in place, guarded by the device bool ``not_done`` (which it updates)."""
    lean = lean_gate(problem, opts.ls_value_only)

    def body(s: _State, not_done: torch.Tensor, aux) -> None:
        with guard(not_done):
            if opts.hess_mode == "hvp_cg":
                direction = _hvp_direction(problem, s.x, s.g, aux, opts)
            else:
                direction = _dense_direction(problem.hess(s.x, aux), s.g)
            p, nh_add = _damping(s.g, opts, not_done, direction)
            alpha, f_new, g_new, nf_add, ng_add = wolfe_step(problem, opts, lean, s.x, s.f, s.g,
                                                             p, aux, not_done)
            x_new = s.x + alpha * p
            gnorm_new = torch.linalg.norm(g_new)
            record_at(not_done, s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
            k_new = s.k + 1
            not_done_new = (k_new < opts.max_iters) & (gnorm_new > opts.tol)
            # every new value is computed; now the state moves
            for dst, new in ((s.x, x_new), (s.f, f_new), (s.g, g_new), (s.gnorm, gnorm_new),
                             (s.nf, s.nf + nf_add), (s.ng, s.ng + ng_add),
                             (s.nh, s.nh + nh_add), (s.k, k_new)):
                assign(not_done, dst, new)
            assign(not_done, not_done, not_done_new)

    return body


RESIDENT_CHUNK = 10  # iterations between the host's reads


def _counters(s: _State) -> tuple:
    return s.k, s.nf, s.ng, s.nh


def _solve(problem: Problem, x0: torch.Tensor, aux, opts: NewtonOptions, *, chunk: int,
           capture: bool) -> SolveResult:
    """The resident driver: captured (``capture``, CUDA only; the graph
    cached per problem, options, shapes and data) or the body run eagerly
    with masked writes."""
    _check_options(problem, opts)
    with full_f32(), torch.no_grad():
        aux = prepared(problem, aux)
        body = _make_resident_body(problem, opts)
        key = ("newton", problem, opts, tuple(x0.shape), x0.dtype, x0.device, data_key(aux))
        (k, nf, ng, nh, _), r = solve_resident(
            key, lambda s, not_done: body(s, not_done, aux), _init_state(problem, opts, x0, aux),
            lambda s: _not_done(s, opts), _counters, (0, 1, 1, 0, True), opts.max_iters,
            chunk=chunk, capture=capture)
        s = r.state
        return finalize(s.x.clone(), k, s.gnorm <= opts.tol, s.f.clone(), s.gnorm.clone(),
                        s.loss_h.clone(), s.gnorm_h.clone(), n_fevals=nf, n_gevals=ng,
                        n_hevals=nh, n_host_syncs=r.syncs)


def newton(problem: Problem, x0: torch.Tensor, aux: Any = (),
           opts: NewtonOptions | None = None) -> SolveResult:
    """Run damped Newton from ``x0`` on its device (``aux`` there too) on
    the resident driver, :data:`RESIDENT_CHUNK` iterations per host read:
    on CUDA tensors the captured iteration replayed, on CPU tensors the
    body run eagerly."""
    return _solve(problem, x0, aux, opts or NewtonOptions(), chunk=RESIDENT_CHUNK,
                  capture=x0.is_cuda)


def _newton_resident_eager(problem: Problem, x0: torch.Tensor, aux: Any = (),
                           opts: NewtonOptions | None = None,
                           chunk: int = RESIDENT_CHUNK) -> SolveResult:
    """The resident body run eagerly (masked writes, nothing captured) on
    any device: what the captured solve is held against."""
    return _solve(problem, x0, aux, opts or NewtonOptions(), chunk=chunk, capture=False)
