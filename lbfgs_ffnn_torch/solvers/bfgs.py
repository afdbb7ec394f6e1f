"""BFGS with a pluggable linear solver and two storage modes.

Counterpart of :mod:`lbfgs_ffnn_tpu.solvers.bfgs`. ``storage="dense"``
keeps the full Hessian approximation ``B`` and solves ``B p = -g`` each
iteration directly (LU), by conjugate gradient or by GMRES, the
reference's injectable Eigen solver (src/minimizer/bfgs.hpp:11-38,
tests/main.cpp:265-269). ``storage="factors"`` is the counterpart of its
sparse instantiation: ``B`` is never formed but kept as stacked rank-2
update rows,

    B_k v = v + sum_j a_j (y_j . v) y_j - b_j ((B_j s_j) . v) (B_j s_j),

a ``(max_iters, n)`` stack each, and the system is solved matrix-free by CG
or GMRES. Both modes take the same rank-2 update ``B += y y^T / (y^T s) -
(Bs)(Bs)^T / (s^T B s)`` (src/minimizer/bfgs.hpp:76-77), without damping or
skip guards, as the reference and the JAX package do.

The solve runs on the resident driver of
:mod:`lbfgs_ffnn_torch.solvers.common`, as gradient descent's Wolfe branch
does: the iteration is JAX's ``body`` on its state (:class:`_State`) in
device tensors, guarded by ``not_done``; the Krylov iterations
(:mod:`lbfgs_ffnn_torch.ops.iterative`) and the Wolfe trials are device
loops and the re-evaluation of an exhausted search a guard. On CUDA tensors
the iteration is captured once into a CUDA graph and replayed, the host
reading the counters and the stop flag once per chunk of
:data:`RESIDENT_CHUNK`; on CPU tensors the same body runs eagerly, its
writes masked. The direct solve
(:func:`~lbfgs_ffnn_torch.ops.iterative.dense_solve`) reads nothing on the
host. TF32 is off for the solve.

:func:`_bfgs_resident_eager` is the body uncaptured, on any device: what
the captured solve is held against on the card.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from lbfgs_ffnn_torch.ops.control import assign, guard
from lbfgs_ffnn_torch.ops.iterative import cg_counted, dense_solve, gmres_counted
from lbfgs_ffnn_torch.solvers.common import (
    data_key, finalize, full_f32, init_history, lean_gate, prepared, record_at, record_row,
    solve_resident, wolfe_step,
)
from lbfgs_ffnn_torch.types import Problem, SolveResult


class BFGSOptions(NamedTuple):
    """The JAX package's options, with its names and defaults."""

    max_iters: int = 1000
    tol: float = 1e-10
    linear_solver: str = "direct"  # "direct" | "cg" | "gmres"
    storage: str = "dense"  # "dense" (B materialised) | "factors" (rank-2 rows; cg or gmres)
    solver_tol: float = 1e-12
    solver_max_iters: int = 10000
    ls_max_iters: int = 50
    c1: float = 1e-4
    c2: float = 0.9
    ls_shrink: float = 0.5
    ls_value_only: bool | None = None  # None: lean trials iff the problem has a line restriction


class _State(NamedTuple):
    """JAX's solver state, every field a device tensor: ``k``, ``nf``,
    ``ng`` and ``nmv`` int32 scalars; ``B`` the dense matrix or
    :class:`_Factors`."""

    k: torch.Tensor
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    gnorm: torch.Tensor
    B: Any
    loss_h: torch.Tensor
    gnorm_h: torch.Tensor
    nf: torch.Tensor
    ng: torch.Tensor
    nmv: torch.Tensor  # Krylov matvecs (0 under the direct solver)


class _Factors(NamedTuple):
    """The BFGS matrix in factor form: B = I + the rank-2 updates, stored as
    stacked update rows. Rows past the current iteration are zero (with
    zero coefficients), so no masking is needed."""

    U: torch.Tensor  # (cap, n): y_j
    V: torch.Tensor  # (cap, n): B_j s_j
    a: torch.Tensor  # (cap,): 1 / (y_j^T s_j)
    b: torch.Tensor  # (cap,): 1 / (s_j^T B_j s_j)


def _factors_empty(cap: int, n: int, dtype, device) -> _Factors:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return _Factors(U=z(cap, n), V=z(cap, n), a=z(cap), b=z(cap))


def _factor_matvec(F: _Factors, v: torch.Tensor) -> torch.Tensor:
    """``B v`` from the factor rows: two (cap, n) matrix products each way."""
    return v + (F.a * (F.U @ v)) @ F.U - (F.b * (F.V @ v)) @ F.V


def _check_options(opts: BFGSOptions) -> None:
    if opts.storage not in ("dense", "factors"):
        raise ValueError(f"unknown storage {opts.storage!r}")
    if opts.linear_solver not in ("direct", "cg", "gmres"):
        raise ValueError(f"unknown linear_solver {opts.linear_solver!r}")
    if opts.storage == "factors" and opts.linear_solver == "direct":
        raise ValueError(
            "storage='factors' never materializes B; use an iterative "
            "linear_solver ('cg' or 'gmres'), matching the reference's "
            "sparse+ConjugateGradient instantiation")


def _solve_iterative(matvec, rhs, opts: BFGSOptions, live):
    """Counted Krylov solve: ``(solution, n_matvecs)``."""
    solve = cg_counted if opts.linear_solver == "cg" else gmres_counted
    return solve(matvec, rhs, tol=opts.solver_tol, maxiter=opts.solver_max_iters, live=live)


def _solve_linear(B, rhs, opts: BFGSOptions, live):
    if opts.linear_solver == "direct":
        return dense_solve(B, rhs), torch.zeros((), dtype=torch.int32, device=rhs.device)
    return _solve_iterative(lambda u: B @ u, rhs, opts, live)


def _init_state(problem: Problem, opts: BFGSOptions, x0, aux, B0) -> _State:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=x0.device)

    return _State(k=i32(0), x=x0.clone(), f=f0.clone(), g=g0.clone(),
                  gnorm=torch.linalg.norm(g0), B=B0, loss_h=loss_h, gnorm_h=gnorm_h,
                  nf=i32(1), ng=i32(1), nmv=i32(0))


def _not_done(s: _State, opts: BFGSOptions) -> torch.Tensor:
    # the reference loops while ||g|| > tol (src/minimizer/bfgs.hpp:61)
    return (s.k < opts.max_iters) & (s.gnorm > opts.tol)


def _make_resident_body(problem: Problem, opts: BFGSOptions):
    """``body(s, not_done, aux)``: JAX's iteration on the device state ``s``,
    in place, guarded by the device bool ``not_done`` (which it updates)."""
    factors = opts.storage == "factors"
    lean = lean_gate(problem, opts.ls_value_only)

    def body(s: _State, not_done: torch.Tensor, aux) -> None:
        with guard(not_done):
            if factors:
                p, nmv_add = _solve_iterative(lambda u: _factor_matvec(s.B, u), -s.g, opts,
                                              not_done)
            else:
                p, nmv_add = _solve_linear(s.B, -s.g, opts, not_done)
            alpha, f_new, g_new, nf_add, ng_add = wolfe_step(problem, opts, lean, s.x, s.f, s.g,
                                                             p, aux, not_done)
            step = alpha * p
            x_new = s.x + step
            y = g_new - s.g
            # NOT counted: the update's B s, in both modes (JAX counts
            # Krylov operator applications only)
            if factors:
                # row k of the stack: (y, B_k s) with 1/(y^T s), 1/(s^T B_k s)
                Bs = _factor_matvec(s.B, step)
                rows = ((s.B.U, y), (s.B.V, Bs), (s.B.a, 1.0 / torch.dot(y, step)),
                        (s.B.b, 1.0 / torch.dot(step, Bs)))
            else:
                Bs = s.B @ step
                B_new = (s.B + torch.outer(y, y) / torch.dot(y, step)
                         - torch.outer(Bs, Bs) / torch.dot(step, Bs))
            gnorm_new = torch.linalg.norm(g_new)
            record_at(not_done, s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
            k_new = s.k + 1
            not_done_new = (k_new < opts.max_iters) & (gnorm_new > opts.tol)
            # every new value is computed; now the state moves
            if factors:
                for h, row in rows:
                    record_row(not_done, h, s.k, row)
            else:
                assign(not_done, s.B, B_new)
            for dst, new in ((s.x, x_new), (s.f, f_new), (s.g, g_new), (s.gnorm, gnorm_new),
                             (s.nf, s.nf + nf_add), (s.ng, s.ng + ng_add),
                             (s.nmv, s.nmv + nmv_add), (s.k, k_new)):
                assign(not_done, dst, new)
            assign(not_done, not_done, not_done_new)

    return body


RESIDENT_CHUNK = 10  # iterations between the host's reads


def _counters(s: _State) -> tuple:
    return s.k, s.nf, s.ng, s.nmv


def _solve(problem: Problem, x0: torch.Tensor, aux, opts: BFGSOptions, initial_hessian, *,
           chunk: int, capture: bool) -> SolveResult:
    """The resident driver: captured (``capture``, CUDA only; the graph
    cached per problem, options, shapes and data, ``initial_hessian`` being
    state) or the body run eagerly with masked writes."""
    if opts.storage == "factors" and initial_hessian is not None:
        raise ValueError("storage='factors' starts from B0 = I; "
                         "initial_hessian is dense-mode only")
    _check_options(opts)
    n = x0.shape[0]
    if opts.storage == "factors":
        B0 = _factors_empty(opts.max_iters, n, x0.dtype, x0.device)
    elif initial_hessian is not None:
        B0 = initial_hessian.to(dtype=x0.dtype, device=x0.device).clone()
    else:
        B0 = torch.eye(n, dtype=x0.dtype, device=x0.device)
    with full_f32(), torch.no_grad():
        aux = prepared(problem, aux)
        body = _make_resident_body(problem, opts)
        key = ("bfgs", problem, opts, tuple(x0.shape), x0.dtype, x0.device, data_key(aux))
        (k, nf, ng, nmv, _), r = solve_resident(
            key, lambda s, not_done: body(s, not_done, aux),
            _init_state(problem, opts, x0, aux, B0), lambda s: _not_done(s, opts), _counters,
            (0, 1, 1, 0, True), opts.max_iters, chunk=chunk, capture=capture)
        s = r.state
        return finalize(s.x.clone(), k, s.gnorm <= opts.tol, s.f.clone(), s.gnorm.clone(),
                        s.loss_h.clone(), s.gnorm_h.clone(), n_fevals=nf, n_gevals=ng,
                        n_matvecs=nmv, n_host_syncs=r.syncs)


def bfgs(
    problem: Problem,
    x0: torch.Tensor,
    aux: Any = (),
    opts: BFGSOptions | None = None,
    initial_hessian: torch.Tensor | None = None,
) -> SolveResult:
    """Run BFGS from ``x0`` on its device (``aux`` there too) on the
    resident driver, :data:`RESIDENT_CHUNK` iterations per host read: on
    CUDA tensors the captured iteration replayed, on CPU tensors the body
    run eagerly. ``initial_hessian`` (dense storage only) replaces
    ``B0 = I``."""
    return _solve(problem, x0, aux, opts or BFGSOptions(), initial_hessian,
                  chunk=RESIDENT_CHUNK, capture=x0.is_cuda)


def _bfgs_resident_eager(problem: Problem, x0: torch.Tensor, aux: Any = (),
                         opts: BFGSOptions | None = None,
                         initial_hessian: torch.Tensor | None = None,
                         chunk: int = RESIDENT_CHUNK) -> SolveResult:
    """The resident body run eagerly (masked writes, nothing captured) on
    any device: what the captured solve is held against."""
    return _solve(problem, x0, aux, opts or BFGSOptions(), initial_hessian, chunk=chunk,
                  capture=False)
