"""Full-batch gradient descent: fixed step, classical momentum or the Wolfe
line search.

Counterpart of :mod:`lbfgs_ffnn_tpu.solvers.gd`, every branch:
``x <- x - lr*g``; ``v <- mu*v - lr*g; x <- x + v`` (the reference's
CudaGD, src/cuda/gd.cuh:73-100); or, with ``momentum == 0`` and
``use_line_search`` (the default), a Wolfe search along ``-g`` (the
reference CPU's GradientDescent, src/minimizer/gd.hpp:42-68) whose
evaluation at the accepted point is reused, only an exhausted search paying
a fresh value-and-gradient.

The solve runs on the resident driver of
:mod:`lbfgs_ffnn_torch.solvers.common`, as L-BFGS's does: the iteration is
JAX's ``body`` with its state (:class:`_State`) in device tensors, guarded
by ``not_done``; the Wolfe trials are one device loop
(:func:`~lbfgs_ffnn_torch.ops.control.loop`) and the re-evaluation of an
exhausted search a guard. On CUDA tensors the iteration is captured once
into a CUDA graph (an IF node per guard, a WHILE node for the trials) and
replayed, the host reading the iteration counter and the stop flag once per
chunk; on CPU tensors the same body runs eagerly, its writes masked.
:func:`gd_chunked` is JAX's measured-chunk driver. TF32 is off for the
solve.

Private entries for tests and the card's comparisons:
:func:`_gd_resident_eager` (the body uncaptured, on any device) and
:func:`_gd_loop` (a host loop that stops early: one host sync per
iteration, and one per trial of the early-exit Wolfe search).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from lbfgs_ffnn_torch.ops.control import assign, guard
from lbfgs_ffnn_torch.ops.linesearch import wolfe_line_search
from lbfgs_ffnn_torch.solvers.common import (
    Resident, cached_resident, data_key, drive_resident, finalize, full_f32, init_history,
    lean_gate, prepared, record, record_at, wolfe_step,
)
from lbfgs_ffnn_torch.types import Problem, SolveResult


class GDOptions(NamedTuple):
    """The JAX package's options, with its names and defaults."""

    max_iters: int = 1000
    tol: float = 1e-10
    step_size: float = 1e-2
    momentum: float = 0.0
    use_line_search: bool = True
    ls_max_iters: int = 50
    c1: float = 1e-4
    c2: float = 0.9
    ls_shrink: float = 0.5
    ls_value_only: bool | None = None  # None: lean trials iff the problem has a line restriction


class _State(NamedTuple):
    """JAX's solver state, every field a device tensor: ``k``, ``nf`` and
    ``ng`` int32 scalars, the rest in the solver dtype."""

    k: torch.Tensor
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    gnorm: torch.Tensor
    v: torch.Tensor  # momentum velocity
    loss_h: torch.Tensor
    gnorm_h: torch.Tensor
    nf: torch.Tensor
    ng: torch.Tensor


def _wolfe(opts: GDOptions) -> bool:
    return opts.momentum <= 0.0 and opts.use_line_search


def _init_state(problem: Problem, opts: GDOptions, x0, aux) -> _State:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=x0.device)

    return _State(k=i32(0), x=x0.clone(), f=f0.clone(), g=g0.clone(),
                  gnorm=torch.linalg.norm(g0), v=torch.zeros_like(x0), loss_h=loss_h,
                  gnorm_h=gnorm_h, nf=i32(1), ng=i32(1))


def _not_done(s: _State, opts: GDOptions) -> torch.Tensor:
    return (s.k < opts.max_iters) & (s.gnorm >= opts.tol)


def _make_resident_body(problem: Problem, opts: GDOptions):
    """``body(s, not_done, aux)``: JAX's iteration on the device state ``s``,
    in place, guarded by the device bool ``not_done`` (which it updates)."""
    lean = lean_gate(problem, opts.ls_value_only)

    def body(s: _State, not_done: torch.Tensor, aux) -> None:
        with guard(not_done):
            v = s.v
            if _wolfe(opts):
                # the search's evaluation at the accepted point is reused;
                # only an exhausted search pays a fresh one
                alpha, f_new, g_new, nf_add, ng_add = wolfe_step(problem, opts, lean, s.x, s.f,
                                                                 s.g, -s.g, aux, not_done)
                x_new = s.x - alpha * s.g
            else:
                if opts.momentum > 0.0:
                    v = opts.momentum * s.v - opts.step_size * s.g
                    x_new = s.x + v
                else:
                    x_new = s.x - opts.step_size * s.g
                f_new, g_new = problem.value_and_grad(x_new, aux)
                nf_add = ng_add = 1
            gnorm_new = torch.linalg.norm(g_new)
            record_at(not_done, s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
            k_new = s.k + 1
            not_done_new = (k_new < opts.max_iters) & (gnorm_new >= opts.tol)
            # every new value is computed; now the state moves
            for dst, new in ((s.x, x_new), (s.f, f_new), (s.g, g_new), (s.gnorm, gnorm_new),
                             (s.v, v), (s.nf, s.nf + nf_add), (s.ng, s.ng + ng_add),
                             (s.k, k_new)):
                assign(not_done, dst, new)
            assign(not_done, not_done, not_done_new)

    return body


RESIDENT_CHUNK = 10  # iterations between the host's reads when gradient_descent() runs


def _counters(s: _State) -> tuple:
    return s.k, s.nf, s.ng


def _solve(problem: Problem, x0: Optional[torch.Tensor], aux, opts: GDOptions, *,
           chunk: int, capture: bool, callback=None, resume_state=None,
           iters: Optional[int] = None):
    """The resident driver: ``chunk`` iterations per host read, captured
    (``capture``, CUDA only; the graph cached per problem, options, shapes
    and data; chunk c+1 enqueued before the host reads chunk c) or run
    eagerly with masked writes, a chunk at a time. ``iters`` stops the host
    loop before ``max_iters`` (a warm-up that captures the full solve's
    iteration). Returns ``(result, time_ms)``."""
    if resume_state is None and x0 is None:
        raise ValueError("x0 is required unless resume_state is given")
    like = x0 if x0 is not None else resume_state.x
    if capture and not like.is_cuda:
        raise ValueError(f"a captured solve needs CUDA tensors, got {like.device}")
    with full_f32(), torch.no_grad():
        aux = prepared(problem, aux)
        body = _make_resident_body(problem, opts)

        def make():
            return Resident([lambda s, not_done: body(s, not_done, aux)],
                            _init_state(problem, opts, like, aux),
                            lambda s: _not_done(s, opts), capture)

        r = make() if not capture else cached_resident(
            ("gd", problem, opts, tuple(like.shape), like.dtype, like.device, data_key(aux)),
            make)
        known = None
        if resume_state is None:
            r.load(_init_state(problem, opts, x0, aux))
            known = (0, 1, 1, True)
        else:
            r.load(resume_state)
        (k, nf, ng, _), time_ms = drive_resident(
            r, chunk, opts.max_iters if iters is None else iters, _counters, known,
            callback=callback, pipeline=capture and iters is None)
        s = r.state
        res = finalize(s.x.clone(), k, s.gnorm < opts.tol, s.f.clone(), s.gnorm.clone(),
                       s.loss_h.clone(), s.gnorm_h.clone(), n_fevals=nf, n_gevals=ng,
                       n_host_syncs=r.syncs)
    return res, time_ms


def gradient_descent(
    problem: Problem, x0: torch.Tensor, aux: Any = (), opts: GDOptions | None = None
) -> SolveResult:
    """Run GD from ``x0`` on its device (``aux`` there too) on the resident
    driver, :data:`RESIDENT_CHUNK` iterations per host read: on CUDA tensors
    the captured iteration replayed, on CPU tensors the body run eagerly."""
    opts = opts or GDOptions()
    return _solve(problem, x0, aux, opts, chunk=RESIDENT_CHUNK, capture=x0.is_cuda)[0]


def _gd_resident_eager(problem: Problem, x0: torch.Tensor, aux: Any = (),
                       opts: GDOptions | None = None,
                       chunk: int = RESIDENT_CHUNK) -> SolveResult:
    """The resident body run eagerly (masked writes, nothing captured) on
    any device: what the captured solve is held against."""
    return _solve(problem, x0, aux, opts or GDOptions(), chunk=chunk, capture=False)[0]


def gd_chunked(
    problem: Problem,
    x0: Optional[torch.Tensor],
    aux: Any = (),
    opts: GDOptions | None = None,
    chunk: int = 10,
    callback: Optional[Callable[[_State, float], None]] = None,
    resume_state: Optional[_State] = None,
):
    """Run GD in ``chunk``-iteration pieces on the resident driver: on CUDA
    the captured iteration replayed, on the CPU the same body run eagerly.

    Returns ``(result, time_ms)`` with JAX's protocol (see
    :func:`~lbfgs_ffnn_torch.solvers.lbfgs.lbfgs_chunked`): ``time_ms[i]``
    the measured cumulative wall time after iteration ``i`` at chunk
    granularity, NaN before a resume. ``callback(state, elapsed_s)`` gets
    the live :class:`_State` after each chunk (static buffers: clone what
    you keep). ``resume_state`` continues from such a state, the momentum
    velocity included; ``x0`` may then be None."""
    opts = opts or GDOptions()
    like = x0 if x0 is not None else (resume_state.x if resume_state is not None else None)
    return _solve(problem, x0, aux, opts, chunk=chunk,
                  capture=like is not None and like.is_cuda, callback=callback,
                  resume_state=resume_state)


def gd_warm_up(problem: Problem, x0: torch.Tensor, aux: Any = (),
               opts: GDOptions | None = None, iters: int = 2) -> SolveResult:
    """``iters`` iterations, from ``x0``, of the solve ``gradient_descent``
    runs with these arguments: on CUDA tensors its iteration captured here
    and cached (a later solve with the same problem, options, shapes and
    ``aux`` tensors replays it, from any start), read by the host once at
    the end; on CPU tensors the eager body. The warm-up before a timed
    solve."""
    opts = opts or GDOptions()
    if x0.is_cuda:
        return _solve(problem, x0, aux, opts, chunk=max(iters, 1), capture=True,
                      iters=iters)[0]
    return gradient_descent(problem, x0, aux, opts._replace(max_iters=iters))


def _gd_loop(problem: Problem, x0: torch.Tensor, aux: Any = (),
             opts: GDOptions | None = None) -> SolveResult:
    """A host loop that stops early, on any device: the stop test syncs the
    host once per iteration, the early-exit Wolfe search once per trial.
    The reference the resident driver is held against."""
    opts = opts or GDOptions()
    lean = lean_gate(problem, opts.ls_value_only)
    with full_f32(), torch.no_grad():
        aux = prepared(problem, aux)
        f, g = problem.value_and_grad(x0, aux)
        gnorm = torch.linalg.norm(g)
        loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)
        x, v, k, nf, ng, syncs = x0, torch.zeros_like(x0), 0, 1, 1, 0
        while k < opts.max_iters and bool(gnorm >= opts.tol):
            if _wolfe(opts):
                p = -g
                ls = wolfe_line_search(
                    problem.value_and_grad, x, p, f, torch.dot(g, p), aux, c1=opts.c1,
                    c2=opts.c2, shrink=opts.ls_shrink, max_iters=opts.ls_max_iters,
                    value=problem.fun if lean else None,
                    value_along=problem.line_fun(x, p, aux) if lean and problem.line_fun
                    else None)
                x = x - ls.alpha * g
                syncs += ls.n_trials
                extra = 0 if ls.evaluated else 1  # an exhausted search's re-evaluation
                nf += ls.n_trials + (1 if lean else extra)
                ng += 1 if lean else ls.n_trials + extra
                f, g = (ls.f_new, ls.g_new) if ls.evaluated else problem.value_and_grad(x, aux)
            else:
                if opts.momentum > 0.0:
                    v = opts.momentum * v - opts.step_size * g
                    x = x + v
                else:
                    x = x - opts.step_size * g
                f, g = problem.value_and_grad(x, aux)
                nf, ng = nf + 1, ng + 1
            gnorm = torch.linalg.norm(g)
            loss_h, gnorm_h = record(loss_h, gnorm_h, k, f, gnorm)
            k += 1
    # one stop test per iteration, plus the final one when tol (not
    # max_iters) ended the solve
    return finalize(x, k, gnorm < opts.tol, f, gnorm, loss_h, gnorm_h, n_fevals=nf,
                    n_gevals=ng, n_host_syncs=syncs + k + int(k < opts.max_iters))
