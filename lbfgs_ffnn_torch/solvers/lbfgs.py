"""L-BFGS with the reference backends' two line-search policies.

Counterpart of :mod:`lbfgs_ffnn_tpu.solvers.lbfgs`, both branches:
  * ``"wolfe"`` (the default) - the reference CPU solver: Wolfe bisection
    search, skipped on the first iteration for ``alpha = min(1, 1/||g||)``,
    re-evaluation at the search's last alpha when it ends unaccepted
    (reference: src/minimizer/lbfgs.hpp:38-99);
  * ``"armijo"`` - the reference CUDA solver: the descent-direction check
    with steepest-descent fallback and history reset, Armijo backtracking
    with safeguarded quadratic interpolation keeping the last trial on
    failure, history reset on line-search failure
    (reference: src/cuda/lbfgs.cuh:90-185);
and the absolute or relative curvature gate in both.

The JAX solve is one ``lax.while_loop``; this one is a host loop with two
kinds of host sync and no others: the line search's accept test, once per
trial, and the stop test ``k < max_iters and gnorm >= tol``, once per
iteration. Directions, ring pushes and resets, alpha and the carried line
prefix stay on the device. ``SolveResult.n_host_syncs`` counts the syncs.

The solve runs in full float32 on CUDA: TF32 matmuls are switched off for
its duration (:func:`~lbfgs_ffnn_torch.solvers.common.full_f32`).
``pair_dtype="bfloat16"`` stores the curvature ring in bf16 (half its bytes
and half the two-loop's history traffic); rho = 1/(y.s) comes from the
solver-dtype pair before the push narrows it, and the recursion runs in the
solver dtype.

Not ported yet (each raises ``NotImplementedError``): the batched Armijo
search, ``ls_alpha_init="warm"``, HVP curvature pairs, the sharded
two-loops, pair dtypes other than bfloat16, ``prefix_dtype`` with
``prefix_refresh``, ``mesh``. ``lbfgs_chunked`` is not ported yet either.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda
from lbfgs_ffnn_torch.ops.linesearch import armijo_quad_line_search, wolfe_line_search
from lbfgs_ffnn_torch.ops.two_loop import (
    RingState, empty_history_state, ring_push, ring_reset, two_loop, two_loop_compact,
)
from lbfgs_ffnn_torch.solvers.common import finalize, full_f32, init_history, record
from lbfgs_ffnn_torch.types import Problem, SolveResult, prepared_aux


class LBFGSOptions(NamedTuple):
    """The JAX package's options that the ported branch reads, with the same
    names and defaults except ``two_loop_impl``: "cuda" (the default; the
    Hopper kernel on CUDA tensors, the plain loop on CPU tensors), "plain"
    (the torch loop everywhere, the kernel's reference) or "compact" (JAX's
    single-device compact form in plain torch, everywhere)."""

    max_iters: int = 1000
    tol: float = 1e-10
    m: int = 16
    line_search: str = "wolfe"
    ls_max_iters: int = 50
    c1: float = 1e-4
    c2: float = 0.9
    ls_shrink: float = 0.5
    curvature_eps: float = 1e-10
    curvature_rel_eps: float = 0.0
    curvature_pairs: str = "grad_diff"
    two_loop_impl: str = "cuda"
    prefix_vag: bool = True
    ls_value_only: bool | None = None
    pair_dtype: str | None = None
    prefix_dtype: str | None = None
    prefix_refresh: int | None = None
    ls_alpha_init: str = "fixed"


def _check_options(opts: LBFGSOptions) -> None:
    choices = {
        "line_search": (opts.line_search, ("wolfe", "armijo"), ("armijo_batched",)),
        "curvature_pairs": (opts.curvature_pairs, ("grad_diff",), ("hvp",)),
        "ls_alpha_init": (opts.ls_alpha_init, ("fixed",), ("warm",)),
        "two_loop_impl": (opts.two_loop_impl, ("plain", "cuda", "compact"), ("xla", "pallas")),
    }
    for name, (val, ported, later) in choices.items():
        if val in later:
            raise NotImplementedError(f"LBFGSOptions({name}={val!r}) is not ported yet")
        if val not in ported:
            raise ValueError(f"unknown {name} {val!r}")
    if opts.pair_dtype not in (None, "bfloat16"):
        raise NotImplementedError(f"LBFGSOptions(pair_dtype={opts.pair_dtype!r}) is not "
                                  "ported yet: the narrow ring is bfloat16")
    if opts.prefix_dtype is not None:
        raise NotImplementedError("LBFGSOptions(prefix_dtype=...) is not ported yet")
    if opts.prefix_refresh not in (None, 0):
        raise NotImplementedError("LBFGSOptions(prefix_refresh=...) is not ported yet")


_PAIR_DTYPES = {None: None, "bfloat16": torch.bfloat16}


class _State(NamedTuple):
    k: int
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    gnorm: torch.Tensor
    hist: RingState
    loss_h: torch.Tensor
    gnorm_h: torch.Tensor
    nf: int  # objective (forward) evaluations
    ng: int  # full-gradient evaluations
    prefix: Any = ()  # carried LinePrefix state (the MLP's A = x@W1 + b1)
    syncs: int = 0  # host syncs of the line searches


class _Step(NamedTuple):
    """What a line-search branch hands the shared update."""

    p: torch.Tensor       # the direction searched (after any fallback)
    hist: RingState       # the ring after any reset
    B: Any                # the prefix's directional increment, or None
    alpha: torch.Tensor
    f_new: torch.Tensor
    g_new: torch.Tensor
    nf_add: int
    ng_add: int
    trials: int           # line-search trials, one host sync each
    carry: Any = ()       # armijo's accept-point prefix


def _lean(problem: Problem, opts: LBFGSOptions) -> bool:
    """Loss-only trials (Wolfe: loss and slope by one jvp) plus one
    value-and-gradient at the chosen point: ``ls_value_only`` when set,
    else on for armijo and wherever the problem has a line restriction."""
    if opts.ls_value_only is not None:
        return opts.ls_value_only
    return (opts.line_search == "armijo" or problem.line_fun is not None
            or problem.line_prefix is not None)


def _use_prefix(problem: Problem, opts: LBFGSOptions) -> bool:
    return problem.line_prefix is not None and _lean(problem, opts)


def _init_state(problem: Problem, opts: LBFGSOptions, x0, aux) -> _State:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)
    return _State(
        k=0, x=x0, f=f0, g=g0, gnorm=torch.linalg.norm(g0),
        hist=empty_history_state(opts.m, x0.shape[0], x0.dtype,
                                 pair_dtype=_PAIR_DTYPES[opts.pair_dtype], device=x0.device),
        loss_h=loss_h, gnorm_h=gnorm_h, nf=1, ng=1,
        prefix=problem.line_prefix.init(x0, aux) if _use_prefix(problem, opts) else (),
    )


def _not_done(s: _State, opts: LBFGSOptions) -> bool:
    """The stop test; reading gnorm is one host sync while k < max_iters."""
    return s.k < opts.max_iters and bool(s.gnorm >= opts.tol)


def _make_body(problem: Problem, opts: LBFGSOptions):
    _check_options(opts)
    two_loop_fn = {"cuda": two_loop_cuda, "compact": two_loop_compact}.get(opts.two_loop_impl,
                                                                          two_loop)
    lean = _lean(problem, opts)
    use_prefix = _use_prefix(problem, opts)
    # The armijo accept evaluation already computes the post-step prefix
    # (the MLP's z1 = A + alpha*B); carrying it replaces the prefix axpy.
    # Wolfe keeps the axpy.
    carry_mode = (use_prefix and opts.prefix_vag and opts.line_search == "armijo"
                  and problem.line_prefix.vag_restrict_carry is not None)

    def make_va(s: _State, p, aux):
        """(B, value_along, vag_along, vag_carry_along) for direction p."""
        if use_prefix:
            lp = problem.line_prefix
            B = lp.direction(p, aux)
            va = lp.restrict(s.prefix, B, s.x, p, aux)
            vag = (lp.vag_restrict(s.prefix, B, s.x, p, aux)
                   if opts.prefix_vag and lp.vag_restrict is not None else None)
            vagc = lp.vag_restrict_carry(s.prefix, B, s.x, p, aux) if carry_mode else None
            return B, va, vag, vagc
        if problem.line_fun is not None:
            return None, problem.line_fun(s.x, p, aux), None, None
        return None, None, None, None

    def armijo(s: _State, p, aux):
        dg0 = torch.dot(s.g, p)
        # Steepest-descent fallback + history reset on a non-descent p
        # (reference: src/cuda/lbfgs.cuh:97-104), decided on the device.
        nondescent = dg0 >= 0
        p = torch.where(nondescent, -s.g, p)
        dg0 = torch.where(nondescent, -torch.dot(s.g, s.g), dg0)
        hist = ring_reset(s.hist, nondescent)

        one = torch.ones_like(s.gnorm)
        alpha0 = torch.minimum(one, 1.0 / s.gnorm) if s.k == 0 else one
        B, va, vag, vagc = make_va(s, p, aux)
        ls = armijo_quad_line_search(
            problem.value_and_grad, s.x, p, s.f, dg0, aux,
            c1=opts.c1, shrink=opts.ls_shrink, max_iters=opts.ls_max_iters,
            alpha0=alpha0,
            value=problem.fun if lean else None,
            value_along=va if lean else None,
            vag_along=vag if lean else None,
            vag_carry_along=vagc if lean else None,
        )
        # History reset on line-search failure (cuda/lbfgs.cuh:147).
        hist = ring_reset(hist, ~ls.ok)
        if lean:  # value-only trials + one value-and-gradient
            nf_add, ng_add = ls.n_trials + 1, 1
        else:     # each trial is a fused value-and-gradient
            nf_add, ng_add = ls.n_trials, ls.n_trials
        return _Step(p, hist, B, ls.alpha, ls.f_new, ls.g_new, nf_add, ng_add, ls.n_trials,
                     ls.carry)

    def wolfe(s: _State, p, aux):
        B, va, vag, _ = make_va(s, p, aux)
        if s.k == 0:
            # First-iteration heuristic step, no search
            # (reference: src/minimizer/lbfgs.hpp:61-65).
            alpha = torch.minimum(torch.ones_like(s.gnorm), 1.0 / s.gnorm)
            f_new, g_new = problem.value_and_grad(s.x + alpha * p, aux)
            return _Step(p, s.hist, B, alpha, f_new, g_new, 1, 1, 0)
        ls = wolfe_line_search(
            problem.value_and_grad, s.x, p, s.f, torch.dot(s.g, p), aux,
            c1=opts.c1, c2=opts.c2, shrink=opts.ls_shrink, max_iters=opts.ls_max_iters,
            alpha0=1.0,
            value=problem.fun if lean else None,
            value_along=va if lean else None,
            vag_along=vag if lean else None,
        )
        f_new, g_new = ls.f_new, ls.g_new
        if not ls.evaluated:  # re-evaluate at the search's last alpha
            f_new, g_new = problem.value_and_grad(s.x + ls.alpha * p, aux)
        if lean:  # jvp trials + one value-and-gradient (accepted or re-evaluated)
            nf_add, ng_add = ls.n_trials + 1, 1
        else:
            one_more = 0 if ls.evaluated else 1
            nf_add, ng_add = ls.n_trials + one_more, ls.n_trials + one_more
        return _Step(p, s.hist, B, ls.alpha, f_new, g_new, nf_add, ng_add, ls.n_trials)

    search = armijo if opts.line_search == "armijo" else wolfe

    def body(s: _State, aux) -> _State:
        p = -two_loop_fn(s.g, s.hist)
        p, hist, B, alpha, f_new, g_new, nf_add, ng_add, trials, carry = search(s, p, aux)

        x_new = s.x + alpha * p
        step = alpha * p
        y = g_new - s.g
        ys = torch.dot(y, step)
        if opts.curvature_rel_eps > 0.0:
            gate = opts.curvature_rel_eps * torch.linalg.norm(y) * torch.linalg.norm(step)
        else:
            gate = opts.curvature_eps
        accept = ys > gate
        rho = torch.where(accept, 1.0 / torch.where(ys == 0, torch.ones_like(ys), ys),
                          torch.zeros_like(ys))
        hist = ring_push(hist, step, y, rho, accept)

        gnorm_new = torch.linalg.norm(g_new)
        loss_h, gnorm_h = record(s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
        if carry_mode:
            prefix_new = carry
        elif use_prefix:  # the prefix is linear in w: P += alpha * B
            prefix_new = s.prefix + alpha * B
        else:
            prefix_new = s.prefix
        return _State(
            k=s.k + 1, x=x_new, f=f_new, g=g_new, gnorm=gnorm_new, hist=hist,
            loss_h=loss_h, gnorm_h=gnorm_h, nf=s.nf + nf_add, ng=s.ng + ng_add,
            prefix=prefix_new, syncs=s.syncs + trials,
        )

    return body


def lbfgs(
    problem: Problem,
    x0: torch.Tensor,
    aux: Any = (),
    opts: LBFGSOptions | None = None,
    mesh=None,
) -> SolveResult:
    """Run L-BFGS from ``x0`` on its device; ``aux`` lives there too."""
    opts = opts or LBFGSOptions()
    if mesh is not None:
        raise NotImplementedError("lbfgs(mesh=...) is not ported yet")
    body = _make_body(problem, opts)
    with full_f32(), torch.no_grad():
        aux = prepared_aux(problem, aux)
        s = _init_state(problem, opts, x0, aux)
        while _not_done(s, opts):
            s = body(s, aux)
    # One stop test per iteration, plus the final one when tol (not
    # max_iters) ended the solve.
    syncs = s.syncs + s.k + int(s.k < opts.max_iters)
    return finalize(s.x, s.k, s.gnorm < opts.tol, s.f, s.gnorm, s.loss_h, s.gnorm_h,
                    n_fevals=s.nf, n_gevals=s.ng, n_host_syncs=syncs)
