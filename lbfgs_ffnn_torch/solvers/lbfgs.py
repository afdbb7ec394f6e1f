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

Two drivers, as in the JAX package:
  * **The resident driver** (``lbfgs`` on CUDA tensors, both searches, and
    :func:`lbfgs_chunked`). The iteration is JAX's ``_make_body`` with its
    state (:class:`_State`) in device tensors and every decision on the
    device: :func:`_make_resident_body` guards the whole iteration with
    ``not_done``, each of the Armijo search's trial slots with its own flag,
    the Wolfe branch's first step and search with ``k == 0`` and ``k > 0``,
    and runs the Wolfe trials in a device loop
    (:mod:`lbfgs_ffnn_torch.ops.control`). On CUDA one iteration is
    captured once into a CUDA graph (IF nodes for the guards, a WHILE node
    for the Wolfe trials) and replayed in chunks; the host reads the
    iteration counter and the stop flag once per chunk
    (:func:`~lbfgs_ffnn_torch.solvers.common.drive_chunks`), the PyTorch
    form of JAX's bounded ``while_loop`` chunks. On CPU tensors
    :func:`lbfgs_chunked` runs the same body eagerly, its writes masked (the
    Wolfe loop reads its flag on the host once per trial).
  * **The early-exit loop** (``lbfgs`` on CPU tensors): a host loop with two
    kinds of host sync, the line search's accept test once per trial and
    the stop test once per iteration.

``SolveResult.n_host_syncs`` counts the syncs of either driver. The solve
runs in full float32 on CUDA: TF32 matmuls are switched off for its
duration (:func:`~lbfgs_ffnn_torch.solvers.common.full_f32`).
``pair_dtype="bfloat16"`` stores the curvature ring in bf16 (half its bytes
and half the two-loop's history traffic); rho = 1/(y.s) comes from the
solver-dtype pair before the push narrows it, and the recursion runs in the
solver dtype.

``curvature_pairs="hvp"`` takes y = H(x_new) s by one Hessian-vector
product (``Problem.hvp``), on both branches, as in JAX.

The traffic options, on both drivers and both searches, as in JAX:
``prefix_dtype`` stores the carried line prefix narrow (its combines and
the accept axpy upcast to the solver dtype, then round to storage), and
``prefix_refresh`` (16 by default under ``prefix_dtype``) re-anchors it
from the fresh iterate every N iterations: on the resident driver an IF
node on ``(k + 1) % N == 0`` computed on the device, which also counts
the refreshes in the state (``n_refresh``); ``ls_alpha_init="warm"``
starts each search after the first at ``min(1, ls_alpha_growth *
alpha_prev)``, ``alpha_prev`` the previous step (on a failed search the
step the search returned: Armijo's last trial, Wolfe's re-evaluated one).

Not ported yet (each raises ``NotImplementedError``): the batched Armijo
search, the sharded two-loops, pair dtypes other than bfloat16, and
``mesh``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from lbfgs_ffnn_torch.ops.control import assign, guard
from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda
from lbfgs_ffnn_torch.ops.linesearch import (
    armijo_quad_line_search, armijo_quad_line_search_device, wolfe_line_search,
)
from lbfgs_ffnn_torch.ops.two_loop import (
    RingState, empty_history_state, ring_push, ring_reset, two_loop, two_loop_compact,
)
from lbfgs_ffnn_torch.solvers.common import (  # clear_graph_cache: re-exported
    Resident, cached_resident, clear_graph_cache, data_key, drive_resident,  # noqa: F401
    finalize, full_f32, init_history, lean_gate, prepared, record, record_at, tensors,
    wolfe_with_counters,
)
from lbfgs_ffnn_torch.types import Problem, SolveResult


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
    prefix_refresh: int | None = None  # None: 16 under prefix_dtype, else 0 (never)
    ls_alpha_init: str = "fixed"       # "fixed" (alpha0 = 1) | "warm"
    ls_alpha_growth: float = 8.0       # "warm": alpha0 = min(1, growth * alpha_prev)


def _check_options(opts: LBFGSOptions) -> None:
    choices = {
        "line_search": (opts.line_search, ("wolfe", "armijo"), ("armijo_batched",)),
        "curvature_pairs": (opts.curvature_pairs, ("grad_diff", "hvp"), ()),
        "ls_alpha_init": (opts.ls_alpha_init, ("fixed", "warm"), ()),
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
    _prefix_dtype(opts)
    if _prefix_refresh_n(opts) < 0:
        raise ValueError(f"prefix_refresh must be >= 0 or None, got {opts.prefix_refresh}")


_PAIR_DTYPES = {None: None, "bfloat16": torch.bfloat16}


def _prefix_dtype(opts: LBFGSOptions):
    """The carried prefix's storage dtype (None: the solver dtype)."""
    if opts.prefix_dtype is None:
        return None
    d = getattr(torch, str(opts.prefix_dtype), None)
    if not isinstance(d, torch.dtype) or not d.is_floating_point:
        raise ValueError(f"prefix_dtype must name a floating dtype, got {opts.prefix_dtype!r}")
    return d


def _prefix_cast(opts: LBFGSOptions):
    """The cast of a prefix to ``prefix_dtype`` (identity when unset),
    applied wherever a prefix is made: init, each direction's B, the
    Armijo carry, the accept axpy, a refresh, a resume."""
    d = _prefix_dtype(opts)
    return (lambda P: P) if d is None else (lambda P: P.to(d))


def _prefix_refresh_n(opts: LBFGSOptions) -> int:
    """Iterations between re-anchors of the carried prefix: JAX's default,
    16 under ``prefix_dtype``, else 0 (never)."""
    if opts.prefix_refresh is None:
        return 16 if opts.prefix_dtype is not None else 0
    return int(opts.prefix_refresh)


def _prefix_axpy(P, B, alpha):
    """``P + alpha*B`` in the solver dtype (``alpha``'s), rounded back to
    P's storage dtype: JAX's ``(a + alpha*b).astype(a.dtype)``."""
    return (P.to(alpha.dtype) + alpha * B.to(alpha.dtype)).to(P.dtype)


def _alpha0_later(opts: LBFGSOptions, alpha_prev, one):
    """The first trial step after iteration 0: 1, or under
    ``ls_alpha_init="warm"`` ``min(1, ls_alpha_growth * alpha_prev)``."""
    if opts.ls_alpha_init == "warm":
        return torch.minimum(one, alpha_prev * opts.ls_alpha_growth)
    return one


class _LoopState(NamedTuple):
    """The early-exit loop's state: counters on the host."""

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
    alpha_prev: torch.Tensor  # the previous iteration's step
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
    return lean_gate(problem, opts.ls_value_only) or (
        opts.ls_value_only is None and opts.line_search == "armijo")


def _use_prefix(problem: Problem, opts: LBFGSOptions) -> bool:
    return problem.line_prefix is not None and _lean(problem, opts)


def _init_loop_state(problem: Problem, opts: LBFGSOptions, x0, aux) -> _LoopState:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)
    return _LoopState(
        k=0, x=x0, f=f0, g=g0, gnorm=torch.linalg.norm(g0),
        hist=empty_history_state(opts.m, x0.shape[0], x0.dtype,
                                 pair_dtype=_PAIR_DTYPES[opts.pair_dtype], device=x0.device),
        loss_h=loss_h, gnorm_h=gnorm_h, nf=1, ng=1,
        alpha_prev=torch.ones((), dtype=x0.dtype, device=x0.device),
        prefix=(_prefix_cast(opts)(problem.line_prefix.init(x0, aux))
                if _use_prefix(problem, opts) else ()),
    )


def _loop_not_done(s: _LoopState, opts: LBFGSOptions) -> bool:
    """The stop test; reading gnorm is one host sync while k < max_iters."""
    return s.k < opts.max_iters and bool(s.gnorm >= opts.tol)


def _carry_mode(problem: Problem, opts: LBFGSOptions) -> bool:
    """The armijo accept evaluation already computes the post-step prefix
    (the MLP's z1 = A + alpha*B); carrying it replaces the prefix axpy.
    Wolfe keeps the axpy."""
    return (_use_prefix(problem, opts) and opts.prefix_vag and opts.line_search == "armijo"
            and problem.line_prefix.vag_restrict_carry is not None)


def _direction_fn(opts: LBFGSOptions):
    return {"cuda": two_loop_cuda, "compact": two_loop_compact}.get(opts.two_loop_impl, two_loop)


def _make_va(problem: Problem, opts: LBFGSOptions):
    """``make_va(x, prefix, p, aux) -> (B, value_along, vag_along,
    vag_carry_along)`` for direction p."""
    use_prefix = _use_prefix(problem, opts)
    carry_mode = _carry_mode(problem, opts)
    cast = _prefix_cast(opts)

    def make_va(x, prefix, p, aux):
        if use_prefix:
            lp = problem.line_prefix
            B = cast(lp.direction(p, aux))
            va = lp.restrict(prefix, B, x, p, aux)
            vag = (lp.vag_restrict(prefix, B, x, p, aux)
                   if opts.prefix_vag and lp.vag_restrict is not None else None)
            vagc = None
            if carry_mode:
                inner = lp.vag_restrict_carry(prefix, B, x, p, aux)

                def vagc(alpha):
                    f, g, P_new = inner(alpha)
                    return f, g, cast(P_new)
            return B, va, vag, vagc
        if problem.line_fun is not None:
            return None, problem.line_fun(x, p, aux), None, None
        return None, None, None, None

    return make_va


def _curvature_pair(problem: Problem, opts: LBFGSOptions, g, g_new, x_new, alpha, p, aux):
    """(step, y, rho, accept): the pair and JAX's curvature gate; y is the
    gradient difference, or under ``curvature_pairs="hvp"`` the exact
    ``H(x_new) step`` (one Hessian-vector product, counted as a gradient
    evaluation by the caller)."""
    step = alpha * p
    y = problem.hvp(x_new, step, aux) if opts.curvature_pairs == "hvp" else g_new - g
    ys = torch.dot(y, step)
    if opts.curvature_rel_eps > 0.0:
        gate = opts.curvature_rel_eps * torch.linalg.norm(y) * torch.linalg.norm(step)
    else:
        gate = opts.curvature_eps
    accept = ys > gate
    rho = torch.where(accept, 1.0 / torch.where(ys == 0, torch.ones_like(ys), ys),
                      torch.zeros_like(ys))
    return step, y, rho, accept


def _make_body(problem: Problem, opts: LBFGSOptions):
    """The early-exit loop's iteration."""
    _check_options(opts)
    two_loop_fn = _direction_fn(opts)
    lean = _lean(problem, opts)
    use_prefix = _use_prefix(problem, opts)
    carry_mode = _carry_mode(problem, opts)
    refresh_n = _prefix_refresh_n(opts)
    _make_va_xp = _make_va(problem, opts)

    def make_va(s: _LoopState, p, aux):
        return _make_va_xp(s.x, s.prefix, p, aux)

    def armijo(s: _LoopState, p, aux):
        dg0 = torch.dot(s.g, p)
        # Steepest-descent fallback + history reset on a non-descent p
        # (reference: src/cuda/lbfgs.cuh:97-104), decided on the device.
        nondescent = dg0 >= 0
        p = torch.where(nondescent, -s.g, p)
        dg0 = torch.where(nondescent, -torch.dot(s.g, s.g), dg0)
        hist = ring_reset(s.hist, nondescent)

        one = torch.ones_like(s.gnorm)
        alpha0 = (torch.minimum(one, 1.0 / s.gnorm) if s.k == 0
                  else _alpha0_later(opts, s.alpha_prev, one))
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

    def wolfe(s: _LoopState, p, aux):
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
            alpha0=_alpha0_later(opts, s.alpha_prev, torch.ones_like(s.gnorm)),
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

    def body(s: _LoopState, aux) -> _LoopState:
        p = -two_loop_fn(s.g, s.hist)
        p, hist, B, alpha, f_new, g_new, nf_add, ng_add, trials, carry = search(s, p, aux)

        x_new = s.x + alpha * p
        step, y, rho, accept = _curvature_pair(problem, opts, s.g, g_new, x_new, alpha, p, aux)
        if opts.curvature_pairs == "hvp":
            ng_add += 1
        hist = ring_push(hist, step, y, rho, accept)

        gnorm_new = torch.linalg.norm(g_new)
        loss_h, gnorm_h = record(s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
        if carry_mode:
            prefix_new = carry
        elif use_prefix:  # the prefix is linear in w: P += alpha * B
            prefix_new = _prefix_axpy(s.prefix, B, alpha)
        else:
            prefix_new = s.prefix
        if use_prefix and refresh_n > 0 and (s.k + 1) % refresh_n == 0:
            # re-anchor: the prefix recomputed from the fresh iterate
            prefix_new = _prefix_cast(opts)(problem.line_prefix.init(x_new, aux))
        return _LoopState(
            k=s.k + 1, x=x_new, f=f_new, g=g_new, gnorm=gnorm_new, hist=hist,
            loss_h=loss_h, gnorm_h=gnorm_h, nf=s.nf + nf_add, ng=s.ng + ng_add,
            alpha_prev=alpha, prefix=prefix_new, syncs=s.syncs + trials,
        )

    return body


# ---------------------------------------------------------------------------
# The resident driver: JAX's state and body on the device
# ---------------------------------------------------------------------------


class _State(NamedTuple):
    """JAX's solver state (``lbfgs_ffnn_tpu.solvers.lbfgs._State``), every
    field a device tensor: ``k``, ``nf`` and ``ng`` int32 scalars, the rest
    in the solver dtype. The resident driver keeps one in static buffers
    that each iteration updates in place."""

    k: torch.Tensor
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    gnorm: torch.Tensor
    hist: RingState
    loss_h: torch.Tensor
    gnorm_h: torch.Tensor
    nf: torch.Tensor  # objective (forward) evaluations
    ng: torch.Tensor  # full-gradient evaluations
    alpha_prev: torch.Tensor  # the previous iteration's step
    n_refresh: torch.Tensor  # int32: the prefix refreshes so far (not in JAX's state)
    prefix: Any = ()  # carried LinePrefix state (the MLP's A = x@W1 + b1)


def _init_state(problem: Problem, opts: LBFGSOptions, x0, aux) -> _State:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=x0.device)

    return _State(
        k=i32(0), x=x0.clone(), f=f0.clone(), g=g0.clone(), gnorm=torch.linalg.norm(g0),
        hist=empty_history_state(opts.m, x0.shape[0], x0.dtype,
                                 pair_dtype=_PAIR_DTYPES[opts.pair_dtype], device=x0.device),
        loss_h=loss_h, gnorm_h=gnorm_h, nf=i32(1), ng=i32(1),
        alpha_prev=torch.ones((), dtype=x0.dtype, device=x0.device), n_refresh=i32(0),
        prefix=(_prefix_cast(opts)(problem.line_prefix.init(x0, aux))
                if _use_prefix(problem, opts) else ()),
    )


def _not_done(s: _State, opts: LBFGSOptions) -> torch.Tensor:
    """The stop test as a device bool."""
    return (s.k < opts.max_iters) & (s.gnorm >= opts.tol)


def _make_resident_body(problem: Problem, opts: LBFGSOptions):
    """``body(s, not_done, aux)``: JAX's iteration on the device state ``s``,
    in place, guarded by the device bool ``not_done`` (which it updates).
    Nothing in it reads a value back to the host under capture: the guards
    are IF nodes and the Wolfe search's trial loop a WHILE node; run
    eagerly, every write is masked by its flag (and the trial loop reads
    its flag on the host once per trial)."""
    _check_options(opts)
    two_loop_fn = _direction_fn(opts)
    lean = _lean(problem, opts)
    use_prefix = _use_prefix(problem, opts)
    carry_mode = _carry_mode(problem, opts)
    refresh_n = _prefix_refresh_n(opts)
    make_va = _make_va(problem, opts)

    def armijo(s: _State, not_done, p, aux):
        dg0 = torch.dot(s.g, p)
        # Steepest-descent fallback + history reset on a non-descent p
        # (reference: src/cuda/lbfgs.cuh:97-104).
        nondescent = dg0 >= 0
        p = torch.where(nondescent, -s.g, p)
        dg0 = torch.where(nondescent, -torch.dot(s.g, s.g), dg0)
        hist = ring_reset(s.hist, nondescent)
        one = torch.ones_like(s.gnorm)
        alpha0 = torch.where(s.k == 0, torch.minimum(one, 1.0 / s.gnorm),
                             _alpha0_later(opts, s.alpha_prev, one))
        B, va, vag, vagc = make_va(s.x, s.prefix, p, aux)
        ls = armijo_quad_line_search_device(
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
        return _Step(p, hist, B, ls.alpha, ls.f_new, ls.g_new, nf_add, ng_add, 0, ls.carry)

    def wolfe(s: _State, not_done, p, aux):
        """JAX's ``lax.cond(s.k == 0, first, later)`` as two guards writing
        one set of buffers; ``later``'s ``lax.cond(ls.evaluated, use_ls,
        reeval)`` as a guard on ``~evaluated``. No non-descent fallback."""
        B, va, vag, _ = make_va(s.x, s.prefix, p, aux)
        alpha, f_new, g_new = s.gnorm.clone(), s.f.clone(), s.g.clone()
        nf_add, ng_add = s.nf.clone(), s.ng.clone()
        out = (alpha, f_new, g_new, nf_add, ng_add)
        first = not_done & (s.k == 0)
        with guard(first):
            # First-iteration heuristic step, no search
            # (reference: src/minimizer/lbfgs.hpp:61-65).
            a = torch.minimum(torch.ones_like(s.gnorm), 1.0 / s.gnorm)
            f, g = problem.value_and_grad(s.x + a * p, aux)
            one = torch.ones_like(s.k)
            for dst, new in zip(out, (a, f, g, one, one)):
                assign(first, dst, new)
        later = not_done & (s.k > 0)
        with guard(later):
            alpha0 = _alpha0_later(opts, s.alpha_prev, torch.ones_like(s.gnorm))
            ls, nf, ng = wolfe_with_counters(problem, opts, s.x, p, s.f, torch.dot(s.g, p), aux,
                                             lean, value_along=va, vag_along=vag, live=later,
                                             alpha0=alpha0)
            reeval = later & ~ls.evaluated
            with guard(reeval):  # re-evaluate at the search's last alpha
                f, g = problem.value_and_grad(s.x + ls.alpha * p, aux)
                assign(reeval, ls.f_new, f)
                assign(reeval, ls.g_new, g)
            for dst, new in zip(out, (ls.alpha, ls.f_new, ls.g_new, nf, ng)):
                assign(later, dst, new)
        return _Step(p, s.hist, B, alpha, f_new, g_new, nf_add, ng_add, 0)

    search = armijo if opts.line_search == "armijo" else wolfe

    def body(s: _State, not_done: torch.Tensor, aux) -> None:
        with guard(not_done):
            p = -two_loop_fn(s.g, s.hist)
            p, hist, B, alpha, f_new, g_new, nf_add, ng_add, _, carry = search(
                s, not_done, p, aux)
            x_new = s.x + alpha * p
            step, y, rho, accept = _curvature_pair(problem, opts, s.g, g_new, x_new, alpha, p,
                                                   aux)
            if opts.curvature_pairs == "hvp":
                ng_add = ng_add + 1
            hist = ring_push(hist, step, y, rho, accept & not_done)  # rows in place
            gnorm_new = torch.linalg.norm(g_new)
            record_at(not_done, s.loss_h, s.gnorm_h, s.k, f_new, gnorm_new)
            if carry_mode:
                prefix_new = carry
            elif use_prefix:  # the prefix is linear in w: P += alpha * B
                prefix_new = _prefix_axpy(s.prefix, B, alpha)
            else:
                prefix_new = s.prefix
            if use_prefix and refresh_n > 0:
                # re-anchor from the fresh iterate on (k + 1) % N == 0: an IF
                # node on a device bool, so the GEMM runs only then
                refresh = not_done & ((s.k + 1) % refresh_n == 0)
                with guard(refresh):
                    fresh = _prefix_cast(opts)(problem.line_prefix.init(x_new, aux))
                    for dst, new in zip(tensors(prefix_new), tensors(fresh), strict=True):
                        assign(refresh, dst, new)
                    assign(refresh, s.n_refresh, s.n_refresh + 1)
            k_new = s.k + 1
            not_done_new = (k_new < opts.max_iters) & (gnorm_new >= opts.tol)
            # every new value is computed; now the state moves
            for dst, new in ((s.x, x_new), (s.f, f_new), (s.g, g_new), (s.gnorm, gnorm_new),
                             (s.hist.head, hist.head), (s.hist.count, hist.count),
                             (s.nf, s.nf + nf_add), (s.ng, s.ng + ng_add),
                             (s.alpha_prev, alpha), (s.k, k_new)):
                assign(not_done, dst, new)
            if use_prefix:
                for dst, new in zip(tensors(s.prefix), tensors(prefix_new), strict=True):
                    assign(not_done, dst, new)
            assign(not_done, not_done, not_done_new)

    return body


RESIDENT_CHUNK = 10  # iterations between the host's reads when lbfgs() runs the resident driver


def _counters(s: _State) -> tuple:
    return s.k, s.nf, s.ng


def _resident(problem: Problem, opts: LBFGSOptions, x0: torch.Tensor, aux,
              capture: bool) -> Resident:
    """A captured iteration from the cache (keyed by the problem, the
    options, x0's shape and the data tensors' storage), else a new one; an
    uncaptured one is never cached."""
    body = _make_resident_body(problem, opts)

    def make():
        return Resident([lambda s, not_done: body(s, not_done, aux)],
                        _init_state(problem, opts, x0, aux),
                        lambda s: _not_done(s, opts), capture)

    if not capture:
        return make()
    return cached_resident(("lbfgs", problem, opts, tuple(x0.shape), x0.dtype, x0.device,
                            data_key(aux)), make)


def _solve_resident(problem: Problem, x0: Optional[torch.Tensor], aux, opts: LBFGSOptions, *,
                    chunk: int, capture: bool, callback=None, resume_state=None,
                    pipeline: bool = True, iters: Optional[int] = None):
    """The resident driver: ``chunk`` iterations per host read, captured
    (``capture``, CUDA only) or run eagerly with masked writes. ``iters``
    stops the host loop earlier than ``max_iters`` (a warm-up that captures
    the graph of the full solve). Returns ``(result, time_ms)``."""
    if resume_state is None and x0 is None:
        raise ValueError("x0 is required unless resume_state is given")
    like = x0 if x0 is not None else resume_state.x
    if capture and not like.is_cuda:
        raise ValueError(f"a captured solve needs CUDA tensors, got {like.device}")
    with full_f32(), torch.no_grad():
        aux = prepared(problem, aux)
        r = _resident(problem, opts, like, aux, capture)
        known = None
        if resume_state is None:
            r.load(_init_state(problem, opts, x0, aux))
            known = (0, 1, 1, True)
        else:
            r.load(resume_state)
            if _use_prefix(problem, opts):
                # a derived field: recomputed from the restored iterate, never trusted
                fresh = _prefix_cast(opts)(problem.line_prefix.init(r.state.x, aux))
                for dst, new in zip(tensors(r.state.prefix), tensors(fresh), strict=True):
                    dst.copy_(new)
        (k, nf, ng, _), time_ms = drive_resident(
            r, chunk, opts.max_iters if iters is None else iters, _counters, known,
            callback=callback, pipeline=pipeline)
        s = r.state
        res = finalize(s.x.clone(), k, s.gnorm < opts.tol, s.f.clone(), s.gnorm.clone(),
                       s.loss_h.clone(), s.gnorm_h.clone(), n_fevals=nf, n_gevals=ng,
                       n_host_syncs=r.syncs)
    return res, time_ms


def _lbfgs_resident_eager(problem: Problem, x0: torch.Tensor, aux: Any = (),
                          opts: LBFGSOptions | None = None,
                          chunk: int = RESIDENT_CHUNK) -> SolveResult:
    """The resident body run eagerly (masked writes, nothing captured) on
    any device: what the captured solve is held against."""
    return _solve_resident(problem, x0, aux, opts or LBFGSOptions(line_search="armijo"),
                           chunk=chunk, capture=False)[0]


def lbfgs(
    problem: Problem,
    x0: torch.Tensor,
    aux: Any = (),
    opts: LBFGSOptions | None = None,
    mesh=None,
) -> SolveResult:
    """Run L-BFGS from ``x0`` on its device; ``aux`` lives there too. CUDA
    tensors run the resident driver, under either search (the iteration
    replayed as a CUDA graph, :data:`RESIDENT_CHUNK` iterations per host
    read); CPU tensors run the early-exit loop."""
    opts = opts or LBFGSOptions()
    if mesh is not None:
        raise NotImplementedError("lbfgs(mesh=...) is not ported yet (ROADMAP queue 1 item 11)")
    if x0.is_cuda:
        return _solve_resident(problem, x0, aux, opts, chunk=RESIDENT_CHUNK, capture=True)[0]
    return _lbfgs_loop(problem, x0, aux, opts)


def _lbfgs_loop(problem: Problem, x0: torch.Tensor, aux: Any = (),
                opts: LBFGSOptions | None = None) -> SolveResult:
    """The early-exit loop on any device: what ``lbfgs`` runs on CPU
    tensors, and the reference the resident driver is held against on the
    card."""
    opts = opts or LBFGSOptions()
    body = _make_body(problem, opts)
    with full_f32(), torch.no_grad():
        aux = prepared(problem, aux)
        s = _init_loop_state(problem, opts, x0, aux)
        while _loop_not_done(s, opts):
            s = body(s, aux)
    # One stop test per iteration, plus the final one when tol (not
    # max_iters) ended the solve.
    syncs = s.syncs + s.k + int(s.k < opts.max_iters)
    return finalize(s.x, s.k, s.gnorm < opts.tol, s.f, s.gnorm, s.loss_h, s.gnorm_h,
                    n_fevals=s.nf, n_gevals=s.ng, n_host_syncs=syncs)


def lbfgs_warm_up(problem: Problem, x0: torch.Tensor, aux: Any = (),
                  opts: LBFGSOptions | None = None, iters: int = 2) -> SolveResult:
    """``iters`` iterations, from ``x0``, of the solve ``lbfgs`` runs with
    these arguments: on CUDA tensors its iteration captured here and cached
    (a later ``lbfgs`` with the same problem, options, shapes and ``aux``
    tensors replays it, from any start), read by the host once at the end;
    on CPU tensors the early-exit loop. The warm-up before a timed solve."""
    opts = opts or LBFGSOptions()
    if x0.is_cuda:
        return _solve_resident(problem, x0, aux, opts, chunk=max(iters, 1), capture=True,
                               pipeline=False, iters=iters)[0]
    return _lbfgs_loop(problem, x0, aux, opts._replace(max_iters=iters))


def lbfgs_chunked(
    problem: Problem,
    x0: Optional[torch.Tensor],
    aux: Any = (),
    opts: LBFGSOptions | None = None,
    chunk: int = 10,
    callback: Optional[Callable[[_State, float], None]] = None,
    resume_state: Optional[_State] = None,
    mesh=None,
):
    """Run L-BFGS (either search; ``line_search="armijo"`` when ``opts`` is
    None) in ``chunk``-iteration pieces on the resident driver: on CUDA the
    captured iteration replayed, on the CPU the same body run eagerly.

    Returns ``(result, time_ms)``: ``time_ms[i]`` is the measured cumulative
    wall time (host clock, host numpy) after iteration ``i``, at chunk
    granularity, callback time excluded; NaN for iterations before a
    resume. Chunk c+1 is enqueued before the host waits for chunk c's
    counter, so at most one speculative chunk runs past the stop, a no-op on
    the device. ``callback(state, elapsed_s)`` runs after each chunk with
    the live :class:`_State` (static buffers: clone what you keep; on the
    card its reads are ordered after the chunk already enqueued, whose own
    ``k`` says how far it is). ``resume_state`` continues from such a
    state; the carried prefix is recomputed from its iterate. ``x0`` may
    then be None.
    """
    opts = opts or LBFGSOptions(line_search="armijo")
    if mesh is not None:
        raise NotImplementedError("lbfgs_chunked(mesh=...) is not ported yet "
                                  "(ROADMAP queue 1 item 11)")
    like = x0 if x0 is not None else (resume_state.x if resume_state is not None else None)
    capture = like is not None and like.is_cuda
    return _solve_resident(problem, x0, aux, opts, chunk=chunk, capture=capture,
                           callback=callback, resume_state=resume_state)
