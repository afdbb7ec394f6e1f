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

``mesh=`` (JAX's ``lbfgs(mesh=, shard_axis=)``) is the parameter-sharded
solve: the iterate, the gradient and the curvature ring are sharded over a
mesh axis, every inner product is reduced over it, and the objective is
averaged over the mesh's other axes (:func:`_sharded_env`). A data-parallel
solve needs no option: pass a problem from
:func:`lbfgs_ffnn_torch.parallel.data_parallel_problem` and this rank's
rows.

``line_search="armijo_batched"`` is JAX's speculative ladder
(:func:`~lbfgs_ffnn_torch.ops.linesearch.armijo_batched_line_search`,
``ls_spec_k`` candidates a round in one batched evaluation) on both
drivers: on the resident driver each round is a guarded slot
(:func:`~lbfgs_ffnn_torch.ops.linesearch.armijo_batched_line_search_device`),
and the carried prefix is used whenever the problem has one, lean trials or
not, as in JAX; its counters are JAX's (``trials + 1`` objective and one
gradient evaluation an iteration).

``pair_dtype`` takes JAX's values: None or "float32" (the solver's f32
ring), "bfloat16" and "float16" (the plain loop only: no kernel takes it).
``two_loop_impl`` takes JAX's "xla" (the loop form everywhere, the port's
"plain") and "pallas" (:func:`~lbfgs_ffnn_torch.ops.cuda_two_loop.two_loop_pallas`:
the kernel where the dispatch takes the ring, else the plain loop after a
warning once per ring shape); "cuda" stays strict and raises on a CUDA ring
no kernel takes.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from lbfgs_ffnn_torch.ops.control import assign, guard
from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda, two_loop_pallas
from lbfgs_ffnn_torch.ops.linesearch import (
    armijo_batched_line_search, armijo_batched_line_search_device, armijo_quad_line_search,
    armijo_quad_line_search_device, wolfe_line_search,
)
from lbfgs_ffnn_torch.ops.two_loop import (
    PAIR_DTYPES, GramRing, RingState, _pad_to, empty_history_state, ring_push, ring_reset,
    two_loop, two_loop_compact,
)
from lbfgs_ffnn_torch.solvers.common import (  # clear_graph_cache: re-exported
    Resident, cached_resident, clear_graph_cache, data_key, drive_resident,  # noqa: F401
    finalize, full_f32, init_history, lean_gate, prepared, record, record_at, tensors,
    wolfe_with_counters,
)
from lbfgs_ffnn_torch.types import Problem, SolveResult
from lbfgs_ffnn_torch.utils import profiling as _prof


class LBFGSOptions(NamedTuple):
    """The JAX package's options, with the same names and defaults except
    ``two_loop_impl``: "cuda" (the default; the Hopper kernel on CUDA
    tensors, the plain loop on CPU tensors; a CUDA ring no kernel takes
    raises), "plain" or JAX's "xla" (the torch loop everywhere, the
    kernel's reference), JAX's "pallas" (the kernel where the dispatch
    takes the ring, else the plain loop after a warning) or "compact"
    (JAX's single-device compact form in plain torch, everywhere)."""

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
    ls_spec_k: int = 4  # armijo_batched: candidates per batched evaluation
    prefix_vag: bool = True
    ls_value_only: bool | None = None
    pair_dtype: str | None = None
    prefix_dtype: str | None = None
    prefix_refresh: int | None = None  # None: 16 under prefix_dtype, else 0 (never)
    ls_alpha_init: str = "fixed"       # "fixed" (alpha0 = 1) | "warm"
    ls_alpha_growth: float = 8.0       # "warm": alpha0 = min(1, growth * alpha_prev)


def _check_options(opts: LBFGSOptions) -> None:
    choices = {
        "line_search": (opts.line_search, ("wolfe", "armijo", "armijo_batched")),
        "curvature_pairs": (opts.curvature_pairs, ("grad_diff", "hvp")),
        "ls_alpha_init": (opts.ls_alpha_init, ("fixed", "warm")),
        "two_loop_impl": (opts.two_loop_impl, ("plain", "cuda", "compact", "xla", "pallas")),
        "pair_dtype": (opts.pair_dtype, tuple(PAIR_DTYPES)),
    }
    for name, (val, known) in choices.items():
        if val not in known:
            raise ValueError(f"unknown {name} {val!r}")
    if opts.line_search == "armijo_batched" and opts.ls_spec_k < 1:
        raise ValueError(f"ls_spec_k must be >= 1, got {opts.ls_spec_k}")
    _prefix_dtype(opts)
    if _prefix_refresh_n(opts) < 0:
        raise ValueError(f"prefix_refresh must be >= 0 or None, got {opts.prefix_refresh}")


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
    trials: int           # the line search's host syncs
    carry: Any = ()       # armijo's accept-point prefix


def _lean(problem: Problem, opts: LBFGSOptions) -> bool:
    """Loss-only trials (Wolfe: loss and slope by one jvp) plus one
    value-and-gradient at the chosen point: ``ls_value_only`` when set,
    else on for armijo and wherever the problem has a line restriction."""
    return lean_gate(problem, opts.ls_value_only) or (
        opts.ls_value_only is None and opts.line_search == "armijo")


def _use_prefix(problem: Problem, opts: LBFGSOptions) -> bool:
    return problem.line_prefix is not None and (_lean(problem, opts)
                                                or opts.line_search == "armijo_batched")


def _init_loop_state(problem: Problem, opts: LBFGSOptions, x0, aux, ops) -> _LoopState:
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)
    return _LoopState(
        k=0, x=x0, f=f0, g=g0, gnorm=ops.norm(g0),
        hist=ops.empty(opts.m, x0.shape[0], x0.dtype, PAIR_DTYPES[opts.pair_dtype], x0.device),
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
    return (_use_prefix(problem, opts) and opts.prefix_vag
            and opts.line_search in ("armijo", "armijo_batched")
            and problem.line_prefix.vag_restrict_carry is not None)


def _direction_fn(opts: LBFGSOptions):
    return {"cuda": two_loop_cuda, "compact": two_loop_compact,
            "pallas": two_loop_pallas}.get(opts.two_loop_impl, two_loop)


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


def _curvature_pair(problem: Problem, opts: LBFGSOptions, g, g_new, x_new, alpha, p, aux,
                    dot=torch.dot, norm=torch.linalg.norm):
    """(step, y, rho, accept): the pair and JAX's curvature gate; y is the
    gradient difference, or under ``curvature_pairs="hvp"`` the exact
    ``H(x_new) step`` (one Hessian-vector product, counted as a gradient
    evaluation by the caller). ``dot`` and ``norm`` are the vector
    reductions (reduced over the mesh in the parameter-sharded solve)."""
    step = alpha * p
    y = problem.hvp(x_new, step, aux) if opts.curvature_pairs == "hvp" else g_new - g
    ys = dot(y, step)
    if opts.curvature_rel_eps > 0.0:
        gate = opts.curvature_rel_eps * norm(y) * norm(step)
    else:
        gate = opts.curvature_eps
    accept = ys > gate
    rho = torch.where(accept, 1.0 / torch.where(ys == 0, torch.ones_like(ys), ys),
                      torch.zeros_like(ys))
    return step, y, rho, accept


def _make_body(problem: Problem, opts: LBFGSOptions, ops: "_VecOps"):
    """The early-exit loop's iteration, with the vector operations ``ops``
    (:func:`_vec_ops`, or a parameter-sharded solve's)."""
    dot = ops.dot
    lean = _lean(problem, opts)
    use_prefix = _use_prefix(problem, opts)
    carry_mode = _carry_mode(problem, opts)
    refresh_n = _prefix_refresh_n(opts)
    _make_va_xp = _make_va(problem, opts)

    def make_va(s: _LoopState, p, aux):
        return _make_va_xp(s.x, s.prefix, p, aux)

    def armijo(s: _LoopState, p, aux):
        dg0 = dot(s.g, p)
        # Steepest-descent fallback + history reset on a non-descent p
        # (reference: src/cuda/lbfgs.cuh:97-104), decided on the device.
        nondescent = dg0 >= 0
        p = torch.where(nondescent, -s.g, p)
        dg0 = torch.where(nondescent, -dot(s.g, s.g), dg0)
        hist = ops.reset(s.hist, nondescent)

        one = torch.ones_like(s.gnorm)
        alpha0 = (torch.minimum(one, 1.0 / s.gnorm) if s.k == 0
                  else _alpha0_later(opts, s.alpha_prev, one))
        B, va, vag, vagc = make_va(s, p, aux)
        if batched:
            ls = armijo_batched_line_search(
                problem.value_and_grad, s.x, p, s.f, dg0, aux, value=problem.fun,
                c1=opts.c1, shrink=opts.ls_shrink, max_iters=opts.ls_max_iters,
                alpha0=alpha0, spec_k=opts.ls_spec_k, value_along=va, vag_along=vag,
                vag_carry_along=vagc)
        else:
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
        hist = ops.reset(hist, ~ls.ok)
        if lean or batched:  # value-only trials + one value-and-gradient
            nf_add, ng_add = ls.n_trials + 1, 1
        else:     # each trial is a fused value-and-gradient
            nf_add, ng_add = ls.n_trials, ls.n_trials
        # one host sync per trial, or per round of the ladder
        syncs = -(-ls.n_trials // opts.ls_spec_k) if batched else ls.n_trials
        return _Step(p, hist, B, ls.alpha, ls.f_new, ls.g_new, nf_add, ng_add, syncs,
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
            problem.value_and_grad, s.x, p, s.f, dot(s.g, p), aux,
            c1=opts.c1, c2=opts.c2, shrink=opts.ls_shrink, max_iters=opts.ls_max_iters,
            alpha0=_alpha0_later(opts, s.alpha_prev, torch.ones_like(s.gnorm)),
            value=problem.fun if lean else None,
            value_along=va if lean else None,
            vag_along=vag if lean else None,
            dot=dot,
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

    batched = opts.line_search == "armijo_batched"
    search = wolfe if opts.line_search == "wolfe" else armijo

    def body(s: _LoopState, aux) -> _LoopState:
        p = -ops.direction(s.g, s.hist)
        p, hist, B, alpha, f_new, g_new, nf_add, ng_add, trials, carry = search(s, p, aux)

        x_new = s.x + alpha * p
        step, y, rho, accept = _curvature_pair(problem, opts, s.g, g_new, x_new, alpha, p, aux,
                                               dot, ops.norm)
        if opts.curvature_pairs == "hvp":
            ng_add += 1
        hist = ops.push(hist, step, y, rho, accept)

        gnorm_new = ops.norm(g_new)
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


class _VecOps(NamedTuple):
    """What the resident iteration does with n-long vectors and the ring:
    the direction (``H_k g``, not negated), the ring's push, reset and
    empty constructor, the inner product and the norm. :func:`_vec_ops` is
    the single-device set; the parameter-sharded solve's
    (:func:`_sharded_env`) reduces each dot over the mesh and keeps a
    sharded ring, as JAX's ``_make_body(direction=, push=, reset=)``."""

    direction: Callable
    push: Callable
    reset: Callable
    empty: Callable  # (m, n, dtype, pair_dtype, device) -> ring, positionally
    dot: Callable = torch.dot
    norm: Callable = torch.linalg.norm


def _vec_ops(opts: LBFGSOptions) -> _VecOps:
    return _VecOps(direction=_direction_fn(opts), push=ring_push, reset=ring_reset,
                   empty=empty_history_state)


def _ring(hist) -> RingState:
    """The RingState of a ring or of a GramRing."""
    return hist.ring if isinstance(hist, GramRing) else hist


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


def _init_state(problem: Problem, opts: LBFGSOptions, x0, aux, ops: _VecOps | None = None) -> _State:
    ops = ops or _vec_ops(opts)
    f0, g0 = problem.value_and_grad(x0, aux)
    loss_h, gnorm_h = init_history(opts.max_iters, x0.dtype, x0.device)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=x0.device)

    return _State(
        k=i32(0), x=x0.clone(), f=f0.clone(), g=g0.clone(), gnorm=ops.norm(g0),
        hist=ops.empty(opts.m, x0.shape[0], x0.dtype, PAIR_DTYPES[opts.pair_dtype], x0.device),
        loss_h=loss_h, gnorm_h=gnorm_h, nf=i32(1), ng=i32(1),
        alpha_prev=torch.ones((), dtype=x0.dtype, device=x0.device), n_refresh=i32(0),
        prefix=(_prefix_cast(opts)(problem.line_prefix.init(x0, aux))
                if _use_prefix(problem, opts) else ()),
    )


def _not_done(s: _State, opts: LBFGSOptions) -> torch.Tensor:
    """The stop test as a device bool."""
    return (s.k < opts.max_iters) & (s.gnorm >= opts.tol)


def _make_resident_body(problem: Problem, opts: LBFGSOptions, ops: _VecOps | None = None):
    """``body(s, not_done, aux)``: JAX's iteration on the device state ``s``,
    in place, guarded by the device bool ``not_done`` (which it updates).
    Nothing in it reads a value back to the host under capture: the guards
    are IF nodes and the Wolfe search's trial loop a WHILE node; run
    eagerly, every write is masked by its flag (and the trial loop reads
    its flag on the host once per trial). ``ops``: the vector operations
    (:func:`_vec_ops` by default)."""
    if ops is None:  # a sharded solve's options were checked by _sharded_env
        _check_options(opts)
        ops = _vec_ops(opts)
    dot = ops.dot
    lean = _lean(problem, opts)
    use_prefix = _use_prefix(problem, opts)
    carry_mode = _carry_mode(problem, opts)
    refresh_n = _prefix_refresh_n(opts)
    make_va = _make_va(problem, opts)

    def armijo(s: _State, not_done, p, aux):
        dg0 = dot(s.g, p)
        # Steepest-descent fallback + history reset on a non-descent p
        # (reference: src/cuda/lbfgs.cuh:97-104).
        nondescent = dg0 >= 0
        p = torch.where(nondescent, -s.g, p)
        dg0 = torch.where(nondescent, -dot(s.g, s.g), dg0)
        hist = ops.reset(s.hist, nondescent)
        one = torch.ones_like(s.gnorm)
        alpha0 = torch.where(s.k == 0, torch.minimum(one, 1.0 / s.gnorm),
                             _alpha0_later(opts, s.alpha_prev, one))
        B, va, vag, vagc = make_va(s.x, s.prefix, p, aux)
        if batched:
            ls = armijo_batched_line_search_device(
                problem.value_and_grad, s.x, p, s.f, dg0, aux, value=problem.fun,
                c1=opts.c1, shrink=opts.ls_shrink, max_iters=opts.ls_max_iters,
                alpha0=alpha0, spec_k=opts.ls_spec_k, value_along=va, vag_along=vag,
                vag_carry_along=vagc)
        else:
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
        hist = ops.reset(hist, ~ls.ok)
        if lean or batched:  # value-only trials + one value-and-gradient
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
            ls, nf, ng = wolfe_with_counters(problem, opts, s.x, p, s.f, dot(s.g, p), aux,
                                             lean, value_along=va, vag_along=vag, live=later,
                                             alpha0=alpha0, dot=dot)
            reeval = later & ~ls.evaluated
            with guard(reeval):  # re-evaluate at the search's last alpha
                f, g = problem.value_and_grad(s.x + ls.alpha * p, aux)
                assign(reeval, ls.f_new, f)
                assign(reeval, ls.g_new, g)
            for dst, new in zip(out, (ls.alpha, ls.f_new, ls.g_new, nf, ng)):
                assign(later, dst, new)
        return _Step(p, s.hist, B, alpha, f_new, g_new, nf_add, ng_add, 0)

    batched = opts.line_search == "armijo_batched"
    search = wolfe if opts.line_search == "wolfe" else armijo

    def body(s: _State, not_done: torch.Tensor, aux) -> None:
        with guard(not_done):
            p = -ops.direction(s.g, s.hist)
            p, hist, B, alpha, f_new, g_new, nf_add, ng_add, _, carry = search(
                s, not_done, p, aux)
            x_new = s.x + alpha * p
            step, y, rho, accept = _curvature_pair(problem, opts, s.g, g_new, x_new, alpha, p,
                                                   aux, dot, ops.norm)
            if opts.curvature_pairs == "hvp":
                ng_add = ng_add + 1
            hist = ops.push(hist, step, y, rho, accept & not_done)  # rows in place
            gnorm_new = ops.norm(g_new)
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
            ring, ring_new = _ring(s.hist), _ring(hist)
            for dst, new in ((s.x, x_new), (s.f, f_new), (s.g, g_new), (s.gnorm, gnorm_new),
                             (ring.head, ring_new.head), (ring.count, ring_new.count),
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
              capture: bool, env: Optional["_ShardedEnv"] = None) -> Resident:
    """A captured iteration from the cache (keyed by the problem, the
    options, x0's shape, the data tensors' storage and, sharded, the mesh
    and its axis), else a new one; an uncaptured one is never cached.
    ``env``: the parameter-sharded solve's padded problem and vector ops."""
    pp, ops = (env.pp, env.ops) if env is not None else (problem, None)
    body = _make_resident_body(pp, opts, ops)

    def iteration(s, not_done):
        body(s, not_done, aux)

    def make():
        return Resident([iteration], _init_state(pp, opts, x0, aux, ops),
                        lambda s: _not_done(s, opts), capture)

    if not capture:
        return make()
    where = () if env is None else (env.mesh, env.axis, env.n)
    return cached_resident(("lbfgs", problem, opts, tuple(x0.shape), x0.dtype, x0.device,
                            data_key(aux)) + where, make)


def _solve_resident(problem: Problem, x0: Optional[torch.Tensor], aux, opts: LBFGSOptions, *,
                    chunk: int, capture: bool, callback=None, resume_state=None,
                    pipeline: bool = True, iters: Optional[int] = None,
                    env: Optional["_ShardedEnv"] = None):
    """The resident driver: ``chunk`` iterations per host read, captured
    (``capture``, CUDA only) or run eagerly with masked writes. ``iters``
    stops the host loop earlier than ``max_iters`` (a warm-up that captures
    the graph of the full solve). ``env``: the parameter-sharded solve (x0
    and resume_state are then this rank's slices; the result's x is the
    whole unpadded iterate). Returns ``(result, time_ms)``."""
    if resume_state is None and x0 is None:
        raise ValueError("x0 is required unless resume_state is given")
    like = x0 if x0 is not None else resume_state.x
    if capture and not like.is_cuda:
        raise ValueError(f"a captured solve needs CUDA tensors, got {like.device}")
    pp, ops = (env.pp, env.ops) if env is not None else (problem, None)
    with _prof.solve(like.device) as trace, full_f32(), torch.no_grad():
        aux = prepared(problem, aux)
        r = _resident(problem, opts, like, aux, capture, env)
        known = None
        if resume_state is None:
            r.load(_init_state(pp, opts, x0, aux, ops))
            known = (0, 1, 1, True)
        else:
            r.load(resume_state)
            if _use_prefix(pp, opts):
                # a derived field: recomputed from the restored iterate, never trusted
                fresh = _prefix_cast(opts)(pp.line_prefix.init(r.state.x, aux))
                for dst, new in zip(tensors(r.state.prefix), tensors(fresh), strict=True):
                    dst.copy_(new)
        (k, nf, ng, _), time_ms = drive_resident(
            r, chunk, opts.max_iters if iters is None else iters, _counters, known,
            callback=callback, pipeline=pipeline)
        with _prof.hot("finalize") if _prof.ACTIVE else _prof.OFF:
            s = r.state
            x = s.x.clone() if env is None else env.gather(s.x)[:env.n]
            res = finalize(x, k, s.gnorm < opts.tol, s.f.clone(), s.gnorm.clone(),
                           s.loss_h.clone(), s.gnorm_h.clone(), n_fevals=nf, n_gevals=ng,
                           n_host_syncs=r.syncs, trace=trace)
    return res, time_ms


# ---------------------------------------------------------------------------
# The parameter-sharded solve (JAX's _ShardedEnv / lbfgs(mesh=))
# ---------------------------------------------------------------------------


class _ShardedEnv(NamedTuple):
    """What the parameter-sharded drivers share (JAX's ``_ShardedEnv``): the
    padded problem on this rank's slices, the vector operations with their
    collectives, and the padding geometry. The solver runs in tile-padded
    parameter space (n rounded up to 1024, or 2048 under a 2-byte ring, as
    in JAX); this rank holds the ``ns`` columns from ``lo``."""

    pp: Problem
    ops: _VecOps
    mesh: Any
    axis: str
    n: int
    n_pad: int
    lo: int
    ns: int
    gather: Callable  # this rank's slice -> the whole padded vector

    def own(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's slice of an (unpadded or padded) whole vector."""
        return _pad_to(v, self.n_pad).narrow(0, self.lo, self.ns)


def _sharded_env(problem: Problem, opts: LBFGSOptions, mesh, axis: str, n: int) -> _ShardedEnv:
    """The parameter-sharded solve of ``problem`` (``n`` parameters) over the
    mesh axis ``axis``: every n-long vector (iterate, gradient, direction,
    the ring's rows) sharded in contiguous slices; scalars, ``rho``, the
    ring indices and the histories replicated.

    Each evaluation all-gathers the iterate over ``axis`` (and the line
    restriction the direction), evaluates the objective on this rank's data
    and, on a mesh with other axes, takes its pmean over them (the data
    axes: each rank passes its rows); the gradient comes back zero-padded
    and cut to this rank's slice. Every inner product is a local partial
    dot and one all-reduce over ``axis``. ``two_loop_impl`` "compact" is
    the Gram form (two all-reduces per direction), "pallas" is refused as
    in JAX (a single-device kernel), any other the loop form
    :func:`~lbfgs_ffnn_torch.ops.two_loop.two_loop_sharded`."""
    from lbfgs_ffnn_torch.ops.two_loop import (
        _round_up, gram_empty, gram_push, gram_reset, two_loop_sharded, two_loop_sharded_compact,
    )
    from lbfgs_ffnn_torch.parallel.collectives import (
        all_gather_1d, axis_index, axis_size, psum,
    )
    from lbfgs_ffnn_torch.types import LinePrefix

    if opts.two_loop_impl == "pallas":
        raise ValueError(
            "two_loop_impl='pallas' is a single-device kernel; the mesh mode uses the "
            "psum-reduced sharded recursion (two_loop_impl='xla') or the collective-lean "
            "Gram form (two_loop_impl='compact')")
    _check_options(opts._replace(two_loop_impl="plain"))
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"shard axis {axis!r} is not an axis of the mesh "
                         f"{mesh.mesh_dim_names}")
    nd = axis_size(mesh, axis)
    pd = PAIR_DTYPES[opts.pair_dtype]
    n_pad = _round_up(n, 2048 if (pd is not None and pd.itemsize < 4) else 1024)
    # the ring is sharded over its tile rows (n_pad / 128), so the row
    # count, not the padded length, must split evenly
    if (n_pad // 128) % nd:
        raise ValueError(f"tile-row count {n_pad // 128} (= padded params {n_pad} / 128) must "
                         f"be divisible by the mesh axis size {nd}")
    ns = n_pad // nd
    lo = axis_index(mesh, axis) * ns
    data_axes = [a for a in mesh.mesh_dim_names if a != axis]

    def gather(v):
        return all_gather_1d(v, mesh, axis)

    def full(v):  # the whole unpadded vector
        return gather(v)[:n]

    def own(g):
        return _pad_to(g, n_pad).narrow(0, lo, ns)

    def mean_f(f):
        for a in data_axes:
            f = psum(f, mesh, a) / axis_size(mesh, a)
        return f

    def mean_fg(f, g):  # value and this rank's gradient slice, one all-reduce per data axis
        g = own(g)
        for a in data_axes:
            packed = psum(torch.cat([f.reshape(1).to(g.dtype), g]), mesh, a) / axis_size(mesh, a)
            f, g = packed[0].to(f.dtype), packed[1:]
        return f, g

    def fun_pad(w, aux):
        return mean_f(problem.fun(full(w), aux))

    def vag_pad(w, aux):
        return mean_fg(*problem.value_and_grad(full(w), aux))

    def grad_pad(w, aux):
        return vag_pad(w, aux)[1]

    line_fun_pad = None
    if problem.line_fun is not None:
        def line_fun_pad(w, p, aux, _lf=problem.line_fun):
            inner = _lf(full(w), full(p), aux)
            return lambda alpha: mean_f(inner(alpha))

    lp_pad = None
    if problem.line_prefix is not None:
        lp = problem.line_prefix

        def restrict(P, B, w, p, aux, _r=lp.restrict):
            inner = _r(P, B, full(w), full(p), aux)
            return lambda alpha: mean_f(inner(alpha))

        vag_restrict = vag_carry = None
        if lp.vag_restrict is not None:
            def vag_restrict(P, B, w, p, aux, _v=lp.vag_restrict):
                inner = _v(P, B, full(w), full(p), aux)
                return lambda alpha: mean_fg(*inner(alpha))
        if lp.vag_restrict_carry is not None:
            def vag_carry(P, B, w, p, aux, _v=lp.vag_restrict_carry):
                inner = _v(P, B, full(w), full(p), aux)

                def call(alpha):
                    f, g, P_new = inner(alpha)
                    return (*mean_fg(f, g), P_new)

                return call
        lp_pad = LinePrefix(init=lambda w, aux: lp.init(full(w), aux),
                            direction=lambda p, aux: lp.direction(full(p), aux),
                            restrict=restrict, vag_restrict=vag_restrict,
                            vag_restrict_carry=vag_carry)

    pp = Problem(fun=fun_pad, grad=grad_pad, value_and_grad=vag_pad, line_fun=line_fun_pad,
                 line_prefix=lp_pad, prepare=problem.prepare)

    def dot(a, b):
        return psum(torch.dot(a, b), mesh, axis)

    def norm(v):
        return torch.sqrt(dot(v, v))

    if opts.two_loop_impl == "compact":
        ops = _VecOps(
            direction=lambda g, h: two_loop_sharded_compact(g, h, mesh, axis),
            push=lambda h, s, y, rho, accept: gram_push(h, s, y, rho, accept, mesh, axis),
            reset=gram_reset, empty=gram_empty, dot=dot, norm=norm)
    else:
        ops = _VecOps(direction=lambda g, h: two_loop_sharded(g, h, mesh, axis),
                      push=ring_push, reset=ring_reset, empty=empty_history_state, dot=dot,
                      norm=norm)
    return _ShardedEnv(pp=pp, ops=ops, mesh=mesh, axis=axis, n=n, n_pad=n_pad, lo=lo, ns=ns,
                       gather=gather)


def _shard_state(state: _State, env: _ShardedEnv) -> _State:
    """A layout-free state (the whole padded iterate, gradient and ring
    rows, as :func:`lbfgs_ffnn_torch.checkpoint.gather_sharded` saves it)
    cut to this rank's slices on ``env``'s mesh."""
    if state.x.shape[0] != env.n_pad:
        raise ValueError(f"the state's iterate has {state.x.shape[0]} entries, not the padded "
                         f"{env.n_pad} of n_params={env.n} (a layout-free mesh state is "
                         "tile-padded)")

    def cols(t):
        return t.narrow(t.dim() - 1, env.lo, env.ns).contiguous()

    def ring(h):
        return h._replace(S=cols(h.S), Y=cols(h.Y))

    hist = (state.hist._replace(ring=ring(state.hist.ring)) if isinstance(state.hist, GramRing)
            else ring(state.hist))
    return state._replace(x=cols(state.x), g=cols(state.g), hist=hist)


def _solve_sharded(problem: Problem, x0, aux, opts: LBFGSOptions, mesh, shard_axis: str, *,
                   n_params: Optional[int] = None, resume_state=None, loop: bool = False,
                   **driver):
    """The parameter-sharded solve on the resident driver (``driver``:
    :func:`_solve_resident`'s chunking and capture arguments), or with
    ``loop`` the early-exit loop; ``x0`` is the whole iterate (every rank
    passes the same), ``resume_state`` a layout-free state."""
    if x0 is not None:
        n = int(x0.shape[0])
    elif n_params is not None:
        n = int(n_params)
    else:
        raise ValueError("mesh-mode resume needs n_params (resume_state.x is tile-padded; the "
                         "unpadded count cannot be inferred)")
    env = _sharded_env(problem, opts, mesh, shard_axis, n)
    x0l = env.own(x0).contiguous() if x0 is not None else None
    if loop:
        return _lbfgs_loop(problem, x0l, aux, opts, env), None
    rs = _shard_state(resume_state, env) if resume_state is not None else None
    return _solve_resident(problem, x0l, aux, opts, resume_state=rs, env=env, **driver)


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
    shard_axis: str = "model",
) -> SolveResult:
    """Run L-BFGS from ``x0`` on its device; ``aux`` lives there too. CUDA
    tensors run the resident driver, under either search (the iteration
    replayed as a CUDA graph, :data:`RESIDENT_CHUNK` iterations per host
    read); CPU tensors run the early-exit loop.

    With ``mesh`` (a :func:`~lbfgs_ffnn_torch.parallel.make_mesh` mesh,
    every rank calling with the same ``x0``) the solver state is
    parameter-sharded over ``mesh``'s ``shard_axis`` (:func:`_sharded_env`),
    as the solve without it: the resident driver on CUDA tensors, the
    early-exit loop on CPU tensors; the result's ``x`` is the whole iterate
    on every rank. The trajectory is the single-device one up to the
    rounding of the reduced inner products."""
    opts = opts or LBFGSOptions()
    if mesh is not None:
        if not x0.is_cuda:
            return _solve_sharded(problem, x0, aux, opts, mesh, shard_axis, loop=True)[0]
        return _solve_sharded(problem, x0, aux, opts, mesh, shard_axis, chunk=RESIDENT_CHUNK,
                              capture=True)[0]
    if x0.is_cuda:
        return _solve_resident(problem, x0, aux, opts, chunk=RESIDENT_CHUNK, capture=True)[0]
    return _lbfgs_loop(problem, x0, aux, opts)


def _lbfgs_loop(problem: Problem, x0: torch.Tensor, aux: Any = (),
                opts: LBFGSOptions | None = None,
                env: Optional["_ShardedEnv"] = None) -> SolveResult:
    """The early-exit loop on any device: what ``lbfgs`` runs on CPU
    tensors, and the reference the resident driver is held against on the
    card. ``env``: the parameter-sharded solve (x0 is this rank's slice;
    the result's x is the whole unpadded iterate)."""
    opts = opts or LBFGSOptions()
    if env is None:
        _check_options(opts)
    pp, ops = (env.pp, env.ops) if env is not None else (problem, _vec_ops(opts))
    body = _make_body(pp, opts, ops)
    with _prof.solve(x0.device) as trace:
        with full_f32(), torch.no_grad():
            aux = prepared(problem, aux)
            s = _init_loop_state(pp, opts, x0, aux, ops)
            while _loop_not_done(s, opts):
                s = body(s, aux)
        # One stop test per iteration, plus the final one when tol (not
        # max_iters) ended the solve.
        syncs = s.syncs + s.k + int(s.k < opts.max_iters)
        x = s.x if env is None else env.gather(s.x)[:env.n]
        return finalize(x, s.k, s.gnorm < opts.tol, s.f, s.gnorm, s.loss_h, s.gnorm_h,
                        n_fevals=s.nf, n_gevals=s.ng, n_host_syncs=syncs, trace=trace)


def lbfgs_warm_up(problem: Problem, x0: torch.Tensor, aux: Any = (),
                  opts: LBFGSOptions | None = None, iters: int = 2, mesh=None,
                  shard_axis: str = "model") -> SolveResult:
    """``iters`` iterations, from ``x0``, of the solve ``lbfgs`` runs with
    these arguments: on CUDA tensors its iteration captured here and cached
    (a later ``lbfgs`` with the same problem, options, shapes and ``aux``
    tensors replays it, from any start), read by the host once at the end;
    on CPU tensors the early-exit loop. The warm-up before a timed solve.
    ``mesh``: the parameter-sharded solve's, as :func:`lbfgs`'s."""
    opts = opts or LBFGSOptions()
    if mesh is not None:
        if not x0.is_cuda:
            return _solve_sharded(problem, x0, aux, opts._replace(max_iters=iters), mesh,
                                  shard_axis, loop=True)[0]
        return _solve_sharded(problem, x0, aux, opts, mesh, shard_axis, chunk=max(iters, 1),
                              capture=True, pipeline=False, iters=iters)[0]
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
    shard_axis: str = "model",
    n_params: Optional[int] = None,
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

    ``mesh`` runs :func:`lbfgs`'s parameter-sharded solve in measured
    chunks; the callback then sees this rank's slices. Its ``resume_state``
    is layout-free (the tile-padded whole iterate and ring rows, as
    :func:`lbfgs_ffnn_torch.checkpoint.save_checkpoint` with ``mesh=`` saves
    them), cut to this rank's slices on the current mesh, a fresh one
    included; without ``x0`` it needs ``n_params``, the unpadded count.
    """
    opts = opts or LBFGSOptions(line_search="armijo")
    like = x0 if x0 is not None else (resume_state.x if resume_state is not None else None)
    capture = like is not None and like.is_cuda
    if mesh is not None:
        return _solve_sharded(problem, x0, aux, opts, mesh, shard_axis, n_params=n_params,
                              resume_state=resume_state, chunk=chunk, capture=capture,
                              callback=callback)
    return _solve_resident(problem, x0, aux, opts, chunk=chunk, capture=capture,
                           callback=callback, resume_state=resume_state)
