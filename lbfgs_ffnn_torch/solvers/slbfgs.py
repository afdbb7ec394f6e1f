"""Stochastic L-BFGS (Moritz et al. 2016): SVRG variance-reduced gradients
with curvature pairs from Hessian-vector products at averaged iterates.

Counterpart of :mod:`lbfgs_ffnn_tpu.solvers.slbfgs` on one device (the
reference CPU flagship, src/minimizer/s_lbfgs.hpp:166-290):

  * Outer epoch: the full gradient ``mu = grad F(w~)`` at the anchor; stop
    when ``||mu|| < tol``.
  * Inner loop (``m_inner`` steps): a batch; ``v = g_S(w_t) - g_S(w~) + mu``
    (one batch for both gradients); the direction from the two-loop with
    the clamped gamma; a fixed step; the iterate pushed into a ring of the
    last ``L + 1`` iterates.
  * After every L-th step: the averaged iterate ``u``; ``s = u - u_prev``;
    ``y = H(u) s`` on a ``b_H`` batch; the pair pushed when ``|y.s|`` passes
    the curvature gate and a previous average exists.
  * Epoch end: the anchor moves to a random recent iterate, the newest
    excluded; the full loss and gradient norm are recorded.

The solve runs on the resident driver of
:mod:`lbfgs_ffnn_torch.solvers.common`, as the Armijo L-BFGS does: the
epoch is JAX's ``body`` with its state (:class:`_State`) in device tensors
and every decision on the device. ``not_done`` guards the epoch and the
``converged`` branch (JAX's ``lax.cond``) is a nested guard, both CUDA graph
IF nodes under capture (:mod:`lbfgs_ffnn_torch.ops.control`); the pair's
accept is a mask of ``ring_push``; the iterate ring's head and count, the
``has_u`` flag and the anchor pick are device tensors. On CUDA tensors the
epoch is captured once and replayed, the host reading the epoch counter and
the stop flag once per chunk of epochs; on CPU tensors the same bodies run
eagerly, their writes masked by :func:`~lbfgs_ffnn_torch.ops.control.assign`.

The schedule is static (``m_inner`` steps, a curvature pair after steps L,
2L, ..., nb*L), so the epoch is three graphs (:func:`_make_bodies`): the
start, with the prologue's steps and the first pair; the segment, L steps
and a pair from a device step counter, replayed ``nb - 1`` times; and the
finish, with the tail. A capture thus holds at most 3L + 1 steps, whatever
``m_inner`` (the Launcher's epoch at N = 60,000 has 468). The batches come
from the ``sampler`` (:class:`~lbfgs_ffnn_torch.ops.sampling.EpochSampler`
by default), a function of the device epoch tensor and the step, so each
replay draws its own batches; each graph draws its steps' batches at once,
never a whole epoch's ``(m_inner, N)`` keys. Tests pass JAX's indices in
through a sampler of their own.

``metric_fn(w, x, y, *metric_args)`` is recorded per epoch into
``metric_history`` by the finish graph, at the new anchor, as JAX's is; the
``metric_args`` (e.g. the held-out split) are operands the graph reads, not
constants captured into it. The sampler's seed is held in the device state
and set by each solve from ``opts.seed``, so one capture serves every seed.

``store=`` (a :class:`~lbfgs_ffnn_torch.data.outofcore.ChunkStore`, with
``x = y = None``) is the out-of-core run, JAX's ``_outofcore_ops``: the
anchor's full gradient and the recorded loss and gradient norm sum over the
store's chunks (:func:`~lbfgs_ffnn_torch.data.outofcore.chunked_mean_evals`),
and each minibatch is gathered from the host store by the card
(``store.fetch_rows``), from the same index streams as the in-memory run.

``mesh=`` is JAX's explicitly sharded mode (``_sharded_ops``): every rank
holds its rows, the state stays replicated (so the direction runs the same
kernel on every rank), and each full pass, batch gradient and HVP is
reduced over the mesh axis, captured with the rest of the epoch on the
card. ``sampling="global"`` draws the single-process run's batches (the
trajectory is the single-process one up to reduction order),
``"local"`` b / nd indices of each rank's own rows (:func:`_mesh_ops`).
JAX's ``scan_unroll`` has no counterpart here.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from lbfgs_ffnn_torch.objectives.mlp import take_batch
from lbfgs_ffnn_torch.ops.control import assign, guard
from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda, two_loop_pallas
from lbfgs_ffnn_torch.ops.sampling import EpochSampler, LocalEpochSampler, device_seed
from lbfgs_ffnn_torch.ops.two_loop import (
    PAIR_DTYPES, RingState, empty_history_state, ring_push, two_loop,
)
from lbfgs_ffnn_torch.ops.two_loop import two_loop_compact
from lbfgs_ffnn_torch.solvers.common import (
    Resident, cached_resident, data_key, drive_resident, finalize, full_f32, init_history,
    init_metric_history, record_at, record_row,
)
from lbfgs_ffnn_torch.types import BatchProblem, SolveResult
from lbfgs_ffnn_torch.utils import profiling as _prof


class SLBFGSOptions(NamedTuple):
    """The JAX package's options with its names and defaults, except
    ``two_loop_impl``: "cuda" (the default; the Hopper kernel the dispatch
    names on CUDA tensors, the plain loop on CPU tensors; it raises on a
    CUDA ring no kernel takes), "plain" or JAX's "xla" (the loop form
    everywhere), JAX's "pallas" (the kernel where the dispatch takes the
    ring, else the plain loop after a warning) or "compact", each with the
    clamped gamma. ``pair_dtype``: None or "float32" (the f32 ring),
    "bfloat16" or "float16" (the plain loop only)."""

    epochs: int = 1000          # outer iterations
    tol: float = 1e-4           # on the full gradient norm
    m_inner: int = 0            # inner steps per epoch; 0 -> N // batch_size
    history: int = 10           # M: curvature pairs kept
    L: int = 10                 # curvature update interval
    batch_size: int = 128       # b: gradient batch
    hvp_batch_size: int = 0     # b_H; 0 -> batch_size // 2
    step_size: float = 0.01
    hvp_mode: str = "exact"     # "exact" (jvp) | "fd" (the reference's central difference)
    fd_eps: float = 1e-4
    sampler: str = "topk"       # the default sampler's draw: "topk" | "sort" (same indices)
    seed: int = 123
    record_full: bool = True    # per-epoch full loss + gradient norm
    curvature_eps: float = 1e-10
    curvature_rel_eps: float = 0.0  # > 0: |y.s| > rel_eps * ||y|| * ||s|| gate
    two_loop_impl: str = "cuda"
    pair_dtype: str | None = None  # "bfloat16": the (S, Y) ring in bf16
    metric_fn: object = None
    sampling: str = "local"     # mesh mode only: "local" (each rank draws b / nd from its
                                # rows) | "global" (the single-process batches)


def _check_options(opts: SLBFGSOptions) -> None:
    choices = {"hvp_mode": (opts.hvp_mode, ("exact", "fd")),
               "sampler": (opts.sampler, ("topk", "sort")),
               "sampling": (opts.sampling, ("local", "global")),
               "two_loop_impl": (opts.two_loop_impl,
                                 ("cuda", "plain", "compact", "xla", "pallas"))}
    for name, (val, ported) in choices.items():
        if val not in ported:
            raise ValueError(f"unknown {name} {val!r}; expected one of {ported}")
    if opts.pair_dtype not in PAIR_DTYPES:
        raise ValueError(f"unknown pair_dtype {opts.pair_dtype!r}; expected one of "
                         f"{tuple(PAIR_DTYPES)}")
    if opts.L < 1 or opts.history < 1 or opts.epochs < 1:
        raise ValueError(f"need L, history and epochs >= 1, got {opts.L}, {opts.history}, "
                         f"{opts.epochs}")


def _sizes(opts: SLBFGSOptions, N: int) -> tuple[int, int, int]:
    """(b, m_inner, b_h) for a data set of N samples, as JAX's _make_parts."""
    b = min(opts.batch_size, N)
    m_inner = opts.m_inner if opts.m_inner > 0 else max(N // b, 1)
    b_h = opts.hvp_batch_size if opts.hvp_batch_size > 0 else max(b // 2, 1)
    return b, m_inner, min(b_h, N)


class _VecRing(NamedTuple):
    """Ring of recent iterates (the reference's w_history): ``buf`` is
    written in place, ``head`` and ``count`` are int64 device scalars."""

    buf: torch.Tensor   # (cap, n)
    head: torch.Tensor
    count: torch.Tensor


def _vr_start(buf: torch.Tensor, w: torch.Tensor) -> _VecRing:
    """The ring holding ``w`` alone (JAX: a push onto an empty ring)."""
    one = torch.ones((), dtype=torch.int64, device=buf.device)
    buf[0].copy_(w)
    return _VecRing(buf, one, one.clone())


def _vr_push(r: _VecRing, v: torch.Tensor) -> _VecRing:
    cap = r.buf.shape[0]
    r.buf.index_copy_(0, r.head.view(1), v.view(1, -1))
    return _VecRing(r.buf, (r.head + 1) % cap, torch.clamp(r.count + 1, max=cap))


def _vr_mean(r: _VecRing) -> torch.Tensor:
    cap = r.buf.shape[0]
    li = (torch.arange(cap, device=r.buf.device) - (r.head - r.count)) % cap
    mask = (li < r.count).to(r.buf.dtype)
    return (mask @ r.buf) / torch.clamp(r.count, min=1).to(r.buf.dtype)


def _vr_pick(r: _VecRing, li: torch.Tensor) -> torch.Tensor:
    cap = r.buf.shape[0]
    return r.buf.index_select(0, ((r.head - r.count + li) % cap).view(1))[0]


class _State(NamedTuple):
    """JAX's solver state (``lbfgs_ffnn_tpu.solvers.slbfgs._State``), every
    field a device tensor: ``epoch`` int32, ``has_u`` and ``stop`` bool, the
    rest in the solver dtype; and the sampler's seed (int64), which each
    solve sets from its options. The resident driver keeps one in static
    buffers that each epoch updates in place."""

    epoch: torch.Tensor
    w: torch.Tensor        # anchor w~
    hist: RingState        # curvature pairs, kept across epochs
    u_prev: torch.Tensor   # the last averaged iterate
    has_u: torch.Tensor
    stop: torch.Tensor
    gnorm: torch.Tensor    # ||mu|| of the most recent epoch
    loss_h: torch.Tensor
    gnorm_h: torch.Tensor
    metric_h: torch.Tensor
    seed: Any = None


def _init_state(opts: SLBFGSOptions, w0: torch.Tensor, x, y, margs=()) -> _State:
    dev = w0.device
    loss_h, gnorm_h = init_history(opts.epochs, w0.dtype, dev)
    return _State(
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        w=w0.clone(),
        hist=empty_history_state(opts.history, w0.shape[0], w0.dtype,
                                 pair_dtype=PAIR_DTYPES[opts.pair_dtype], device=dev),
        u_prev=torch.zeros_like(w0),
        has_u=torch.zeros((), dtype=torch.bool, device=dev),
        stop=torch.zeros((), dtype=torch.bool, device=dev),
        gnorm=torch.full((), float("inf"), dtype=w0.dtype, device=dev),
        loss_h=loss_h,
        gnorm_h=gnorm_h,
        metric_h=init_metric_history(opts.metric_fn, opts.epochs, w0, x, y, *margs),
        seed=device_seed(opts.seed, dev),
    )


def _not_done(s: _State, opts: SLBFGSOptions) -> torch.Tensor:
    return (s.epoch < opts.epochs) & ~s.stop


def _direction_fn(opts: SLBFGSOptions) -> Callable:
    return {"cuda": two_loop_cuda, "compact": two_loop_compact,
            "pallas": two_loop_pallas}.get(opts.two_loop_impl, two_loop)


def _plan(m_inner: int, L: int) -> tuple[int, int, int]:
    """JAX's static schedule of an epoch: ``nb`` pairs (after steps L, 2L,
    ..., nb*L), the prologue's last step ``p_end`` (the first pair's, or
    the epoch's last when there is none) and the ``tail`` steps after the
    last pair."""
    nb = (m_inner - 1) // L
    if nb == 0:
        return 0, m_inner - 1, 0
    return nb, L, m_inner - 1 - nb * L


class _Scratch(NamedTuple):
    """What an epoch's bodies hand each other, in static buffers made before
    capture (a tensor one graph allocates cannot be read by another)."""

    run: torch.Tensor    # bool: this epoch runs (not done, not converged)
    mu: torch.Tensor     # the anchor's full gradient
    wt: torch.Tensor     # the inner iterate
    buf: torch.Tensor    # the iterate ring's rows, (L + 1, n)
    head: torch.Tensor   # int64: the iterate ring's next slot
    count: torch.Tensor  # int64: its iterates
    t0: torch.Tensor     # int64: the step of the latest pair


def _make_bodies(problem: BatchProblem, opts: SLBFGSOptions, x: torch.Tensor,
                 y: torch.Tensor, margs: tuple, sampler, like: torch.Tensor,
                 store=None, mesh=None, axis: str = "data") -> tuple[list, list]:
    """``(bodies, schedule)``: one epoch of JAX's ``body`` as three kinds of
    ``body(s, not_done)`` on the device state ``s``, in place, run in the
    order ``schedule``: the start (the anchor's full gradient, the
    ``converged`` branch, the prologue's steps and the first pair), the
    segment (L steps and a pair, from the device step ``t0``; replayed
    ``nb - 1`` times) and the finish (the tail's steps, the anchor reset,
    the record). The start is guarded by ``not_done``, the rest by the
    epoch's ``run`` flag. Nothing in them reads a value back to the host.
    Each holds at most L + 1 steps, whatever ``m_inner``. ``sampler`` None
    draws from :class:`EpochSampler` on the state's seed. ``store`` (x and
    y None) sums the full passes over its chunks and gathers the batches from
    it, as JAX's ``_outofcore_ops``. ``mesh``: x and y are this rank's
    rows, and the passes and batches are :func:`_mesh_ops`'."""
    nd, rank = (1, 0) if mesh is None else _mesh_place(mesh, axis)
    N = store.n if store is not None else x.shape[0] * nd
    b, m_inner, b_h = _sizes(opts, N)
    nb, p_end, tail = _plan(m_inner, opts.L)
    direction = _direction_fn(opts)
    grad_pair = torch.func.vmap(problem.grad, in_dims=(0, None, None))
    dev, n = like.device, like.shape[0]
    i64 = functools.partial(torch.zeros, (), dtype=torch.int64, device=dev)
    sc = _Scratch(run=torch.zeros((), dtype=torch.bool, device=dev),
                  mu=torch.zeros_like(like), wt=torch.zeros_like(like),
                  buf=torch.zeros((opts.L + 1, n), dtype=like.dtype, device=dev),
                  head=i64(), count=i64(), t0=i64())

    # what a rank draws: the global batches, or under local sampling b / nd
    # of its own rows
    local = mesh is not None and opts.sampling == "local"
    b_d, bh_d = (max(b // nd, 1), max(b_h // nd, 1)) if local else (b, b_h)

    def draws(s: _State):
        if sampler is not None:
            return sampler
        if local:
            return LocalEpochSampler(s.seed, x.shape[0], b_d, bh_d, rank,
                                     opts.sampler)
        return EpochSampler(s.seed, N, b, b_h, opts.sampler)

    def batches(s: _State, t, count: int) -> torch.Tensor:
        # a graph's batches in one draw (its steps' keys together: at most
        # (L + 1) x N of them)
        idx = draws(s).batches(s.epoch, t, count)
        if idx.shape != (count, b_d):
            raise ValueError(f"the sampler's batches have shape {tuple(idx.shape)}, not "
                             f"({count}, {b_d})")
        return idx

    if store is not None:
        from lbfgs_ffnn_torch.data.outofcore import chunked_mean_evals

        full_loss, full_grad = chunked_mean_evals(problem, store)
        fetch = store.fetch_rows
    else:
        def full_grad(w):
            return problem.grad(w, x, y)

        def fetch(idx):
            return take_batch(x, y, idx)

    def batch_grads_at(w_t, w_anchor, idx):
        # One vmapped pass for both gradients on the shared batch, as JAX's
        # batch_grads_at.
        xb, yb = fetch(idx)
        g2 = grad_pair(torch.stack([w_t, w_anchor]), xb, yb)
        return g2[0], g2[1]

    def hvp(u, s_vec, idx):
        if idx.shape != (bh_d,):
            raise ValueError(f"the sampler's HVP batch has shape {tuple(idx.shape)}, "
                             f"not ({bh_d},)")
        xh, yh = fetch(idx)
        if opts.hvp_mode == "fd":
            return problem.fd_hvp(u, s_vec, xh, yh, eps=opts.fd_eps)
        return problem.hvp(u, s_vec, xh, yh)

    def full_vag(w):
        return problem.value_and_grad(w, x, y)

    metric = opts.metric_fn
    if mesh is not None:
        full_grad, full_vag, batch_grads_at, hvp, metric = _mesh_ops(
            problem, opts, x, y, b, b_h, mesh, axis, local)

    def step(s: _State, idx, wt, wr: _VecRing):
        # Variance-reduced gradient (s_lbfgs.hpp:225-228), the direction
        # with the clamped gamma and the fixed step.
        g_t, g_anchor = batch_grads_at(wt, s.w, idx)
        d = direction(g_t - g_anchor + sc.mu, s.hist, clamp_gamma=True)
        wt = wt - opts.step_size * d
        return wt, _vr_push(wr, wt)

    def pair_update(s: _State, t, wr: _VecRing, run):
        # The curvature pair from the averaged recent iterates
        # (s_lbfgs.hpp:231-247); `accept & has_u` masks the push before the
        # first average exists, and `run` where the epoch does not run.
        u = _vr_mean(wr)
        s_vec = u - s.u_prev
        yv = hvp(u, s_vec, draws(s).hvp_batch(s.epoch, t))
        ys = torch.dot(yv, s_vec)
        if opts.curvature_rel_eps > 0.0:
            gate = opts.curvature_rel_eps * torch.linalg.norm(yv) * torch.linalg.norm(s_vec)
        else:
            gate = opts.curvature_eps
        accept = (torch.abs(ys) > gate) & s.has_u
        rho = torch.where(accept, 1.0 / torch.where(ys == 0, torch.ones_like(ys), ys),
                          torch.zeros_like(ys))
        hist = ring_push(s.hist, s_vec, yv, rho, accept & run)  # rows in place
        for dst, new in ((s.hist.head, hist.head), (s.hist.count, hist.count),
                         (s.u_prev, u), (s.has_u, torch.ones_like(s.has_u))):
            assign(run, dst, new)

    def carry(run, wt, wr: _VecRing, t0=None) -> None:
        for dst, new in ((sc.wt, wt), (sc.head, wr.head), (sc.count, wr.count)):
            assign(run, dst, new)
        if t0 is not None:
            assign(run, sc.t0, t0)

    def start(s: _State, not_done: torch.Tensor) -> None:
        # unguarded: the segments' steps stay on the schedule in an epoch
        # that does not run (eagerly, its writes masked)
        sc.run.copy_(not_done)
        sc.t0.fill_(opts.L)
        with guard(not_done):
            # SVRG anchor: the full gradient at w~ (s_lbfgs.hpp:203-206).
            mu = full_grad(s.w)
            mu_norm = torch.linalg.norm(mu)
            converged = mu_norm < opts.tol
            for dst, new in ((sc.run, ~converged), (sc.mu, mu), (s.gnorm, mu_norm),
                             (s.stop, converged)):
                assign(not_done, dst, new)
            assign(not_done, not_done, ~converged)
            with guard(sc.run):
                wr = _vr_start(sc.buf, s.w)
                wt = s.w
                for idx in batches(s, 0, p_end + 1):
                    wt, wr = step(s, idx, wt, wr)
                if nb >= 1:
                    pair_update(s, opts.L, wr, sc.run)
                carry(sc.run, wt, wr)

    def segment(s: _State, not_done: torch.Tensor) -> None:
        with guard(sc.run):
            wt, wr = sc.wt, _VecRing(sc.buf, sc.head, sc.count)
            for idx in batches(s, sc.t0 + 1, opts.L):
                wt, wr = step(s, idx, wt, wr)
            t_pair = sc.t0 + opts.L
            pair_update(s, t_pair, wr, sc.run)
            carry(sc.run, wt, wr, t_pair)

    def finish(s: _State, not_done: torch.Tensor) -> None:
        with guard(sc.run):
            wt, wr = sc.wt, _VecRing(sc.buf, sc.head, sc.count)
            for idx in (batches(s, m_inner - tail, tail) if tail else ()):
                wt, wr = step(s, idx, wt, wr)
            # Anchor reset to a random recent iterate, the newest excluded
            # (s_lbfgs.hpp:265-270).
            j = draws(s).anchor(s.epoch, wr.count)
            w_new = torch.where(wr.count >= 2, _vr_pick(wr, j), wt)
            if opts.record_full:
                if store is not None:  # two chunk sweeps, as JAX's ops.full_loss and full_grad
                    f_new, g_new = full_loss(w_new), full_grad(w_new)
                else:
                    f_new, g_new = full_vag(w_new)
                record_at(sc.run, s.loss_h, s.gnorm_h, s.epoch, f_new, torch.linalg.norm(g_new))
            if metric is not None:
                record_row(sc.run, s.metric_h, s.epoch, metric(w_new, x, y, *margs))
            assign(sc.run, s.w, w_new)
            assign(sc.run, s.epoch, s.epoch + 1)
            assign(sc.run, not_done, _not_done(s, opts))

    if nb >= 2:
        return [start, segment, finish], [0] + [1] * (nb - 1) + [2]
    return [start, finish], [0, 1]


def _mesh_place(mesh, axis: str) -> tuple[int, int]:
    """(the axis's size, this rank's index along it); the parallel package
    is imported by mesh runs only."""
    from lbfgs_ffnn_torch.parallel.collectives import axis_index, axis_size

    return axis_size(mesh, axis), axis_index(mesh, axis)


def _mesh_ops(problem: BatchProblem, opts: SLBFGSOptions, x, y, b: int, b_h: int, mesh,
              axis: str, local: bool):
    """JAX's ``_sharded_ops`` for this rank's rows ``x``, ``y``: ``(full_grad,
    full_vag, batch_grads_at, hvp, metric)``.

    The full passes are the pmean of the local means (one all-reduce each,
    the value and gradient together). Under ``"local"`` sampling the batch
    indices are this rank's rows and every batch gradient and HVP is the
    pmean of the local ones. Under ``"global"`` they are the global draw of
    the single-process run: each rank takes the indices that land in its
    rows, masks the rest, and contributes its masked sum over the global
    batch size, so one psum gives the global batch mean; the regularizer
    is added once, after it. The two iterates' gradients share one
    all-reduce, as do the two points of a finite-difference HVP. The metric
    (e.g. an accuracy over equal shards) is the pmean of the local ones."""
    from lbfgs_ffnn_torch.parallel.collectives import psum
    from lbfgs_ffnn_torch.parallel.shard import data_parallel_batch_problem

    nd, r = _mesh_place(mesh, axis)
    n_local = x.shape[0]
    vmap = torch.func.vmap
    dp = data_parallel_batch_problem(problem, mesh, axis)

    def mean(t):
        return psum(t, mesh, axis) / nd

    def full_grad(w):
        return dp.grad(w, x, y)

    def full_vag(w):
        return dp.value_and_grad(w, x, y)

    metric = None
    if opts.metric_fn is not None:
        def metric(w, xs, ys, *margs):
            return mean(torch.as_tensor(opts.metric_fn(w, xs, ys, *margs), dtype=w.dtype,
                                        device=w.device))

    if local:
        grad_pair = vmap(problem.grad, in_dims=(0, None, None))

        def batch_grads_at(w_t, w_anchor, idx):
            xb, yb = take_batch(x, y, idx)
            g2 = mean(grad_pair(torch.stack([w_t, w_anchor]), xb, yb))
            return g2[0], g2[1]

        def hvp(u, s_vec, idx):
            xh, yh = take_batch(x, y, idx)
            if opts.hvp_mode == "fd":
                g2 = mean(grad_pair(torch.stack([u + opts.fd_eps * s_vec,
                                                 u - opts.fd_eps * s_vec]), xh, yh))
                return (g2[0] - g2[1]) / (2.0 * opts.fd_eps)
            return mean(problem.hvp(u, s_vec, xh, yh))

        return full_grad, full_vag, batch_grads_at, hvp, metric

    def masked_take(idx):
        pos = idx - r * n_local
        valid = (pos >= 0) & (pos < n_local)
        xb, yb = take_batch(x, y, torch.clamp(pos, 0, n_local - 1))
        return xb, yb, valid

    def local_loss(w, xb, yb, valid, size: int):
        ls = problem.per_sample(w, xb, yb)
        return torch.sum(torch.where(valid, ls, torch.zeros_like(ls))) / size

    local_grad = torch.func.grad(local_loss)
    local_pair = vmap(local_grad, in_dims=(0, None, None, None, None))
    reg_grad = torch.func.grad(problem.reg) if problem.reg is not None else None

    def with_reg(g, w):  # the regularizer counted once, after the psum
        return g + vmap(reg_grad)(w) if reg_grad is not None else g

    def batch_grads_at(w_t, w_anchor, idx):
        xb, yb, valid = masked_take(idx)
        w2 = torch.stack([w_t, w_anchor])
        g2 = with_reg(psum(local_pair(w2, xb, yb, valid, b), mesh, axis), w2)
        return g2[0], g2[1]

    def hvp(u, s_vec, idx):
        xh, yh, valid = masked_take(idx)
        if opts.hvp_mode == "fd":
            w2 = torch.stack([u + opts.fd_eps * s_vec, u - opts.fd_eps * s_vec])
            g2 = with_reg(psum(local_pair(w2, xh, yh, valid, b_h), mesh, axis), w2)
            return (g2[0] - g2[1]) / (2.0 * opts.fd_eps)
        h = psum(torch.func.jvp(lambda w: local_grad(w, xh, yh, valid, b_h), (u,), (s_vec,))[1],
                 mesh, axis)
        if reg_grad is not None:
            h = h + torch.func.jvp(reg_grad, (u,), (s_vec,))[1]
        return h

    return full_grad, full_vag, batch_grads_at, hvp, metric


def _check_mesh_rows(x: torch.Tensor, mesh, axis: str) -> None:
    """JAX's guard that the sample count divides the axis: every rank must
    hold the same number of rows (one all-reduce, before any capture)."""
    from lbfgs_ffnn_torch.parallel.collectives import psum

    nd = _mesh_place(mesh, axis)[0]
    total = int(psum(torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device), mesh,
                     axis))
    if total != x.shape[0] * nd:
        raise ValueError(f"N={total} must divide the mesh size {nd}")


RESIDENT_CHUNK = 10  # epochs between the host's reads when slbfgs() runs on the card


def _counters(s: _State) -> tuple:
    return (s.epoch,)


def _resident(problem, opts, w0, x, y, margs, sampler, capture: bool, store=None, mesh=None,
              axis: str = "data") -> Resident:
    def make():
        bodies, schedule = _make_bodies(problem, opts, x, y, margs, sampler, w0, store, mesh,
                                        axis)
        return Resident(bodies, _init_state(opts, w0, x, y, margs), lambda s: _not_done(s, opts),
                        capture, schedule)

    if not capture:
        return make()
    # the seed is not in the key: the graphs read it from the state
    return cached_resident(("slbfgs", problem, opts._replace(seed=0), tuple(w0.shape), w0.dtype,
                            w0.device, data_key((x, y, margs)), sampler, store, mesh, axis), make)


def _solve(problem: BatchProblem, w0: Optional[torch.Tensor], x, y, opts: SLBFGSOptions, *,
           chunk: int, capture: bool, sampler=None, callback=None, resume_state=None,
           epochs: Optional[int] = None, metric_args: tuple = (), store=None, mesh=None,
           axis: str = "data"):
    """The resident driver: ``chunk`` epochs per host read, captured
    (``capture``, CUDA only; chunk c+1 is enqueued before the host reads
    chunk c) or run eagerly with masked writes (one chunk at a time: on
    the CPU a chunk enqueued ahead would only run ahead). ``epochs`` stops
    the host loop before ``opts.epochs`` (a warm-up that captures the full
    solve's epoch). ``store``: the data in a ChunkStore (x = y = None).
    ``mesh``: x and y are this rank's rows of the ``axis`` shards. Returns
    ``(result, time_ms)``."""
    _check_options(opts)
    if resume_state is None and w0 is None:
        raise ValueError("w0 is required unless resume_state is given")
    like = w0 if w0 is not None else resume_state.w
    if capture and not like.is_cuda:
        raise ValueError(f"a captured solve needs CUDA tensors, got {like.device}")
    if store is not None and store.device != like.device:
        raise ValueError(f"the store serves {store.device}, the iterate is on {like.device}")
    margs = tuple(metric_args)
    if mesh is not None:
        _check_mesh_rows(x, mesh, axis)
    with _prof.solve(like.device) as trace, full_f32(), torch.no_grad():
        r = _resident(problem, opts, like, x, y, margs, sampler, capture, store, mesh, axis)
        state = (resume_state if resume_state is not None
                 else _init_state(opts, w0, x, y, margs))
        r.load(state._replace(seed=device_seed(opts.seed, like.device)))  # the seed is the run's
        known = (0, True) if resume_state is None else None
        # a warm-up that stops before opts.epochs must not run a chunk ahead
        (k, _), time_ms = drive_resident(r, chunk, opts.epochs if epochs is None else epochs,
                                         _counters, known, callback=callback,
                                         pipeline=capture and epochs is None)
        with _prof.hot("finalize") if _prof.ACTIVE else _prof.OFF:
            s = r.state
            res = finalize(s.w.clone(), k, s.stop.clone(), s.loss_h[max(k - 1, 0)].clone(),
                           s.gnorm.clone(), s.loss_h.clone(), s.gnorm_h.clone(),
                           s.metric_h.clone() if opts.metric_fn is not None else None,
                           n_host_syncs=r.syncs, trace=trace)
    return res, time_ms


def _check_store(store, x, y, mesh, opts: SLBFGSOptions) -> None:
    """JAX's guards of the out-of-core run: the data live in the store."""
    if x is not None or y is not None:
        raise ValueError("pass x=y=None with store= (data lives in the store)")
    if mesh is not None:
        raise ValueError("store= (out-of-core) and mesh= are mutually exclusive")
    if opts.metric_fn is not None:
        raise ValueError("metric_fn is unsupported with store= (no resident x/y to evaluate "
                         "it on)")


def slbfgs(
    problem: BatchProblem,
    w0: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    opts: SLBFGSOptions | None = None,
    mesh=None,
    axis_name: str = "data",
    metric_args: tuple = (),
    store=None,
    sampler=None,
) -> SolveResult:
    """Run S-LBFGS from ``w0`` on its device (``x``, ``y`` there too). On
    CUDA tensors each epoch is replayed from its captured CUDA graphs,
    :data:`RESIDENT_CHUNK` epochs per host read; on CPU tensors the same
    epoch runs eagerly. ``store``: the data in a
    :class:`~lbfgs_ffnn_torch.data.outofcore.ChunkStore` on w0's device,
    with ``x = y = None`` (the out-of-core run; ``mesh`` and ``metric_fn``
    are refused with it).
    ``sampler`` replaces the default index draws (see
    :class:`~lbfgs_ffnn_torch.ops.sampling.EpochSampler` for its protocol;
    under ``sampling="local"`` it draws this rank's rows).

    ``mesh``: the data-parallel run over its ``axis_name``; every rank
    passes its rows of ``x`` and ``y`` (:func:`~lbfgs_ffnn_torch.parallel.
    shard_batch`) and the same ``w0``; the state stays replicated (see
    :func:`_mesh_ops` for the two samplings)."""
    opts = opts or SLBFGSOptions()
    if store is not None:
        _check_store(store, x, y, mesh, opts)
    return _solve(problem, w0, x, y, opts, chunk=RESIDENT_CHUNK, capture=w0.is_cuda,
                  sampler=sampler, metric_args=metric_args, store=store, mesh=mesh,
                  axis=axis_name)[0]


def _slbfgs_resident_eager(problem: BatchProblem, w0: torch.Tensor, x, y,
                           opts: SLBFGSOptions | None = None, chunk: int = RESIDENT_CHUNK,
                           sampler=None, metric_args: tuple = (), store=None) -> SolveResult:
    """The epoch body run eagerly (masked writes, nothing captured) on any
    device: what the captured solve is held against."""
    return _solve(problem, w0, x, y, opts or SLBFGSOptions(), chunk=chunk, capture=False,
                  sampler=sampler, metric_args=metric_args, store=store)[0]


def slbfgs_chunked(
    problem: BatchProblem,
    w0: Optional[torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    opts: SLBFGSOptions | None = None,
    chunk: int = 10,
    callback: Optional[Callable[[_State, float], None]] = None,
    resume_state: Optional[_State] = None,
    mesh=None,
    axis_name: str = "data",
    metric_args: tuple = (),
    sampler=None,
) -> tuple[SolveResult, Any]:
    """Run S-LBFGS in ``chunk``-epoch pieces: on CUDA the captured epoch
    replayed, on the CPU the same body run eagerly.

    Returns ``(result, time_ms)``: ``time_ms[e]`` is the measured cumulative
    wall time (host clock, host numpy) after epoch ``e``, at chunk
    granularity, callback time excluded; NaN for epochs before a resume.
    ``callback(state, elapsed_s)`` runs after each chunk with the live
    :class:`_State` (static buffers: clone what you keep; on the card a
    chunk may already be enqueued past it, whose own ``epoch`` says how far
    it is). ``resume_state`` continues from such a state (or one from
    :func:`~lbfgs_ffnn_torch.objectives.mlp.slbfgs_state_from_numpy`) with
    the anchor, the curvature ring and the last average intact; ``w0`` may
    then be None. ``mesh`` as in :func:`slbfgs`.
    """
    opts = opts or SLBFGSOptions()
    like = w0 if w0 is not None else (resume_state.w if resume_state is not None else None)
    return _solve(problem, w0, x, y, opts, chunk=chunk,
                  capture=like is not None and like.is_cuda, sampler=sampler,
                  callback=callback, resume_state=resume_state, metric_args=metric_args,
                  mesh=mesh, axis=axis_name)


def slbfgs_warm_up(problem: BatchProblem, w0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   opts: SLBFGSOptions | None = None, epochs: int = 2,
                   metric_args: tuple = (), sampler=None, mesh=None,
                   axis_name: str = "data") -> SolveResult:
    """``epochs`` epochs, from ``w0``, of the solve ``slbfgs`` runs with
    these arguments: on CUDA tensors its epoch captured here and cached (a
    later ``slbfgs`` with the same problem, options but the seed, shapes and
    data replays it), read by the host once at the end; on CPU tensors the
    eager epoch. The warm-up before a timed solve."""
    opts = opts or SLBFGSOptions()
    if w0.is_cuda:
        return _solve(problem, w0, x, y, opts, chunk=max(epochs, 1), capture=True,
                      sampler=sampler, epochs=epochs, metric_args=metric_args, mesh=mesh,
                      axis=axis_name)[0]
    return slbfgs(problem, w0, x, y, opts._replace(epochs=epochs), metric_args=metric_args,
                  sampler=sampler, mesh=mesh, axis_name=axis_name)
