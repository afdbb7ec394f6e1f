"""Shared solver utilities: history recording, the result record, the
full-f32 guard, the Wolfe search with its evaluation counters, the
measured-chunk driver protocol and the resident driver every solver of the
port shares. Counterpart of
:mod:`lbfgs_ffnn_tpu.solvers.common`; its jit cache has no counterpart
(eager PyTorch compiles nothing), the cache of captured steps
(:func:`cached_resident`) stands in its place."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from lbfgs_ffnn_torch.ops.control import Graph, assign, capture, guard, host_reads
from lbfgs_ffnn_torch.ops.linesearch import wolfe_line_search_device
from lbfgs_ffnn_torch.types import SolveResult
from lbfgs_ffnn_torch.utils import profiling as _prof


def init_history(max_iters: int, dtype, device=None):
    return (
        torch.full((max_iters,), float("nan"), dtype=dtype, device=device),
        torch.full((max_iters,), float("nan"), dtype=dtype, device=device),
    )


def record(loss_h, gnorm_h, k: int, loss, gnorm):
    """Write one (loss, gnorm) row at iteration ``k`` in place, on the
    device (the mirror of the reference's IterationRecorder::record)."""
    loss_h[k] = loss
    gnorm_h[k] = gnorm
    return loss_h, gnorm_h


def record_at(flag, loss_h, gnorm_h, k, loss, gnorm) -> None:
    """Write one (loss, gnorm) row at the device index ``k`` in place where
    the device bool ``flag`` holds: no value reaches the host. ``k`` is
    clamped into the history, so a masked (eager) write at ``k ==
    max_iters`` stays in bounds and changes nothing."""
    record_row(flag, loss_h, k, loss)
    record_row(flag, gnorm_h, k, gnorm)


def record_row(flag, h, k, value) -> None:
    """``h[k] = value`` in place where the device bool ``flag`` holds, ``k``
    a device index clamped into ``h``; ``value`` has the shape of a row of
    ``h`` (a scalar for a history, a vector for a metric history)."""
    idx = torch.clamp(k, max=h.shape[0] - 1).long().view(1)
    row = torch.as_tensor(value, dtype=h.dtype, device=h.device).reshape((1,) + h.shape[1:])
    h.index_copy_(0, idx, torch.where(flag, row, h.index_select(0, idx)))


def init_metric_history(metric_fn, epochs: int, w0, x, y, *margs) -> torch.Tensor:
    """Per-epoch metric storage, NaN-filled: ``(epochs,)`` without a metric,
    else ``(epochs,) + shape`` with ``shape`` that of ``metric_fn(w, x, y,
    *margs)`` (a scalar, e.g. TrainAcc, or a vector, e.g. [TrainAcc,
    TestAcc]). JAX reads the shape abstractly; here the metric is evaluated
    once, at ``w0``, before any capture. ``margs`` are operands (e.g. the
    held-out split), never constants of a captured graph."""
    shape = () if metric_fn is None else tuple(metric_fn(w0, x, y, *margs).shape)
    return torch.full((epochs,) + shape, float("nan"), dtype=w0.dtype, device=w0.device)


def finalize(x, k, converged, loss, gnorm, loss_h, gnorm_h, metric_h=None,
             n_fevals=None, n_gevals=None, n_hevals=None, n_matvecs=None,
             n_host_syncs=None, trace=None) -> SolveResult:
    return SolveResult(
        x=x,
        n_iters=k,
        converged=converged,
        final_loss=loss,
        final_gnorm=gnorm,
        loss_history=loss_h,
        gnorm_history=gnorm_h,
        metric_history=metric_h,
        n_fevals=n_fevals,
        n_gevals=n_gevals,
        n_hevals=n_hevals,
        n_matvecs=n_matvecs,
        n_host_syncs=n_host_syncs,
        trace=trace,
    )


@contextlib.contextmanager
def full_f32():
    """Full-f32 matmuls (no TF32) for the duration of a solve: switches off
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` and restores the caller's settings."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lean_gate(problem, ls_value_only) -> bool:
    """Whether the Wolfe search takes loss-only trials (plus one
    value-and-gradient at the accepted point): ``ls_value_only`` when set,
    else wherever the problem carries a line restriction in either form."""
    if ls_value_only is not None:
        return ls_value_only
    return problem.line_fun is not None or problem.line_prefix is not None


def wolfe_with_counters(problem, opts, x, p, f0, dg0, aux, lean: bool, *, value_along=None,
                        vag_along=None, live=None, alpha0=1.0, dot=torch.dot):
    """The device-form Wolfe search (its trials one device loop) with the
    evaluation counters it adds, ``(ls, nf_add, ng_add)`` as int32 device
    scalars: a lean search counts its trials plus one value-and-gradient at
    the accepted point (or the caller's re-evaluation where none was
    accepted); a fused one counts every trial as a value-and-gradient, plus
    one more when it ran out of trials unevaluated. ``opts`` gives ``c1``,
    ``c2``, ``ls_shrink`` and ``ls_max_iters``; lean trials go through
    ``value_along`` (``alpha -> f(x + alpha p)``) when given, else a jvp of
    ``problem.fun``; ``live`` is the enclosing guard's flag; ``alpha0`` the
    first trial step (a float or a device scalar); ``dot`` the fused trials'
    slope product."""
    ls = wolfe_line_search_device(
        problem.value_and_grad, x, p, f0, dg0, aux,
        c1=opts.c1, c2=opts.c2, shrink=opts.ls_shrink, max_iters=opts.ls_max_iters,
        alpha0=alpha0,
        value=problem.fun if lean else None,
        value_along=value_along if lean else None,
        vag_along=vag_along if lean else None,
        live=live,
        dot=dot,
    )
    if lean:
        return ls, ls.n_trials + 1, torch.ones_like(ls.n_trials)
    nf = ls.n_trials + (~ls.evaluated).to(torch.int32)
    return ls, nf, nf


def wolfe_step(problem, opts, lean: bool, x, f, g, p, aux, live):
    """One Wolfe search along ``p`` from ``(x, f, g)`` inside the guard
    ``live``, as the JAX BFGS and Newton iterations take it: lean trials
    through ``problem.line_fun`` when it has one, the search's evaluation
    at the accepted step reused, and a fresh value-and-gradient at its last
    step (a guard) where it ended unevaluated. Returns ``(alpha, f_new,
    g_new, nf_add, ng_add)``, device tensors."""
    va = problem.line_fun(x, p, aux) if lean and problem.line_fun is not None else None
    ls, nf_add, ng_add = wolfe_with_counters(problem, opts, x, p, f, torch.dot(g, p), aux, lean,
                                             value_along=va, live=live)
    reeval = live & ~ls.evaluated
    with guard(reeval):
        f_re, g_re = problem.value_and_grad(x + ls.alpha * p, aux)
        assign(reeval, ls.f_new, f_re)
        assign(reeval, ls.g_new, g_re)
    return ls.alpha, ls.f_new, ls.g_new, nf_add, ng_add


def drive_chunks(run_chunk, state, args, total, counter, done, callback=None, pipeline=True):
    """The chunked-execution protocol of the JAX package's ``drive_chunks``:
    run chunks with one host sync per chunk, accumulating *measured*
    cumulative wall time into ``time_ms[counter_prev:counter_now]`` (a host
    numpy column, NaN for iterations before a resume).

    ``run_chunk(state, *args) -> state`` enqueues a chunk;
    ``counter(state) -> int`` (the iteration counter) waits for it, the
    chunk's host sync; ``done(state) -> bool`` is the solver's early stop,
    evaluated after ``counter``. Returns ``(state, time_ms)``.

    ``pipeline`` (default): chunk c+1 is enqueued before the host blocks on
    chunk c's counter, so the device never waits for the host at a
    boundary. The stop decision lags one chunk: at most one speculative
    chunk runs past the stop, and its result is discarded (the solver's
    guard makes it a no-op). Host time spent in ``callback(state,
    elapsed_s)`` and in the stop test is excluded from later windows.

    Unlike JAX's, no warm-up chunk runs here: there is nothing to compile,
    and a solver that captures a graph does so before it calls this.
    """
    time_ms = np.full((total,), np.nan)
    k_prev = counter(state)

    if not pipeline:
        elapsed = 0.0
        while True:
            t0 = time.perf_counter()
            state = run_chunk(state, *args)
            k_now = counter(state)  # host sync per chunk (that's the point)
            elapsed += time.perf_counter() - t0
            time_ms[k_prev:k_now] = elapsed * 1e3
            if callback is not None:
                callback(state, elapsed)
            if k_now == k_prev or k_now >= total or done(state):
                return state, time_ms
            k_prev = k_now

    t0 = time.perf_counter()
    cb_host = 0.0  # host time at boundaries (callbacks, the stop test), excluded
    cur = run_chunk(state, *args)
    while True:
        nxt = run_chunk(cur, *args)  # speculative: enqueued before the sync
        k_now = counter(cur)         # blocks until chunk c is done on the device
        elapsed = time.perf_counter() - t0 - cb_host
        time_ms[k_prev:k_now] = elapsed * 1e3
        th0 = time.perf_counter()
        if callback is not None:
            callback(cur, elapsed)
        stop = k_now == k_prev or k_now >= total or done(cur)
        cb_host += time.perf_counter() - th0
        if stop:
            return cur, time_ms
        k_prev = k_now
        cur = nxt


# ---------------------------------------------------------------------------
# The resident driver: a solver's state and step on the device
# ---------------------------------------------------------------------------


def tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of NamedTuples and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in tensors(item)]
    return []


def clone(tree):
    """A copy of a tree of NamedTuples and tuples with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [clone(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def copy_state(dst, src) -> None:
    """Copy every tensor of the tree ``src`` into ``dst``'s, in place."""
    for d, t in zip(tensors(dst), tensors(src), strict=True):
        d.copy_(t)


class Resident:
    """A solver's state in static device buffers, its step and, on CUDA,
    that step captured into CUDA graphs (:mod:`lbfgs_ffnn_torch.ops.control`).

    A step is ``bodies`` run in the order ``schedule`` (indices into
    ``bodies``; by default each body once, in order): each
    ``body(state, not_done)`` works in place, guarded by the device bool
    ``not_done``, which the step updates; ``not_done_of(state)`` computes
    that bool. Bodies hand each other values only through static buffers
    made before capture. Each capture (the span ``resident.capture``) first
    runs every body once eagerly on a copy of the state (the counter
    ``captures`` counts them: a launch count on the card sees those runs
    too), then once in a flat check capture, where a host sync in a body
    raises cleanly, then into the graph that :meth:`step` replays.
    ``syncs`` counts the host reads: one per chunk (:class:`Snapshot`),
    and, uncaptured, each read of a loop's flag
    (:func:`~lbfgs_ffnn_torch.ops.control.host_reads`). A recorded solve
    (:mod:`lbfgs_ffnn_torch.utils.profiling`) sees each replay of a body
    as the span ``replay:<the body's __name__>``.
    """

    def __init__(self, bodies, state, not_done_of: Callable, capture: bool, schedule=None):
        self.bodies = list(bodies)
        self.names = [getattr(b, "__name__", "body") for b in self.bodies]
        self.schedule = list(range(len(self.bodies)) if schedule is None else schedule)
        self.state = state
        self._not_done_of = not_done_of
        self.not_done = not_done_of(state)
        self.graphs = None
        self.syncs = 0
        if capture:
            self._capture()

    def _capture(self) -> None:
        with _prof.span("resident.capture"):
            # An eager run of the bodies on a copy of the state first, on a
            # side stream: cuBLAS, the allocator and the kernels' launch
            # configurations are set up before capture.
            with _prof.span("capture.eager"):
                warm, flag = clone(self.state), self.not_done.clone()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for body in self.bodies:
                        body(warm, flag)
                torch.cuda.current_stream().wait_stream(side)
            _prof.count("captures")
            # The capture mode ("global") raises on any host sync. A flat
            # capture first (no IF nodes, never replayed) is where a sync in
            # a body raises: inside an IF node's body it could not be unwound.
            with _prof.span("capture.check"):
                for body in self.bodies:
                    with capture(Graph(flat=True)):
                        body(warm, self.not_done.clone())
                del warm
            with _prof.span("capture.graph"):
                self.graphs = []
                for body in self.bodies:
                    self.graphs.append(Graph())
                    with capture(self.graphs[-1]):
                        body(self.state, self.not_done)
                torch.cuda.synchronize()

    def load(self, src) -> None:
        with _prof.hot("resident.load") if _prof.ACTIVE else _prof.OFF:
            copy_state(self.state, src)
            self.not_done.copy_(self._not_done_of(self.state))
            self.syncs = 0

    def step(self) -> None:
        t = _prof.current() if _prof.ACTIVE else None
        if t is not None:
            return self._step_recorded(t)
        if self.graphs is not None:
            for i in self.schedule:
                self.graphs[i].replay()
            return
        reads = host_reads()
        for i in self.schedule:
            self.bodies[i](self.state, self.not_done)
        self.syncs += host_reads() - reads  # an eager loop's flag reads

    def _step_recorded(self, t) -> None:
        """:meth:`step` in a recorded solve: a span per replay of a body,
        the device's end of each on the host clock."""
        for i in self.schedule:
            name = self.names[i]
            with t.open("replay:" + name):
                t.launch()
                if self.graphs is not None:
                    self.graphs[i].replay()
                else:
                    reads = host_reads()
                    self.bodies[i](self.state, self.not_done)
                    reads = host_reads() - reads
                    self.syncs += reads
                    t.counters["host_syncs"] += reads
                t.landed("replay:" + name, self.graphs is not None)
            t.counters["replays:" + name] += 1


class Snapshot:
    """The int32 scalars ``counters(state)`` and ``not_done`` copied to the
    host behind a chunk; the first read waits for them, the chunk's one host
    sync. ``values()`` is ``(*counters, not_done)``."""

    def __init__(self, r: Resident, counters: Callable, known: Optional[tuple] = None):
        self._r, self._values = r, known
        if known is not None:
            return
        packed = torch.stack([c.to(torch.int32) for c in counters(r.state)]
                             + [r.not_done.to(torch.int32)])
        if packed.is_cuda:
            self._host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = packed, None

    def values(self) -> tuple:
        if self._values is None:
            with _prof.hot("chunk.read") if _prof.ACTIVE else _prof.OFF:
                if self._event is not None:
                    self._event.synchronize()
                *counts, not_done = self._host.tolist()
            self._values = (*counts, bool(not_done))
            self._r.syncs += 1
            if _prof.ACTIVE:
                _prof.hot_count("host_syncs")
        return self._values


def drive_resident(r: Resident, chunk: int, total: int, counters: Callable,
                   known: Optional[tuple] = None, callback=None, pipeline: bool = True):
    """Run ``r`` in ``chunk``-step pieces through :func:`drive_chunks` until
    ``total`` steps or its stop, reading ``counters(state)`` (the first of
    them the step counter) and ``not_done`` once per chunk; ``known`` gives
    the starting values without a read. ``callback(state, elapsed_s)`` gets
    the live state. Returns ``(values, time_ms)``, ``values`` the last
    read."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")

    def run_chunk(_snap):
        with _prof.hot("chunk") if _prof.ACTIVE else _prof.OFF:
            for _ in range(chunk):
                r.step()
            return Snapshot(r, counters)

    cb = None
    if callback is not None:
        def cb(_snap, elapsed):
            callback(r.state, elapsed)

    last, time_ms = drive_chunks(
        run_chunk, Snapshot(r, counters, known), (), total,
        counter=lambda snap: snap.values()[0],
        done=lambda snap: not snap.values()[-1],
        callback=cb, pipeline=pipeline,
    )
    return last.values(), time_ms


def solve_resident(key: tuple, body: Callable, state, not_done_of: Callable, counters: Callable,
                   known: tuple, total: int, *, chunk: int, capture: bool):
    """One solve of a single-body iteration on the resident driver: the
    step cached under ``key`` and captured (``capture``, CUDA tensors only)
    or a fresh eager one, loaded with ``state`` and driven ``chunk``
    iterations per host read until ``total`` or its stop (chunk c + 1
    enqueued before the host reads chunk c when captured). ``known`` are the
    starting counters and ``not_done``. Returns ``(values, resident)``,
    ``values`` the last read of ``(*counters(state), not_done)``."""
    device = tensors(state)[0].device
    if capture and device.type != "cuda":
        raise ValueError(f"a captured solve needs CUDA tensors, got {device}")

    def make():
        return Resident([body], clone(state), not_done_of, capture)

    r = cached_resident(key, make) if capture else make()
    r.load(state)
    values, _ = drive_resident(r, chunk, total, counters, known, pipeline=capture)
    return values, r


RESIDENT_CACHE_SIZE = 8  # captured steps kept; each holds a memory pool
_GRAPHS: "collections.OrderedDict[tuple, Resident]" = collections.OrderedDict()


def data_key(aux) -> tuple:
    """What a captured step's cache key holds of its data: each tensor's
    storage address, shape, dtype and device (the graph reads them at fixed
    addresses)."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype, t.device) for t in tensors(aux))


def cached_resident(key: tuple, make: Callable[[], Resident]) -> Resident:
    """The captured step cached under ``key`` (which must pin everything the
    graph reads: problem, options, shapes and :func:`data_key`; the entry
    keeps the data alive), else ``make()``'s, cached."""
    if key in _GRAPHS:
        _prof.count("graph_cache.hit")
        _GRAPHS.move_to_end(key)
        return _GRAPHS[key]
    _prof.count("graph_cache.miss")
    while len(_GRAPHS) >= RESIDENT_CACHE_SIZE:
        _GRAPHS.popitem(last=False)
    _GRAPHS[key] = make()
    return _GRAPHS[key]


_PREPARED: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()


def prepared(problem, aux):
    """``problem.prepare(aux)`` (``aux`` itself when the problem has no
    ``prepare``), made once per problem and data and kept beside the
    captured steps: a second solve on the same tensors gets the same
    prepared ones (the same narrow copy at the same address), so its
    :func:`data_key` finds the captured step again instead of capturing
    anew. Keyed on the problem and the raw tensors' :func:`data_key` and
    version counters (an in-place change of the data makes a new copy);
    the entry holds the raw aux too, so its addresses are not reused while
    it stands."""
    if problem.prepare is None:
        return aux
    key = (problem, data_key(aux), tuple(t._version for t in tensors(aux)))
    if key in _PREPARED:
        _prof.count("prepared.hit")
        _PREPARED.move_to_end(key)
        return _PREPARED[key][1]
    _prof.count("prepared.miss")
    while len(_PREPARED) >= RESIDENT_CACHE_SIZE:
        _PREPARED.popitem(last=False)
    with _prof.span("prepare"):
        _PREPARED[key] = (aux, problem.prepare(aux))
    return _PREPARED[key][1]


def clear_graph_cache() -> None:
    """Drop every captured step (and the memory pools they hold) and every
    prepared copy of the data."""
    _GRAPHS.clear()
    _PREPARED.clear()
