"""Minibatch SGD.

Counterpart of :mod:`lbfgs_ffnn_tpu.solvers.sgd`, the union of the
reference's two SGDs:
  * ``sampling="random"`` (the reference CPU's StochasticGradientDescent):
    an epoch is ``m = N // b`` batches, each drawn without replacement,
    plain steps, the epoch loss the mean over the ``m*b`` samples visited
    (src/minimizer/s_gd.hpp:63-137,146-170);
  * ``sampling="sequential"`` (the reference's CudaSGD): ``N // b`` full
    contiguous batches, then the ragged tail once at its true shape, the
    epoch loss the batch-weighted mean over N (src/cuda/sgd.cuh:50-153);
and, in either, classical momentum, the step-wise lr decay (applied before
an epoch when ``epoch > 0`` and ``epoch % lr_decay_step == 0``), the
relative-improvement stop on the epoch loss (``tol > 0``), the per-epoch
record (the full-data loss and gradient norm, or with ``record_full=False``
the epoch loss and NaN) and an optional per-epoch ``metric_fn``.

The solve runs on the resident driver of
:mod:`lbfgs_ffnn_torch.solvers.common`, its state (:class:`_State`) in
device tensors and every decision on the device. An epoch is three bodies,
as S-LBFGS's is: the start (the lr decay), a segment of :data:`SEGMENT`
steps from the device step counter ``t0``, replayed ``m // SEGMENT`` times,
and the finish (the steps left over, the tail, the record, the metric and
the stop test). On CUDA tensors each body is captured once into a CUDA
graph and replayed, the host reading the epoch counter and the stop flag
once per chunk of epochs (:func:`sgd_chunked`); on CPU tensors the same
bodies run eagerly, their writes masked. A segment's batches are one index
table, its rows the steps' batches, taken by a gather (``index_select``)
of b rows of x and y per step: contiguous rows ``t*b + arange(b)`` in
sequential sampling (the device t makes them a gather where JAX's static
slice fuses into the GEMM's read), the sampler's draws in random sampling.
x may be uint8 (pixel-quantized, ``objectives.mlp.quantize_pixels``):
each step gathers b uint8 rows, and the record reads the uint8 x, a
quarter of f32's bytes; the objective upcasts them (JAX's u8 SGD rows).
The draws come from ``sampler`` (by default
:class:`~lbfgs_ffnn_torch.ops.sampling.SGDSampler`, keyed on the seed held
in the device state: one capture serves every seed); tests pass JAX's
indices in. JAX's ``scan_unroll`` has no counterpart: no epoch is a scan.

:func:`sgd_streaming` trains from a host-side
:class:`~lbfgs_ffnn_torch.runtime.streamer.BatchStreamer` instead, one
update per streamed batch.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from lbfgs_ffnn_torch.objectives.mlp import take_batch
from lbfgs_ffnn_torch.ops.control import assign, guard
from lbfgs_ffnn_torch.ops.sampling import SGDSampler, device_seed
from lbfgs_ffnn_torch.solvers.common import (
    Resident, cached_resident, data_key, drive_resident, finalize, full_f32, init_history,
    init_metric_history, record_at, record_row,
)
from lbfgs_ffnn_torch.types import BatchProblem, SolveResult


class SGDOptions(NamedTuple):
    """The JAX package's options with its names and defaults, but
    ``scan_unroll``, which has no counterpart."""

    epochs: int = 1000
    batch_size: int = 128
    step_size: float = 0.01
    momentum: float = 0.0
    sampling: str = "random"  # "random" (the reference CPU's) | "sequential" (its CUDA's)
    lr_decay: float = 1.0
    lr_decay_step: int = 0
    tol: float = 0.0          # > 0: the relative-improvement stop
    seed: int = 123
    record_full: bool = True  # per-epoch full-data loss and gradient norm
    sampler: str = "topk"     # random sampling's draw: "topk" | "sort" (the same indices)
    metric_fn: object = None  # (w, x, y, *metric_args) -> scalar or vector, per epoch


SEGMENT = 32  # steps per segment graph; a capture holds at most 2 * SEGMENT + 1 steps


class _State(NamedTuple):
    """JAX's solver state, every field a device tensor (``epoch`` int32,
    ``stop`` bool, the rest in the solver dtype), and the sampler's seed
    (int64), which the solve sets from its options."""

    epoch: torch.Tensor
    w: torch.Tensor
    v: torch.Tensor
    lr: torch.Tensor
    prev_loss: torch.Tensor
    stop: torch.Tensor
    loss_h: torch.Tensor
    gnorm_h: torch.Tensor
    metric_h: torch.Tensor
    seed: Any = None


def _check_options(opts: SGDOptions) -> None:
    if opts.sampling not in ("random", "sequential"):
        raise ValueError(f"unknown sampling {opts.sampling!r}")
    if opts.sampler not in ("topk", "sort"):
        raise ValueError(f"unknown sampler {opts.sampler!r}")
    if opts.epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {opts.epochs}")


def _sizes(opts: SGDOptions, N: int) -> tuple[int, int, int]:
    """(b, m, rem): the batch, the full batches per epoch and the
    sequential tail's rows, as JAX's _make_parts."""
    b = min(opts.batch_size, N)
    m = N // b if opts.sampling == "sequential" else max(N // b, 1)
    return b, m, (N - m * b if opts.sampling == "sequential" else 0)


def _init_state(opts: SGDOptions, w0, x, y, margs=()) -> _State:
    dev = w0.device
    loss_h, gnorm_h = init_history(opts.epochs, w0.dtype, dev)
    return _State(
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        w=w0.clone(), v=torch.zeros_like(w0),
        lr=torch.full((), opts.step_size, dtype=w0.dtype, device=dev),
        prev_loss=torch.full((), float("inf"), dtype=w0.dtype, device=dev),
        stop=torch.zeros((), dtype=torch.bool, device=dev),
        loss_h=loss_h, gnorm_h=gnorm_h,
        metric_h=init_metric_history(opts.metric_fn, opts.epochs, w0, x, y, *margs),
        seed=device_seed(opts.seed, dev),
    )


def _not_done(s: _State, opts: SGDOptions) -> torch.Tensor:
    return (s.epoch < opts.epochs) & ~s.stop


class _Scratch(NamedTuple):
    """What an epoch's bodies hand each other, in static buffers."""

    t0: torch.Tensor    # int64: the first step of the next segment
    wsum: torch.Tensor  # the epoch's batch-weighted loss sum so far


def _make_bodies(problem: BatchProblem, opts: SGDOptions, x, y, margs, sampler,
                 like: torch.Tensor) -> tuple[list, list]:
    """``(bodies, schedule)``: one epoch of JAX's ``body`` as the start, the
    segment (replayed) and the finish, each ``body(s, not_done)`` working on
    the device state ``s`` in place under the guard ``not_done``, which only
    the finish updates."""
    N = x.shape[0]
    b, m, rem = _sizes(opts, N)
    seg = min(SEGMENT, m)
    nseg, left = m // seg, m % seg
    dev = like.device
    sc = _Scratch(t0=torch.zeros((), dtype=torch.int64, device=dev),
                  wsum=torch.zeros((), dtype=like.dtype, device=dev))
    cols = torch.arange(b, device=dev)

    def batches(s: _State, t, count: int) -> torch.Tensor:
        if opts.sampling == "sequential":
            return (t + torch.arange(count, device=dev)).unsqueeze(1) * b + cols
        draw = sampler if sampler is not None else SGDSampler(s.seed, N, b, m, opts.sampler)
        idx = draw.batches(s.epoch, t, count)
        if idx.shape != (count, b):
            raise ValueError(f"the sampler's batches have shape {tuple(idx.shape)}, not "
                             f"({count}, {b})")
        return idx

    def update(s: _State, w, v, xb, yb):
        loss, g = problem.value_and_grad(w, xb, yb)
        if opts.momentum > 0.0:
            v = opts.momentum * v - s.lr * g
            return w + v, v, loss
        return w - s.lr * g, v, loss

    def steps(s: _State, not_done, t, count: int) -> None:
        """``count`` steps from step ``t``, their batch-weighted losses
        added to the epoch's sum."""
        w, v, losses = s.w, s.v, []
        for idx in batches(s, t, count):
            w, v, loss = update(s, w, v, *take_batch(x, y, idx))
            losses.append(loss)
        for dst, new in ((s.w, w), (s.v, v), (sc.wsum, sc.wsum + (torch.stack(losses) * b).sum())):
            assign(not_done, dst, new)

    def start(s: _State, not_done: torch.Tensor) -> None:
        sc.t0.zero_()
        sc.wsum.zero_()
        if opts.lr_decay_step > 0:
            with guard(not_done):
                # the step-wise decay before the epoch (src/cuda/sgd.cuh:97-99)
                decay = (s.epoch > 0) & (s.epoch % opts.lr_decay_step == 0)
                assign(not_done, s.lr, torch.where(decay, s.lr * opts.lr_decay, s.lr))

    def segment(s: _State, not_done: torch.Tensor) -> None:
        with guard(not_done):
            steps(s, not_done, sc.t0, seg)
            assign(not_done, sc.t0, sc.t0 + seg)

    def finish(s: _State, not_done: torch.Tensor) -> None:
        with guard(not_done):
            if left:
                steps(s, not_done, nseg * seg, left)
            w, v, wsum = s.w, s.v, sc.wsum
            if rem:  # the ragged tail, once, at its true shape: no mask, no padded copy
                w, v, loss = update(s, w, v, x[m * b:], y[m * b:])
                wsum = wsum + loss * rem
            epoch_loss = wsum / (N if opts.sampling == "sequential" else m * b)
            # the record (src/minimizer/s_gd.hpp:108-131, src/cuda/sgd.cuh:134-145)
            if opts.record_full:
                full_loss, full_g = problem.value_and_grad(w, x, y)
                gnorm = torch.linalg.norm(full_g)
            else:
                full_loss, gnorm = epoch_loss, torch.full_like(epoch_loss, float("nan"))
            record_at(not_done, s.loss_h, s.gnorm_h, s.epoch, full_loss, gnorm)
            if opts.metric_fn is not None:
                record_row(not_done, s.metric_h, s.epoch, opts.metric_fn(w, x, y, *margs))
            stop = s.stop
            if opts.tol > 0.0:  # relative improvement (src/cuda/sgd.cuh:126-131)
                denom = torch.maximum(torch.ones_like(epoch_loss), torch.abs(s.prev_loss))
                rel = torch.abs(s.prev_loss - epoch_loss) / denom
                stop = torch.isfinite(s.prev_loss) & (rel < opts.tol)
            epoch = s.epoch + 1
            for dst, new in ((s.w, w), (s.v, v), (s.prev_loss, epoch_loss), (s.stop, stop),
                             (s.epoch, epoch)):
                assign(not_done, dst, new)
            assign(not_done, not_done, (epoch < opts.epochs) & ~stop)

    return [start, segment, finish], [0] + [1] * nseg + [2]


RESIDENT_CHUNK = 10  # epochs between the host's reads when sgd() runs


def _counters(s: _State) -> tuple:
    return (s.epoch,)


def _solve(problem: BatchProblem, w0: Optional[torch.Tensor], x, y, opts: SGDOptions, *,
           chunk: int, capture: bool, sampler=None, callback=None, resume_state=None,
           epochs: Optional[int] = None, metric_args: tuple = ()):
    """The resident driver: ``chunk`` epochs per host read, captured
    (``capture``, CUDA only; the graphs cached per problem, options but the
    seed, shapes and data; chunk c+1 enqueued before the host reads chunk
    c) or run eagerly with masked writes, a chunk at a time. ``epochs``
    stops the host loop before ``opts.epochs`` (a warm-up that captures the
    full solve's epoch). Returns ``(result, time_ms)``."""
    _check_options(opts)
    if resume_state is None and w0 is None:
        raise ValueError("w0 is required unless resume_state is given")
    like = w0 if w0 is not None else resume_state.w
    if capture and not like.is_cuda:
        raise ValueError(f"a captured solve needs CUDA tensors, got {like.device}")
    margs = tuple(metric_args)
    with full_f32(), torch.no_grad():
        state = resume_state if resume_state is not None else _init_state(opts, w0, x, y, margs)
        state = state._replace(seed=device_seed(opts.seed, like.device))  # the seed is the run's

        def make():
            bodies, schedule = _make_bodies(problem, opts, x, y, margs, sampler, like)
            return Resident(bodies, _init_state(opts, like, x, y, margs),
                            lambda s: _not_done(s, opts), capture, schedule)

        r = make() if not capture else cached_resident(
            ("sgd", problem, opts._replace(seed=0), tuple(like.shape), like.dtype, like.device,
             data_key((x, y, margs)), sampler), make)
        r.load(state)
        known = (0, True) if resume_state is None else None
        (k, _), time_ms = drive_resident(r, chunk, opts.epochs if epochs is None else epochs,
                                         _counters, known, callback=callback,
                                         pipeline=capture and epochs is None)
        s = r.state
        last = max(k - 1, 0)
        res = finalize(s.w.clone(), k, s.stop.clone(), s.loss_h[last].clone(),
                       s.gnorm_h[last].clone(), s.loss_h.clone(), s.gnorm_h.clone(),
                       s.metric_h.clone() if opts.metric_fn is not None else None,
                       n_host_syncs=r.syncs)
    return res, time_ms


def sgd(
    problem: BatchProblem,
    w0: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    opts: SGDOptions | None = None,
    metric_args: tuple = (),
    sampler=None,
) -> SolveResult:
    """Run SGD from ``w0`` on its device (``x``, ``y`` and ``metric_args``
    there too): on CUDA tensors each epoch replayed from its captured CUDA
    graphs, :data:`RESIDENT_CHUNK` epochs per host read; on CPU tensors the
    same epoch run eagerly. ``sampler`` replaces random sampling's draws
    (the protocol of :class:`~lbfgs_ffnn_torch.ops.sampling.SGDSampler`)."""
    opts = opts or SGDOptions()
    return _solve(problem, w0, x, y, opts, chunk=RESIDENT_CHUNK, capture=w0.is_cuda,
                  sampler=sampler, metric_args=metric_args)[0]


def _sgd_resident_eager(problem: BatchProblem, w0: torch.Tensor, x, y,
                        opts: SGDOptions | None = None, chunk: int = RESIDENT_CHUNK,
                        sampler=None, metric_args: tuple = ()) -> SolveResult:
    """The epoch's bodies run eagerly (masked writes, nothing captured) on
    any device: what the captured solve is held against."""
    return _solve(problem, w0, x, y, opts or SGDOptions(), chunk=chunk, capture=False,
                  sampler=sampler, metric_args=metric_args)[0]


def sgd_chunked(
    problem: BatchProblem,
    w0: Optional[torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    opts: SGDOptions | None = None,
    chunk: int = 10,
    callback: Optional[Callable[[_State, float], None]] = None,
    resume_state: Optional[_State] = None,
    metric_args: tuple = (),
    sampler=None,
) -> tuple[SolveResult, Any]:
    """Run SGD in ``chunk``-epoch pieces: on CUDA the captured epoch
    replayed, on the CPU the same bodies run eagerly. Returns ``(result,
    time_ms)``, ``time_ms[e]`` the measured cumulative wall time after
    epoch ``e`` at chunk granularity (NaN before a resume).
    ``callback(state, elapsed_s)`` gets the live :class:`_State` after each
    chunk (static buffers: clone what you keep). ``resume_state`` continues
    from such a state (momentum, the decayed lr and the stop state
    included); ``w0`` may then be None."""
    opts = opts or SGDOptions()
    like = w0 if w0 is not None else (resume_state.w if resume_state is not None else None)
    return _solve(problem, w0, x, y, opts, chunk=chunk,
                  capture=like is not None and like.is_cuda, sampler=sampler,
                  callback=callback, resume_state=resume_state, metric_args=metric_args)


def sgd_warm_up(problem: BatchProblem, w0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                opts: SGDOptions | None = None, epochs: int = 2, metric_args: tuple = (),
                sampler=None) -> SolveResult:
    """``epochs`` epochs, from ``w0``, of the solve ``sgd`` runs with these
    arguments: on CUDA tensors its epoch captured here and cached (a later
    ``sgd`` with the same problem, options but the seed, shapes and data
    replays it), read by the host once at the end; on CPU tensors the eager
    epoch. The warm-up before a timed solve."""
    opts = opts or SGDOptions()
    if w0.is_cuda:
        return _solve(problem, w0, x, y, opts, chunk=max(epochs, 1), capture=True,
                      sampler=sampler, epochs=epochs, metric_args=metric_args)[0]
    return sgd(problem, w0, x, y, opts._replace(epochs=epochs), metric_args, sampler)


# ---------------------------------------------------------------------------
# Streaming driver: host-fed minibatches
# ---------------------------------------------------------------------------


def sgd_streaming(
    problem: BatchProblem,
    w0: torch.Tensor,
    streamer,
    opts: SGDOptions | None = None,
    full_eval_fn=None,
) -> SolveResult:
    """Minibatch SGD fed by a
    :class:`~lbfgs_ffnn_torch.runtime.streamer.BatchStreamer`: one update
    per streamed batch, through the problem's ``fun_masked`` (the rows past
    a batch's count masked), with momentum and the lr decay at epoch
    boundaries, which the streamer's epoch label marks. For data that does
    not live on the device whole; :func:`sgd` is the resident path. A
    streamer over uint8 x hands uint8 batches, read as :func:`sgd` reads
    a uint8 x.

    On a CUDA ``w0`` each batch goes to the card by a ``non_blocking`` copy
    from the streamer's pinned buffer on a copy stream of its own, which the
    update waits for through an event; the host waits for the copy (not for
    the update) before it takes the next batch, whose arrival releases the
    buffer to the streamer's producer.

    Stops after ``opts.epochs`` epochs of the stream. The loss history
    records the last batch's loss of each epoch and the gradient-norm
    history stays NaN, unless ``full_eval_fn(w) -> (loss, gnorm)`` gives
    each epoch's full-data values. JAX's ``steps_per_epoch``, which it does
    not read, has no counterpart."""
    opts = opts or SGDOptions()
    w = w0
    nan = torch.full((), float("nan"), dtype=w.dtype, device=w.device)
    if opts.epochs <= 0:
        zero_h = torch.zeros((0,), dtype=w.dtype, device=w.device)
        return SolveResult(x=w, n_iters=0, converged=torch.zeros((), dtype=torch.bool),
                           final_loss=nan, final_gnorm=nan.clone(), loss_history=zero_h,
                           gnorm_history=zero_h.clone())
    vag = torch.func.grad_and_value(problem.fun_masked)
    dev = w.device
    copy_stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def to_device(t):
        if copy_stream is None:
            return t.clone()
        with torch.cuda.stream(copy_stream):
            out = t.to(dev, non_blocking=True)
        out.record_stream(torch.cuda.current_stream(dev))
        return out

    b = streamer.batch_size
    cols = torch.arange(b, device=dev)
    with full_f32(), torch.no_grad():
        v = torch.zeros_like(w)
        lr = torch.full((), opts.step_size, dtype=w.dtype, device=dev)
        loss_h, gnorm_h = init_history(opts.epochs, w.dtype, dev)
        last_loss, cur_epoch, last_trained, copied = nan, 0, None, None
        while True:
            if copied is not None:
                copied.synchronize()  # the previous batch is on the card: its buffer may go
            xb, yb, count, epoch = streamer.next()
            if epoch != cur_epoch:
                if full_eval_fn is not None:
                    ef, eg = full_eval_fn(w)
                    loss_h[cur_epoch] = ef
                    gnorm_h[cur_epoch] = eg
                    last_loss = torch.as_tensor(ef, dtype=w.dtype, device=dev)
                else:
                    loss_h[cur_epoch] = last_loss
                cur_epoch = epoch
                if opts.lr_decay_step > 0 and epoch % opts.lr_decay_step == 0:
                    lr = lr * opts.lr_decay
                if epoch >= opts.epochs:
                    break
            xd, yd = to_device(xb), to_device(yb)
            if copy_stream is not None:
                copied = torch.cuda.Event()
                copied.record(copy_stream)
                torch.cuda.current_stream(dev).wait_event(copied)
            mask = (cols < count).to(w.dtype)
            g, last_loss = vag(w, xd, yd, mask)
            v = opts.momentum * v - lr * g
            w = w + v
            last_trained = (xd, yd, mask)
        if full_eval_fn is not None:
            gnorm = gnorm_h[opts.epochs - 1]
        else:
            gnorm = torch.linalg.norm(problem.grad_masked(w, *last_trained))
    return SolveResult(x=w, n_iters=opts.epochs, converged=torch.zeros((), dtype=torch.bool),
                       final_loss=last_loss, final_gnorm=gnorm, loss_history=loss_h,
                       gnorm_history=gnorm_h)
