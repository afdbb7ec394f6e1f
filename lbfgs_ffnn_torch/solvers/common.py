"""Shared solver utilities: history recording, the result record, the
full-f32 guard and the measured-chunk driver protocol. Counterpart of
:mod:`lbfgs_ffnn_tpu.solvers.common` (its jit cache has no counterpart:
eager PyTorch compiles nothing, and the captured iterations are cached by
the solver that captures them)."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from lbfgs_ffnn_torch.types import SolveResult


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
    idx = torch.clamp(k, max=loss_h.shape[0] - 1).long().view(1)
    for h, v in ((loss_h, loss), (gnorm_h, gnorm)):
        h.index_copy_(0, idx, torch.where(flag, v, h.index_select(0, idx).view(())).view(1))


def finalize(x, k, converged, loss, gnorm, loss_h, gnorm_h, metric_h=None,
             n_fevals=None, n_gevals=None, n_hevals=None, n_matvecs=None,
             n_host_syncs=None) -> SolveResult:
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
