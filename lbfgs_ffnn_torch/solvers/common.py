"""Shared solver utilities: history recording, the result record and the
full-f32 guard. Counterpart of :mod:`lbfgs_ffnn_tpu.solvers.common`
(`drive_chunks` and the jit cache are not ported yet)."""

from __future__ import annotations

import contextlib

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
