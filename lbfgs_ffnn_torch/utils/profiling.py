"""Profiling: a ``torch.profiler`` trace.

Counterpart of :mod:`lbfgs_ffnn_tpu.utils.profiling` (a ``jax.profiler``
trace). The reference's tracing is wall-clock timestamps per iteration
(std::chrono / cudaEvent); the deeper view here is a profiler trace of the
host's operators and, on a card, its kernels, written as a Chrome trace
(chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``with trace(dir): run()`` traces ``run()`` (the CPU's operators and,
    where a card is visible, its kernels) and writes the Chrome trace
    ``trace-<time>-<pid>.json`` into ``logdir`` (default: a directory
    under the temporary directory). Yields the directory."""
    logdir = Path(logdir) if logdir else Path(tempfile.gettempdir()) / "lbfgs_ffnn_torch_trace"
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield str(logdir)
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(logdir / f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"))
