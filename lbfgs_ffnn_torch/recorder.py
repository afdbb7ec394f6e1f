"""Iteration history and CSV output.

Counterpart of :mod:`lbfgs_ffnn_tpu.recorder`: ``<name>_history.csv`` with
the columns ``Iteration,Loss,GradNorm,TimeMs`` strided by ``log_interval``
(reference: src/unified_optimization.hpp:66-85), numbers as ``%.17g``. The
(loss, gnorm) columns come from the solver's on-device history; TimeMs is
the measured whole-solve wall time spread uniformly over the iterations, so
the last row holds the whole solve's time (cumulative, like the reference's
column), unless the Launcher ran measured chunks (``timed_chunks``): then
each row holds the measured cumulative time of its chunk.

As in the JAX package, the native runtime (``runtime.cpp``'s
``csv_write_history``, ``%lld,%.17g,%.17g,%.17g``) writes a history
without ``extra`` columns, and the Python writer
(:func:`write_history_csv_plain`, the plain version the tests hold the
library against) writes one with them, or one the library could not write.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from lbfgs_ffnn_torch.runtime.native import get_lib
from lbfgs_ffnn_torch.types import SolveResult


@dataclasses.dataclass
class History:
    loss: np.ndarray     # (n,)
    gnorm: np.ndarray    # (n,)
    time_ms: np.ndarray  # (n,) cumulative

    @property
    def n(self) -> int:
        return int(self.loss.shape[0])


def history_from_result(result: SolveResult, total_time_s: float) -> History:
    """Trim the NaN padding and synthesize the cumulative-ms column."""
    n = int(result.n_iters)
    loss = result.loss_history[:n].detach().cpu().double().numpy()
    gnorm = result.gnorm_history[:n].detach().cpu().double().numpy()
    if n > 0:
        time_ms = np.linspace(total_time_s * 1e3 / n, total_time_s * 1e3, n)
    else:
        time_ms = np.zeros((0,))
    return History(loss=loss, gnorm=gnorm, time_ms=time_ms)


def write_history_csv(path, history: History, log_interval: int = 1,
                      extra: dict | None = None) -> None:
    """Write ``Iteration,Loss,GradNorm,TimeMs`` rows strided by
    ``log_interval``; nothing when ``log_interval <= 0`` or the history is
    empty. ``extra`` maps further column names (``TrainAcc``, ``TestAcc``:
    the reference's plot tooling shows accuracy panels where they exist) to
    per-iteration arrays, written after TimeMs in its order."""
    if log_interval <= 0 or history.n == 0:
        return
    if not extra:
        cols = [np.ascontiguousarray(c, dtype=np.float64)
                for c in (history.loss, history.gnorm, history.time_ms)]
        p = ctypes.POINTER(ctypes.c_double)
        rc = get_lib().csv_write_history(str(path).encode(), *(c.ctypes.data_as(p) for c in cols),
                                         history.n, int(log_interval))
        if rc == 0:
            return
    write_history_csv_plain(path, history, log_interval, extra)


def write_history_csv_plain(path, history: History, log_interval: int = 1,
                            extra: dict | None = None) -> None:
    """:func:`write_history_csv` in Python: ``%.17g`` numbers."""
    if log_interval <= 0 or history.n == 0:
        return
    cols = {k: np.asarray(v, dtype=np.float64) for k, v in (extra or {}).items()}
    with open(path, "w") as f:
        f.write("Iteration,Loss,GradNorm,TimeMs" + "".join(f",{k}" for k in cols) + "\n")
        for i in range(0, history.n, log_interval):
            f.write(f"{i},{history.loss[i]:.17g},{history.gnorm[i]:.17g},"
                    f"{history.time_ms[i]:.17g}"
                    + "".join(f",{c[i]:.17g}" for c in cols.values()) + "\n")


def read_history_csv(path) -> History:
    data = np.atleast_1d(np.genfromtxt(path, delimiter=",", names=True))
    return History(
        loss=np.asarray(data["Loss"], dtype=np.float64),
        gnorm=np.asarray(data["GradNorm"], dtype=np.float64),
        time_ms=np.asarray(data["TimeMs"], dtype=np.float64),
    )
