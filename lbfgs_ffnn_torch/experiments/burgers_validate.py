"""Quantitative PINN-vs-FD-oracle validation of a Burgers run: the port's
copy of the JAX package's ``scripts/burgers_validate.py``.

Reads a ``burgers_test_extrapolation.csv`` (the reference's x,t,u,type
format, written by :mod:`lbfgs_ffnn_torch.experiments.run_burgers`), solves
the same PDE with the fine-grid finite-difference oracle
(:mod:`lbfgs_ffnn_torch.experiments.burgers_fd`), and prints mean/max
|u_PINN - u_FD| at the interpolation snapshots t = 0, 0.5, 1.0.

The gate: mean |u - u_FD| <= 0.02 at every snapshot.

Usage: python -m lbfgs_ffnn_torch.experiments.burgers_validate burgers_test_extrapolation.csv
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from lbfgs_ffnn_torch.experiments.burgers_fd import solve_burgers_fd

SNAPSHOTS = (0.0, 0.5, 1.0)
MEAN_TOL = 0.02


def errors(csv_path: str) -> dict[float, np.ndarray]:
    """|u_PINN - u_FD| at the CSV's interpolation rows (type 0) of each
    snapshot time, the oracle interpolated to the CSV's x."""
    rows = np.genfromtxt(csv_path, delimiter=",", names=True)
    x_fd, snaps = solve_burgers_fd(snapshot_times=SNAPSHOTS)
    out = {}
    for t in SNAPSHOTS:
        sel = (np.abs(rows["t"] - t) < 1e-9) & (rows["type"] == 0)
        out[t] = np.abs(rows["u"][sel] - np.interp(rows["x"][sel], x_fd, snaps[t]))
    return out


def validate(csv_path: str, mean_tol: float = MEAN_TOL) -> bool:
    """Print each snapshot's mean and max error; True when every mean is
    within ``mean_tol``."""
    ok = True
    for t, err in errors(csv_path).items():
        status = "ok" if err.mean() <= mean_tol else "FAIL"
        print(f"t={t:3.1f}: mean|u-u_FD|={err.mean():.4f}  "
              f"max={err.max():.4f}  [{status}, tol {mean_tol}]")
        ok &= bool(err.mean() <= mean_tol)
    return ok


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("csv")
    p.add_argument("--mean-tol", type=float, default=MEAN_TOL)
    args = p.parse_args()
    sys.exit(0 if validate(args.csv, args.mean_tol) else 1)
