"""Finite-difference reference solution of 1D viscous Burgers: the port's
copy of the JAX package's ``scripts/burgers_fd.py`` (numpy only), the
oracle of :mod:`lbfgs_ffnn_torch.experiments.burgers_validate`.

Counterpart of the reference's visual comparison script
(reference: tests/burgers/visual.py): solves
    u_t + u*u_x = nu*u_xx,  u(x,0) = sin(pi x),  u(+-1,t) = 0
with an explicit upwind/central scheme on a fine grid, for validating the
PINN solution quantitatively and visually against
``burgers_test_extrapolation.csv``.

Usage: python -m lbfgs_ffnn_torch.experiments.burgers_fd [-o burgers_fd.csv]
"""

from __future__ import annotations

import argparse
import math

import numpy as np


def solve_burgers_fd(
    nx: int = 801,
    t_end: float = 1.0,
    nu: float = 0.01 / math.pi,
    snapshot_times: tuple[float, ...] = (0.0, 0.5, 1.0),
) -> tuple[np.ndarray, dict[float, np.ndarray]]:
    """Explicit FD: upwind convection + central diffusion, CFL-limited dt.

    Returns (x_grid, {t: u(x, t)}).
    """
    x = np.linspace(-1.0, 1.0, nx)
    dx = x[1] - x[0]
    u = np.sin(np.pi * x)
    u[0] = u[-1] = 0.0

    snapshots: dict[float, np.ndarray] = {}
    remaining = sorted(snapshot_times)
    t = 0.0
    if remaining and remaining[0] <= 0.0:
        snapshots[remaining.pop(0)] = u.copy()

    while t < t_end - 1e-12:
        umax = max(np.abs(u).max(), 1e-12)
        dt = 0.4 * min(dx / umax, dx * dx / (2.0 * nu))
        if remaining:
            dt = min(dt, remaining[0] - t + 1e-15)
        dt = min(dt, t_end - t)

        # upwind convection
        du_dx_back = (u[1:-1] - u[:-2]) / dx
        du_dx_fwd = (u[2:] - u[1:-1]) / dx
        conv = np.where(u[1:-1] > 0, u[1:-1] * du_dx_back, u[1:-1] * du_dx_fwd)
        diff = nu * (u[2:] - 2 * u[1:-1] + u[:-2]) / dx**2

        u_new = u.copy()
        u_new[1:-1] = u[1:-1] + dt * (diff - conv)
        u_new[0] = u_new[-1] = 0.0
        u = u_new
        t += dt

        if remaining and t >= remaining[0] - 1e-12:
            snapshots[remaining.pop(0)] = u.copy()

    return x, snapshots


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--output", default="burgers_fd.csv")
    args = parser.parse_args()
    x, snaps = solve_burgers_fd()
    with open(args.output, "w") as f:
        f.write("x,t,u,type\n")
        for t, u in sorted(snaps.items()):
            for xi, ui in zip(x, u):
                f.write(f"{xi},{t},{ui},1\n")
    print(f"wrote {args.output} ({len(snaps)} snapshots)")


if __name__ == "__main__":
    main()
