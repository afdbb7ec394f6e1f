"""Harmonic-oscillator PINN runner on the port: the reference's
tests/enzyme_test2.cpp experiment as the JAX package's
``experiments/run_oscillator.py`` runs it: 1-20-20-1 tanh net, ODE
u'' + u = 0 with u(0) = 0, u'(0) = 1 on x in [0, 6.28] (step 0.1), L-BFGS
(m = 16, Wolfe, 50 fused trials, at most 2000 iterations, tol 1e-6), then
validated against sin(x) at x = 0..3.14 step 0.5. The reference only prints
the max error; the 0.05 gate is the JAX package's
(tests/test_pinn.py::test_oscillator_learns_sin), and a run above it exits
with 1.

The reference sums the squared residuals over its 63 points
(enzyme_test2.cpp:59-63); ``oscillator_problem`` takes their mean, so the
runner passes ``w_ode = n_points``. On the card the solves run on the
resident driver through the cooperative two-loop kernel (m = 16); a short
warm-up from another seed captures the iteration first, then ``--reps``
fresh-seed solves are timed (CUDA events) and the least ms/iter is
reported. ``--device cpu`` runs the early-exit loop.

Usage: python -m lbfgs_ffnn_torch.experiments.run_oscillator [--iters 2000] [--f64] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from lbfgs_ffnn_torch.objectives.mlp import mlp_apply, mlp_spec
from lbfgs_ffnn_torch.objectives.pinn import oscillator_problem, pinn_init
from lbfgs_ffnn_torch.solvers.common import full_f32
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs, lbfgs_warm_up

MAX_ERR = 0.05


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--m", type=int, default=16,
                   help="L-BFGS history (reference CPU default, lbfgs.hpp:142)")
    p.add_argument("--width", type=int, default=20)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--seed", type=int, default=123,
                   help="init seed (torch.Generator); the reference's init is unseeded")
    p.add_argument("--reps", type=int, default=3,
                   help="timed fresh-seed solves; ms/iter is the least of them")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Train, print the summary and the validation. Returns the primary
    seed's ``result``, ``ms_iter`` (least over the reps), ``max_err``,
    ``passed`` (max_err within the gate) and ``iters_run`` (every
    iteration run, warm-up included: one two-loop call each)."""
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    spec = mlp_spec([1, args.width, args.width, 1], ["tanh", "tanh", "linear"])
    print("=== Harmonic-oscillator PINN (u'' + u = 0) ===")
    print(f"Total Params: {spec.n_params}")
    # x = 0, 0.1, ..., 6.2 (the reference's accumulating 0.1 step stops at 6.28)
    xs = torch.arange(0.0, 6.28, 0.1, dtype=dtype, device=dev).reshape(-1, 1)
    prob = oscillator_problem(spec, w_ode=float(xs.shape[0]), w_bc=1.0)
    opts = LBFGSOptions(max_iters=args.iters, tol=args.tol, m=args.m)

    def init(seed):
        return pinn_init(spec, torch.Generator().manual_seed(seed), dtype, device=dev)

    def timed_solve(w):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = lbfgs(prob, w, xs, opts)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3, r
        t0 = time.perf_counter()
        r = lbfgs(prob, w, xs, opts)
        return time.perf_counter() - t0, r

    iters_run = lbfgs_warm_up(prob, init(args.seed + 1), xs, opts).n_iters
    elapsed, res = timed_solve(init(args.seed))
    iters_run += res.n_iters
    ms_iter = 1e3 * elapsed / max(res.n_iters, 1)
    for k in range(max(args.reps, 1) - 1):
        tk, rk = timed_solve(init(args.seed + 2 + k))
        iters_run += rk.n_iters
        ms_iter = min(ms_iter, 1e3 * tk / max(rk.n_iters, 1))
    print(f"L-BFGS: iters={res.n_iters} loss={float(res.final_loss):.6e} "
          f"gnorm={float(res.final_gnorm):.3e} time={elapsed:.2f}s "
          f"({ms_iter:.3f} ms/iter min over {max(args.reps, 1)} fresh-seed reps) "
          f"nf={res.n_fevals} ng={res.n_gevals} host syncs={res.n_host_syncs}")

    print("\nValidation:")
    xv = torch.arange(0.0, 3.14, 0.5, dtype=dtype, device=dev).reshape(-1, 1)
    with full_f32(), torch.no_grad():
        pred = mlp_apply(spec, res.x, xv)[:, 0].cpu().numpy()
    xv = xv[:, 0].cpu().numpy()
    exact = np.sin(xv)
    for x, p, e in zip(xv, pred, exact):
        print(f"x={x:.2f} Pred={p:.6f} Exact={e:.6f}")
    max_err = float(np.max(np.abs(pred - exact)))
    print(f"Max Error: {max_err:.6e}")
    passed = max_err <= MAX_ERR
    if not passed:
        print(f"WARNING: max |u - sin| above the {MAX_ERR} gate", file=sys.stderr)
    return {"result": res, "ms_iter": ms_iter, "max_err": max_err, "passed": passed,
            "iters_run": iters_run}


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
