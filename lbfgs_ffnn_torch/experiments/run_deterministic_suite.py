"""Deterministic solver suite: BFGS / LBFGS / BFGS+GMRES / Newton across
Rosenbrock n=4, Ackley n=3 and Rastrigin n=500, the reference's
tests/main.cpp experiment as the JAX package's
``experiments/run_deterministic_suite.py`` runs it (max_iters 5000, tol
1e-12, L-BFGS m = 16), through the port's harness with its convergence
classification and per-run timing (CUDA events on the card, each first
solve of a problem and options including its capture, as JAX's includes
its compile).

The L-BFGS row's two-loop: in f64 ``two_loop_impl="plain"``, the named
counterpart of JAX's default ``"xla"`` (the Hopper kernels take f32
only); under ``--f32`` ``"cuda"``, the cooperative kernel (m = 16). The
runner prints which one it ran. Two flags of the port's own cut the run:
``--quick`` sets max_iters to 20 and Rastrigin to n = 50 (a smoke run on
the CPU); ``--gmres-max-iters N`` cuts only the BFGS+GMRES rows, for the
f32 run on the card: tol 1e-12 is out of f32's reach, so GMRES runs all of
its 10,000 restart cycles in every BFGS iteration (about a second per
iteration there; PERF.md), while every other row keeps the suite's 5000
iterations and Rastrigin its n = 500.

Usage: python -m lbfgs_ffnn_torch.experiments.run_deterministic_suite [--f32] [--device cpu]
       [--quick] [--gmres-max-iters N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lbfgs_ffnn_torch.harness import TestCase, TestSuite
from lbfgs_ffnn_torch.objectives.analytic import (
    ackley_problem, ackley_start, rastrigin_problem, rastrigin_start, rosenbrock_problem,
    rosenbrock_start,
)
from lbfgs_ffnn_torch.solvers import (
    BFGSOptions, LBFGSOptions, NewtonOptions, bfgs, lbfgs, newton,
)

MAX_ITERS, TOL, M = 5000, 1e-12, 16


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--f32", action="store_true", help="run in float32")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--quick", action="store_true",
                   help="max_iters 20 and Rastrigin n = 50 (a smoke run)")
    p.add_argument("--gmres-max-iters", type=int, default=None, metavar="N",
                   help="max_iters of the BFGS+GMRES rows only (default: the suite's)")
    return p


def build_suite(dtype: torch.dtype, device, quick: bool = False,
                gmres_max_iters: int | None = None) -> TestSuite:
    """The suite's four implementations and three cases; returns the
    :class:`TestSuite` (run it with ``.run()``)."""
    iters = 20 if quick else MAX_ITERS
    gmres_iters = iters if gmres_max_iters is None else gmres_max_iters
    n_rastrigin = 50 if quick else 500
    impl = "plain" if dtype == torch.float64 else "cuda"
    suite = TestSuite()
    suite.add_implementation(
        "BFGS", lambda p, x0: bfgs(p, x0, opts=BFGSOptions(max_iters=iters, tol=TOL)))
    suite.add_implementation(
        "LBFGS", lambda p, x0: lbfgs(p, x0, opts=LBFGSOptions(max_iters=iters, tol=TOL, m=M,
                                                              two_loop_impl=impl)))
    suite.add_implementation(
        "BFGS+GMRES",
        lambda p, x0: bfgs(p, x0, opts=BFGSOptions(max_iters=gmres_iters, tol=TOL,
                                                   linear_solver="gmres")))
    suite.add_implementation(
        "Newton", lambda p, x0: newton(p, x0, opts=NewtonOptions(max_iters=iters, tol=TOL)))
    suite.add_test(TestCase("rosenbrock n=4", rosenbrock_problem(),
                            rosenbrock_start(4, dtype, device), expected_min=np.ones(4),
                            gtol=1e-8))
    suite.add_test(TestCase("ackley n=3", ackley_problem(), ackley_start(dtype, device),
                            expected_min=np.zeros(3), gtol=1e-8))
    suite.add_test(TestCase(f"rastrigin n={n_rastrigin}", rastrigin_problem(),
                            rastrigin_start(n_rastrigin, dtype, device), gtol=1e-7))
    return suite


def main(argv=None):
    """Run the suite and print one line per run; returns the harness's
    records. A CUDA device without a card raises."""
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the suite runs on an NVIDIA GPU and torch.cuda.is_available() is "
                           "false; pass --device cpu")
    dtype = torch.float32 if args.f32 else torch.float64
    impl = "plain" if dtype == torch.float64 else "cuda"
    print(f"deterministic suite: {dtype}, device {dev}; LBFGS row m={M}, two_loop_impl={impl!r}"
          + (" (the Hopper two-loop kernels take f32 only; JAX's default 'xla' is the plain "
             "loop)" if impl == "plain" else " (K1, the cooperative kernel, on the card)")
          + ("" if args.gmres_max_iters is None
             else f"; BFGS+GMRES rows cut to {args.gmres_max_iters} iterations"),
          flush=True)
    return build_suite(dtype, dev, args.quick, args.gmres_max_iters).run()


if __name__ == "__main__":
    main()
