"""Burgers PINN trainer on the port: the reference's
tests/burgers/test_burgers_parallel.cpp experiment as the JAX package's
``experiments/run_burgers.py`` runs it: 2-20-20-20-1 tanh net, weighted
IC(20)/BC(20)/PDE(1) loss, L-BFGS m=100 under the Wolfe search with 100
lean trials (a trial is one jvp along the direction), then an extrapolation
CSV at t = 0, 0.5, 1.0 (interpolation) and t = 1.5 (extrapolation) in the
reference's x,t,u,type format.

On the card the solve runs on the resident driver (each iteration a
replayed CUDA graph, the Wolfe trials a WHILE node in it) through the
two-loop kernel the dispatch picks for the m=100 ring (the streaming
kernel); a short warm-up on a perturbed init captures that graph first, so
the timed solve (CUDA events) replays it. ``--device cpu`` runs the
early-exit loop. ``--warm-alpha`` starts each Wolfe search after the
first at min(1, 8 * the previous step) (``ls_alpha_init="warm"``). :mod:`lbfgs_ffnn_torch.experiments.burgers_validate`
holds the CSV against the finite-difference oracle.

Usage: python -m lbfgs_ffnn_torch.experiments.run_burgers [--iters 5000] [--coarse] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from lbfgs_ffnn_torch.objectives.mlp import mlp_apply
from lbfgs_ffnn_torch.objectives.pinn import (
    burgers_points, burgers_problem, default_burgers_spec, pinn_init,
)
from lbfgs_ffnn_torch.solvers.common import full_f32
from lbfgs_ffnn_torch.utils import profiling
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs, lbfgs_warm_up


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=5000)
    p.add_argument("--coarse", action="store_true", help="coarser grids for a quick run")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--curvature", choices=["grad_diff", "hvp"], default="grad_diff",
                   help="L-BFGS curvature pairs: grad_diff (the reference's) or hvp (exact "
                        "H*s, one Hessian-vector product per iteration)")
    p.add_argument("--warm-alpha", action="store_true",
                   help="warm-started line-search initial step (ls_alpha_init='warm'): "
                        "each Wolfe search after the first starts at min(1, 8*alpha_prev) "
                        "instead of alpha0=1")
    p.add_argument("--seed", type=int, default=123, help="init seed (torch.Generator)")
    p.add_argument("--out", default="burgers_test_extrapolation.csv")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def options(iters: int, f64: bool, curvature: str = "grad_diff",
            warm_alpha: bool = False) -> LBFGSOptions:
    """The runner's L-BFGS options. f32 runs use the scale-invariant
    curvature gate (the absolute 1e-10 gate under-rejects noisy f32 pairs
    near the plateau); the lean trials are jvps, cheaper than fused ones on
    the PINN plateau's many trials per iteration."""
    return LBFGSOptions(max_iters=iters, tol=1e-10, m=100, ls_max_iters=100,
                        curvature_rel_eps=0.0 if f64 else 1e-6, ls_value_only=True,
                        curvature_pairs=curvature, two_loop_impl="cuda",
                        ls_alpha_init="warm" if warm_alpha else "fixed")


def write_csv(path, spec, w) -> None:
    """u on x in [-1, 1] (step 0.02) at t = 0, 0.5, 1 (type 0) and 1.5
    (type 2), the reference's x,t,u,type rows."""
    xs = torch.arange(-1.0, 1.0 + 0.01, 0.02, dtype=w.dtype, device=w.device)
    with open(path, "w") as f, full_f32(), torch.no_grad():
        f.write("x,t,u,type\n")
        for t, typ in ((0.0, 0), (0.5, 0), (1.0, 0), (1.5, 2)):
            xt = torch.stack([xs, torch.full_like(xs, t)], dim=1)
            u = mlp_apply(spec, w, xt)[:, 0]
            for xi, ui in zip(xs.tolist(), u.tolist()):
                f.write(f"{xi},{t},{ui},{typ}\n")


def main(argv=None) -> dict:
    """Train, print the summary and write the CSV. Returns the timed solve's
    ``result``, its ``seconds``, ``ms_iter``, the ``warmup`` solve (None on
    the CPU), ``capture_s`` and ``csv``."""
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    spec = default_burgers_spec()
    prob = burgers_problem(spec)
    if args.coarse:
        pts = burgers_points(dx=0.01, dt=0.02, int_dx=0.04, int_dt=0.08, dtype=dtype, device=dev)
    else:
        pts = burgers_points(dtype=dtype, device=dev)
    print(f"PDE Points: {pts.col_xt.shape[0]}")
    w0 = pinn_init(spec, torch.Generator().manual_seed(args.seed), dtype, device=dev)
    opts = options(args.iters, args.f64, args.curvature, args.warm_alpha)

    warm, capture_s = None, None
    if dev.type == "cuda":  # captures the timed solve's iteration
        warm = lbfgs_warm_up(prob, w0 * (1.0 + 1e-6) + 1e-7, pts, opts)
        capture_s = profiling.last("resident.capture").seconds
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = lbfgs(prob, w0, pts, opts)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        res = lbfgs(prob, w0, pts, opts)
        seconds = time.perf_counter() - t0
    n = max(res.n_iters, 1)
    print(f"Training Time: {seconds:.3f}s ({seconds * 1e3 / n:.3f} ms/iter"
          + (f", graph captured in {capture_s:.2f}s before" if capture_s is not None else "")
          + f")  iters={res.n_iters} loss={float(res.final_loss):.6g} "
          f"||g||={float(res.final_gnorm):.3g} nf={res.n_fevals} ng={res.n_gevals} "
          f"host syncs={res.n_host_syncs}")
    write_csv(args.out, spec, res.x)
    print(f"wrote {args.out}")
    return {"result": res, "seconds": seconds, "ms_iter": seconds * 1e3 / n, "warmup": warm,
            "capture_s": capture_s, "csv": args.out}


if __name__ == "__main__":
    main()
