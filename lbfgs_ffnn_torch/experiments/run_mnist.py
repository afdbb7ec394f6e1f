"""MNIST / Fashion-MNIST experiment runner on the port: the reference's
tests/mnist/main-{cpu,gpu}.cpp configurations, as the JAX package's
``experiments/run_mnist.py`` builds them.

Style "cuda" (reference main-gpu.cpp: 60,000 samples):
  GD(mom .9) -> SGD(b=256, decay .8/40) -> L-BFGS m=10 -> L-BFGS m=100,
  with ``--bf16-ring`` adding L-BFGS m=10 and m=100 on a bfloat16 ring.
Style "cpu" (reference main-cpu.cpp: 5,000 samples):
  GD(mom .9) -> SGD -> S-LBFGS -> L-BFGS(m=20, Wolfe).

Runs on the card unless ``--device cpu``; the rows whose solver is not
ported yet (SGD) are named on one line and not run. Each run writes
``<name>_history.csv`` into ``--out-dir``; ``--timed-chunks K`` runs the
L-BFGS rows (Armijo and Wolfe) in K-iteration chunks and the S-LBFGS row in
K-epoch chunks, with a measured ``TimeMs`` column.

Usage:
  python -m lbfgs_ffnn_torch.experiments.run_mnist --dataset fashion --deep --data-root DIR
"""

from __future__ import annotations

import argparse
from pathlib import Path

from lbfgs_ffnn_torch.data.datasets import load_fashion_mnist, load_mnist
from lbfgs_ffnn_torch.launcher import Launcher, TrainReport, UnifiedConfig

# (solver, style) rows not ported yet -> what they wait for
_DEFERRED = {("sgd", "cpu"): "SGD, ROADMAP queue 1 item 7",
             ("sgd", "cuda"): "SGD, ROADMAP queue 1 item 7"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--style", choices=["cpu", "cuda"], default="cuda")
    p.add_argument("--train-size", type=int, default=None)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--dataset", choices=["mnist", "fashion"], default="mnist")
    p.add_argument("--deep", action="store_true",
                   help="784-256-128-64-10 (reference main_gpu_deep.cpp)")
    p.add_argument("--bf16-ring", action="store_true",
                   help="add L-BFGS runs storing the curvature ring in bfloat16 (half "
                        "the two-loop's history traffic; its arithmetic stays f32)")
    p.add_argument("--plain-two-loop", action="store_true",
                   help="use the plain torch two-loop instead of the Hopper kernels")
    p.add_argument("--only", type=str, default="",
                   help="run only configs whose name contains this substring")
    p.add_argument("--data-root", required=True,
                   help="directory of the dataset's IDX files (the label files are "
                        "required; missing images are synthesized from the labels)")
    p.add_argument("--out-dir", default=".", help="where the history CSVs go")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--timed-chunks", type=int, default=0,
                   help="K > 0: run L-BFGS in K-iteration chunks (lbfgs_chunked) and "
                        "S-LBFGS in K-epoch chunks (slbfgs_chunked) with a measured TimeMs "
                        "column (GD rows keep the whole-solve time)")
    return p


def run_list(args) -> list[tuple[str, UnifiedConfig]]:
    """The runs of the JAX runner for these flags, in its order."""
    name = args.dataset.upper()
    two_loop = "plain" if args.plain_two_loop else "cuda"
    if args.style == "cpu":
        runs = [
            ("gd", UnifiedConfig(name=f"{name}_Unified_GD", max_iters=args.iters,
                                 tolerance=1e-4, learning_rate=0.01, momentum=0.9,
                                 log_interval=1)),
            ("sgd", UnifiedConfig(name=f"{name}_SGD", max_iters=args.iters)),
            ("slbfgs", UnifiedConfig(name=f"{name}_SLBFGS", max_iters=args.iters,
                                     tolerance=1e-4, learning_rate=0.02, batch_size=256,
                                     m_param=10, L_param=10, b_H_param=128,
                                     log_interval=1, two_loop_impl=two_loop)),
            ("lbfgs", UnifiedConfig(name=f"{name}_LBFGS", max_iters=args.iters,
                                    tolerance=1e-4, m_param=20, log_interval=1,
                                    two_loop_impl=two_loop)),
        ]
    else:
        runs = [
            ("gd", UnifiedConfig(name=f"{name}_GD", max_iters=args.iters,
                                 tolerance=1e-3, learning_rate=0.02, momentum=0.9,
                                 log_interval=1)),
            ("sgd", UnifiedConfig(name=f"{name}_SGD", max_iters=args.iters)),
            ("lbfgs", UnifiedConfig(name=f"{name}_LBFGS_m10", max_iters=args.iters,
                                    tolerance=1e-3, m_param=10, log_interval=1,
                                    two_loop_impl=two_loop)),
            ("lbfgs", UnifiedConfig(name=f"{name}_LBFGS_m100", max_iters=args.iters,
                                    tolerance=1e-3, m_param=100, log_interval=1,
                                    two_loop_impl=two_loop)),
        ]
    if args.bf16_ring:
        for m in (10, 100):
            runs.append(("lbfgs", UnifiedConfig(
                name=f"{name}_LBFGS_m{m}_bf16ring", max_iters=args.iters,
                tolerance=1e-3 if args.style == "cuda" else 1e-4, m_param=m,
                log_interval=1, two_loop_impl=two_loop, pair_dtype="bfloat16")))
    return runs


def main(argv=None) -> list[tuple[str, UnifiedConfig, TrainReport]]:
    """Run the configured rows; returns (solver, config, report) per run."""
    parser = build_parser()
    args = parser.parse_args(argv)
    runs = run_list(args)
    if args.only:
        runs = [(s, c) for s, c in runs if args.only in c.name]
        if not runs:
            parser.error(f"--only {args.only!r} matches no configured run")
    deferred = [f"{c.name} ({_DEFERRED[s, args.style]})" for s, c in runs
                if (s, args.style) in _DEFERRED]
    runs = [(s, c) for s, c in runs if (s, args.style) not in _DEFERRED]
    if deferred:
        print("not run, not ported yet: " + "; ".join(deferred))

    train_size = args.train_size or (5000 if args.style == "cpu" else 60000)
    loader = load_mnist if args.dataset == "mnist" else load_fashion_mnist
    ds = loader(args.data_root, train_size=train_size, test_size=10000)
    if ds.synthetic_images:
        print("NOTE: image files missing; training on synthetic class-structured "
              "images with the label stream.")

    launcher = Launcher(backend_style=args.style, device=args.device, out_dir=Path(args.out_dir))
    if args.deep:
        launcher.add_layer(784, 256, "relu").add_layer(256, 128, "relu")
        launcher.add_layer(128, 64, "relu").add_layer(64, 10, "linear")
    else:
        launcher.add_layer(784, 128, "relu").add_layer(128, 10, "linear")
    launcher.build_network().set_data(ds)

    done = []
    for solver, cfg in runs:
        if solver in ("slbfgs", "lbfgs") and args.timed_chunks > 0:
            cfg.timed_chunks = args.timed_chunks
        print(f"Running {cfg.name} ({solver}, seed={cfg.seed})...")
        report = launcher.train(solver, cfg)
        launcher.test()
        done.append((solver, cfg, report))
    return done


if __name__ == "__main__":
    main()
