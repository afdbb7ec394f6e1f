"""MNIST / Fashion-MNIST experiment runner on the port: the reference's
tests/mnist/main-{cpu,gpu}.cpp configurations, as the JAX package's
``experiments/run_mnist.py`` builds them.

Style "cuda" (reference main-gpu.cpp: 60,000 samples):
  GD(mom .9) -> SGD(b=256, decay .8/40) -> L-BFGS m=10 -> L-BFGS m=100.
Style "cpu" (reference main-cpu.cpp: 5,000 samples):
  GD(mom .9) -> SGD(b=256, lr .03) -> S-LBFGS -> L-BFGS(m=20, Wolfe).
The JAX runner's variant flags each add L-BFGS m=10 and m=100 rows named
``<NAME>_LBFGS_m<m>_<suffix>``: ``--bf16-ring`` (bf16ring),
``--bf16-grad-input`` (bf16gradin), ``--bf16-prefix`` (bf16prefix),
``--bf16-line-input`` (bf16lineinput), ``--bf16-all`` (bf16all: the four),
``--u8-input`` (u8input: the uint8 input copy in every first-layer GEMM),
``--u8-all`` (u8all: u8input + bf16 ring and prefix) and ``--warm-alpha``
(warmalpha, and u8warm: u8all + warm alpha); ``--u8-input`` and
``--u8-all`` also add ``<NAME>_GD_u8input`` and, in the cuda style,
``<NAME>_SGD_u8input``. ``--bf16-compute`` and ``--batched-ls`` are not
ported (ROADMAP's do-not-port list): each prints one line saying so and
the runner exits non-zero.

Runs on the card unless ``--device cpu``. Each run writes
``<name>_history.csv`` into ``--out-dir`` (``--record-accuracy`` adds the
SGD and S-LBFGS rows' TrainAcc and TestAcc columns), and the runner writes
``run_meta.json`` there; ``--timed-chunks K`` runs every solver in
K-iteration (K-epoch) chunks with a measured ``TimeMs`` column (-1: SGD's
whole run as one chunk, the others ``max(50, iters // 5)``); ``--seeds N``
runs each row at init seeds seed, seed + 1, ... and writes their ms/iter
and final losses to ``multiseed_summary.json``. The seed is an argument of
each solve, not part of a captured graph: the seeds of a row share its
captures.

Usage:
  python -m lbfgs_ffnn_torch.experiments.run_mnist --dataset fashion --deep --data-root DIR
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from lbfgs_ffnn_torch.data.datasets import load_fashion_mnist, load_mnist
from lbfgs_ffnn_torch.launcher import Launcher, TrainReport, UnifiedConfig


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
    p.add_argument("--bf16-grad-input", action="store_true",
                   help="add L-BFGS runs reading a bf16 copy of x in the accepted point's "
                        "dW1 GEMM only")
    p.add_argument("--bf16-prefix", action="store_true",
                   help="add L-BFGS runs storing the carried line prefix in bf16 (arithmetic "
                        "f32, re-anchored every 16 iterations)")
    p.add_argument("--bf16-line-input", action="store_true",
                   help="add L-BFGS runs reading a bf16 copy of x in the prefix GEMMs")
    p.add_argument("--bf16-all", action="store_true",
                   help="add L-BFGS runs with the bf16 ring, grad input, line input and "
                        "prefix together")
    p.add_argument("--u8-input", action="store_true",
                   help="add L-BFGS runs reading a uint8 pixel-quantized copy of x in every "
                        "first-layer GEMM (exact for k/255 pixel data), and the GD (and, in "
                        "the cuda style, SGD) u8input rows")
    p.add_argument("--u8-all", action="store_true",
                   help="add L-BFGS runs with the uint8 input copy, the bf16 ring and the "
                        "bf16 prefix, and the u8input GD/SGD rows")
    p.add_argument("--warm-alpha", action="store_true",
                   help="add L-BFGS runs with the warm-started line search "
                        "(ls_alpha_init='warm': alpha0 = min(1, 8*previous step)), alone and "
                        "on the u8 traffic configuration")
    p.add_argument("--bf16-compute", action="store_true",
                   help="not ported (bf16 matmul operands): prints so and exits non-zero")
    p.add_argument("--batched-ls", action="store_true",
                   help="not ported (the batched Armijo ladder): prints so and exits "
                        "non-zero")
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
                   help="K > 0: run every solver in K-iteration (K-epoch) chunks with a "
                        "measured TimeMs column; -1: SGD's whole run as one chunk, the "
                        "others max(50, iters // 5)")
    p.add_argument("--record-accuracy", action="store_true",
                   help="per-epoch TrainAcc and TestAcc columns for the SGD and S-LBFGS rows")
    p.add_argument("--seeds", type=int, default=1,
                   help="run each row at N init seeds (seed, seed + 1, ...); the first "
                        "writes the CSV, multiseed_summary.json gets each seed's ms/iter "
                        "and final loss and their median, min and max")
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
            ("sgd", UnifiedConfig(name=f"{name}_SGD", max_iters=args.iters,
                                  tolerance=1e-4, learning_rate=0.03, batch_size=256,
                                  log_interval=5)),
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
            ("sgd", UnifiedConfig(name=f"{name}_SGD", max_iters=args.iters,
                                  tolerance=1e-3, learning_rate=0.01, batch_size=256,
                                  log_interval=5, lr_decay=0.80, lr_decay_rate=40)),
            ("lbfgs", UnifiedConfig(name=f"{name}_LBFGS_m10", max_iters=args.iters,
                                    tolerance=1e-3, m_param=10, log_interval=1,
                                    two_loop_impl=two_loop)),
            ("lbfgs", UnifiedConfig(name=f"{name}_LBFGS_m100", max_iters=args.iters,
                                    tolerance=1e-3, m_param=100, log_interval=1,
                                    two_loop_impl=two_loop)),
        ]
    u8 = dict(line_input_dtype="uint8", grad_input_dtype="uint8", fun_input_dtype="uint8")
    u8_all = dict(u8, pair_dtype="bfloat16", prefix_dtype="bfloat16")
    for enabled, suffix, extra in (
            (args.bf16_ring, "bf16ring", dict(pair_dtype="bfloat16")),
            (args.bf16_grad_input, "bf16gradin", dict(grad_input_dtype="bfloat16")),
            (args.bf16_prefix, "bf16prefix", dict(prefix_dtype="bfloat16")),
            (args.bf16_line_input, "bf16lineinput", dict(line_input_dtype="bfloat16")),
            (args.bf16_all, "bf16all", dict(pair_dtype="bfloat16", grad_input_dtype="bfloat16",
                                            line_input_dtype="bfloat16",
                                            prefix_dtype="bfloat16")),
            (args.u8_input, "u8input", u8),
            (args.u8_all, "u8all", u8_all),
            (args.warm_alpha, "warmalpha", dict(ls_alpha_init="warm")),
            (args.warm_alpha, "u8warm", dict(u8_all, ls_alpha_init="warm"))):
        if not enabled:
            continue
        for m in (10, 100):
            runs.append(("lbfgs", UnifiedConfig(
                name=f"{name}_LBFGS_m{m}_{suffix}", max_iters=args.iters,
                tolerance=1e-3 if args.style == "cuda" else 1e-4, m_param=m,
                log_interval=1, two_loop_impl=two_loop, **extra)))
    if args.u8_input or args.u8_all:
        # GD's and SGD's iterations read x whole: fun_input_dtype is their lever
        runs.append(("gd", UnifiedConfig(
            name=f"{name}_GD_u8input", max_iters=args.iters, tolerance=1e-3,
            learning_rate=0.02, momentum=0.9, log_interval=1, fun_input_dtype="uint8")))
        if args.style == "cuda":
            runs.append(("sgd", UnifiedConfig(
                name=f"{name}_SGD_u8input", max_iters=args.iters, tolerance=1e-3,
                learning_rate=0.01, batch_size=256, log_interval=5, lr_decay=0.80,
                lr_decay_rate=40, fun_input_dtype="uint8")))
    return runs


def _timed_chunks(args, solver: str, cfg: UnifiedConfig) -> int:
    """The row's chunk: ``--timed-chunks`` when positive; with -1, SGD's
    whole run as one chunk and the others ``max(50, iters // 5)`` (JAX's
    rule)."""
    if args.timed_chunks == -1:
        return cfg.max_iters if solver == "sgd" else max(50, cfg.max_iters // 5)
    return max(args.timed_chunks, 0)


def _median(values: list) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else (v[len(v) // 2 - 1] + v[len(v) // 2]) / 2


def _merge_json(path: Path, update: dict) -> None:
    """Merge ``update`` into the JSON object at ``path`` (a partial
    regeneration with ``--only`` keeps the other rows)."""
    merged = json.loads(path.read_text()) if path.exists() else {}
    merged.update(update)
    path.write_text(json.dumps(merged, indent=2, sort_keys=True) + "\n")


def main(argv=None) -> list[tuple[str, UnifiedConfig, TrainReport]]:
    """Run the configured rows; returns (solver, config, report) per run,
    the first seed's of each row."""
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, what in (("bf16_compute", "--bf16-compute (compute_dtype='bfloat16')"),
                       ("batched_ls", "--batched-ls (line_search='armijo_batched')")):
        if getattr(args, flag):
            print(f"{what}: not ported (ROADMAP's do-not-port list)")
            raise SystemExit(2)
    runs = run_list(args)
    if args.only:
        runs = [(s, c) for s, c in runs if args.only in c.name]
        if not runs:
            parser.error(f"--only {args.only!r} matches no configured run")

    train_size = args.train_size or (5000 if args.style == "cpu" else 60000)
    loader = load_mnist if args.dataset == "mnist" else load_fashion_mnist
    ds = loader(args.data_root, train_size=train_size, test_size=10000)
    if ds.synthetic_images:
        print("NOTE: image files missing; training on synthetic class-structured "
              "images with the label stream.")

    out_dir = Path(args.out_dir)
    launcher = Launcher(backend_style=args.style, device=args.device, out_dir=out_dir)
    if args.deep:
        launcher.add_layer(784, 256, "relu").add_layer(256, 128, "relu")
        launcher.add_layer(128, 64, "relu").add_layer(64, 10, "linear")
    else:
        launcher.add_layer(784, 128, "relu").add_layer(128, 10, "linear")
    launcher.build_network().set_data(ds)

    done, meta_runs, multiseed = [], [], {}
    for solver, cfg in runs:
        cfg.record_accuracy = args.record_accuracy and solver in ("sgd", "slbfgs")
        cfg.timed_chunks = _timed_chunks(args, solver, cfg)
        seeds = [cfg.seed + k for k in range(max(args.seeds, 1))]
        per_seed = {"solver": solver, "seeds": seeds, "ms_per_iter": [], "final_loss": [],
                    "n_iters": []}
        for k, seed in enumerate(seeds):
            cfg.seed, cfg.write_csv = seed, k == 0  # the first seed writes the CSV
            print(f"Running {cfg.name} ({solver}, seed={seed})...")
            report = launcher.train(solver, cfg)
            launcher.test()
            n = max(int(report.result.n_iters), 1)
            ms = (float(report.history.time_ms[n - 1]) / n if cfg.timed_chunks > 0
                  else report.ms_per_iter)
            per_seed["ms_per_iter"].append(ms)
            per_seed["final_loss"].append(float(report.result.final_loss))
            per_seed["n_iters"].append(n)
            if k == 0:
                done.append((solver, cfg, report))
        cfg.seed = seeds[0]
        ms = per_seed["ms_per_iter"]
        per_seed.update(ms_per_iter_median=_median(ms), ms_per_iter_min=min(ms),
                        ms_per_iter_max=max(ms))
        if len(seeds) > 1 or (out_dir / "multiseed_summary.json").exists():
            multiseed[cfg.name] = per_seed
        meta_runs.append({"name": cfg.name, "solver": solver, "max_iters": cfg.max_iters,
                          "timed_chunks": cfg.timed_chunks, "seeds": seeds})

    out_dir.mkdir(parents=True, exist_ok=True)
    if multiseed:
        _merge_json(out_dir / "multiseed_summary.json", multiseed)
    device = launcher.device
    meta_path = out_dir / "run_meta.json"
    runs_by_name = {}
    if args.only and meta_path.exists():
        runs_by_name = {r["name"]: r for r in json.loads(meta_path.read_text())["runs"]}
    runs_by_name.update({r["name"]: r for r in meta_runs})
    _merge_json(meta_path, {
        "cmd": "python -m lbfgs_ffnn_torch.experiments.run_mnist " + " ".join(
            sys.argv[1:] if argv is None else argv),
        "date_utc": time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime()),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "train_size": train_size,
        "synthetic_images": bool(ds.synthetic_images),
        "timems_semantics": (
            "Cumulative wall time measured at chunk boundaries (the pipelined chunk "
            "driver enqueues chunk c+1 before it reads chunk c); the rows of a chunk "
            "share one time. timed_chunks=0: the whole solve's time (CUDA events on the "
            "card) spread evenly over its iterations."),
        "runs": list(runs_by_name.values()),
    })
    return done


if __name__ == "__main__":
    main()
