"""GMRES's least-squares kernel (``csrc/lstsq.cu``) on the card: its time
per call at GMRES's shapes, and what it costs the f32 suite's BFGS+GMRES rows.

At the shapes GMRES gives it (:data:`SHAPES`: 4 x 3 for Ackley n = 3, 5 x 4
for Rosenbrock n = 4, 21 x 20 at restart 20 and 32 x 31, the largest the
kernel takes), f32 and f64, on a seeded full-rank upper Hessenberg matrix
(:func:`~lbfgs_ffnn_torch.ops.cuda_lstsq.hessenberg`), each kernel is timed
two ways: lone calls back to back between CUDA events (the wrapper's host
work shows where it is slower than the kernel), and replayed: ``K1`` and
``K2`` calls captured in two CUDA graphs, the time per call the slope
between their replays. Beside them, in the same run, the plain version
(``lstsq_plain``, ``torch.linalg.svd`` on the card), ``torch.linalg.svd``
alone and ``torch.linalg.lstsq`` (QR only: the same function where H has
full rank), each by events; the kernel's error against the plain version
in f64 on the CPU; the sweeps it made (its optional device count) and the
mirror's sweeps and rounds
(:func:`~lbfgs_ffnn_torch.ops.cuda_lstsq.jacobi_mirror`); ns per round is
the replayed time over the mirror's rounds. Then every kernel's error on
the 21 x 20 f64 matrices graded by columns and by rows at
:data:`GRADED_SEEDS`.

The kernels: this tree's and, with ``--parent DIR`` (an unpacked copy of an
earlier commit of the repo), that tree's kernel, built there by its own
``_build`` in a process of its own and called through its ``lstsq_launch``
(with no sweep count); timed in turns (parent, this tree, this tree,
parent) in one process.

``--suite`` adds the f32 suite's BFGS+GMRES rows (Rosenbrock n = 4, Ackley
n = 3, Rastrigin n = 500, ``max_iters`` 10, tol 1e-12, as ``chip_smoke.py``'s
suite phase runs them), each tree's in a process of its own, importing that
tree's package, in turns (parent, this tree, this tree, parent): the
solve's wall time (host clock; its capture, which runs one iteration
eagerly, included, as the suite's runner times it), the capture's seconds,
the kernel's launches on the device; and the kernel's share of a GMRES
cycle's device time from ``torch.profiler``: the solve's body run eagerly
(kernel names in a replayed graph are not reliable) for one BFGS iteration
at two restart-cycle budgets, the share the slope between them.

``--mirror`` prints only what the mirror says (it needs no card): sweeps and
rounds at :data:`SHAPES` and its error against numpy's ``lstsq`` on the
graded matrices (with ``--parent DIR``, that tree's mirror beside it).
``--mirror --suite-matrices`` adds the f32 suite's BFGS+GMRES rows run on
the CPU (the plain version solves there, so the trajectories are the
CPU's): every ``(H, b)`` that reaches the
least-squares step, recorded by a wrapper the study puts in place of
``ops.iterative``'s ``lstsq_min_norm`` for the run alone, goes through this
tree's mirror and, with ``--parent DIR``, that tree's mirror (its
``ops/cuda_lstsq.py`` loaded from the file): per row, the calls and the
distinct matrices among them, the sweeps and the error against numpy's
``lstsq`` in f64 with f32's cutoff (``rcond = eps32 max(m, n)``, JAX's).

Usage: python -m lbfgs_ffnn_torch.experiments.lstsq_study [--parent DIR]
       [--suite] [--reps N] [--json FILE] [--mirror [--suite-matrices]]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SHAPES = ((4, 3), (5, 4), (21, 20), (32, 31))
K1, K2 = 10, 50  # calls in the two captured graphs
SEED = 0
GRADED_SEEDS = (100, 101, 102, 103)
SUITE_ITERS = 10  # chip_smoke.py's SUITE_F32_GMRES_ITERS
SHARE_CYCLES = (10, 30)  # GMRES restart cycles in the two profiled iterations


def mirror_report(parent: Path | None = None) -> dict:
    """The mirror's sweeps and rounds at :data:`SHAPES` (f32, f64) and its
    error against numpy's ``lstsq`` on the graded matrices; with ``parent``,
    that tree's mirror beside it."""
    from lbfgs_ffnn_torch.ops.cuda_lstsq import hessenberg, jacobi_mirror

    mirrors = {"mirror": jacobi_mirror}
    if parent is not None:
        mirrors["parent's mirror"] = tree_mirror(parent)
    out = {"shapes": {}, "graded": {}}
    for m, n in SHAPES:
        H, b = hessenberg(SEED, m, n)
        for dt in (np.float32, np.float64):
            for label, mirror in mirrors.items():
                _, sweeps, rounds = mirror(H.astype(dt), b.astype(dt))
                out["shapes"][f"{label} {m}x{n} {dt.__name__}"] = (sweeps, rounds)
                print(f"{label} {m} x {n} {dt.__name__}: {sweeps} sweeps, {rounds} rounds",
                      flush=True)
    for graded in ("columns", "rows"):
        for seed in GRADED_SEEDS:
            H, b = hessenberg(seed, 21, 20, graded=graded)
            ref = np.linalg.lstsq(H, b, rcond=None)[0]
            for label, mirror in mirrors.items():
                y, sweeps, _ = mirror(H, b)
                err = float(np.abs(y - ref).max() / np.abs(ref).max())
                out["graded"][f"{label} {graded} {seed}"] = {
                    "cond": float(np.linalg.cond(H)), "error": err, "sweeps": sweeps}
                print(f"{label} 21 x 20 f64 graded by {graded}, seed {seed}, cond "
                      f"{np.linalg.cond(H):.3g}: error {err:.3g} (max |y - numpy lstsq| / max "
                      f"|numpy lstsq|), {sweeps} sweeps", flush=True)
    return out


def suite_matrices(iters: int = SUITE_ITERS) -> dict:
    """Every ``(H, b)`` (numpy, f32) that reaches the least-squares step in
    the f32 suite's BFGS+GMRES rows, run on the CPU: ``{case: [(H, b),
    ...]}`` in call order, recorded by a wrapper in place of
    ``ops.iterative``'s ``lstsq_min_norm`` for these runs alone."""
    from lbfgs_ffnn_torch.experiments.run_deterministic_suite import TOL
    from lbfgs_ffnn_torch.ops import iterative

    tb = importlib.import_module("lbfgs_ffnn_torch.solvers.bfgs")
    opts = tb.BFGSOptions(max_iters=iters, tol=TOL, linear_solver="gmres")
    plain = iterative.lstsq_min_norm
    calls: list = []

    def recorded(H, b):
        calls.append((H.numpy().copy(), b.numpy().copy()))
        return plain(H, b)

    out = {}
    iterative.lstsq_min_norm = recorded
    try:
        for case, (problem, x0) in suite_cases(torch.device("cpu")).items():
            calls = []
            res = tb.bfgs(problem, x0, opts=opts)
            out[case] = calls
            print(f"suite f32 BFGS+GMRES {case} on the CPU: {res.n_iters} iterations, "
                  f"{len(calls)} least-squares calls", flush=True)
    finally:
        iterative.lstsq_min_norm = plain
    return out


def tree_mirror(root: Path):
    """``jacobi_mirror`` of the tree at ``root``: its ``ops/cuda_lstsq.py``
    loaded from the file under a name of its own (the mirror is numpy)."""
    path = root / "lbfgs_ffnn_torch" / "ops" / "cuda_lstsq.py"
    spec = importlib.util.spec_from_file_location("tree_cuda_lstsq", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.jacobi_mirror


def suite_mirror_report(parent: Path | None) -> dict:
    """This tree's mirror and ``parent``'s on every matrix of
    :func:`suite_matrices`: per row, the calls, the distinct finite
    matrices (a NaN H, which the solve's NaN leaves, is counted apart), and
    per mirror the sweeps (mean over the calls, min, max) and the error
    (max |y - ref| / max |ref|, median and max over the distinct matrices;
    ref numpy's ``lstsq`` in f64 with f32's cutoff)."""
    from lbfgs_ffnn_torch.ops.cuda_lstsq import jacobi_mirror

    mirrors = {"new": jacobi_mirror}
    if parent is not None:
        mirrors = {"parent": tree_mirror(parent), **mirrors}
    out = {}
    for case, calls in suite_matrices().items():
        distinct: dict = {}
        finite = [(H, b) for H, b in calls if np.isfinite(H).all() and np.isfinite(b).all()]
        for H, b in finite:
            key = H.tobytes() + b.tobytes()
            if key in distinct:
                distinct[key][2] += 1
            else:
                distinct[key] = [H, b, 1]
        row = {"calls": len(calls), "non_finite": len(calls) - len(finite),
               "distinct": len(distinct),
               "shape": "x".join(map(str, calls[0][0].shape)) if calls else None}
        for label, mirror in mirrors.items():
            sweeps, errs, weights = [], [], []
            for H, b, count in distinct.values():
                m, n = H.shape
                ref = np.linalg.lstsq(H.astype(np.float64), b.astype(np.float64),
                                      rcond=float(np.finfo(np.float32).eps) * max(m, n))[0]
                y, swept, _ = mirror(H, b)
                scale = np.abs(ref).max()
                errs.append(float(np.abs(y - ref).max() / scale) if scale > 0 else 0.0)
                sweeps.append(swept)
                weights.append(count)
            row[label] = {"sweeps_mean": float(np.average(sweeps, weights=weights)),
                          "sweeps_min": int(min(sweeps)), "sweeps_max": int(max(sweeps)),
                          "error_median": float(np.median(errs)), "error_max": float(max(errs))}
        out[case] = row
        print(f"suite f32 BFGS+GMRES {case} ({row['shape']}), CPU trajectory: {row['calls']} "
              f"calls ({row['non_finite']} not finite, left out), {row['distinct']} distinct "
              "matrices; " + "; ".join(
                  f"{label} mirror {r['sweeps_mean']:.2f} sweeps a call ({r['sweeps_min']}-"
                  f"{r['sweeps_max']}), error against numpy lstsq median {r['error_median']:.3g}"
                  f" max {r['error_max']:.3g}"
                  for label, r in row.items() if isinstance(r, dict)), flush=True)
    return out


def events_us(fn, reps: int) -> float:
    """us per call of ``fn()`` over ``reps`` calls back to back, CUDA
    events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def replayed_us(fn, reps: int = 20, k1: int = K1, k2: int = K2) -> float:
    """us per call of ``fn()`` replayed from CUDA graphs: ``k1`` and ``k2``
    calls captured in two graphs, each replayed ``reps`` times between
    events, the slope between them."""
    fn()
    torch.cuda.synchronize()
    per_replay = {}
    for k in (k1, k2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(k):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        per_replay[k] = start.elapsed_time(end) * 1e3 / reps
        del graph
    return (per_replay[k2] - per_replay[k1]) / (k2 - k1)


def parent_kernel(root: Path):
    """``fn(H, b)`` launching the least-squares kernel of the tree at
    ``root``: built there by that tree's ``_build`` (a process of its own,
    which imports that tree's package) and called through its
    ``lstsq_launch(elem_bytes, H, b, y, m, n, stream, launches, sweeps)``
    with no sweep count (an entry without that argument ignores the null
    after its last), on contiguous CUDA tensors."""
    code = "from lbfgs_ffnn_torch import _build; print(_build.build('lstsq').path)"
    built = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                           env={**os.environ, "PYTHONPATH": str(root)}, check=True)
    lib = ctypes.CDLL(built.stdout.strip().splitlines()[-1])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstsq_launch.argtypes = [i, p, p, p, i, i, p, p, p]
    lib.lstsq_launch.restype = i
    count = torch.zeros(1, dtype=torch.int32, device="cuda")

    def fn(H, b):
        y = torch.empty(H.shape[1], dtype=H.dtype, device=H.device)
        rc = lib.lstsq_launch(H.element_size(), H.data_ptr(), b.data_ptr(), y.data_ptr(),
                              *H.shape, torch.cuda.current_stream().cuda_stream,
                              count.data_ptr(), None)
        if rc != 0:
            raise RuntimeError(f"the parent's lstsq_launch failed: CUDA error {rc}")
        return y

    return fn


def kernel_table(dev, impls: dict, reps: int = 200) -> dict:
    """Every kernel of ``impls`` (name -> ``fn(H, b)``; ``"kernel"`` is this
    tree's, whose sweeps are counted) at each shape and dtype, in turns (the
    order of ``impls``, then back), with the plain version,
    ``torch.linalg.svd`` and ``torch.linalg.lstsq`` beside them; returns
    ``{"<m>x<n> <dtype>": row}``."""
    from lbfgs_ffnn_torch.ops.cuda_lstsq import hessenberg, jacobi_mirror, launch, lstsq_plain

    table = {}
    for m, n in SHAPES:
        H, b = hessenberg(SEED, m, n)
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            Hd = torch.tensor(H, dtype=dtype, device=dev)
            bd = torch.tensor(b, dtype=dtype, device=dev)
            ref = lstsq_plain(Hd.cpu().double(), bd.cpu().double())
            row = {"plain_us": events_us(lambda: lstsq_plain(Hd, bd), 50),
                   "svd_us": events_us(lambda: torch.linalg.svd(Hd, full_matrices=False), 50),
                   "library_us": events_us(lambda: torch.linalg.lstsq(Hd, bd[:, None]).solution,
                                           50)}
            for label in list(impls) + list(reversed(list(impls))):
                fn = impls[label]
                y = fn(Hd, bd)
                err = float((y.cpu().double() - ref).abs().max() / ref.abs().max())
                r = row.setdefault(label, {"events_us": [], "replayed_us": [], "rel_err": err})
                r["events_us"].append(events_us(lambda: fn(Hd, bd), reps))
                r["replayed_us"].append(replayed_us(lambda: fn(Hd, bd)))
            k = row["kernel"]
            swept = torch.zeros(1, dtype=torch.int32, device=dev)
            launch(Hd, bd, sweeps=swept)
            k["sweeps"] = int(swept)
            k["mirror_sweeps"], k["mirror_rounds"] = jacobi_mirror(H.astype(name),
                                                                   b.astype(name))[1:]
            k["ns_per_round"] = float(np.mean(k["replayed_us"])) * 1e3 / k["mirror_rounds"]
            table[f"{m}x{n} {name}"] = row
            print(f"{m} x {n} {name}: " + "; ".join(
                f"{label} events {np.mean(v['events_us']):.2f} us "
                f"{[round(t, 2) for t in v['events_us']]}, replayed "
                f"{np.mean(v['replayed_us']):.2f} us {[round(t, 2) for t in v['replayed_us']]}, "
                f"rel err {v['rel_err']:.3g}"
                for label, v in row.items() if isinstance(v, dict))
                + f"; kernel {k['sweeps']} sweeps (mirror {k['mirror_sweeps']}, "
                f"{k['mirror_rounds']} rounds, {k['ns_per_round']:.1f} ns a round replayed)"
                + f"; plain {row['plain_us']:.2f} us, torch.linalg.svd {row['svd_us']:.2f} us, "
                f"torch.linalg.lstsq {row['library_us']:.2f} us", flush=True)
    return table


def graded_errors(dev, impls: dict) -> dict:
    """Every kernel's error against the plain version (f64, CPU) on the
    21 x 20 f64 matrices graded by columns and by rows, at each seed of
    :data:`GRADED_SEEDS`."""
    from lbfgs_ffnn_torch.ops.cuda_lstsq import hessenberg, lstsq_plain

    out = {}
    for graded in ("columns", "rows"):
        for seed in GRADED_SEEDS:
            H, b = hessenberg(seed, 21, 20, graded=graded)
            ref = lstsq_plain(torch.tensor(H), torch.tensor(b))
            Hd, bd = torch.tensor(H, device=dev), torch.tensor(b, device=dev)
            row = {label: float((fn(Hd, bd).cpu() - ref).abs().max() / ref.abs().max())
                   for label, fn in impls.items()}
            out[f"{graded} {seed}"] = row
            print(f"graded by {graded}, seed {seed}, 21 x 20 f64, cond {np.linalg.cond(H):.3g}: "
                  "max |kernel - plain f64| / max |plain f64|: "
                  + ", ".join(f"{label} {e:.3g}" for label, e in row.items()), flush=True)
    return out


def suite_cases(dev):
    from lbfgs_ffnn_torch.objectives.analytic import (
        ackley_problem, ackley_start, rastrigin_problem, rastrigin_start, rosenbrock_problem,
        rosenbrock_start,
    )

    f32 = torch.float32
    return {"rosenbrock n=4": (rosenbrock_problem(), rosenbrock_start(4, f32, dev)),
            "ackley n=3": (ackley_problem(), ackley_start(f32, dev)),
            "rastrigin n=500": (rastrigin_problem(), rastrigin_start(500, f32, dev))}


def suite_rows(dev, iters: int = SUITE_ITERS) -> dict:
    """The f32 suite's BFGS+GMRES rows through the imported package's
    kernel; per case: wall s, capture s, launches, iterations, final |g|."""
    from lbfgs_ffnn_torch.experiments.run_deterministic_suite import TOL
    from lbfgs_ffnn_torch.ops.cuda_lstsq import lstsq_min_norm
    from lbfgs_ffnn_torch.utils import profiling

    tb = importlib.import_module("lbfgs_ffnn_torch.solvers.bfgs")
    opts = tb.BFGSOptions(max_iters=iters, tol=TOL, linear_solver="gmres")
    count = lstsq_min_norm.LAUNCHES
    rows = {}
    for case, (problem, x0) in suite_cases(dev).items():
        count.counter(dev)
        count.reset()
        c0 = profiling.counter("captures")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tb.bfgs(problem, x0, opts=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        capture = (profiling.last("resident.capture").seconds
                   if profiling.counter("captures") > c0 else 0.0)
        rows[case] = {"wall_s": wall, "capture_s": capture, "launches": int(count),
                      "n_iters": res.n_iters, "final_gnorm": float(res.final_gnorm)}
    return rows


def cycle_share(dev, budgets=SHARE_CYCLES, iters: int = 3) -> dict:
    """The kernel's share of a GMRES cycle's device time in each f32 suite
    case: the solve's body run eagerly for ``iters`` BFGS iterations (the
    first, on B = I, takes one cycle) at each restart-cycle budget,
    profiled (kernels only, copies left out), the share the slope between
    the budgets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tb = importlib.import_module("lbfgs_ffnn_torch.solvers.bfgs")
    out = {}
    for case, (problem, x0) in suite_cases(dev).items():
        got = {}
        for c in budgets:
            opts = tb.BFGSOptions(max_iters=iters, tol=1e-12, linear_solver="gmres",
                                  solver_max_iters=c)
            tb._bfgs_resident_eager(problem, x0, opts=opts)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tb._bfgs_resident_eager(problem, x0, opts=opts)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and "Memcpy" not in e.key and "Memset" not in e.key]
            busy = sum(e.self_device_time_total for e in ev)
            kern = sum(e.self_device_time_total for e in ev if "lstsq_min_norm_kernel" in e.key)
            got[c] = (busy, kern)
        (b1, k1), (b2, k2) = got[budgets[0]], got[budgets[1]]
        cycles = budgets[1] - budgets[0]
        out[case] = {"share": (k2 - k1) / (b2 - b1) if b2 > b1 else float("nan"),
                     "cycle_us": (b2 - b1) / cycles, "kernel_us": (k2 - k1) / cycles}
    return out


def suite_in(root: Path, label: str) -> dict:
    """:func:`suite_rows` and :func:`cycle_share` of the tree at ``root``,
    in a process of its own that imports that tree's package."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "suite.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--suite-here",
                        "--json", str(out)], env={**os.environ, "PYTHONPATH": str(root)},
                       check=True)
        got = json.loads(out.read_text())
    for case, r in got["rows"].items():
        s = got["share"][case]
        print(f"suite f32 BFGS+GMRES {case} via {label}: wall {r['wall_s']:.3f} s (capture "
              f"{r['capture_s']:.3f} s), {r['n_iters']} iterations, {r['launches']} launches, "
              f"|g| {r['final_gnorm']:.3g}; a GMRES cycle {s['cycle_us']:.1f} us of kernels, "
              f"the least-squares kernel {s['kernel_us']:.1f} us of it ({s['share'] * 100:.1f}%; "
              f"profiler, eager body, {SHARE_CYCLES} cycles)", flush=True)
    return got


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None, metavar="DIR",
                        help="an unpacked earlier commit whose kernel is timed beside this one")
    parser.add_argument("--suite", action="store_true",
                        help="also the f32 suite's BFGS+GMRES rows and the cycle share")
    parser.add_argument("--suite-here", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--reps", type=int, default=200, help="calls per events timing")
    parser.add_argument("--json", default=None, metavar="FILE", help="write the results here")
    parser.add_argument("--mirror", action="store_true", help="the mirror only (no card)")
    parser.add_argument("--suite-matrices", action="store_true",
                        help="with --mirror: the mirrors on the f32 suite's GMRES matrices (CPU)")
    args = parser.parse_args(argv)
    if args.suite_matrices and not args.mirror:
        parser.error("--suite-matrices goes with --mirror")
    if args.suite_here:  # the child of suite_in: this process's package only
        dev = torch.device("cuda")
        results = {"rows": suite_rows(dev), "share": cycle_share(dev)}
    else:
        parent = None if args.parent is None else Path(args.parent).resolve()
        results = {"mirror": mirror_report(parent)}
        if args.suite_matrices:
            results["suite_matrices"] = suite_mirror_report(parent)
    if not (args.mirror or args.suite_here):
        if not torch.cuda.is_available():
            raise SystemExit("lstsq_study needs an NVIDIA GPU (or --mirror)")
        from lbfgs_ffnn_torch.ops.cuda_lstsq import lstsq_min_norm

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print(smi, flush=True)
        results["device"] = smi
        dev = torch.device("cuda")
        impls = {"kernel": lstsq_min_norm}
        if args.parent is not None:
            impls = {"parent": parent_kernel(Path(args.parent).resolve()), **impls}
        results["kernels"] = kernel_table(dev, impls, reps=args.reps)
        results["graded"] = graded_errors(dev, impls)
        if args.suite:
            here = Path(__file__).resolve().parents[2]
            trees = [("kernel", here)]
            if args.parent is not None:
                trees = [("parent", Path(args.parent).resolve())] + trees
            results["suite"] = {}
            for label, root in trees + trees[::-1]:
                results["suite"].setdefault(label, []).append(suite_in(root, label))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1, default=str))
    return results


if __name__ == "__main__":
    main()
