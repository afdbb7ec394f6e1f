"""Headline benchmark of the port: MNIST 784-128-10 full-batch L-BFGS m=10,
ms/iteration, on one NVIDIA GPU.

The port of the repository's root ``bench.py`` (the JAX package's bench,
which stays as it is): the same model (784-128-10 ReLU/linear, 101,770
parameters), loss (0.5*||out-y||^2/N), solver (L-BFGS m=10, the reference
CUDA backend's Armijo policy, 20 trials, tol 1e-12, 1000 iterations, f32
with TF32 off) and training-set size (N = 60,000), against the reference
CUDA backend's 7.20 ms/iter (BASELINE.md). The solve is ``lbfgs`` on CUDA
tensors: the resident driver, each iteration a replayed CUDA graph.

    python -m lbfgs_ffnn_torch.experiments.bench                 # on the card
    python -m lbfgs_ffnn_torch.experiments.bench --device cpu    # the CPU test
    BENCH_QUICK=1 python -m lbfgs_ffnn_torch.experiments.bench   # N=6000, 20 iters

Prints exactly one JSON line on stdout,
  {"metric": ..., "value": <ms/iter>, "unit": "ms/iter", "vs_baseline": 7.20 / value};
everything else goes to stderr. Timing: one warm-up solve (init seed 123;
on the card it captures the iteration), then three timed solves from init
seeds 124-126, CUDA events around each on the card (the host clock on the
CPU); a row's ms/iter is the median of the three.

The headline, as the root bench chooses it: five configurations of the
solve, built as the root bench builds them (``bench.py:102-127``): f32;
bf16-traffic (bf16 input copy in the prefix and dW1 GEMMs, bf16 carried
prefix, bf16 ring); u8-traffic (the uint8 input copy in every first-layer
GEMM, bf16 prefix and ring); u8-warm (u8-traffic with the warm-started
line search, growth 8); u8-warm-nr (u8-warm without the prefix refresh).
Each row's final loss is recomputed exactly with the plain f32 objective,
and a row passes the root bench's parity gate (``bench.py:150-159``) when
the median of those losses over the seeds is within 2% of f32's (+1e-6)
and the median train accuracy within 0.3 points. The headline is the
fastest row that passes, f32 when none is faster; the stderr line
``headline config: <row>`` names it.

The data are seeded labels (``default_rng(123)``) with
``synthetic_images_for_labels``, as ``chip_smoke.py`` makes them, unless
``--mnist-root DIR`` names MNIST IDX files; nothing is downloaded.

Supplementary rows on stderr: the bf16 ring alone with the same gate (a
reading, not a headline candidate), the deep 784-256-128-64-10 m=100 rows
on seeded Fashion labels (f32, the bf16 ring, and the root bench's "u8
traffic stack" and "u8 + warm alpha", each gated against f32), the S-LBFGS
row (the root bench's: the first 5,000 samples, b=256,
b_H=128, M=10, L=10, lam=1e-4, step 0.02, tol 1e-12, 100 epochs, 4 under
BENCH_QUICK; ms/epoch per init seed 124-126 and their median, against the
reference CPU's 214.7 ms/epoch; on the card each epoch replayed from its
CUDA graphs), and the two-loop's µs per call at m=10 and m=100 for n=101,770 (the
dispatch's kernel and the plain loop, from the slope over two call counts).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from lbfgs_ffnn_torch.data import datasets
from lbfgs_ffnn_torch.objectives.mlp import (
    evaluate, mlp_batch_problem, mlp_init, mlp_problem, mlp_spec,
)
from lbfgs_ffnn_torch.ops.cuda_two_loop import kernel_dispatch, two_loop_cuda
from lbfgs_ffnn_torch.ops.two_loop import empty_history_state, ring_push, two_loop
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs
from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions, slbfgs

METRIC = "MNIST 784-128-10 full-batch L-BFGS m=10 step time"
BASELINE_MS = 7.20  # the reference CUDA backend's ms/iter (BASELINE.md)
DIMS, ACTS = [784, 128, 10], ["relu", "linear"]
DEEP_DIMS, DEEP_ACTS = [784, 256, 128, 64, 10], ["relu", "relu", "relu", "linear"]
WARM_SEED, SEEDS = 123, (124, 125, 126)
DEEP_SEEDS = (124, 125)
LOSS_GATE, ACC_GATE = 0.02, 0.3  # the root bench's parity gate (bench.py:150-159)
SLBFGS_REF_MS = 214.7  # the reference CPU's S-LBFGS ms/epoch at N=5000, b=256 (bench.py:162)

HEADLINE_ROWS = ("f32", "bf16-traffic", "u8-traffic", "u8-warm", "u8-warm-nr")


class Sizes(NamedTuple):
    """The bench's sizes: full, ``BENCH_QUICK=1``, or a test's."""

    n_train: int
    iters: int
    two_loop_n: int
    calls: tuple[int, int]  # call counts of the two-loop slope
    sl_n: int = 5_000       # S-LBFGS samples (the first of the data)
    sl_epochs: int = 100


FULL = Sizes(60_000, 1000, 101_770, (50, 350))
QUICK = Sizes(6_000, 20, 101_770, (25, 125), sl_epochs=4)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _timer(dev: torch.device):
    """``timed(fn) -> (result, seconds)``: CUDA events on the card, the host
    clock on the CPU; both end with the work done."""
    def timed(fn):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    return timed


def _mnist(n: int, mnist_root: str | None):
    if mnist_root is not None:
        ds = datasets.load_mnist(mnist_root, train_size=n, test_size=0)
        what = "synthetic" if ds.synthetic_images else "real"
        return ds.train_x, ds.train_y, f"MNIST IDX files in {mnist_root} ({what} images)"
    labels = np.random.default_rng(123).integers(0, 10, n)
    x = datasets.synthetic_images_for_labels(labels)
    return (x, np.eye(10, dtype=np.float32)[labels],
            "seeded labels (default_rng(123)) + synthetic_images_for_labels, no image files")


def _fashion(n: int):
    """Seeded Fashion labels and the loader's synthetic images for them, as
    chip_smoke.py's deep phase writes and loads them."""
    labels = np.random.default_rng(123).integers(0, 10, n, dtype=np.uint8)
    x = datasets.synthetic_images_for_labels(labels, seed=456, noise_seed=0)
    return x, np.eye(10, dtype=np.float32)[labels]


def variants(spec, opts):
    """The root bench's headline configurations (``bench.py:102-127``):
    ``{row: (problem, options)}`` in :data:`HEADLINE_ROWS` order."""
    opts_bf16 = opts._replace(pair_dtype="bfloat16", prefix_dtype="bfloat16")
    prob_u8 = mlp_problem(spec, grad_input_dtype="uint8", line_input_dtype="uint8",
                          fun_input_dtype="uint8")
    opts_warm = opts_bf16._replace(ls_alpha_init="warm", ls_alpha_growth=8.0)
    return {"f32": (mlp_problem(spec), opts),
            "bf16-traffic": (mlp_problem(spec, grad_input_dtype="bfloat16",
                                         line_input_dtype="bfloat16"), opts_bf16),
            "u8-traffic": (prob_u8, opts_bf16),
            "u8-warm": (prob_u8, opts_warm),
            "u8-warm-nr": (prob_u8, opts_warm._replace(prefix_refresh=0))}


def deep_variants(spec, opts):
    """The deep rows: f32 and the bf16 ring, and the root bench's "u8
    traffic stack" and "u8 + warm alpha" (``bench.py:202-216``)."""
    prob_u8 = mlp_problem(spec, grad_input_dtype="uint8", line_input_dtype="uint8")
    opts_u8 = opts._replace(pair_dtype="bfloat16", prefix_dtype="bfloat16")
    return {"f32": (mlp_problem(spec), opts),
            "bf16 ring": (mlp_problem(spec), opts._replace(pair_dtype="bfloat16")),
            "u8 traffic stack": (prob_u8, opts_u8),
            "u8 + warm alpha": (prob_u8, opts_u8._replace(ls_alpha_init="warm",
                                                          ls_alpha_growth=8.0))}


def _solves(spec, problem, x, y, opts, seeds, timed, dev):
    """One warm-up solve (seed 123), then one per seed: rows of (seed,
    ms/iter, n_iters, n_fevals, exact final loss, train accuracy); the
    exact loss is the plain f32 objective's at the returned iterate."""
    exact = mlp_problem(spec)
    aux = (x, y)

    def w0(seed):
        return mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32, device=dev)

    lbfgs(problem, w0(WARM_SEED), aux, opts)
    rows = []
    for seed in seeds:
        res, seconds = timed(lambda: lbfgs(problem, w0(seed), aux, opts))
        n = max(res.n_iters, 1)
        with torch.no_grad():
            loss = float(exact.fun(res.x, aux))
        rows.append((seed, seconds * 1e3 / n, res.n_iters, res.n_fevals, loss,
                     evaluate(spec, res.x, x, y)["accuracy"]))
    return rows


def gate(rows, ref_rows) -> tuple[bool, str]:
    """The root bench's parity gate on the medians over the seeds: exact
    final loss within 2% of the reference's (+1e-6), train accuracy within
    0.3 points. Returns (passed, the line's numbers)."""
    loss = statistics.median(r[4] for r in rows)
    acc = statistics.median(r[5] for r in rows)
    loss_f = statistics.median(r[4] for r in ref_rows)
    acc_f = statistics.median(r[5] for r in ref_rows)
    ok = loss <= loss_f * (1 + LOSS_GATE) + 1e-6 and acc >= acc_f - ACC_GATE
    return ok, (f"loss {loss:.6g} vs {loss_f:.6g} ({(loss - loss_f) / loss_f * 100:+.3f}%), "
                f"acc {acc:.2f} vs {acc_f:.2f}")


def choose_headline(rows: dict) -> tuple[str, float]:
    """The root bench's rule: the fastest row (median ms/iter) among f32 and
    the rows that pass the gate against f32; f32 wins ties."""
    chosen, best = "f32", statistics.median(r[1] for r in rows["f32"])
    for tag in HEADLINE_ROWS[1:]:
        if tag not in rows:
            continue
        ms = statistics.median(r[1] for r in rows[tag])
        if gate(rows[tag], rows["f32"])[0] and ms < best:
            chosen, best = tag, ms
    return chosen, best


def _report(tag: str, n_train: int, rows) -> None:
    ms = [r[1] for r in rows]
    log(f"L-BFGS {tag} N={n_train}: ms/iter per seed "
        + ", ".join(f"{r[0]}: {r[1]:.4f}" for r in rows)
        + f"; median {statistics.median(ms):.4f}, min {min(ms):.4f}; "
        + "; ".join(f"seed {r[0]}: {r[2]} iters, {(r[3] - 1) / max(r[2], 1) - 1:.3f} "
                    f"trials/iter, exact f32 final loss {r[4]:.6g}, train acc {r[5]:.2f}%"
                    for r in rows))


def _slbfgs_row(x, y, sizes: Sizes, timed, dev) -> None:
    """The root bench's S-LBFGS row: one warm-up solve (init seed 123; on
    the card it captures the epoch), then one per seed, ms/epoch each."""
    n = min(sizes.sl_n, x.shape[0])
    xs, ys = x[:n], y[:n]
    spec = mlp_spec(DIMS, ACTS)
    problem = mlp_batch_problem(spec, lam=1e-4)
    opts = SLBFGSOptions(epochs=sizes.sl_epochs, tol=1e-12, history=10, L=10, batch_size=256,
                         hvp_batch_size=128, step_size=0.02)

    def w0(seed):
        return mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32, device=dev)

    slbfgs(problem, w0(WARM_SEED), xs, ys, opts)
    rows = []
    for seed in SEEDS:
        res, seconds = timed(lambda: slbfgs(problem, w0(seed), xs, ys, opts))
        rows.append((seed, seconds * 1e3 / max(res.n_iters, 1), res.n_iters,
                     float(res.final_loss), res.n_host_syncs))
    log(f"S-LBFGS N={n} b=256 ms/epoch per seed "
        + ", ".join(f"{r[0]}: {r[1]:.4f}" for r in rows)
        + f"; median {statistics.median(r[1] for r in rows):.4f} (reference CPU: "
        f"{SLBFGS_REF_MS} ms/epoch); "
        + "; ".join(f"seed {r[0]}: {r[2]} epochs, final full loss {r[3]:.6g}, {r[4]} host syncs"
                    for r in rows))


def _lean_trial_us(problem, spec, x, y, dev, reps: int = 50) -> float:
    """Time of one lean Armijo trial (the carried-prefix restriction's
    loss at one alpha) at the headline's size, µs, averaged over ``reps``;
    on the card the trial is captured in a CUDA graph and replayed, so the
    host's launches are not in it."""
    w = mlp_init(spec, torch.Generator().manual_seed(WARM_SEED), torch.float32, device=dev)
    p = -torch.ones_like(w) * 1e-3
    lp = problem.line_prefix
    with torch.no_grad():
        va = lp.restrict(lp.init(w, (x, y)), lp.direction(p, (x, y)), w, p, (x, y))
        alpha = torch.tensor(0.5, device=dev)
        va(alpha)
        trial = lambda: va(alpha)  # noqa: E731
        if dev.type == "cuda":
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                va(alpha)
            graph.replay()
            trial = graph.replay
        _, seconds = _timer(dev)(lambda: [trial() for _ in range(reps)])
    return seconds * 1e6 / reps


def _two_loop_us(fn, m: int, n: int, calls: tuple[int, int], dev) -> float:
    """µs per call of ``fn`` on a full m-pair ring of n parameters: the
    slope between two chained call counts (each call's input is the last
    output, so the calls run in order), which cancels fixed costs."""
    rng = np.random.default_rng(0)
    hist = empty_history_state(m, n, torch.float32, device=dev)
    for _ in range(m):
        s = torch.tensor(rng.normal(size=n), dtype=torch.float32, device=dev)
        yv = torch.tensor(rng.normal(size=n), dtype=torch.float32, device=dev) + 0.5 * s
        hist = ring_push(hist, s, yv, 1.0 / torch.dot(yv, s), torch.tensor(True, device=dev))
    timed = _timer(dev)

    def chain(k):
        acc = torch.tensor(rng.normal(size=n), dtype=torch.float32, device=dev)
        for _ in range(k):
            acc = acc + 1e-6 * fn(acc, hist)
        return acc

    chain(2)
    t = {k: min(timed(lambda k=k: chain(k))[1] for _ in range(2)) for k in calls}
    return (t[calls[1]] - t[calls[0]]) / (calls[1] - calls[0]) * 1e6


def main(argv=None, sizes: Sizes | None = None) -> dict:
    """Run the bench; ``sizes`` (a test's hook) overrides the full or
    ``BENCH_QUICK=1`` sizes. Returns the contract line's fields."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--mnist-root", default=None,
                        help="directory of the MNIST IDX files; without it the data are "
                             "seeded labels with synthetic images")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on an NVIDIA GPU and torch.cuda.is_available() is "
                           "false; pass --device cpu for the CPU test")
    sizes = sizes or (QUICK if os.environ.get("BENCH_QUICK") else FULL)
    timed = _timer(dev)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}; TF32 off in every solve")
    else:
        log(f"device: cpu (a CPU run times PyTorch's CPU kernels; no device metric); torch "
            f"{torch.__version__}")

    x_np, y_np, source = _mnist(sizes.n_train, args.mnist_root)
    log(f"data: {source}; N={sizes.n_train}, {sizes.iters} iterations per solve")
    x = torch.tensor(x_np, device=dev)
    y = torch.tensor(y_np, device=dev)
    opts = LBFGSOptions(max_iters=sizes.iters, tol=1e-12, m=10, line_search="armijo",
                        ls_max_iters=20)
    spec = mlp_spec(DIMS, ACTS)
    rows = {}
    rows_of = dict(variants(spec, opts))
    rows_of["bf16 ring"] = (mlp_problem(spec), opts._replace(pair_dtype="bfloat16"))
    for tag, (problem, o) in rows_of.items():
        rows[tag] = _solves(spec, problem, x, y, o, SEEDS, timed, dev)
        _report(f"m=10 [{tag}]", sizes.n_train, rows[tag])
    for tag in HEADLINE_ROWS[1:] + ("bf16 ring",):
        ok, numbers = gate(rows[tag], rows["f32"])
        log(f"{tag} parity gate (exact f32 final loss within 2%, train accuracy within 0.3 "
            f"points, medians over seeds {list(SEEDS)}) {'PASSED' if ok else 'FAILED'}: "
            f"{numbers}" + ("; a reading, not a headline candidate" if tag == "bf16 ring"
                            else ""))
    log(f"lean Armijo trial (carried-prefix restriction, one alpha) at N={sizes.n_train}: "
        f"{_lean_trial_us(rows_of['f32'][0], spec, x, y, dev):.1f} us")
    chosen, ms_per_iter = choose_headline(rows)
    log(f"headline config: {chosen}; median {ms_per_iter:.4f} ms/iter over seeds "
        f"{list(SEEDS)}")

    xd_np, yd_np = _fashion(sizes.n_train)
    xd, yd = torch.tensor(xd_np, device=dev), torch.tensor(yd_np, device=dev)
    log("deep data: seeded Fashion labels (default_rng(123)) + the loader's synthetic images "
        "(prototype seed 456), no image files")
    dspec = mlp_spec(DEEP_DIMS, DEEP_ACTS)
    deep = {}
    for tag, (problem, o) in deep_variants(dspec, opts._replace(m=100)).items():
        deep[tag] = _solves(dspec, problem, xd, yd, o, DEEP_SEEDS, timed, dev)
        _report(f"deep 784-256-128-64-10 m=100 [{tag}] (reference GPU: 19.4 ms/iter)",
                sizes.n_train, deep[tag])
        if tag != "f32":
            ok, numbers = gate(deep[tag], deep["f32"])
            log(f"deep [{tag}] parity gate (medians over seeds {list(DEEP_SEEDS)}) "
                f"{'PASSED' if ok else 'FAILED'}: {numbers}")

    _slbfgs_row(x, y, sizes, timed, dev)

    n = sizes.two_loop_n
    for m in (10, 100):
        n_pad = -(-n // 128) * 128
        impl = (kernel_dispatch(n_pad, m, torch.float32)[0] if dev.type == "cuda"
                else "plain loop (CPU tensors)")
        us_k = _two_loop_us(two_loop_cuda, m, n, sizes.calls, dev)
        us_p = _two_loop_us(two_loop, m, n, sizes.calls, dev)
        log(f"two-loop m={m} n={n}: dispatch ({impl}) {us_k:.1f} us | plain loop {us_p:.1f} us "
            f"per call (slope over {sizes.calls[0]} and {sizes.calls[1]} chained calls)")

    out = {"metric": METRIC, "value": round(ms_per_iter, 4), "unit": "ms/iter",
           "vs_baseline": round(BASELINE_MS / ms_per_iter, 3)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
