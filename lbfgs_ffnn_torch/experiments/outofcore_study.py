"""Out-of-core study on the card: what chip_smoke.py's ``outofcore`` phase
does not vary.

On the seeded MNIST-shaped data (60,000 x 784 f32) in a pinned
``ChunkStore``:

1. **Capture**: a sweep of torch's pinned ``copy_`` chunk fetches inside a
   captured IF node (``ops.control.guard``) against the same sweep run
   eagerly, bitwise.
2. **Copy rates**: one 256 MiB pinned copy; a sweep's chunk copies alone,
   replayed from a CUDA graph; the prefix sweep (copies and the first-layer
   GEMM per chunk), replayed; so a sweep's time splits into copies and the
   compute between them.
3. **The gather kernel** at b = 256 and 128: launched from the host and
   replayed from a graph, CUDA events.
4. **S-LBFGS rounding spread** (N = 60,000, b = 256, b_H = 128, L = 10, 3
   epochs, lambda 1e-4, step 0.02, the same seed): the per-epoch losses in
   memory through K1 ("cuda"), the plain and the compact two-loops, and out
   of core at ``chunk_rows`` 8192, 4096 and 60,000, each relative to the
   in-memory K1 run: how far f32 summation order alone moves the
   trajectory.

Usage: python -m lbfgs_ffnn_torch.experiments.outofcore_study [--epochs 3]
"""

from __future__ import annotations

import argparse
import importlib
import sys

import numpy as np
import torch

from lbfgs_ffnn_torch.data.outofcore import ChunkStore, outofcore_mlp_problem
from lbfgs_ffnn_torch.experiments.kill_resume import mnist_like
from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
from lbfgs_ffnn_torch.ops.control import Graph, capture, guard
from lbfgs_ffnn_torch.ops.cuda_gather import gather_rows

N, ROWS, SEED = 60_000, 8192, 123


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_of(fn) -> torch.cuda.CUDAGraph:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("outofcore_study needs a card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    x_np, y_np = mnist_like(N)
    store = ChunkStore(x_np, y_np, ROWS)
    spec = mlp_spec([784, 128, 10], ["relu", "linear"])
    w0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)

    # 1. chunk copies captured inside an IF node
    flag = torch.ones((), dtype=torch.bool, device=dev)
    acc = torch.zeros(784, device=dev)

    def sweep_sum():
        for c in range(store.num_chunks):
            acc.add_(store.fetch_chunk(c)[0].sum(0))

    sweep_sum()
    eager = acc.clone()
    acc.zero_()
    graph = Graph()
    with capture(graph):
        with guard(flag):
            sweep_sum()
    graph.replay()
    torch.cuda.synchronize()
    print(f"1. a sweep's pinned copy_ fetches captured inside an IF node equal the eager "
          f"sweep bitwise: {torch.equal(acc, eager)}", flush=True)

    # 2. copy rates
    big = torch.empty(64 << 20, dtype=torch.float32, pin_memory=True)
    dbig = torch.empty_like(big, device=dev)
    ms = _events_ms(lambda: dbig.copy_(big, non_blocking=True), 5)
    sweep_bytes = store.num_chunks * ROWS * (784 + 10) * 4
    copies = _graph_of(lambda: [store.fetch_chunk(c) for c in range(store.num_chunks)])
    copies_ms = _events_ms(copies.replay, 20)
    prefix = outofcore_mlp_problem(spec, store).line_prefix
    with torch.no_grad():
        prefix_graph = _graph_of(lambda: prefix.init(w0, ()))
    prefix_ms = _events_ms(prefix_graph.replay, 20)
    print(f"2. a 256 MiB pinned copy: {big.numel() * 4 / (ms * 1e-3) / 1e9:.2f} GB/s; a sweep's "
          f"{store.num_chunks} chunk copies ({sweep_bytes / 1e6:.1f} MB) replayed: "
          f"{copies_ms:.4f} ms, {sweep_bytes / (copies_ms * 1e-3) / 1e9:.2f} GB/s; the prefix "
          f"sweep (copies and the first-layer GEMMs) replayed: {prefix_ms:.4f} ms", flush=True)
    del big, dbig, copies, prefix_graph

    # 3. the gather kernel
    idx = torch.tensor(np.random.default_rng(0).integers(0, N, 256), device=dev)
    for b in (256, 128):
        host_ms = _events_ms(lambda: gather_rows(store.x, store.y, idx[:b]), 200)
        g = _graph_of(lambda: gather_rows(store.x, store.y, idx[:b]))
        print(f"3. gather b={b}: {host_ms * 1e3:.2f} us/call launched from the host, "
              f"{_events_ms(g.replay, 200) * 1e3:.2f} us replayed from a graph", flush=True)

    # 4. S-LBFGS rounding spread
    tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")
    bp = mlp_batch_problem(spec, lam=1e-4)
    opts = tsl.SLBFGSOptions(epochs=args.epochs, tol=1e-12, history=10, L=10, batch_size=256,
                             hvp_batch_size=128, step_size=0.02)
    x, y = torch.tensor(x_np, device=dev), torch.tensor(y_np, device=dev)
    runs = {f"in memory, {impl}": tsl.slbfgs(bp, w0, x, y, opts._replace(two_loop_impl=impl))
            for impl in ("cuda", "plain", "compact")}
    for rows in (ROWS, 4096, N):
        runs[f"out of core, chunk_rows {rows}"] = tsl.slbfgs(bp, w0, None, None, opts,
                                                             store=ChunkStore(x_np, y_np, rows))
    ref = runs["in memory, cuda"].loss_history.cpu().numpy()
    for name, res in runs.items():
        lh = res.loss_history.cpu().numpy()
        print(f"4. S-LBFGS {name}: per-epoch losses {lh.tolist()}, relative to in memory through "
              f"K1 {(np.abs(lh - ref) / ref).tolist()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
