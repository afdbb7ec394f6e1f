"""Where a stage of the blocked two-loop kernel (K3) spends its time.

Builds five variants of ``csrc/two_loop.cu`` beside the real one and times
K3 in each, with and without its L2 prefetch, on full wrapped m=50 rings at
n = 2M (f32 and bf16) and 4M (f32):

  * ``full``:    the kernel as it is;
  * ``no-sync``: ``grid.sync()`` in the grid reduction replaced by a block
    barrier, so the sweeps and block reductions run without waiting for the
    grid (the result is wrong; only its time is read);
  * ``no-sweep``: the stage loop given no chunks, so only the grid
    reductions and the prefetches run;
  * ``at-reduction``: the prefetch issued right before each stage's grid
    reduction (rows up to 2t + d of the sequence, each once) instead of at
    each sweep's start, so that its traffic would fill the barrier; and
    ``at-reduction no-sync``, the same without the grid barrier.

Each variant is also built with ``prefetch_l2`` emptied (``off``), so the
prefetch's own effect shows at every distance. Times are CUDA events around
each call with the L2 flushed before it, min of two runs in turns, printed
per call and per stage (time / 2 count). Runs only on an NVIDIA GPU with
nvcc; the variants are compiled in parallel into ``build/`` (git-ignored).

Usage:
  python -m lbfgs_ffnn_torch.experiments.blocked_stage_study
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from lbfgs_ffnn_torch import _build
from lbfgs_ffnn_torch.ops import cuda_two_loop as ctl
from lbfgs_ffnn_torch.ops.two_loop import empty_history_state, ring_push

# Text the variants replace in csrc/two_loop.cu.
PREFETCH = '''  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n"
               ::"l"(__cvta_generic_to_global(gmem)), "r"(bytes) : "memory");'''
SYNC = "  grid.sync();  // also orders"
NO_SYNC = (SYNC, "  __syncthreads();  // also orders")
STAGES = "run_stages<T>(p, q, nchunk, head, count, grid, row, [&](int u) { prefetch(u + d); });"
REDUCE = "      grid_sum_wide<{nv}>(vals, p, pbuf, grid, red, bcast);"
AT_REDUCTION = [
    ("    starts(2 * t);\n    float dot;", "    float dot;"),
    ("    starts(2 * t + 1);\n", ""),
    *[(REDUCE.format(nv=nv), "      starts(2 * t);\n" + REDUCE.format(nv=nv)) for nv in (3, 1)],
    ("  for (int u = 0; u < d; ++u) prefetch(u);",
     "  int next = 2;  // rows 0 and 1 are read at once by stage 0's sweep"),
    (STAGES, "run_stages<T>(p, q, nchunk, head, count, grid, row, [&](int u) "
             "{ for (; next < nrows && next <= u + d; ++next) prefetch(next); });"),
]
VARIANTS = {
    "full": [],
    "no-sync": [NO_SYNC],
    "no-sweep": [(STAGES, STAGES.replace("q, nchunk,", "q, 0,"))],
    "at-reduction": AT_REDUCTION,
    "at-reduction no-sync": AT_REDUCTION + [NO_SYNC],
}
RINGS = ((2_000_000, torch.float32), (2_000_000, torch.bfloat16), (4_000_000, torch.float32))
M = 50


def build_variants() -> dict[str, ctypes.CDLL]:
    """Compile every variant (with and without the prefetch) at once."""
    src = (_build.CSRC / "two_loop.cu").read_text()
    for old, _ in [(PREFETCH, None), *sum(VARIANTS.values(), [])]:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/two_loop.cu no longer holds {old.strip()!r} once")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        for pf in ("on", "off"):
            text = src
            for old, new in edits + ([(PREFETCH, "")] if pf == "off" else []):
                text = text.replace(old, new)
            cu = _build.BUILD_DIR / f"study_{name}_{pf}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            procs[f"{name} prefetch {pf}"] = (so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {label} variant:\n{err}")
        libs[label] = ctypes.CDLL(str(so))
    return libs


def wrapped_ring(n: int, pair_dtype, dev, seed: int = 6):
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = empty_history_state(M, n, torch.float32, pair_dtype, device=dev)
    for _ in range(M + 3):
        s = torch.randn(n, generator=gen, device=dev)
        y = torch.randn(n, generator=gen, device=dev) + 0.5 * s
        hist = ring_push(hist, s, y, 1.0 / torch.dot(y, s), torch.dot(y, s) > 1e-3)
    return hist, torch.randn(n, generator=gen, device=dev)


def cold_us(fn, flush, reps: int) -> float:
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps * 1e3


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--distances", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("blocked_stage_study needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, device=dev)  # 256 MB > the 50 MB L2
    real = _build.load("two_loop")
    try:
        for n, pd in RINGS:
            hist, v = wrapped_ring(n, pd, dev)
            times = {}
            for labels in (list(libs), list(libs)[::-1]):  # in turns, min of two
                for label in labels:
                    _build._LOADED["two_loop"] = libs[label]
                    ctl._CONFIGS.clear()  # a variant may differ in registers, so in grid
                    for d in args.distances:
                        fn = lambda d=d: ctl.launch(ctl.BLOCKED, v, hist, prefetch=d)
                        fn()
                        times.setdefault((label, d), []).append(cold_us(fn, flush, args.reps))
            grid = ctl._config(ctl._lib(), dev.index or 0, ctl._KIND[ctl.BLOCKED], pd.itemsize, 1,
                               hist.S.shape[1], M)
            name = "f32" if pd == torch.float32 else "bf16"
            print(f"m={M} n={n} {name}, grid/slice/smem {grid}, wrapped ring, {args.reps} calls "
                  "per timing, L2 flushed:", flush=True)
            for (label, d), ts in times.items():
                print(f"  {label:22s} d={d}: {min(ts):8.1f} us per call, "
                      f"{min(ts) / (2 * M):6.2f} us per stage; runs "
                      f"{[round(t, 1) for t in ts]}", flush=True)
            del hist, v
    finally:
        _build._LOADED["two_loop"] = real
        ctl._CONFIGS.clear()


if __name__ == "__main__":
    main()
