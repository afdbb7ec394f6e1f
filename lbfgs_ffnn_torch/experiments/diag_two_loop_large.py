"""Two-loop direction cost at large n (slope protocol).

Counterpart of the JAX package's ``scripts/diag_two_loop_large.py``: the
time of one L-BFGS direction r = H v on a full ring of m pairs at n in the
millions, where the dispatch takes the blocked kernel (K3). Every number is
a slope, (t_K2 - t_K1) / (K2 - K1) over a chain of K data-dependent
directions (each direction feeds the next vector), so the fixed cost of a
chain differences out; each t is the minimum over ``--reps`` runs, timed
with CUDA events on a CUDA device (the host clock on the CPU). The
axpy-only row calibrates the chain's own cost (~0).

Bounds printed for context, at the HBM rate of an H100 SXM (3.35 TB/s),
for an f32 ring of m pairs of n floats:
  * 4mn: every history row read once per pass (s and y, both passes);
  * 8mn: plus q's read and write per stage, with one stage's axpy fused
    into the next stage's dot (the best a q-in-HBM schedule can do);
  * 10mn: unfused q in HBM, a 2n dot sweep and a 3n axpy sweep per stage.
K3 keeps q in shared memory, so 4mn is its floor; 2mn (history read once)
is the least any schedule could move, reachable only from a cache that
holds the ring.

Usage:
  python -m lbfgs_ffnn_torch.experiments.diag_two_loop_large --n 4000000 --m 50
  python -m lbfgs_ffnn_torch.experiments.diag_two_loop_large --device cpu --n 300000 --k 2 4
"""

from __future__ import annotations

import argparse
import time

import torch

from lbfgs_ffnn_torch.ops.cuda_two_loop import kernel_dispatch, two_loop_cuda
from lbfgs_ffnn_torch.ops.two_loop import empty_history_state, ring_push, two_loop

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def make_hist(m: int, n: int, device, seed: int = 1):
    """A full f32 ring of m seeded pairs, y = s + 0.1 noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hist = empty_history_state(m, n, torch.float32, device=device)
    for _ in range(m):
        s = torch.randn(n, generator=gen, device=device)
        y = s + 0.1 * torch.randn(n, generator=gen, device=device)
        hist = ring_push(hist, s, y, 1.0 / torch.dot(y, s), torch.tensor(True, device=device))
    return hist


def _chain(direction, hist, v, k: int) -> torch.Tensor:
    g = v
    for _ in range(k):
        g = g + 1e-9 * direction(g, hist)
    return g


def _seconds(fn, device) -> float:
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def slope(name, direction, hist, v, ks, reps, bounds, device) -> float:
    """Seconds per direction: the slope between chains of ks[0] and ks[1]
    directions, each the minimum of ``reps`` runs after one warm-up."""
    k1, k2 = ks
    for k in ks:
        _seconds(lambda k=k: _chain(direction, hist, v, k), device)
    best = {k: min(_seconds(lambda k=k: _chain(direction, hist, v, k), device)
                   for _ in range(reps)) for k in ks}
    per = (best[k2] - best[k1]) / (k2 - k1)
    b4, b8 = bounds[4], bounds[8]
    print(f"{name:16s} {per * 1e3:10.4f} ms/call   (t{k1}={best[k1] * 1e3:.2f} ms, "
          f"t{k2}={best[k2] * 1e3:.2f} ms; {per / b4:.2f}x of 4mn, {per / b8:.2f}x of 8mn)",
          flush=True)
    return per


def main(argv=None) -> dict:
    """Print the slopes and return ``{row: seconds per call}``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=4_000_000)
    parser.add_argument("--m", type=int, default=50)
    parser.add_argument("--k", type=int, nargs=2, default=[3, 9], metavar=("K1", "K2"))
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--impl", nargs="+", default=["plain", "cuda"], choices=["plain", "cuda"],
                        help="'cuda' is the dispatch's choice of kernel, printed")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("diag_two_loop_large: no CUDA device; pass --device cpu for the CPU")

    n, m = args.n, args.m
    n_pad = -(-n // 128) * 128
    bounds = {c: c * m * n * 4 / HBM_BYTES_PER_S for c in (2, 4, 8, 10)}
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (host clock; not a device time)")
    print(f"# n={n} (n_pad={n_pad}), m={m}, on {where}; HBM bounds at 3.35 TB/s: "
          + ", ".join(f"{c}mn={b * 1e3:.4f} ms" for c, b in bounds.items()), flush=True)
    hist = make_hist(m, n, device)
    v = torch.randn(n, generator=torch.Generator(device=device).manual_seed(0), device=device)
    out = {"axpy-only": slope("axpy-only", lambda g, h: g, hist, v, args.k, args.reps, bounds,
                              device)}
    for impl in args.impl:
        if impl == "plain":
            out["plain"] = slope("plain", two_loop, hist, v, args.k, args.reps, bounds, device)
        else:
            sel, why = kernel_dispatch(n_pad, m, torch.float32)
            print(f"# dispatch at this size: {sel}" + (f" ({why})" if why else ""), flush=True)
            name = sel if device.type == "cuda" else f"{sel} (plain on cpu)"
            out[sel] = slope(name, two_loop_cuda, hist, v, args.k, args.reps, bounds, device)
    return out


if __name__ == "__main__":
    main()
