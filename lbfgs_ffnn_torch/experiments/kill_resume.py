"""Kill-and-resume across processes: a chunked solve saved to a checkpoint
file from its callback and killed, then restored and finished by another
process.

Two legs, each a process of its own, over three cases (``--cases``):

* ``rosenbrock`` - Armijo L-BFGS (m = 10, no line prefix) on the extended
  Rosenbrock at n = ``--rosenbrock-n``, in memory, saved at the first
  callback with k >= ``--iters`` / 2;
* ``slbfgs`` - S-LBFGS (b = 256, b_H = 128, L = 10, history 10, lambda
  1e-4) on the MLP 784-128-10 over the seeded data, in memory, saved at the
  first callback with epoch >= 1 (chunks of one epoch);
* ``outofcore`` - Armijo L-BFGS (m = 10) on ``outofcore_mlp_problem`` over a
  ``ChunkStore`` of the same data (``--chunk-rows``), saved at the first
  callback with k >= ``--iters`` / 2.

``--leg save`` runs each case with ``lbfgs_chunked`` / ``slbfgs_chunked``
and a callback that saves the live state (``save_checkpoint``) into
``DIR/<case>.pt`` and kills the run: by an exception for every case but the
last, and by ``os._exit(0)`` (no clean-up, as a kill) after the last.
``--leg resume`` restores each file into a template (a fresh state of the
same solve) and resumes with ``x0=None`` to the end, writing the result to
``DIR/<case>.resumed.pt``: ``x``, the loss and gradient-norm histories,
``n_iters``, the counters and ``time_ms`` (NaN before the resume).

``chip_smoke.py``'s ``outofcore`` phase runs both legs on the card and holds
the resumed runs against uninterrupted ones: the in-memory cases bitwise
(nothing is recomputed on a resume), the out-of-core one to rounding (the
carried prefix is recomputed from the iterate).

Usage: python -m lbfgs_ffnn_torch.experiments.kill_resume --leg save|resume --dir DIR
       [--device cuda] [--n-train 60000] [--rosenbrock-n 100000] [--iters 100] [--epochs 3]
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from lbfgs_ffnn_torch.checkpoint import restore_checkpoint, save_checkpoint
from lbfgs_ffnn_torch.solvers.common import prepared

CASES = ("rosenbrock", "slbfgs", "outofcore")
SEED = 123
DIMS, ACTS = [784, 128, 10], ["relu", "linear"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--leg", choices=("save", "resume"), required=True)
    p.add_argument("--dir", required=True, help="directory of the checkpoint files")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--n-train", type=int, default=60_000)
    p.add_argument("--rosenbrock-n", type=int, default=100_000)
    p.add_argument("--iters", type=int, default=100, help="the L-BFGS cases' iterations")
    p.add_argument("--epochs", type=int, default=3, help="the S-LBFGS case's epochs")
    p.add_argument("--chunk-rows", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=256)
    return p


@functools.lru_cache(maxsize=1)
def mnist_like(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The seeded data every chip run uses: labels from default_rng(123),
    synthetic_images_for_labels, one-hot targets (f32)."""
    from lbfgs_ffnn_torch.data.datasets import synthetic_images_for_labels

    labels = np.random.default_rng(SEED).integers(0, 10, n)
    return synthetic_images_for_labels(labels), np.eye(10, dtype=np.float32)[labels]


class Case:
    """One solve: its chunked driver ``run(x0, callback, resume_state)``,
    its counter, the counter value to save at and a fresh state (the
    restore's template)."""

    def __init__(self, name: str, args, dev: torch.device):
        tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
        tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")
        from lbfgs_ffnn_torch.objectives.mlp import mlp_init, mlp_spec

        self.name = name
        lbfgs_opts = tl.LBFGSOptions(max_iters=args.iters, tol=1e-12, m=10, line_search="armijo",
                                     ls_max_iters=20)
        if name == "rosenbrock":
            from lbfgs_ffnn_torch.objectives.analytic import rosenbrock_problem, rosenbrock_start

            problem = rosenbrock_problem()
            self.x0 = rosenbrock_start(args.rosenbrock_n, torch.float32, dev)
            self._lbfgs(tl, problem, (), lbfgs_opts, args.iters)
            return
        spec = mlp_spec(DIMS, ACTS)
        self.x0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
        x, y = mnist_like(args.n_train)
        if name == "outofcore":
            from lbfgs_ffnn_torch.data.outofcore import ChunkStore, outofcore_mlp_problem

            self.store = ChunkStore(x, y, args.chunk_rows, device=dev)
            self._lbfgs(tl, outofcore_mlp_problem(spec, self.store), (), lbfgs_opts, args.iters)
            return
        from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem

        problem = mlp_batch_problem(spec, lam=1e-4)
        xt, yt = torch.tensor(x, device=dev), torch.tensor(y, device=dev)
        opts = tsl.SLBFGSOptions(epochs=args.epochs, tol=1e-12, history=10, L=10,
                                 batch_size=args.batch_size,
                                 hvp_batch_size=args.batch_size // 2, step_size=0.02)
        self.at = 1
        self.counter = lambda s: int(s.epoch)
        self.template = lambda: tsl._init_state(opts, self.x0, xt, yt)
        self.run = lambda x0, cb=None, resume=None: tsl.slbfgs_chunked(
            problem, x0, xt, yt, opts, chunk=1, callback=cb, resume_state=resume)

    def _lbfgs(self, tl, problem, aux, opts, iters):
        self.at = iters // 2
        self.counter = lambda s: int(s.k)

        def template():
            with torch.no_grad():
                return tl._init_state(problem, opts, self.x0, prepared(problem, aux))

        self.template = template
        self.run = lambda x0, cb=None, resume=None: tl.lbfgs_chunked(
            problem, x0, aux, opts, chunk=10, callback=cb, resume_state=resume)


class _Killed(Exception):
    pass


def save_leg(cases: list[Case], out: Path) -> None:
    for i, case in enumerate(cases):
        last = i == len(cases) - 1

        def cb(state, _elapsed, case=case, last=last):
            at = case.counter(state)
            if at < case.at:
                return
            save_checkpoint(out / f"{case.name}.pt", state)
            (out / f"{case.name}.json").write_text(json.dumps({"saved_at": at}))
            print(f"kill_resume: {case.name} saved at {at} and killed", flush=True)
            if last:
                os._exit(0)  # the process dies here: nothing after this runs
            raise _Killed

        try:
            case.run(case.x0, cb)
        except _Killed:
            continue
        raise RuntimeError(f"{case.name}: the run ended before its save point {case.at}")


def resume_leg(cases: list[Case], out: Path) -> None:
    for case in cases:
        state = restore_checkpoint(out / f"{case.name}.pt", case.template())
        res, time_ms = case.run(None, resume=state)
        torch.save({"x": res.x.cpu(), "loss_history": res.loss_history.cpu(),
                    "gnorm_history": res.gnorm_history.cpu(), "n_iters": res.n_iters,
                    "n_fevals": res.n_fevals, "n_gevals": res.n_gevals,
                    "resumed_at": case.counter(state), "time_ms": torch.tensor(time_ms)},
                   out / f"{case.name}.resumed.pt")
        print(f"kill_resume: {case.name} resumed at {case.counter(state)}, ended at "
              f"{res.n_iters}, final loss {float(res.final_loss):.8g}", flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    names = [c for c in args.cases.split(",") if c]
    unknown = set(names) - set(CASES)
    if unknown:
        raise SystemExit(f"unknown cases {sorted(unknown)}; choose from {CASES}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a card (torch.cuda.is_available() is false)")
    out = Path(args.dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [Case(name, args, dev) for name in names]
    (save_leg if args.leg == "save" else resume_leg)(cases, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
