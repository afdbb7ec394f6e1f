"""What a solver kind is: the generator that turns a traffic mix into calls
of the program.

A mix names its solver kind (``"solver"``), the program's options of a
solve (``solve``), the regulariser ``lam`` and the number of steps
(iterations or epochs) the correctness check follows (``check_steps``).
Each kind is a file ``benchmark/kinds/<solver>.py`` that defines ``KIND``,
a :class:`Kind`; each configuration names its model family (``model``), a
file ``benchmark/models/<model>.py`` (see :mod:`benchmark.models.mlp`).
A kind knows how to build the program's problem and options from the
family, run the first steps of a solve through the cached step that the
window replays (the program's ``*_warm_up``), run a whole solve, run the
plain reference's steps, and count the operations a solve needs; where the
solver keeps a curvature history, how to take the history a whole solve
leaves and apply the solver's dispatch to it; where it draws batches, how
to hold the program's draws against the reference's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Program(NamedTuple):
    """What a kind built of the program for one cell."""

    problem: object
    opts: object
    data: tuple        # the model family's inputs, as the solver takes them
    rows: int          # the rows a full pass reads
    work: object       # the family's operation counts (benchmark.counts.MLPWork)
    traffic: dict
    device: torch.device


class Kind(NamedTuple):
    unit: str                      # "iter" or "epoch": what a solve counts
    length: str                    # the solve option that sets a solve's length
    build: Callable                # (model, config, traffic, data, device) -> Program
    first_steps: Callable          # (program, w0, seed, k) -> SolveResult after k steps
    solve: Callable                # (program, w0, seed) -> SolveResult of a whole solve
    flops: Callable                # (program, result) -> operations of one solve
    batch_vag: Callable            # (program) -> (zero-argument value-and-gradient call, rows)
    reference: Callable            # (objective, w0, data, traffic, seed, k) -> reference steps
    first_grad: Callable = lambda result: None  # the first gradient's norm, from one step's state
    ring_after: Callable | None = None  # (program, w0, seed) -> (ring, v) after a whole solve
    clamp_gamma: bool = False      # the solver's two-loop clamps gamma
    sampler_gap: Callable | None = None  # (program, seed, k) -> draws unlike the reference's


def last_state(run_chunked, prefer=None) -> object:
    """The live state a chunked solve hands its callback at the end, with
    every tensor cloned; with ``prefer`` (a test of a state), the last
    state that passes it, where one does."""
    from lbfgs_ffnn_torch.solvers.common import clone
    seen = {}

    def keep(state, _elapsed):
        seen["state"] = clone(state)
        if prefer is not None and prefer(seen["state"]):
            seen["preferred"] = seen["state"]

    run_chunked(keep)
    return seen.get("preferred", seen["state"])


def wrapped(state) -> bool:
    """The state's history ring has its next slot other than slot 0, so
    that its oldest pair is not in row 0."""
    return int(state.hist.head) != 0


def direction(v: torch.Tensor, ring, clamp_gamma: bool) -> torch.Tensor:
    """``H v`` through the dispatch the solvers call (``two_loop_impl``
    "cuda", their default)."""
    from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda
    return two_loop_cuda(v, ring, clamp_gamma=clamp_gamma)


def ring_rows(ring, n: int) -> list:
    """The pairs ``[(s, y), ...]`` a history ring holds, oldest first, as
    float32 rows of ``n``: the ring's ``count`` rows ending before slot
    ``head`` (``S``, ``Y`` of shape ``(m, n_pad)``; the next push goes to
    ``head``)."""
    m = ring.S.shape[0]
    head, count = int(ring.head), int(ring.count)
    slots = [(head - count + j) % m for j in range(count)]
    return [(ring.S[i, :n].float(), ring.Y[i, :n].float()) for i in slots]


def probe_point(p: Program) -> torch.Tensor:
    """A fixed parameter vector at which the objective's probe is timed."""
    g = torch.Generator(device=p.device)
    g.manual_seed(0)
    return 0.05 * torch.randn(p.work.n_params, generator=g, device=p.device)


def batch_vag(p: Program):
    """The batch problem's value and gradient on the mix's first
    ``batch_size`` rows, at the probe point."""
    b = p.opts.batch_size
    w = probe_point(p)
    xb, yb = p.data[0][:b].clone(), p.data[1][:b].clone()
    return (lambda: p.problem.value_and_grad(w, xb, yb)), b


def release() -> None:
    """Drop the program's captured steps and cached data copies."""
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache
    clear_graph_cache()
