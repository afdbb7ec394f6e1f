"""The comparison that decides ``correct``.

The program's first ``k`` steps (iterations, or epochs) from the checked
start are held against the reference's from the same start and data:

- ``loss``: the largest relative gap of a step's loss, over the steps and
  over every reading of them (the set-up's first steps, its warm-up solve
  and the window's first solve);
- ``first_loss``: the same for the first step's loss alone;
- ``first_step``: the first gradient as the optimizer applied it, read
  from its state after one step as the parameters' change ``w_1 - w_0``;
- ``change``: the parameters' change after ``k`` steps, ``w_k - w_0``;
- ``first_grad``: where the solver's state after one step holds the first
  gradient's norm (S-LBFGS: the first anchor's full gradient), its
  relative gap;
- ``direction``: where the solver keeps a curvature history, ``H v`` by
  the solver's own dispatch on the history that a whole solve left
  (full, wrapped), against the reference's two-loop over the same pairs
  (its rho worked out again from each pair), leaf by leaf: the norm of the
  difference over the reference's norm of that leaf or of the median
  leaf, whichever is larger, the worst leaf;
- ``sampler``: where the solver draws batches, how many of the program's
  draws over the checked epochs differ from the reference's frozen draw.

A cell's limits file names the numbers it compares; the others are
computed but decide nothing.

``first_step`` and ``change`` are taken leaf by leaf (each layer's weight and bias): the
gap between the program's norm and the reference's, over the reference's
norm of that leaf or of the median leaf, whichever is larger; the worst
leaf is the number. Leaves whose reference gradient at the start is under
a thousandth of the median leaf's are left out (their change is round-off).
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss", "first_loss", "first_step", "change", "first_grad", "direction",
           "sampler")
WORST = 1e308  # a gap that was not finite: still a number in the result's JSON


def _worst(gaps) -> float:
    """The largest gap; any gap that is not finite is the worst."""
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else WORST


def _leaf_norms(v: torch.Tensor, leaves) -> list[float]:
    return [float(torch.linalg.norm(v[lo:hi].double())) for _, lo, hi in leaves]


def counted_leaves(g0: torch.Tensor, leaves) -> list:
    norms = _leaf_norms(g0, leaves)
    med = statistics.median(norms)
    return [leaf for leaf, n in zip(leaves, norms) if n >= 1e-3 * med]


def leaf_gap(prog: torch.Tensor, ref: torch.Tensor, leaves) -> float:
    p, r = _leaf_norms(prog, leaves), _leaf_norms(ref, leaves)
    med = statistics.median(r)
    return _worst(abs(a - b) / max(b, med) for a, b in zip(p, r))


def direction_gap(prog: torch.Tensor, ref: torch.Tensor, leaves) -> float:
    d, r = _leaf_norms(prog - ref, leaves), _leaf_norms(ref, leaves)
    med = statistics.median(r)
    return _worst(a / max(b, med) for a, b in zip(d, r))


def loss_gap(prog_losses, ref_losses) -> float:
    return _worst(abs(float(a) - b) / abs(b) for a, b in zip(prog_losses, ref_losses))


def numbers(w0: torch.Tensor, prog: dict, ref: dict, leaves) -> dict:
    """``prog``: ``{"loss_runs": [[f_1..f_k], ...], "w1", "wk", "gnorm0"}``
    (``gnorm0`` None where the state does not hold it); ``ref``: the
    reference's steps (``losses``, ``iterates``, ``g0``). A reading that is
    not finite counts as the largest gap a JSON number holds, 1e308."""
    keep = counted_leaves(ref["g0"], leaves)
    k = len(ref["losses"])
    out = {
        "loss": _worst(loss_gap(run[:k], ref["losses"]) for run in prog["loss_runs"]),
        "first_loss": _worst(loss_gap(run[:1], ref["losses"][:1]) for run in prog["loss_runs"]),
        "first_step": leaf_gap(prog["w1"] - w0, ref["iterates"][0] - w0, keep),
        "change": leaf_gap(prog["wk"] - w0, ref["iterates"][k - 1] - w0, keep),
    }
    if prog.get("gnorm0") is not None:
        g0 = float(torch.linalg.norm(ref["g0"].double()))
        out["first_grad"] = abs(prog["gnorm0"] - g0) / g0
    return {name: v if math.isfinite(v) else WORST for name, v in out.items()}


def verdict(gaps: dict, limits: dict) -> tuple[bool, dict]:
    """``(every number the limits name within its limit, {name: {"value",
    "limit"}})``; a named number that was not read fails."""
    shown = {n: {"value": gaps.get(n, WORST), "limit": limits[n]} for n in limits}
    return all(c["value"] <= c["limit"] for c in shown.values()), shown
