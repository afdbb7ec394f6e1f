"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.control --workload <cell> --seeds S1 S2 ... [--out FILE]

For each seed, at the cell's own size:

- ``sound``: the compared numbers of a run of the program (the harness's
  own path, with a window of one solve);
- ``control``: the plain reference in TF32, the nearest precision below
  the configuration's float32 with TF32 off, in the program's place: its
  steps with TF32 matmuls, and its two-loop over the program's history
  with every product's operands rounded to TF32;
- ``half_batch``: the reference in float32 with half of the rows of every
  loss, gradient and Hessian-vector product left out (the mean over the
  first half of the rows it is given), in the program's place;
- ``half_minibatch`` (kinds that count epochs): the same for the calls on
  fewer rows than the training set only: the batches, not the full passes
  (an S-LBFGS anchor's gradient, the record);
- ``oldest_dropped``, ``slot_order`` (kinds with a history): the
  reference's two-loop over the program's history without its oldest
  pair, and with its pairs in the order of the ring's rows, in the
  dispatch's place (an answer altered where it is produced).

A step that returns its state unchanged reads 1 in ``change`` by
construction and needs no run. Prints one JSON line a seed and a summary:
the largest sound reading and the smallest reading of each stand-in, per
number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import torch

from benchmark import catalog, check, drive, run
from benchmark.reference import lbfgs as ref_lbfgs
from benchmark.reference.precision import precision, tf32


class HalfRows(NamedTuple):
    """An objective that reads only the first half of the rows of each call
    on fewer than ``below`` rows (every call where ``below`` is None)."""

    whole: object
    below: int | None = None

    @property
    def n_params(self) -> int:
        return self.whole.n_params

    def leaves(self):
        return self.whole.leaves()

    def _cut(self, x, y):
        if self.below is not None and x.shape[0] >= self.below:
            return x, y
        h = max(x.shape[0] // 2, 1)
        return x[:h], y[:h]

    def loss(self, w, x, y):
        return self.whole.loss(w, *self._cut(x, y))

    def value_and_grad(self, w, x, y):
        return self.whole.value_and_grad(w, *self._cut(x, y))

    def hvp(self, w, v, x, y):
        return self.whole.hvp(w, v, *self._cut(x, y))


def stand_ins(cell, seed: int, held: dict, with_first_grad: bool) -> dict:
    """The compared numbers of each stand-in for the program (see the
    module's docstring), on the seed's data and start; ``held`` the
    program's history, vector and start as :func:`benchmark.run.run_cell`
    keeps them."""
    dev = torch.device("cuda")
    kind, model = cell.kind, cell.model
    obj = model.objective(cell.config, cell.traffic.get("lam", 0.0))
    k = int(cell.traffic["check_steps"])
    inputs = model.inputs(cell.config, seed, dev)
    rows = inputs[0].shape[0]
    w0, s0 = held["w0"], held["s0"]
    variants = {"control": ("tf32", obj), "half_batch": ("float32", HalfRows(obj))}
    if kind.unit == "epoch":
        variants["half_minibatch"] = ("float32", HalfRows(obj, rows))
    out = {}
    with torch.no_grad():
        with precision("float32"):
            ref = kind.reference(obj, w0, inputs, cell.traffic, s0, k)
        for name, (mode, stand) in variants.items():
            with precision(mode):
                other = kind.reference(stand, w0, inputs, cell.traffic, s0, k)
            gnorm0 = float(torch.linalg.norm(other["g0"])) if with_first_grad else None
            prog = {"loss_runs": [other["losses"]], "w1": other["iterates"][0],
                    "wk": other["iterates"][k - 1], "gnorm0": gnorm0}
            out[name] = check.numbers(w0, prog, ref, obj.leaves())
        if "ring" in held:
            rows_ = drive.ring_rows(held["ring"], obj.n_params)
            v, clamp = held["v"], kind.clamp_gamma
            pairs = ref_lbfgs.with_rho(rows_)
            z_ref = ref_lbfgs.two_loop(v, pairs, clamp_gamma=clamp)
            tf32_pairs = [(s, y, 1.0 / torch.dot(tf32(y), tf32(s))) for s, y in rows_]
            m = held["ring"].S.shape[0]
            by_row = sorted(zip([(int(held["ring"].head) - len(rows_) + j) % m
                                 for j in range(len(rows_))], pairs), key=lambda t: t[0])
            altered = {"control": ref_lbfgs.two_loop(v, tf32_pairs, clamp, rnd=tf32),
                       "oldest_dropped": ref_lbfgs.two_loop(v, pairs[1:], clamp),
                       "slot_order": ref_lbfgs.two_loop(v, [p for _, p in by_row], clamp)}
            for name, z in altered.items():
                out.setdefault(name, {})["direction"] = check.direction_gap(z, z_ref,
                                                                            obj.leaves())
    return out


def readings(cell, seed: int) -> dict:
    held = {}
    sound = run.run_cell(cell, seed, 0.0, False, "cuda", log=lambda *a: None, keep=held)
    torch.cuda.empty_cache()
    ring = held.get("ring")
    return {"seed": seed, "sound": sound["gaps"], "sound_correct": sound["correct"],
            "ring": None if ring is None else [int(ring.count), int(ring.head)],
            **stand_ins(cell, seed, held, "first_grad" in sound["gaps"])}


def summary(rows: list) -> dict:
    out = {}
    for n in check.NUMBERS:
        if n not in rows[0]["sound"]:
            continue
        out[n] = {"sound_max": max(r["sound"][n] for r in rows)}
        for name in rows[0]:
            if isinstance(rows[0][name], dict) and name != "sound" and n in rows[0][name]:
                out[n][f"{name}_min"] = min(r[name][n] for r in rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None, help="also write the readings here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA device", file=sys.stderr)
        return 1
    root = catalog.root_of()
    run.cache_dirs(root)
    cell = catalog.load_cell(args.workload, root)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, seed))
        print(json.dumps(rows[-1]), flush=True)
    out = {"workload": cell.name, "card": run.power_limit(), "rows": rows,
           "summary": summary(rows)}
    print(json.dumps(out["summary"]), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
