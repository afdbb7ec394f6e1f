"""The control and the planted faults on the card, at each cell's own
size: the plain reference in TF32 (the precision below the configurations'
float32 with TF32 off), and with half of each batch (or of each
mini-batch) left out, and the two-loop over the program's history with
its oldest pair dropped or its pairs in row order, each put in the
program's place, must fail the cell's limits on every seed tried; the
program itself must pass them. Run on the card with ``python3 -m pytest
--noconftest -m cuda benchmark/tests`` (the repository's conftest imports
JAX, which that machine lacks); skips itself where no card is visible."""

import json

import pytest
import torch

from benchmark import catalog, check, control

ROOT = catalog.HERE.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (9100000001, 9100000002, 9100000003)
STAND_INS = ("control", "half_batch", "half_minibatch", "oldest_dropped", "slot_order")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_every_stand_in_fails(card, name):
    cell = catalog.load_cell(name, ROOT)
    for seed in SEEDS:
        r = control.readings(cell, seed)
        assert r["sound_correct"], (seed, r["sound"])
        for stand in STAND_INS:
            if stand not in r:
                continue
            # the numbers this stand-in reads (it draws no batches of its own)
            limits = {n: v for n, v in cell.limits.items() if n in r[stand]}
            if not limits:
                continue
            ok, shown = check.verdict(r[stand], limits)
            assert not ok, (seed, stand, shown)
