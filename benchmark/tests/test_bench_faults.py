"""A whole run at a tiny size on the CPU, the harness's look for a card
skipped, with the program's path broken underneath: each fault a cell can
have must turn ``correct`` false, and the unbroken run passes."""

import importlib

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_cell

CELLS = {"lbfgs": "mnist-lbfgs-m10", "lbfgs-deep": "deep-lbfgs-m100",
         "slbfgs": "mnist-slbfgs-b256", "sgd": "deep-sgd-b256"}
ENTRY = {"lbfgs": ("lbfgs", ("lbfgs", "lbfgs_warm_up", "lbfgs_chunked")),
         "slbfgs": ("slbfgs", ("slbfgs", "slbfgs_warm_up", "slbfgs_chunked")),
         "sgd": ("sgd", ("sgd", "sgd_warm_up"))}
ROWS = 600  # the tiny cells' training rows


def _solver(cell):
    module, names = ENTRY[cell.traffic["solver"]]
    return importlib.import_module(f"lbfgs_ffnn_torch.solvers.{module}"), names


def _wrap(monkeypatch, cell, after):
    """Every solve of the cell's solver, its result passed through
    ``after(result, w0)``."""
    mod, names = _solver(cell)
    for name in names[:2]:
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **kw: after(_r(*a, **kw), a[1]))


def unchanged(monkeypatch, cell):
    """A step that returns its state unchanged."""
    _wrap(monkeypatch, cell, lambda res, w0: res._replace(x=w0.clone()))


def loss_altered(monkeypatch, cell):
    """An answer altered where it is produced: the loss the solve reports."""
    _wrap(monkeypatch, cell, lambda res, w0: res._replace(loss_history=res.loss_history * 1.01))


def _halved_rows(monkeypatch, below):
    """Every batch evaluation of the program's objective over the first
    half of its rows, where it has fewer than ``below`` rows (all where
    ``below`` is None)."""
    objective = importlib.import_module("lbfgs_ffnn_torch.objectives.mlp")
    build = objective.mlp_batch_problem

    def cut(x):
        return below is None or x.shape[0] < below

    def halved(*a, **kw):
        bp = build(*a, **kw)

        def half(f):
            def g(w, x, y, *rest):
                if cut(x):
                    h = max(x.shape[0] // 2, 1)
                    x, y = x[:h], y[:h]
                return f(w, x, y, *rest)
            return g
        # (the exact HVP differentiates grad)
        return bp._replace(fun=half(bp.fun), grad=half(bp.grad),
                           value_and_grad=half(bp.value_and_grad))
    monkeypatch.setattr(objective, "mlp_batch_problem", halved)


def half_batch(monkeypatch, cell):
    """Half of the batch left out, the mean taken over the rest: the full
    batch's rows, or every batch evaluation, the full passes' included."""
    mod, names = _solver(cell)
    if cell.traffic["solver"] == "lbfgs":
        for name in names:
            real = getattr(mod, name)

            def halved(problem, w0, aux, *a, _r=real, **kw):
                h = aux[0].shape[0] // 2
                return _r(problem, w0, (aux[0][:h], aux[1][:h]), *a, **kw)
            monkeypatch.setattr(mod, name, halved)
    else:
        _halved_rows(monkeypatch, None)


def half_minibatch(monkeypatch, cell):
    """Half of each mini-batch left out, the full passes whole."""
    _halved_rows(monkeypatch, ROWS)


def _dispatch(monkeypatch, cell, ring_of):
    """The two-loop dispatch the solver and the harness call, over the
    ring ``ring_of(ring)``."""
    ops = importlib.import_module("lbfgs_ffnn_torch.ops.cuda_two_loop")
    real = ops.two_loop_cuda

    def broken(v, hist, **kw):
        return real(v, ring_of(hist), **kw)
    monkeypatch.setattr(ops, "two_loop_cuda", broken)
    mod, _ = _solver(cell)
    monkeypatch.setattr(mod, "two_loop_cuda", broken)


def oldest_dropped(monkeypatch, cell):
    """The two-loop leaves out the history's oldest pair."""
    _dispatch(monkeypatch, cell,
              lambda h: h._replace(count=torch.clamp(h.count - 1, min=0)))


def head_ignored(monkeypatch, cell):
    """The two-loop reads a full ring from row 0, whatever its head."""
    _dispatch(monkeypatch, cell, lambda h: h._replace(
        head=torch.where(h.count == h.S.shape[0], torch.zeros_like(h.head), h.head)))


def draws_shifted(monkeypatch, cell):
    """The sampler hands each step the batch of the step after it."""
    sampling = importlib.import_module("lbfgs_ffnn_torch.ops.sampling")
    real = sampling.EpochSampler.batches
    monkeypatch.setattr(sampling.EpochSampler, "batches",
                        lambda self, epoch, t, count: real(self, epoch, t + 1, count))


FAULTS = {"lbfgs": [unchanged, half_batch, oldest_dropped, head_ignored],
          "slbfgs": [unchanged, half_batch, half_minibatch, oldest_dropped, head_ignored,
                     draws_shifted],
          "sgd": [unchanged, half_batch, half_minibatch]}
CASES = [(which, fault) for which, name in sorted(CELLS.items())
         for fault in FAULTS[tiny_cell(name).traffic["solver"]]]


def _run(cell):
    return run.run_cell(cell, 2 ** 31 + 99, 0.0, False, "cpu", log=lambda *a: None)


@pytest.mark.parametrize("which", sorted(CELLS))
def test_sound_run_is_correct(which):
    cell = tiny_cell(CELLS[which])
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    rate = "iter_ms" if cell.traffic["solver"] == "lbfgs" else "epoch_ms"
    assert set(result["metrics"]) == {"setup_s", rate}
    assert set(cell.limits) <= set(result["gaps"])


@pytest.mark.parametrize("which, fault", CASES, ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_turns_correct_false(monkeypatch, which, fault):
    cell = tiny_cell(CELLS[which])
    fault(monkeypatch, cell)
    result = _run(cell)
    assert not result["correct"], result["checks"]


# the cells that compare each step's loss
LOSS_CELLS = sorted(w for w, c in CELLS.items() if "loss" in tiny_cell(c).limits)


@pytest.mark.parametrize("which", LOSS_CELLS)
def test_altered_loss_turns_correct_false(monkeypatch, which):
    cell = tiny_cell(CELLS[which])
    loss_altered(monkeypatch, cell)
    assert not _run(cell)["correct"]


def test_no_card_no_result(capsys, monkeypatch):
    """Without a card the command exits non-zero and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mnist-lbfgs-m10", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
