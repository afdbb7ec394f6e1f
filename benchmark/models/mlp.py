"""The dense MLP family (a configuration whose ``model`` is ``"mlp"``):
its data, its starting points, the program's problems and the plain
reference's objective, and the work of its calls.

A model family is a file ``benchmark/models/<model>.py`` with these
functions; the solver kinds (``benchmark/kinds/``) call nothing else of it.
"""

from __future__ import annotations

from benchmark import counts, data
from benchmark.reference import mlp as ref


def objective(config: dict, lam: float) -> ref.Objective:
    """The plain reference's loss (autograd, float32)."""
    return ref.Objective(ref.net(config), lam)


def inputs(config: dict, seed: int, device) -> tuple:
    """The training rows ``(x, y)`` for this seed, made on the device."""
    return data.inputs(config, seed, device)


def rows(data: tuple) -> int:
    """The rows a full pass over ``data`` reads."""
    return data[0].shape[0]


def start(obj: ref.Objective, seed: int, device):
    """An initial parameter vector drawn from ``seed``."""
    return data.weights(obj.net, seed, device)


def _spec(config: dict):
    from lbfgs_ffnn_torch.objectives.mlp import mlp_spec
    return mlp_spec(config["dims"], config["activations"])


def problem(config: dict, lam: float):
    """The program's full-batch problem (aux = (x, y))."""
    from lbfgs_ffnn_torch.objectives.mlp import mlp_problem
    return mlp_problem(_spec(config), lam=lam)


def batch_problem(config: dict, lam: float):
    """The program's problem over batches of rows."""
    from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem
    return mlp_batch_problem(_spec(config), lam=lam)


def work(config: dict) -> counts.MLPWork:
    return counts.MLPWork(tuple(config["dims"]))
