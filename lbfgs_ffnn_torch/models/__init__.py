"""Model families (alias of :mod:`lbfgs_ffnn_torch.objectives`).

Counterpart of :mod:`lbfgs_ffnn_tpu.models`, with its names: the framework's
"models" are objective providers, flat-parameter dense MLPs for
classification and PINNs for PDE/ODE residual losses, the reference's model
families (dense MLP: src/network.hpp + src/cuda/network.cuh; PINN:
src/enzyme/pinn_network.hpp).
"""

from lbfgs_ffnn_torch.objectives.mlp import (
    MLPSpec,
    evaluate,
    mlp_apply,
    mlp_apply_single,
    mlp_batch_problem,
    mlp_init,
    mlp_loss,
    mlp_problem,
    mlp_spec,
)
from lbfgs_ffnn_torch.objectives.pinn import (
    BurgersPoints,
    burgers_points,
    burgers_problem,
    burgers_residual,
    default_burgers_spec,
    default_oscillator_spec,
    oscillator_points,
    oscillator_problem,
    pinn_init,
)

__all__ = [
    "MLPSpec",
    "evaluate",
    "mlp_apply",
    "mlp_apply_single",
    "mlp_batch_problem",
    "mlp_init",
    "mlp_loss",
    "mlp_problem",
    "mlp_spec",
    "BurgersPoints",
    "burgers_points",
    "burgers_problem",
    "burgers_residual",
    "default_burgers_spec",
    "default_oscillator_spec",
    "oscillator_points",
    "oscillator_problem",
    "pinn_init",
]
