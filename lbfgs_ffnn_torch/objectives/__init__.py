from lbfgs_ffnn_torch.objectives.analytic import (
    ackley_problem,
    rastrigin_problem,
    rosenbrock_problem,
)
from lbfgs_ffnn_torch.objectives.mlp import (
    MLPSpec,
    evaluate,
    mlp_apply,
    mlp_init,
    mlp_loss,
    mlp_problem,
    mlp_spec,
    params_from_numpy,
)

__all__ = [
    "ackley_problem",
    "rastrigin_problem",
    "rosenbrock_problem",
    "MLPSpec",
    "evaluate",
    "mlp_apply",
    "mlp_init",
    "mlp_loss",
    "mlp_problem",
    "mlp_spec",
    "params_from_numpy",
]
