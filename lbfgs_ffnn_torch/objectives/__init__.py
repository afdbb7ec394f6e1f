from lbfgs_ffnn_torch.objectives.analytic import (
    ackley_problem,
    rastrigin_problem,
    rosenbrock_problem,
)
from lbfgs_ffnn_torch.objectives.mlp import (
    MLPSpec,
    evaluate,
    mlp_apply,
    mlp_batch_problem,
    mlp_init,
    mlp_loss,
    mlp_problem,
    mlp_spec,
    params_from_numpy,
    slbfgs_state_from_numpy,
    take_batch,
)

__all__ = [
    "ackley_problem",
    "rastrigin_problem",
    "rosenbrock_problem",
    "MLPSpec",
    "evaluate",
    "mlp_apply",
    "mlp_batch_problem",
    "mlp_init",
    "mlp_loss",
    "mlp_problem",
    "mlp_spec",
    "params_from_numpy",
    "slbfgs_state_from_numpy",
    "take_batch",
]
