from lbfgs_ffnn_torch.ops.iterative import cg_counted, gmres_counted
from lbfgs_ffnn_torch.ops.linesearch import armijo_quad_line_search, wolfe_line_search
from lbfgs_ffnn_torch.ops.two_loop import two_loop, ring_push, empty_history_state

__all__ = [
    "cg_counted",
    "gmres_counted",
    "armijo_quad_line_search",
    "wolfe_line_search",
    "two_loop",
    "ring_push",
    "empty_history_state",
]
