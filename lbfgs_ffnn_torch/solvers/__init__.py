from lbfgs_ffnn_torch.solvers.gd import GDOptions, gradient_descent
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs

__all__ = [
    "GDOptions",
    "gradient_descent",
    "LBFGSOptions",
    "lbfgs",
]
