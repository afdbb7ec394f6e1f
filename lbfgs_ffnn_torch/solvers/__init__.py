from lbfgs_ffnn_torch.solvers.gd import GDOptions, gradient_descent
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs
from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions, slbfgs, slbfgs_chunked

__all__ = [
    "GDOptions",
    "gradient_descent",
    "LBFGSOptions",
    "lbfgs",
    "SLBFGSOptions",
    "slbfgs",
    "slbfgs_chunked",
]
