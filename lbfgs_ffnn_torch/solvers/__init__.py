from lbfgs_ffnn_torch.solvers.gd import GDOptions, gradient_descent
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs
from lbfgs_ffnn_torch.solvers.bfgs import BFGSOptions, bfgs
from lbfgs_ffnn_torch.solvers.newton import NewtonOptions, newton
from lbfgs_ffnn_torch.solvers.sgd import SGDOptions, sgd
from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions, slbfgs, slbfgs_chunked

__all__ = [
    "GDOptions",
    "gradient_descent",
    "LBFGSOptions",
    "lbfgs",
    "BFGSOptions",
    "bfgs",
    "NewtonOptions",
    "newton",
    "SGDOptions",
    "sgd",
    "SLBFGSOptions",
    "slbfgs",
    "slbfgs_chunked",
]
