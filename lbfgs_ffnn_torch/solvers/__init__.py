from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs

__all__ = [
    "LBFGSOptions",
    "lbfgs",
]
