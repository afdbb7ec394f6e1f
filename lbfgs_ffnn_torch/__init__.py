"""lbfgs_ffnn_torch — the PyTorch + CUDA port of ``lbfgs_ffnn_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names and is tested against it on the same inputs. It imports
torch and numpy only. Ported so far: the MNIST L-BFGS main path (IDX data,
the MLP objective with its carried line prefix, the Armijo line search, the
curvature ring, the two-loop recursion as plain torch and as a hand-written
Hopper kernel, and the armijo L-BFGS solver).
"""

from lbfgs_ffnn_torch.types import Problem, SolveResult, make_problem
from lbfgs_ffnn_torch.solvers import LBFGSOptions, lbfgs

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "SolveResult",
    "make_problem",
    "LBFGSOptions",
    "lbfgs",
]
