"""lbfgs_ffnn_torch — the PyTorch + CUDA port of ``lbfgs_ffnn_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names and is tested against it on the same inputs. It imports
torch and numpy only. Ported so far: the MNIST L-BFGS main path, the
deep-net Fashion-MNIST path and the large-n L-BFGS path (IDX data and both
loaders, the MLP objective with its carried line prefix, the analytic
objectives, the Armijo and Wolfe line searches, the curvature ring with f32
or bf16 pairs, the two-loop recursion as plain torch and as three
hand-written Hopper kernels with their size dispatch, the L-BFGS solver with
both searches, BFGS (dense and factor storage; direct, CG and GMRES
solves) and damped Newton (dense and Newton-CG) with the counted CG and
GMRES solvers and the autodiff dense Hessian, gradient descent with its
three branches, SGD (resident and streamed, with the prefetching batch
streamer), S-LBFGS with its batch
problem and its device-side sampler, the Burgers and oscillator PINNs with
their runners and the FD oracle, the recorder, the launcher, the MNIST
runner, the harness with the deterministic suite runner and the large-n
two-loop diagnostic), checkpoint/resume of any solver state
(``checkpoint``), the out-of-core path (``data.outofcore``: the
``ChunkStore`` in pinned host memory, its problems, ``slbfgs(store=)`` and
the hand-written row-gather kernel), the utilities (``utils``: diagnostics
and a profiler trace) and the ``models`` alias of the objectives.
"""

from lbfgs_ffnn_torch.types import (
    BatchProblem, Problem, SolveResult, make_batch_problem, make_problem,
)
from lbfgs_ffnn_torch.solvers import (
    BFGSOptions, GDOptions, LBFGSOptions, NewtonOptions, SGDOptions, SLBFGSOptions, bfgs,
    gradient_descent, lbfgs, newton, sgd, slbfgs, slbfgs_chunked,
)

__version__ = "0.1.0"

__all__ = [
    "BatchProblem",
    "Problem",
    "SolveResult",
    "make_batch_problem",
    "make_problem",
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
