"""Core problem / result types.

Counterpart of :mod:`lbfgs_ffnn_tpu.types`. An objective is a set of plain
callables ``fun(w, aux) -> scalar`` over one flat parameter tensor; the
default gradient comes from ``torch.func.grad_and_value`` where the JAX
package uses ``jax.value_and_grad``. ``aux`` is a tuple of extra operands
(e.g. the training set ``(x, y)``).

``Problem.hess`` is the dense Hessian: the objective's own where it
supplies one (the analytic objectives do), else the autodiff default of
:func:`make_problem`, ``torch.func.hessian`` of ``fun`` where JAX uses
``jax.hessian``, which refuses more than :data:`DENSE_HESSIAN_LIMIT`
parameters before anything of size n^2 is allocated. ``Problem.hvp`` is
forward over reverse; the stochastic solvers' :class:`BatchProblem` comes
from :func:`make_batch_problem`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

# Largest parameter count for which make_problem's default dense Hessian is
# allowed to materialize (8192^2 f64 = 537 MB), as in the JAX package. Larger
# problems supply an explicit ``hess`` or use matrix-free Newton-CG.
DENSE_HESSIAN_LIMIT = 8192


class LinePrefix(NamedTuple):
    """Carried line-restriction protocol for objectives with a
    parameter-linear prefix (the MLP's first-layer preactivation).

    ``init(w, aux) -> P`` computes the prefix at the current iterate;
    ``direction(p, aux) -> B`` its directional increment; the restriction
    ``restrict(P, B, w, p, aux)(alpha)`` equals ``fun(w + alpha*p, aux)`` up
    to rounding. ``vag_restrict(P, B, w, p, aux)(alpha) -> (loss, grad)`` is
    the full value and gradient computed from the prefix, and
    ``vag_restrict_carry`` additionally returns the post-step prefix
    ``P + alpha*B`` it computed for its own forward, which the solver carries
    as the next prefix (see :class:`lbfgs_ffnn_tpu.types.LinePrefix`).
    """

    init: Callable[..., Any]
    direction: Callable[..., Any]
    restrict: Callable[..., Callable[[torch.Tensor], torch.Tensor]]
    vag_restrict: Optional[Callable[..., Callable]] = None
    vag_restrict_carry: Optional[Callable[..., Callable]] = None


class Problem(NamedTuple):
    """A smooth unconstrained objective for full-batch solvers.

    All callables take ``(w, aux)``; ``hess(w, aux)`` is the dense Hessian
    when the objective supplies one; ``line_fun(w, p, aux)`` returns
    ``alpha -> fun(w + alpha*p, aux)`` computed with structure, and
    ``line_prefix`` is its carried form. ``prepare(aux) -> aux`` makes what
    the objective reads beside the raw data (the MLP's narrow input copy);
    the solvers call it once per problem and data
    (:func:`lbfgs_ffnn_torch.solvers.common.prepared`), identity when None.
    """

    fun: Callable[..., torch.Tensor]
    grad: Callable[..., torch.Tensor]
    value_and_grad: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    hess: Optional[Callable[..., torch.Tensor]] = None
    line_fun: Optional[Callable[..., Callable[[torch.Tensor], torch.Tensor]]] = None
    line_prefix: Optional[LinePrefix] = None
    prepare: Optional[Callable[[Any], Any]] = None

    def hvp(self, w: torch.Tensor, v: torch.Tensor, aux: Any = ()) -> torch.Tensor:
        """Exact Hessian-vector product, forward over reverse
        (``torch.func.jvp`` of ``grad``)."""
        return torch.func.jvp(lambda u: self.grad(u, aux), (w,), (v,))[1]


class BatchProblem(NamedTuple):
    """A finite-sum objective exposed through per-batch callables
    ``(w, xb, yb)`` (see :class:`lbfgs_ffnn_tpu.types.BatchProblem`); the
    index gather lives in ``take_batch``.

    ``fun_masked``/``grad_masked`` also take a ``(b,)`` 0/1 mask and average
    over the unmasked samples only (the ragged trailing batch of SGD).
    """

    fun: Callable[..., torch.Tensor]  # (w, xb, yb) -> scalar mean loss (+reg)
    grad: Callable[..., torch.Tensor]  # (w, xb, yb) -> flat grad of fun
    value_and_grad: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    fun_masked: Callable[..., torch.Tensor]  # (w, xb, yb, mask) -> scalar
    grad_masked: Callable[..., torch.Tensor]
    per_sample: Callable[..., torch.Tensor]  # (w, xb, yb) -> (b,) losses, no reg
    reg: Optional[Callable[..., torch.Tensor]] = None  # (w,) -> scalar, or None

    def hvp(self, w: torch.Tensor, v: torch.Tensor, xb: torch.Tensor,
            yb: torch.Tensor) -> torch.Tensor:
        """Exact HVP of the batch loss, forward over reverse (``torch.func.jvp``
        of ``torch.func.grad``)."""
        return torch.func.jvp(lambda u: self.grad(u, xb, yb), (w,), (v,))[1]

    def fd_hvp(self, w: torch.Tensor, v: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
               eps: float = 1e-4) -> torch.Tensor:
        """Central finite-difference HVP, the reference's
        (src/minimizer/s_lbfgs.hpp:88-101)."""
        gp = self.grad(w + eps * v, xb, yb)
        gm = self.grad(w - eps * v, xb, yb)
        return (gp - gm) / (2.0 * eps)


class SolveResult(NamedTuple):
    """Outcome of a solver run.

    ``loss_history`` / ``gnorm_history`` are ``(max_iters,)`` tensors padded
    with NaN past ``n_iters``. Counters known on the host (``n_iters``,
    ``n_fevals``, ``n_gevals``, ``n_host_syncs``) are Python ints.
    ``n_host_syncs`` counts the points where the solve waited for the device
    to hand a value to the host. ``trace`` is the solve's
    :class:`~lbfgs_ffnn_torch.utils.profiling.SolveTrace` (its spans,
    counters and the device's idle gaps) where the solve was recorded, else
    None.
    """

    x: torch.Tensor
    n_iters: int
    converged: torch.Tensor  # bool
    final_loss: torch.Tensor
    final_gnorm: torch.Tensor
    loss_history: torch.Tensor
    gnorm_history: torch.Tensor
    metric_history: Optional[torch.Tensor] = None
    n_fevals: Optional[int] = None  # objective (forward) evaluations
    n_gevals: Optional[int] = None  # full-gradient evaluations
    n_hevals: Optional[int] = None  # Hessian-vector products
    n_matvecs: Optional[int] = None  # Krylov operator applications
    n_host_syncs: Optional[int] = None
    trace: Optional[Any] = None


def make_problem(
    fun: Callable[..., torch.Tensor],
    grad: Optional[Callable[..., torch.Tensor]] = None,
    hess: Optional[Callable[..., torch.Tensor]] = None,
    line_fun: Optional[Callable[..., Callable]] = None,
    line_prefix: Optional[LinePrefix] = None,
    prepare: Optional[Callable[[Any], Any]] = None,
) -> Problem:
    """Build a :class:`Problem` from a scalar objective ``fun(w, aux)``, with
    the parameters in the JAX package's order. Analytic ``grad``/``hess``
    may be supplied; otherwise both come from ``torch.func`` autodiff, the
    dense Hessian only up to :data:`DENSE_HESSIAN_LIMIT` parameters."""
    if grad is None:
        grad = torch.func.grad(fun)
        _grad_and_value = torch.func.grad_and_value(fun)

        def value_and_grad(w, aux=()):
            g, f = _grad_and_value(w, aux)
            return f, g
    else:
        def value_and_grad(w, aux=(), _f=fun, _g=grad):
            return _f(w, aux), _g(w, aux)

    if hess is None:
        _dense_hess = torch.func.hessian(fun)

        def hess(w, aux=(), _h=_dense_hess):
            # Refuse before anything n^2 is allocated: an MLP's 101k
            # parameters would need a 41 GB f32 Hessian. The reference's
            # Newton likewise requires an explicit HessFun
            # (src/minimizer/newton.hpp:25).
            n = int(w.shape[0])
            if n > DENSE_HESSIAN_LIMIT:
                raise ValueError(
                    f"default dense torch.func.hessian refused for n={n} > "
                    f"{DENSE_HESSIAN_LIMIT} parameters (would materialize an "
                    f"n^2 = {n * n:,}-element matrix). Pass an analytic/"
                    "structured `hess` to make_problem, or use the "
                    "matrix-free Newton-CG path: NewtonOptions(hess_mode="
                    "'hvp_cg') solves (H + mu I) p = -g with CG over exact "
                    "Hessian-vector products (Problem.hvp) and never forms H.")
            return _h(w, aux)
    if line_fun is None and line_prefix is not None:
        # The per-call restriction is derivable from the carried protocol.
        def line_fun(w, p, aux, _lp=line_prefix):
            return _lp.restrict(_lp.init(w, aux), _lp.direction(p, aux), w, p, aux)
    return Problem(fun=fun, grad=grad, value_and_grad=value_and_grad, hess=hess,
                   line_fun=line_fun, line_prefix=line_prefix, prepare=prepare)


def make_batch_problem(
    per_sample: Callable[..., torch.Tensor],
    reg: Optional[Callable[..., torch.Tensor]] = None,
) -> BatchProblem:
    """Build a :class:`BatchProblem` from a per-sample loss
    ``per_sample(w, xb, yb) -> (b,)`` and an optional whole-parameter
    regularizer ``reg(w)`` added to every batch loss."""

    def fun(w, xb, yb):
        loss = torch.mean(per_sample(w, xb, yb))
        return loss + reg(w) if reg is not None else loss

    def fun_masked(w, xb, yb, mask):
        # Zero the padded rows before per_sample: a where on the loss alone
        # protects the forward, but the backward's zero cotangent times a NaN
        # activation is still NaN.
        xb = zero_masked_rows(mask, xb)
        yb = zero_masked_rows(mask, yb)
        ls = per_sample(w, xb, yb)
        loss = (torch.sum(torch.where(mask > 0, ls, torch.zeros_like(ls)))
                / torch.clamp(torch.sum(mask), min=1.0))
        return loss + reg(w) if reg is not None else loss

    def _value_and_grad(f):
        gv = torch.func.grad_and_value(f)

        def value_and_grad(*args):
            g, v = gv(*args)
            return v, g

        return value_and_grad

    return BatchProblem(
        fun=fun,
        grad=torch.func.grad(fun),
        value_and_grad=_value_and_grad(fun),
        fun_masked=fun_masked,
        grad_masked=torch.func.grad(fun_masked),
        per_sample=per_sample,
        reg=reg,
    )


def zero_masked_rows(mask: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Replace the rows of ``arr`` where ``mask == 0`` with zeros, so NaN or
    Inf padding cannot poison the masked forward or backward."""
    shape = (mask.shape[0],) + (1,) * (arr.ndim - 1)
    return torch.where(mask.reshape(shape) > 0, arr, torch.zeros((), dtype=arr.dtype,
                                                                 device=arr.device))
