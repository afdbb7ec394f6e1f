"""Physics-informed network objectives: 1D viscous Burgers and a harmonic
oscillator ODE.

Counterpart of :mod:`lbfgs_ffnn_tpu.objectives.pinn`. The reference takes
the PDE derivatives with Enzyme, forward JVPs for u_t and u_x and
forward-over-forward for u_xx per collocation point
(tests/burgers/test_burgers_parallel.cpp:43-63), nested reverse mode for
the oscillator's u'' (tests/enzyme_test2.cpp:22-40). Here they are
``torch.func.jvp`` and jvp-of-jvp of the network, batched over the points
by ``torch.func.vmap`` (the default ``"vmap"`` formulation) or pushed
through jvp as whole point batches (``"batched"``); the loss gradient is
one ``torch.func.grad`` over the weighted objective.

Network conventions are the reference PINN's: tanh MLP, Xavier-uniform
init ``U(-sqrt(6/(in+out)), +sqrt(6/(in+out)))`` per layer
(src/enzyme/pinn_network.hpp:74-92; seeded here).

**Full FP32 matmuls (load-bearing).** The losses differentiate the network
twice, and reduced-precision multiplies break those second derivatives:
on the TPU, bf16 multiplies stalled an f32 L-BFGS run ~20x above the f64
loss (the JAX module's docstring). The CUDA counterpart of a reduced
multiply is TF32, so ``precision="highest"`` (the only value taken) runs
every callable of the problem, and so everything autodiff derives from
the loss (the gradient, the jvp trials, the Hessian-vector product), with
TF32 switched off, whatever the caller set.

Not ported yet: the data-parallel objective (``mesh=``,
``pad_burgers_points``, ``shard_burgers_points``, ``MaskedBurgersPoints``;
ROADMAP queue 1 item 11), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from lbfgs_ffnn_torch.objectives.mlp import MLPSpec, mlp_apply, mlp_apply_single, mlp_spec
from lbfgs_ffnn_torch.solvers.common import full_f32
from lbfgs_ffnn_torch.types import Problem, make_problem

BURGERS_NU = 0.01 / math.pi


def pinn_init(spec: MLPSpec, generator: torch.Generator, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Xavier-uniform init over the flat parameter vector, drawn from
    ``generator`` on its own device and moved to ``device``. The stream
    differs from ``jax.random``'s; parity tests carry JAX's vector over with
    :func:`~lbfgs_ffnn_torch.objectives.mlp.params_from_numpy`."""
    parts = []
    for w_off, b_off, d_in, d_out in spec.layer_slices():
        limit = math.sqrt(6.0 / (d_in + d_out))
        u = torch.rand(d_in * d_out + d_out, generator=generator, dtype=dtype,
                       device=generator.device)
        parts.append((2.0 * u - 1.0) * limit)
    return torch.cat(parts).to(device)


# ---------------------------------------------------------------------------
# Burgers: u_t + u*u_x = nu*u_xx, u(x,0) = sin(pi x), u(+-1,t) = 0, nu = 0.01/pi
# ---------------------------------------------------------------------------


class BurgersPoints(NamedTuple):
    ic_xt: torch.Tensor      # (n_ic, 2)
    ic_target: torch.Tensor  # (n_ic,)
    bc_xt: torch.Tensor      # (n_bc, 2)
    col_xt: torch.Tensor     # (n_col, 2)


def burgers_points(dx: float = 0.001, dt: float = 0.005, int_dx: float = 0.01,
                   int_dt: float = 0.02, dtype=torch.float32, device=None) -> BurgersPoints:
    """The reference runner's grids (tests/burgers/test_burgers_parallel.cpp:
    97-115), the JAX package's numpy grids bit for bit: IC on x in [-1, 1]
    at t = 0 with target sin(pi x), BC at x = +-1 over t in [0, 1],
    collocation on the int_dx x int_dt lattice."""
    xs_ic = np.arange(-1.0, 1.0 + dx / 2, dx)
    ic_xt = np.stack([xs_ic, np.zeros_like(xs_ic)], axis=1)
    ic_target = np.sin(np.pi * xs_ic)

    ts = np.arange(0.0, 1.0 + dt / 2, dt)
    bc_xt = np.concatenate([np.stack([-np.ones_like(ts), ts], axis=1),
                            np.stack([np.ones_like(ts), ts], axis=1)], axis=0)

    xs = np.arange(-1.0, 1.0 + int_dx / 2, int_dx)
    tc = np.arange(0.0, 1.0 + int_dt / 2, int_dt)
    gx, gt = np.meshgrid(xs, tc, indexing="ij")
    col_xt = np.stack([gx.ravel(), gt.ravel()], axis=1)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return BurgersPoints(ic_xt=t(ic_xt), ic_target=t(ic_target), bc_xt=t(bc_xt),
                         col_xt=t(col_xt))


def default_burgers_spec(width: int = 20) -> MLPSpec:
    """2-20-20-20-1 tanh net (reference: test_burgers_parallel.cpp:25-29)."""
    return mlp_spec([2, width, width, width, 1], ["tanh", "tanh", "tanh", "linear"])


def _u(spec: MLPSpec, w: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    return mlp_apply(spec, w, xt)[:, 0]


def burgers_residual(spec: MLPSpec, w: torch.Tensor, xt: torch.Tensor, nu: float = BURGERS_NU,
                     formulation: str = "vmap") -> torch.Tensor:
    """PDE residual u_t + u*u_x - nu*u_xx at each point of ``xt (n, 2)``.

    ``"vmap"`` (the default, as in JAX): per-point scalar derivatives, jvp
    and forward-over-forward jvp (the reference's __enzyme_fwddiff
    composition), vectorised over the points with ``torch.func.vmap``.
    ``"batched"``: the same jvps of the batched network along the whole
    point batch's unit directions; the same math. The unit directions are
    rows of ``torch.eye`` (a device kernel, no host copy under capture)."""
    e = torch.eye(2, dtype=xt.dtype, device=xt.device)
    ex, et = e[0], e[1]
    jvp = torch.func.jvp
    if formulation == "batched":
        n = xt.shape[0]
        ex_n, et_n = ex.expand(n, 2).contiguous(), et.expand(n, 2).contiguous()

        def u_fn(pts):
            return _u(spec, w, pts)

        u, u_x = jvp(u_fn, (xt,), (ex_n,))
        _, u_t = jvp(u_fn, (xt,), (et_n,))
        _, u_xx = jvp(lambda pts: jvp(u_fn, (pts,), (ex_n,))[1], (xt,), (ex_n,))
        return u_t + u * u_x - nu * u_xx
    if formulation != "vmap":
        raise ValueError(f"unknown formulation {formulation!r}; expected 'vmap' or 'batched'")

    def u1(pt):
        return mlp_apply_single(spec, w, pt)[0]

    def per_point(pt):
        u, u_x = jvp(u1, (pt,), (ex,))
        _, u_t = jvp(u1, (pt,), (et,))
        _, u_xx = jvp(lambda q: jvp(u1, (q,), (ex,))[1], (pt,), (ex,))
        return u_t + u * u_x - nu * u_xx

    return torch.func.vmap(per_point)(xt)


def _check_precision(precision: str) -> None:
    if precision != "highest":
        raise ValueError(f"precision={precision!r}: the PINN objectives run full FP32 matmuls "
                         "only (\"highest\"); reduced-precision multiplies break their second "
                         "derivatives")


def _highest(problem: Problem) -> Problem:
    """``problem`` with its callables run under full FP32 (TF32 off), so the
    gradient and every jvp through them too."""
    def wrap(fn):
        def run(*args, **kw):
            with full_f32():
                return fn(*args, **kw)
        return run

    return problem._replace(fun=wrap(problem.fun), grad=wrap(problem.grad),
                            value_and_grad=wrap(problem.value_and_grad))


def burgers_problem(spec: MLPSpec | None = None, w_ic: float = 20.0, w_bc: float = 20.0,
                    w_pde: float = 1.0, nu: float = BURGERS_NU, precision: str = "highest",
                    mesh=None, formulation: str = "vmap") -> Problem:
    """Weighted IC/BC/PDE mean-squared loss (reference:
    test_burgers_parallel.cpp:127-161); ``aux`` is a :class:`BurgersPoints`.
    ``formulation`` is :func:`burgers_residual`'s."""
    _check_precision(precision)
    if mesh is not None:
        raise NotImplementedError("burgers_problem(mesh=...), the data-parallel objective, is "
                                  "not ported yet (ROADMAP queue 1 item 11)")
    spec = spec or default_burgers_spec()

    def fun(w, aux):
        pts: BurgersPoints = aux
        loss_ic = torch.mean((_u(spec, w, pts.ic_xt) - pts.ic_target) ** 2)
        loss_bc = torch.mean(_u(spec, w, pts.bc_xt) ** 2)
        r = burgers_residual(spec, w, pts.col_xt, nu, formulation)
        return w_ic * loss_ic + w_bc * loss_bc + w_pde * torch.mean(r ** 2)

    return _highest(make_problem(fun))


# ---------------------------------------------------------------------------
# Harmonic oscillator ODE: u'' + u = 0, u(0) = 0, u'(0) = 1 => u = sin(x)
# (reference: tests/enzyme_test2.cpp)
# ---------------------------------------------------------------------------


def default_oscillator_spec(width: int = 16) -> MLPSpec:
    return mlp_spec([1, width, width, 1], ["tanh", "tanh", "linear"])


def oscillator_problem(spec: MLPSpec | None = None, w_ode: float = 1.0, w_bc: float = 1.0,
                       precision: str = "highest") -> Problem:
    """ODE residual plus the initial conditions, u'' by jvp-of-jvp (the
    reference nests reverse-mode Enzyme for it, enzyme_test2.cpp:22-40);
    ``aux`` is the ``(n, 1)`` collocation points."""
    _check_precision(precision)
    spec = spec or default_oscillator_spec()
    jvp = torch.func.jvp

    def fun(w, aux):
        xs = aux

        def u1(pt):
            return mlp_apply_single(spec, w, pt)[0]

        def per_point(pt):
            one = torch.ones_like(pt)
            u, _ = jvp(u1, (pt,), (one,))
            _, ddu = jvp(lambda q: jvp(u1, (q,), (torch.ones_like(q),))[1], (pt,), (one,))
            return u, ddu

        u, ddu = torch.func.vmap(per_point)(xs)
        ode = torch.mean((ddu + u) ** 2)
        x0 = torch.zeros((1,), dtype=xs.dtype, device=xs.device)
        u0, du0 = jvp(u1, (x0,), (torch.ones_like(x0),))
        # du0 - ones, not du0 - 1.0: in torch 2.13, forward over reverse
        # of the Python float's subtraction (Problem.hvp) meets a float64
        # operand in an f32 matmul
        return w_ode * ode + w_bc * (u0 ** 2 + (du0 - torch.ones_like(du0)) ** 2)

    return _highest(make_problem(fun))


def oscillator_points(n: int = 64, x_max: float = math.pi, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """``n`` evenly spaced points on [0, x_max] as an ``(n, 1)`` tensor
    (``jnp.linspace``'s values, from numpy in f64)."""
    return torch.tensor(np.linspace(0.0, x_max, n).reshape(-1, 1), dtype=dtype, device=device)
