"""The port's damped Newton and its default dense Hessian against the JAX
package's in f64: both Hessian modes on Rosenbrock n = 4 and on JAX's small
MLP (8-16-4 tanh, weights and data from a numpy seed), the HVP counter on
a quadratic, the autodiff Hessian against ``jax.hessian`` and its size
limit, and the option errors. Histories to rtol 1e-8, x to 1e-8, and
n_iters, n_fevals, n_gevals and n_hevals equal. On the CPU the resident
body runs eagerly, the code the card captures.

Newton-CG on Rosenbrock is held over its first 20 iterations: after ~23
the two libraries' f64 rounding, amplified through CG, moves the loss by
more than 1e-8 (ROADMAP, "Differences that are not faults")."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu import types as jtypes
from lbfgs_ffnn_tpu.objectives import analytic as ja
from lbfgs_ffnn_tpu.solvers import NewtonOptions as JOptions, newton as j_newton
from lbfgs_ffnn_torch import types as ttypes
from lbfgs_ffnn_torch.objectives import analytic as ta
from lbfgs_ffnn_torch.solvers import NewtonOptions, newton

tn = importlib.import_module("lbfgs_ffnn_torch.solvers.newton")
COUNTERS = ("n_fevals", "n_gevals", "n_hevals")


def _close(t, j, rtol=1e-8):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * np.abs(j).max())


def _same_run(rt, rj, rtol=1e-8):
    assert rt.n_iters == int(rj.n_iters)
    assert [getattr(rt, c) for c in COUNTERS] == [int(getattr(rj, c)) for c in COUNTERS]
    assert bool(rt.converged) == bool(rj.converged)
    k = rt.n_iters
    _close(rt.loss_history[:k], np.asarray(rj.loss_history)[:k], rtol)
    _close(rt.gnorm_history[:k], np.asarray(rj.gnorm_history)[:k], rtol)
    _close(rt.x, rj.x, rtol)


@pytest.mark.parametrize("mode,iters", [("dense", 40), ("hvp_cg", 20)])
def test_rosenbrock_matches_jax(mode, iters):
    """Dense Newton converges (gnorm exactly 0) at iteration 26."""
    kw = dict(max_iters=iters, tol=1e-12, hess_mode=mode)
    rj = j_newton(ja.rosenbrock_problem(), ja.rosenbrock_start(4), opts=JOptions(**kw))
    rt = newton(ta.rosenbrock_problem(), ta.rosenbrock_start(4), opts=NewtonOptions(**kw))
    _same_run(rt, rj)
    assert (rt.n_hevals > 0) == (mode == "hvp_cg")


def _mlp():
    from lbfgs_ffnn_tpu.objectives import mlp as jm
    from lbfgs_ffnn_torch.objectives import mlp as tm

    rng = np.random.default_rng(1)
    spec_t = tm.mlp_spec([8, 16, 4], ["tanh", "linear"])
    w0 = rng.normal(size=spec_t.n_params) * 0.3
    x = rng.normal(size=(32, 8))
    y = np.eye(4)[np.arange(32) % 4]
    jargs = (jm.mlp_problem(jm.mlp_spec([8, 16, 4], ["tanh", "linear"])), jnp.asarray(w0),
             (jnp.asarray(x), jnp.asarray(y)))
    targs = (tm.mlp_problem(spec_t), torch.tensor(w0), (torch.tensor(x), torch.tensor(y)))
    return jargs, targs


@pytest.mark.parametrize("mode,iters", [("dense", 4), ("hvp_cg", 10)])
def test_mlp_matches_jax(mode, iters):
    """JAX's matrix-free test case (tests/test_matrixfree_modes.py:54): lean
    Wolfe trials through the line restriction; dense mode takes the
    autodiff Hessian of the 212-parameter objective. The MLP's Hessian is
    indefinite and H + 1e-6 I nearly singular, so the libraries' rounding
    grows ~30x per dense iteration (1e-8 of the loss by iteration 5) and
    ~10x per Newton-CG one (by iteration 11): held over 4 and 10."""
    jargs, targs = _mlp()
    kw = dict(max_iters=iters, tol=1e-12, hess_mode=mode)
    rj, rt = j_newton(*jargs, JOptions(**kw)), newton(*targs, NewtonOptions(**kw))
    _same_run(rt, rj)
    assert float(rt.final_loss) < 0.5 * float(targs[0].fun(targs[1], targs[2]))


def test_hvp_counter_is_exact():
    """f = 0.5 w^T D w with 4 distinct eigenvalues: each iteration one
    damping trial whose CG converges in exactly 4 products (JAX's test)."""
    d = np.array([1.0, 2.0, 2.0, 4.0, 4.0, 9.0])
    kw = dict(max_iters=50, tol=1e-10, hess_mode="hvp_cg", cg_tol=1e-12, cg_max_iters=50)
    dt = torch.tensor(d)
    rt = newton(ttypes.make_problem(lambda w, aux: 0.5 * torch.dot(w, dt * w)),
                torch.ones(6, dtype=torch.float64), opts=NewtonOptions(**kw))
    rj = j_newton(jtypes.make_problem(lambda w, aux: 0.5 * jnp.vdot(w, jnp.asarray(d) * w)),
                  jnp.ones(6), opts=JOptions(**kw))
    assert bool(rt.converged) and rt.n_hevals == 4 * rt.n_iters == int(rj.n_hevals)
    _same_run(rt, rj)


def test_damping_escalates_and_falls_back():
    """A concave quadratic: no damped Newton step up to reg_max descends, so
    every iteration runs all trials and takes -g (JAX's fallback)."""
    d = np.array([-1.0, -2.0, -3.0])
    kw = dict(max_iters=3, tol=1e-12, reg_max=1e-2, ls_max_iters=5)
    dt = torch.tensor(d)
    rt = newton(ttypes.make_problem(lambda w, aux: 0.5 * torch.dot(w, dt * w)),
                torch.ones(3, dtype=torch.float64), opts=NewtonOptions(**kw))
    rj = j_newton(jtypes.make_problem(lambda w, aux: 0.5 * jnp.vdot(w, jnp.asarray(d) * w)),
                  jnp.ones(3), opts=JOptions(**kw))
    _same_run(rt, rj)


def test_dense_hessian_matches_jax():
    """The autodiff default at n = 4 against ``jax.hessian``, and the n = 8193
    refusal, raised before anything n^2 is allocated (JAX's message)."""
    w = np.random.default_rng(4).normal(size=4)
    tp, jp = ta.rosenbrock_problem(analytic=False), ja.rosenbrock_problem(analytic=False)
    _close(tp.hess(torch.tensor(w), ()), jax.hessian(ja.rosenbrock)(jnp.asarray(w), ()), 1e-12)
    _close(tp.hess(torch.tensor(w), ()), jp.hess(jnp.asarray(w), ()), 1e-12)
    assert ttypes.DENSE_HESSIAN_LIMIT == jtypes.DENSE_HESSIAN_LIMIT == 8192
    big = ttypes.DENSE_HESSIAN_LIMIT + 1
    with pytest.raises(ValueError, match="hvp_cg"):
        tp.hess(torch.zeros(big, dtype=torch.float64), ())
    with pytest.raises(ValueError, match="hvp_cg"):
        jp.hess(jnp.zeros(big), ())


def test_option_errors_match_jax():
    with pytest.raises(ValueError, match="unknown hess_mode"):
        newton(ta.rosenbrock_problem(), ta.rosenbrock_start(4),
               opts=NewtonOptions(hess_mode="bfgs"))
    with pytest.raises(ValueError, match="unknown hess_mode"):
        j_newton(ja.rosenbrock_problem(), ja.rosenbrock_start(4), opts=JOptions(hess_mode="bfgs"))
    with pytest.raises(ValueError, match="requires problem.hess"):
        newton(ta.rosenbrock_problem()._replace(hess=None), ta.rosenbrock_start(4),
               opts=NewtonOptions(max_iters=2))
    with pytest.raises(ValueError, match="requires problem.hess"):
        j_newton(ja.rosenbrock_problem()._replace(hess=None), ja.rosenbrock_start(4),
                 opts=JOptions(max_iters=2))
    assert NewtonOptions._fields == JOptions._fields and NewtonOptions() == JOptions()


def test_resident_eager_entry_is_the_solve():
    """``_newton_resident_eager`` (the card's reference) is the CPU solve;
    the eager loops read their flags on the host."""
    opts = NewtonOptions(max_iters=8, tol=1e-12, hess_mode="hvp_cg")
    a = newton(ta.rosenbrock_problem(), ta.rosenbrock_start(4), opts=opts)
    b = tn._newton_resident_eager(ta.rosenbrock_problem(), ta.rosenbrock_start(4), opts=opts,
                                  chunk=3)
    assert torch.equal(a.x, b.x) and torch.equal(a.loss_history, b.loss_history)
    assert a.n_hevals == b.n_hevals and a.n_host_syncs > a.n_iters
