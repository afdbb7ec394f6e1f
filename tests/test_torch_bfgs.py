"""The port's BFGS against the JAX package's in f64: every storage and
linear-solver mode on Rosenbrock n = 4 and Ackley n = 3, an initial
Hessian, the exhausted-search re-evaluation (Rastrigin at its minimum) and
lean Wolfe trials on a small MLP; loss and gradient-norm histories to rtol
1e-8, x to 1e-8, and n_iters, n_fevals, n_gevals and n_matvecs equal. On
the CPU the resident body runs eagerly, the code the card captures.

Rosenbrock is held over 30 iterations: the two libraries' f64 rounding,
amplified by the iteration, reaches 1e-8 of the loss after about 39
(ROADMAP, "Differences that are not faults")."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import analytic as ja
from lbfgs_ffnn_tpu.solvers import BFGSOptions as JOptions, bfgs as j_bfgs
from lbfgs_ffnn_torch.objectives import analytic as ta
from lbfgs_ffnn_torch.solvers import BFGSOptions, bfgs

tb = importlib.import_module("lbfgs_ffnn_torch.solvers.bfgs")

MODES = {"dense-direct": dict(), "dense-cg": dict(linear_solver="cg"),
         "dense-gmres": dict(linear_solver="gmres"),
         "factors-cg": dict(storage="factors", linear_solver="cg"),
         "factors-gmres": dict(storage="factors", linear_solver="gmres")}
COUNTERS = ("n_fevals", "n_gevals", "n_matvecs")


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
    assert torch.all(torch.isnan(rt.loss_history[k:]))


def _case(name, lib):
    mod = ja if lib == "jax" else ta
    start = mod.ackley_start() if name == "ackley" else mod.rosenbrock_start(4)
    return getattr(mod, f"{name}_problem")(), start


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["rosenbrock", "ackley"])
def test_bfgs_matches_jax(name, mode):
    kw = dict(max_iters=30, tol=1e-12, **MODES[mode])
    rj = j_bfgs(*_case(name, "jax"), opts=JOptions(**kw))
    rt = bfgs(*_case(name, "torch"), opts=BFGSOptions(**kw))
    _same_run(rt, rj)
    assert (rt.n_matvecs == 0) == (mode == "dense-direct")


def test_initial_hessian_matches_jax():
    B0 = np.diag([2.0, 1.0, 4.0, 0.5])
    kw = dict(max_iters=20, tol=1e-12)
    rj = j_bfgs(*_case("rosenbrock", "jax"), opts=JOptions(**kw), initial_hessian=jnp.asarray(B0))
    rt = bfgs(*_case("rosenbrock", "torch"), opts=BFGSOptions(**kw),
              initial_hessian=torch.tensor(B0))
    _same_run(rt, rj)


@pytest.mark.parametrize("mode", ["dense-direct", "factors-cg"])
def test_exhausted_searches_match_jax(mode):
    """Rastrigin n = 50 from (+4, -4): the first search lands on the
    minimum at its second trial; every later search exhausts its 50 trials
    and the iteration pays a fresh value-and-gradient (the re-evaluation
    guard). Not GMRES: its first step lands 3e-14 off the minimum, where the
    gradient is all rounding (the two libraries' differ by 15%)."""
    kw = dict(max_iters=4, tol=1e-12, **MODES[mode])
    rj = j_bfgs(ja.rastrigin_problem(), ja.rastrigin_start(50), opts=JOptions(**kw))
    rt = bfgs(ta.rastrigin_problem(), ta.rastrigin_start(50), opts=BFGSOptions(**kw))
    _same_run(rt, rj)
    assert rt.n_fevals == 1 + 2 + 3 * (50 + 1)


def test_f32_rastrigin_nan_matches_jax():
    """The suite's f32 BFGS row on Rastrigin (here n = 50, the direct
    solve) ends in NaN after 3 iterations, in JAX as in the port: the first
    step lands within 3e-5 of the minimum, where the f32 loss rounds to 0
    (10 n less the sum of the cosines cancels); the second search cannot go
    below 0 and exhausts its 50 trials, and its last step (about 2^-50 of p)
    is below half an ulp of x, so s = y = 0 and the update, with no skip
    guard (the reference's and JAX's), divides 0 by 0. The same counters,
    the same histories (NaN included), x all NaN in both."""
    kw = dict(max_iters=6, tol=1e-12)
    rj = j_bfgs(ja.rastrigin_problem(), ja.rastrigin_start(50, jnp.float32), opts=JOptions(**kw))
    rt = bfgs(ta.rastrigin_problem(), ta.rastrigin_start(50, torch.float32),
              opts=BFGSOptions(**kw))
    assert rt.x.dtype == torch.float32 and np.asarray(rj.x).dtype == np.float32
    assert rt.n_iters == int(rj.n_iters) == 3
    assert [getattr(rt, c) for c in COUNTERS] == [int(getattr(rj, c)) for c in COUNTERS]
    assert rt.n_fevals == 1 + 2 + (50 + 1) + 1  # the second search exhausted
    for h in ("loss_history", "gnorm_history"):
        t, j = getattr(rt, h)[:3].numpy(), np.asarray(getattr(rj, h))[:3]
        assert np.array_equal(np.isnan(t), [False, False, True]), (h, t)
        assert np.array_equal(np.isnan(j), [False, False, True]), (h, j)
        np.testing.assert_allclose(t[:2], j[:2], rtol=1e-5)
    assert rt.loss_history[1] == 0.0 and rj.loss_history[1] == 0.0
    assert torch.isnan(rt.x).all() and np.isnan(np.asarray(rj.x)).all()


def test_factors_match_dense():
    """Factor storage is the same algorithm (JAX's own test): the same
    iterations, x and loss history as the dense-B run over 120 iterations."""
    dense = bfgs(*_case("rosenbrock", "torch"),
                 opts=BFGSOptions(max_iters=120, tol=1e-10, linear_solver="cg"))
    mf = bfgs(*_case("rosenbrock", "torch"),
              opts=BFGSOptions(max_iters=120, tol=1e-10, linear_solver="cg", storage="factors"))
    assert mf.n_iters == dense.n_iters
    np.testing.assert_allclose(mf.x.numpy(), dense.x.numpy(), rtol=1e-7)
    np.testing.assert_allclose(mf.loss_history[:mf.n_iters].numpy(),
                               dense.loss_history[:dense.n_iters].numpy(), rtol=1e-6)


def _mlp():
    """JAX's small MLP (8-16-4 tanh), its weights and data from a numpy seed."""
    from lbfgs_ffnn_tpu.objectives import mlp as jm
    from lbfgs_ffnn_torch.objectives import mlp as tm

    rng = np.random.default_rng(0)
    spec_j, spec_t = jm.mlp_spec([8, 16, 4], ["tanh", "linear"]), tm.mlp_spec([8, 16, 4],
                                                                               ["tanh", "linear"])
    w0 = rng.normal(size=spec_t.n_params) * 0.3
    x = rng.normal(size=(32, 8))
    y = np.eye(4)[np.arange(32) % 4]
    jargs = (jm.mlp_problem(spec_j), jnp.asarray(w0), (jnp.asarray(x), jnp.asarray(y)))
    targs = (tm.mlp_problem(spec_t), torch.tensor(w0), (torch.tensor(x), torch.tensor(y)))
    return jargs, targs


@pytest.mark.parametrize("mode", ["factors-cg", "dense-gmres"])
def test_mlp_lean_trials_match_jax(mode):
    """On the MLP the Wolfe trials are lean (loss-only through the line
    restriction, one value-and-gradient at the accepted step)."""
    jargs, targs = _mlp()
    kw = dict(max_iters=10, tol=1e-12, solver_max_iters=50, **MODES[mode])
    _same_run(bfgs(*targs, BFGSOptions(**kw)), j_bfgs(*jargs, JOptions(**kw)))


def test_resident_eager_entry_is_the_solve():
    """``_bfgs_resident_eager`` (the card's reference) is the CPU solve."""
    opts = BFGSOptions(max_iters=12, tol=1e-12, linear_solver="gmres", storage="factors")
    a = bfgs(*_case("rosenbrock", "torch"), opts=opts)
    b = tb._bfgs_resident_eager(*_case("rosenbrock", "torch"), opts=opts, chunk=5)
    assert torch.equal(a.x, b.x) and torch.equal(a.loss_history, b.loss_history)
    assert a.n_host_syncs > 0


@pytest.mark.parametrize("kw,init,match", [
    (dict(storage="sparse"), None, "unknown storage"),
    (dict(storage="factors", linear_solver="direct"), None, "iterative"),
    (dict(storage="factors", linear_solver="cg"), "eye", "dense-mode only"),
    (dict(linear_solver="lu"), None, "unknown linear_solver"),
])
def test_option_errors_match_jax(kw, init, match):
    opts = dict(max_iters=3, **kw)
    with pytest.raises(ValueError, match=match):
        j_bfgs(*_case("rosenbrock", "jax"), opts=JOptions(**opts),
               initial_hessian=None if init is None else jnp.eye(4))
    with pytest.raises(ValueError, match=match):
        bfgs(*_case("rosenbrock", "torch"), opts=BFGSOptions(**opts),
             initial_hessian=None if init is None else torch.eye(4, dtype=torch.float64))


def test_options_match_jax():
    assert BFGSOptions._fields == JOptions._fields
    assert BFGSOptions() == JOptions()
