"""Gradient descent on the CPU against the JAX package, in f64, on a 6-5-3
MLP with N = 40:

* ``gradient_descent`` (the resident body run eagerly, its writes masked)
  against JAX's ``gradient_descent`` for the fixed step, momentum, and the
  Wolfe branch with lean trials (through the MLP's line restriction), fused
  trials, and a budget of 2 fused trials that leaves searches exhausted
  (the re-evaluation): loss and gradient-norm histories to rtol 1e-10, the final
  iterate to rtol 1e-9, ``n_iters``, ``n_fevals`` and ``n_gevals`` equal;
* ``gd_chunked`` at chunks 1 and 3 equal to one solve and to JAX's
  ``gd_chunked``; a resume from a mid-solve state (the momentum velocity
  in it) equal to the uninterrupted solve;
* the eager resident body equal to the host loop ``_gd_loop``, bitwise, on
  every branch.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.solvers.gd import GDOptions as JOptions
from lbfgs_ffnn_tpu.solvers.gd import gd_chunked as j_gd_chunked
from lbfgs_ffnn_tpu.solvers.gd import gradient_descent as j_gd
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.solvers import gd as tgd
from lbfgs_ffnn_torch.solvers.common import clone

DIMS, ACTS = [6, 5, 3], ["relu", "linear"]
N, ITERS = 40, 23  # no multiple of any chunk below
SPEC_T = tmlp.mlp_spec(DIMS, ACTS)
BRANCHES = {
    "fixed": dict(use_line_search=False, step_size=0.1),
    "momentum": dict(momentum=0.9, step_size=0.05),
    "wolfe_lean": dict(),
    "wolfe_fused": dict(ls_value_only=False),
    "wolfe_exhausted": dict(ls_max_iters=2, c1=0.5, ls_value_only=False),
}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, DIMS[0]))
    y = np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], N)]
    return x, y, rng.normal(size=SPEC_T.n_params) * 0.4


X, Y, W0 = _data()
AUX_T = (torch.tensor(X), torch.tensor(Y))
AUX_J = (jnp.asarray(X), jnp.asarray(Y))


@functools.lru_cache(maxsize=None)
def _problems():
    return jmlp.mlp_problem(jmlp.mlp_spec(DIMS, ACTS)), tmlp.mlp_problem(SPEC_T)


def _kw(branch, **extra):
    return dict(max_iters=ITERS, tol=1e-12, **BRANCHES[branch], **extra)


def _assert_matches_jax(rt, rj):
    assert rt.n_iters == int(rj.n_iters)
    assert (rt.n_fevals, rt.n_gevals) == (int(rj.n_fevals), int(rj.n_gevals))
    assert bool(rt.converged) == bool(rj.converged)
    for name in ("loss_history", "gnorm_history"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=1e-10, err_msg=name)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(float(rt.final_loss), float(rj.final_loss), rtol=1e-10)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_gd_matches_jax(branch):
    jp, tp = _problems()
    rj = j_gd(jp, jnp.asarray(W0), AUX_J, JOptions(**_kw(branch)))
    rt = tgd.gradient_descent(tp, torch.tensor(W0), AUX_T, tgd.GDOptions(**_kw(branch)))
    _assert_matches_jax(rt, rj)
    if branch == "wolfe_exhausted":  # fused: more than 2 per iteration only by re-evaluations
        assert rt.n_fevals > 2 * rt.n_iters + 1
    if not branch.startswith("wolfe"):  # eagerly, only the Wolfe loop reads on the host
        assert rt.n_host_syncs <= -(-ITERS // tgd.RESIDENT_CHUNK) + 2


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("branch", ["momentum", "wolfe_lean"])
def test_gd_chunked_matches_one_solve_and_jax(branch, chunk):
    jp, tp = _problems()
    opts = tgd.GDOptions(**_kw(branch))
    whole = tgd.gradient_descent(tp, torch.tensor(W0), AUX_T, opts)
    res, time_ms = tgd.gd_chunked(tp, torch.tensor(W0), AUX_T, opts, chunk=chunk)
    assert torch.equal(res.x, whole.x) and torch.equal(res.loss_history, whole.loss_history)
    assert (res.n_iters, res.n_fevals, res.n_gevals) == (whole.n_iters, whole.n_fevals,
                                                         whole.n_gevals)
    assert time_ms.shape == (ITERS,) and np.all(np.isfinite(time_ms))
    assert np.all(np.diff(time_ms) >= 0) and len(np.unique(time_ms)) == -(-ITERS // chunk)
    rj, _ = j_gd_chunked(jp, jnp.asarray(W0), AUX_J, JOptions(**_kw(branch)), chunk=chunk)
    _assert_matches_jax(res, rj)


@pytest.mark.parametrize("branch", ["momentum", "wolfe_fused"])
def test_gd_resumes_from_a_mid_solve_state(branch):
    """The state after 9 iterations (chunks of 3), the velocity in it,
    carried into a new gd_chunked: the rest of the solve equals the
    uninterrupted one."""
    _, tp = _problems()
    opts = tgd.GDOptions(**_kw(branch))
    kept = {}
    whole, _ = tgd.gd_chunked(tp, torch.tensor(W0), AUX_T, opts, chunk=3,
                              callback=lambda s, _e: kept.setdefault(int(s.k), clone(s)))
    state = kept[9]
    if branch == "momentum":
        assert float(torch.linalg.norm(state.v)) > 0
    res, time_ms = tgd.gd_chunked(tp, None, AUX_T, opts, chunk=4, resume_state=state)
    assert res.n_iters == ITERS
    assert torch.equal(res.x, whole.x) and torch.equal(res.loss_history, whole.loss_history)
    assert (res.n_fevals, res.n_gevals) == (whole.n_fevals, whole.n_gevals)
    assert np.all(np.isnan(time_ms[:9])) and np.all(np.isfinite(time_ms[9:]))


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_gd_eager_body_equals_host_loop(branch):
    _, tp = _problems()
    opts = tgd.GDOptions(**_kw(branch))
    body = tgd._gd_resident_eager(tp, torch.tensor(W0), AUX_T, opts, chunk=7)
    loop = tgd._gd_loop(tp, torch.tensor(W0), AUX_T, opts)
    assert torch.equal(body.x, loop.x)
    assert torch.equal(body.loss_history, loop.loss_history)
    assert torch.equal(body.gnorm_history, loop.gnorm_history)
    assert (body.n_iters, body.n_fevals, body.n_gevals) == (loop.n_iters, loop.n_fevals,
                                                            loop.n_gevals)
    assert loop.n_host_syncs >= ITERS  # one stop test per iteration


def test_gd_options_are_jaxs():
    assert tgd.GDOptions()._asdict() == JOptions()._asdict()
    with pytest.raises(ValueError):
        tgd.gd_chunked(_problems()[1], None, AUX_T)
