"""The port's Wolfe search against the JAX package's, trial for trial, in
f64: the returned alpha, ``ok``, ``evaluated`` and ``n_trials`` are equal,
values agree to rtol 1e-12 (``atol`` 1e-15 for a value that cancels to
zero, as in tests/test_torch_linesearch.py); and the Wolfe L-BFGS solve
against JAX's where searches fail and the solver re-evaluates, and on the
MLP, whose lean trials take jvps through the carried prefix."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import analytic as ja
from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.ops.linesearch import wolfe_line_search as j_wolfe
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions, lbfgs as j_lbfgs
from lbfgs_ffnn_torch.objectives import analytic as ta
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.ops.linesearch import wolfe_line_search as t_wolfe
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs


def quadratic(lib, center):
    def f(w, aux=()):
        return 0.5 * lib.sum((w - center) ** 2)
    return f, lambda w, aux=(): (f(w), w - center)


def octic(lib):
    def f(w, aux=()):
        return lib.sum(w ** 8)
    return f, lambda w, aux=(): (f(w), 8.0 * w ** 7)


# name -> (function factory, x0, direction scale, search options). The
# direction is scale * gradient; each case drives one branch of the policy
# and the assertions below pin which.
CASES = {
    "accept_first": (lambda lib: quadratic(lib, 0.5), [0.0, 0.0], -1.0, {}),
    # a short step: the curvature test fails twice, alpha doubles to 4
    "expand": (lambda lib: quadratic(lib, 0.0), [1.0, 2.0], -0.03, {}),
    # a long step: Armijo fails once, alpha halves into [0, 1]
    "shrink": (lambda lib: quadratic(lib, 0.0), [1.0], -3.0, {}),
    # a narrow window (steps of 0.9-1.02 Newton steps pass both tests):
    # Armijo fails, then curvature, then Armijo again, and the bracket is
    # bisected to alpha = 5/8
    "bracket": (lambda lib: quadratic(lib, 0.0), [1.0, 3.0], -1.5, {"c1": 0.49, "c2": 0.1}),
    # many doublings and one overshoot on a flat octic
    "octic": (octic, [0.8], -1e-4, {}),
    # an ascent direction reported with a negative slope: nothing passes,
    # and the alpha returned is the post-update one, never evaluated
    "all_fail": (lambda lib: quadratic(lib, 0.0), [1.0, -2.0], 1.0, {"max_iters": 4}),
}


def run_both(case, mode):
    make, x0, scale, opts = CASES[case]
    out = {}
    for lib, search, arr in ((jnp, j_wolfe, jnp.asarray),
                             (torch, t_wolfe, lambda a: torch.tensor(a, dtype=torch.float64))):
        f, vag = make(lib)
        x = arr(np.asarray(x0, dtype=np.float64))
        f0, g0 = vag(x)
        p = scale * g0
        dg0 = -abs(float((g0 * p).sum()))
        kw = {}
        if mode in ("lean", "along"):
            kw["value"] = f
        if mode == "along":
            kw["value_along"] = lambda a, x=x, p=p, f=f: f(x + a * p)
            kw["vag_along"] = lambda a, x=x, p=p, vag=vag: vag(x + a * p)
        out[lib.__name__] = search(vag, x, p, f0, arr(np.float64(dg0)), **opts, **kw)
    return out["jax.numpy"], out["torch"]


@pytest.mark.parametrize("mode", ["fused", "lean", "along"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wolfe_matches_jax(case, mode):
    rj, rt = run_both(case, mode)
    assert float(rt.alpha) == float(rj.alpha)
    assert bool(rt.ok) == bool(rj.ok)
    assert rt.evaluated == bool(rj.evaluated) == bool(rt.ok)
    assert rt.n_trials == int(rj.n_trials)
    np.testing.assert_allclose(float(rt.f_new), float(rj.f_new), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(rt.g_new.numpy(), np.asarray(rj.g_new), rtol=1e-12, atol=1e-15)
    a, n = float(rt.alpha), rt.n_trials
    if case == "accept_first":
        assert rt.ok and n == 1 and a == 1.0
    elif case == "expand":
        assert rt.ok and n == 3 and a == 4.0
    elif case == "shrink":
        assert rt.ok and n == 2 and a == 0.5
    elif case == "bracket":
        assert rt.ok and n == 4 and a == 0.625
    elif case == "octic":
        assert rt.ok and n == 8 and a == 128.0
    else:
        assert not rt.ok and n == 4 and a == 0.5 ** n
        assert not rt.g_new.any() or mode == "fused"


def test_wolfe_zero_trials():
    """max_iters=0 evaluates nothing, as JAX's while_loop does."""
    f, vag = quadratic(torch, 0.5)
    x = torch.zeros(2, dtype=torch.float64)
    r = t_wolfe(vag, x, -x, f(x), torch.tensor(-1.0, dtype=torch.float64), max_iters=0)
    assert r.n_trials == 0 and not r.evaluated and float(r.alpha) == 1.0


@pytest.mark.parametrize("ls_max_iters", [1, 2])
@pytest.mark.parametrize("ls_value_only", [None, True], ids=["fused", "lean"])
def test_failed_searches_reevaluate_like_jax(ls_max_iters, ls_value_only):
    """With c2 = 0.1 a one- or two-trial budget makes some Wolfe searches on
    Rosenbrock fail; the solver then re-evaluates at the search's last
    alpha and counts it as JAX does. rtol 1e-9 on the losses and 1e-8 on
    x, as tests/test_torch_lbfgs.py."""
    kw = dict(max_iters=25, tol=1e-10, m=5, line_search="wolfe", ls_max_iters=ls_max_iters,
              ls_value_only=ls_value_only, c2=0.1)
    rj = j_lbfgs(ja.rosenbrock_problem(), ja.rosenbrock_start(6), opts=JOptions(**kw))
    rt = lbfgs(ta.rosenbrock_problem(), ta.rosenbrock_start(6), opts=LBFGSOptions(**kw))
    full = lbfgs(ta.rosenbrock_problem(), ta.rosenbrock_start(6),
                 opts=LBFGSOptions(**{**kw, "ls_max_iters": 50}))
    assert rt.n_iters == int(rj.n_iters) == 25
    assert rt.n_fevals == int(rj.n_fevals) and rt.n_gevals == int(rj.n_gevals)
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history), rtol=1e-9)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8, atol=1e-10)
    assert not torch.equal(rt.loss_history, full.loss_history)  # some search failed
    if ls_value_only:
        # one host sync per trial and per stop test; the first iteration
        # searches nothing and each later one adds trials + 1 fevals
        assert rt.n_host_syncs == rt.n_fevals - 1


@pytest.mark.parametrize("ls_value_only", [None, False], ids=["lean", "fused"])
def test_mlp_wolfe_matches_jax(ls_value_only):
    """The MLP under Wolfe: by default lean jvp trials through the carried
    prefix's restriction, the prefix moved by its axpy; or fused trials.
    rtol 1e-9 on 30 f64 iterations, as tests/test_torch_lbfgs.py."""
    dims, acts = [12, 8, 3], ["relu", "linear"]
    rng = np.random.default_rng(0)
    js, ts = jmlp.mlp_spec(dims, acts), tmlp.mlp_spec(dims, acts)
    w0 = rng.normal(size=js.n_params) * 0.5
    x = rng.random((40, dims[0]))
    y = np.eye(dims[-1])[rng.integers(0, dims[-1], 40)]
    kw = dict(max_iters=30, tol=1e-12, m=5, line_search="wolfe", ls_value_only=ls_value_only)
    rj = j_lbfgs(jmlp.mlp_problem(js), jnp.asarray(w0), aux=(jnp.asarray(x), jnp.asarray(y)),
                 opts=JOptions(**kw))
    rt = lbfgs(tmlp.mlp_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
               aux=(torch.tensor(x), torch.tensor(y)), opts=LBFGSOptions(**kw))
    assert rt.n_iters == int(rj.n_iters)
    assert rt.n_fevals == int(rj.n_fevals) and rt.n_gevals == int(rj.n_gevals)
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history), rtol=1e-9)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8, atol=1e-10)
