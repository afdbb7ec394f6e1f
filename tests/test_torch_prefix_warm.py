"""The bf16 carried prefix (``prefix_dtype``, ``prefix_refresh``) and the
warm-started line search (``ls_alpha_init="warm"``) against the JAX
package's ``lbfgs`` and ``lbfgs_chunked``, in f64 on the same numpy inputs
(JAX x64 as the suite's conftest sets it):

* both searches, ``prefix_dtype="bfloat16"`` with ``prefix_refresh`` None
  (16), 5 and 0, on the early-exit loop (``lbfgs`` on CPU tensors) and on
  ``lbfgs_chunked`` at chunks 1 and 7: the same ``n_iters``, ``n_fevals``
  and ``n_gevals``, loss and gnorm histories to rtol 1e-10;
* the refresh re-anchors the prefix exactly and counts itself on the device
  (``n_refresh``);
* warm alpha on Rosenbrock and the small MLP, both searches, and stacked on
  the uint8 input copies with the bf16 prefix and ring;
* a chunked resume under a narrow prefix;
* the step a failed search returns (the seed of warm alpha): Armijo's last
  trial, Wolfe's last update, as JAX's.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import analytic as ja
from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.ops import linesearch as jls
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions
from lbfgs_ffnn_tpu.solvers.lbfgs import lbfgs as j_lbfgs, lbfgs_chunked as j_chunked
from lbfgs_ffnn_torch.objectives import analytic as ta
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.ops import linesearch as tls
from lbfgs_ffnn_torch.solvers.common import clone

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")  # the module, not lbfgs()

DIMS, ACTS = [16, 12, 8, 4], ["relu", "relu", "linear"]
ITERS = 21  # no multiple of 5, 7 or 16


def _mlp(seed=0, n=64, **kw):
    """The small MLP on pixel data (the k/255 grid): (JAX, port) triples of
    (problem, w0, aux); ``kw`` goes to both ``mlp_problem``s."""
    js, ts = jmlp.mlp_spec(DIMS, ACTS), tmlp.mlp_spec(DIMS, ACTS)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, DIMS[0])) / 255.0
    y = np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], n)]
    w0 = rng.normal(size=js.n_params) * 0.4
    return ((jmlp.mlp_problem(js, **kw), jnp.asarray(w0), (jnp.asarray(x), jnp.asarray(y))),
            (tmlp.mlp_problem(ts, **kw), torch.tensor(w0), (torch.tensor(x), torch.tensor(y))))


def _rosenbrock(n=6):
    return ((ja.rosenbrock_problem(), ja.rosenbrock_start(n), ()),
            (ta.rosenbrock_problem(), ta.rosenbrock_start(n), ()))


def _same(rt, rj, rtol=1e-10):
    assert (rt.n_iters, rt.n_fevals, rt.n_gevals) == (
        int(rj.n_iters), int(rj.n_fevals), int(rj.n_gevals))
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history), rtol=rtol)
    np.testing.assert_allclose(rt.gnorm_history.numpy(), np.asarray(rj.gnorm_history),
                               rtol=rtol)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8, atol=1e-10)


def _run(driver, problem, w0, aux, opts):
    if driver == "loop":
        return tl.lbfgs(problem, w0, aux, opts)
    return tl.lbfgs_chunked(problem, w0, aux, opts, chunk=int(driver[len("chunk"):]))[0]


@pytest.mark.parametrize("driver", ["loop", "chunk1", "chunk7"])
@pytest.mark.parametrize("refresh", [None, 5, 0])
@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_bf16_prefix_matches_jax(line_search, refresh, driver):
    (jp, jw, jaux), (tp, tw, taux) = _mlp()
    kw = dict(max_iters=ITERS, tol=1e-12, m=5, line_search=line_search, ls_max_iters=20,
              prefix_dtype="bfloat16", prefix_refresh=refresh)
    rj = j_lbfgs(jp, jw, jaux, JOptions(**kw))
    rt = _run(driver, tp, tw, taux, tl.LBFGSOptions(**kw))
    assert rt.n_iters == ITERS
    _same(rt, rj)


@pytest.mark.parametrize("refresh", [1, 5])
def test_refresh_reanchors_exactly_and_counts(refresh):
    """After a refresh iteration the carried prefix is round(init(x_k))
    bitwise (the IF node recomputed it from the fresh iterate), and the
    state's device counter holds the refreshes so far: floor(k / N)."""
    _, (tp, tw, taux) = _mlp(seed=1)
    opts = tl.LBFGSOptions(max_iters=11, m=4, line_search="armijo", prefix_dtype="bfloat16",
                           prefix_refresh=refresh)
    seen = []
    tl.lbfgs_chunked(tp, tw, taux, opts, chunk=1, callback=lambda s, t: seen.append(clone(s)))
    assert seen
    for s in seen:
        k = int(s.k)
        assert s.prefix.dtype == torch.bfloat16 and int(s.n_refresh) == k // refresh
        if k % refresh == 0:
            want = tp.line_prefix.init(s.x, taux).to(torch.bfloat16)
            assert torch.equal(s.prefix, want), k
    assert int(seen[-1].k) == 11


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
@pytest.mark.parametrize("case", ["rosenbrock", "mlp"])
def test_warm_alpha_matches_jax(case, line_search):
    """ls_alpha_init="warm" with JAX's default growth and a smaller one, on
    both drivers: the MLP's histories to rtol 1e-10, the ill-conditioned
    Rosenbrock's to the 1e-9 of the port's other Rosenbrock trajectories."""
    (jp, jw, jaux), (tp, tw, taux) = _rosenbrock() if case == "rosenbrock" else _mlp(seed=2)
    for growth in (8.0, 2.0):
        kw = dict(max_iters=ITERS, tol=1e-12, m=5, line_search=line_search, ls_max_iters=20,
                  ls_alpha_init="warm", ls_alpha_growth=growth)
        rj = j_lbfgs(jp, jw, jaux, JOptions(**kw))
        fixed = j_lbfgs(jp, jw, jaux, JOptions(**dict(kw, ls_alpha_init="fixed")))
        assert int(rj.n_fevals) != int(fixed.n_fevals) or not np.array_equal(
            np.asarray(rj.loss_history), np.asarray(fixed.loss_history))
        for driver in ("loop", "chunk3"):
            _same(_run(driver, tp, tw, taux, tl.LBFGSOptions(**kw)), rj,
                  rtol=1e-9 if case == "rosenbrock" else 1e-10)


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_warm_alpha_stacked_on_the_u8_traffic_stack(line_search):
    """u8-warm, the bench's row: the uint8 input copies, the bf16 prefix and
    ring, warm alpha; with and without the refresh."""
    (jp, jw, jaux), (tp, tw, taux) = _mlp(seed=3, grad_input_dtype="uint8",
                                          line_input_dtype="uint8", fun_input_dtype="uint8")
    for refresh in (None, 0):
        kw = dict(max_iters=ITERS, tol=1e-12, m=5, line_search=line_search, ls_max_iters=20,
                  pair_dtype="bfloat16", prefix_dtype="bfloat16", prefix_refresh=refresh,
                  ls_alpha_init="warm")
        rj = j_lbfgs(jp, jw, jaux, JOptions(**kw))
        for driver in ("loop", "chunk7"):
            _same(_run(driver, tp, tw, taux, tl.LBFGSOptions(**kw)), rj)


def test_chunked_resume_under_a_narrow_prefix():
    """Resume from the state after 10 iterations: the prefix is recomputed
    from the restored iterate and cast to bf16, in both packages, which then
    go on identically."""
    (jp, jw, jaux), (tp, tw, taux) = _mlp(seed=4, grad_input_dtype="bfloat16")
    kw = dict(max_iters=ITERS, tol=1e-12, m=5, line_search="armijo", prefix_dtype="bfloat16")
    snap_j, snap_t = {}, {}

    def keep(snap, copy):
        def cb(s, _t):
            if int(s.k) == 10:
                snap.setdefault("s", copy(s))
        return cb

    j_chunked(jp, jw, jaux, JOptions(**kw), chunk=5, callback=keep(snap_j, lambda s: s))
    tl.lbfgs_chunked(tp, tw, taux, tl.LBFGSOptions(**kw), chunk=5, callback=keep(snap_t, clone))
    rj, _ = j_chunked(jp, None, jaux, JOptions(**kw), chunk=5, resume_state=snap_j["s"])
    rt, tms = tl.lbfgs_chunked(tp, None, taux, tl.LBFGSOptions(**kw), chunk=5,
                               resume_state=snap_t["s"])
    assert rt.n_iters == int(rj.n_iters) == ITERS and np.all(np.isnan(tms[:10]))
    assert snap_t["s"].prefix.dtype == torch.bfloat16
    assert (rt.n_fevals, rt.n_gevals) == (int(rj.n_fevals), int(rj.n_gevals))
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history),
                               rtol=1e-10)


def _ascent(lib, arr):
    """A quadratic searched along +g: every trial fails."""
    def f(w, aux=()):
        return 0.5 * lib.sum(w * w)
    x = arr(np.array([1.0, -2.0, 0.5]))
    return f, (lambda w, aux=(): (f(w), w)), x


@pytest.mark.parametrize("search", ["armijo", "armijo_device", "wolfe", "wolfe_device"])
def test_failed_search_returns_jaxs_alpha(search):
    """The step a failed search hands the solver, which warm alpha seeds
    from: Armijo's last trial evaluated (the reference keeps it), Wolfe's
    last updated step (the solver re-evaluates there); equal to JAX's."""
    fj, vj, xj = _ascent(jnp, jnp.asarray)
    ft, vt, xt = _ascent(torch, lambda a: torch.tensor(a, dtype=torch.float64))
    pj, pt = xj, xt.clone()  # ascent: dg0 is passed negative so the test is live
    dg0 = -float(xt @ xt)
    kind = search.split("_")[0]
    jfn = {"armijo": jls.armijo_quad_line_search, "wolfe": jls.wolfe_line_search}[kind]
    tfn = {"armijo": tls.armijo_quad_line_search, "armijo_device":
           tls.armijo_quad_line_search_device, "wolfe": tls.wolfe_line_search,
           "wolfe_device": tls.wolfe_line_search_device}[search]
    rj = jfn(vj, xj, pj, fj(xj), jnp.asarray(dg0), max_iters=4, alpha0=jnp.asarray(0.75),
             value=fj)
    seen = []

    def logged(w, aux=()):
        seen.append(float(((w - xt) / pt)[0]))
        return ft(w)

    rt = tfn(vt, xt, pt, ft(xt), torch.tensor(dg0, dtype=torch.float64), max_iters=4,
             alpha0=torch.tensor(0.75, dtype=torch.float64), value=logged)
    assert not bool(rt.ok) and not bool(rj.ok)
    assert float(rt.alpha) == float(rj.alpha)
    assert int(rt.n_trials) == int(rj.n_trials) == 4
    if search == "armijo":  # the last trial evaluated
        assert float(rt.alpha) == pytest.approx(seen[-1], rel=1e-12)
    if search == "wolfe":  # the last update, one past the last trial
        assert float(rt.alpha) == pytest.approx(0.5 * seen[-1], rel=1e-12)
