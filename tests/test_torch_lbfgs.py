"""Whole-solve parity: the port's armijo L-BFGS against the JAX package's on
the same f64 MLP problem and the same w0. Counters must be equal; the
trajectory agrees to rtol 1e-9 (loss, gnorm) and 1e-8 (x) — f64 reduction
order differs between the two, and 30 iterations keep the drift far below
any Armijo threshold flip."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions, lbfgs as j_lbfgs
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs

SPECS = {
    "shallow": ([12, 8, 3], ["relu", "linear"]),
    "deep": ([12, 8, 6, 3], ["relu", "tanh", "linear"]),
}
ITERS = 30


def _problem(spec_name, seed=0, n=40):
    dims, acts = SPECS[spec_name]
    rng = np.random.default_rng(seed)
    js, ts = jmlp.mlp_spec(dims, acts), tmlp.mlp_spec(dims, acts)
    w0 = rng.normal(size=js.n_params) * 0.5
    x = rng.random((n, dims[0]))
    y = np.eye(dims[-1])[rng.integers(0, dims[-1], n)]
    return js, ts, w0, x, y


def _solve_both(spec_name, ls_max_iters, impl="plain", **extra):
    js, ts, w0, x, y = _problem(spec_name)
    kw = dict(max_iters=ITERS, tol=1e-12, m=5, line_search="armijo", ls_max_iters=ls_max_iters,
              **extra)
    rj = j_lbfgs(jmlp.mlp_problem(js), jnp.asarray(w0), aux=(jnp.asarray(x), jnp.asarray(y)),
                 opts=JOptions(**kw))
    rt = lbfgs(tmlp.mlp_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
               aux=(torch.tensor(x), torch.tensor(y)), opts=LBFGSOptions(two_loop_impl=impl, **kw))
    return rj, rt


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("ls_max_iters", [20, 1])
def test_trajectory_matches_jax(spec_name, ls_max_iters):
    """ls_max_iters=1 makes every search that needs a second trial fail, so
    the failed-search ring reset runs (checked below: the 1-trial
    trajectory parts from the 20-trial one)."""
    rj, rt = _solve_both(spec_name, ls_max_iters)
    assert rt.n_iters == int(rj.n_iters) == ITERS
    assert rt.n_fevals == int(rj.n_fevals)
    assert rt.n_gevals == int(rj.n_gevals)
    assert bool(rt.converged) == bool(rj.converged)
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history), rtol=1e-9)
    np.testing.assert_allclose(rt.gnorm_history.numpy(), np.asarray(rj.gnorm_history), rtol=1e-9)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(rt.final_loss), float(rj.final_loss), rtol=1e-9)
    # one host sync per line-search trial and per stop test: with lean
    # trials n_fevals = 1 + sum(trials + 1), so syncs = n_fevals - 1
    assert rt.n_host_syncs == rt.n_fevals - 1
    if ls_max_iters == 1:
        _, r20 = _solve_both(spec_name, 20)
        assert r20.n_fevals > rt.n_fevals - 1  # some search needed > 1 trial
        assert not torch.equal(r20.loss_history, rt.loss_history)


def _assert_same_trajectory(rt, rj):
    assert rt.n_iters == int(rj.n_iters)
    assert rt.n_fevals == int(rj.n_fevals) and rt.n_gevals == int(rj.n_gevals)
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history), rtol=1e-9)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("extra", [
    {"ls_value_only": False},     # fused trials: every trial a value-and-gradient
    {"prefix_vag": False},        # accept point from the full objective, prefix axpy
    {"curvature_rel_eps": 1e-3},  # scale-invariant curvature gate
])
def test_option_parity(extra):
    rj, rt = _solve_both("deep", 20, **extra)
    _assert_same_trajectory(rt, rj)


@pytest.mark.parametrize("analytic_grad", [False, True])
def test_generic_problem_parity(analytic_grad):
    """A problem with no line restriction (Rosenbrock via make_problem):
    loss-only trials through ``fun``, torch.func or a supplied gradient."""
    from lbfgs_ffnn_tpu.types import make_problem as j_make
    from lbfgs_ffnn_torch.types import make_problem as t_make

    def rosen(sum_, cat):
        def f(w, aux=()):
            return sum_(100.0 * (w[1:] - w[:-1] ** 2) ** 2 + (1.0 - w[:-1]) ** 2)

        def g(w, aux=()):
            d = w[1:] - w[:-1] ** 2
            zero = w[:1] * 0.0
            return (cat([-400.0 * w[:-1] * d - 2.0 * (1.0 - w[:-1]), zero])
                    + cat([zero, 200.0 * d]))
        return f, g

    jf, jg = rosen(jnp.sum, jnp.concatenate)
    tf, tg = rosen(torch.sum, torch.cat)
    x0 = np.random.default_rng(4).normal(size=6)
    kw = dict(max_iters=ITERS, tol=1e-12, m=5, line_search="armijo", ls_max_iters=20)
    rj = j_lbfgs(j_make(jf, jg if analytic_grad else None), jnp.asarray(x0), opts=JOptions(**kw))
    rt = lbfgs(t_make(tf, tg if analytic_grad else None), torch.tensor(x0),
               opts=LBFGSOptions(**kw))
    _assert_same_trajectory(rt, rj)


def test_cuda_impl_on_cpu_equals_plain():
    """two_loop_impl="cuda", the default, with CPU tensors takes the plain
    two-loop."""
    assert LBFGSOptions().two_loop_impl == "cuda"
    _, a = _solve_both("shallow", 20, impl="plain")
    _, b = _solve_both("shallow", 20, impl="cuda")
    assert torch.equal(a.x, b.x) and a.n_fevals == b.n_fevals


@pytest.mark.parametrize("name", ["ls_spec_k", "ls_alpha_growth"])
def test_options_of_unported_branches_are_refused(name):
    """Options read only by the batched search do not exist here, so setting
    one fails instead of doing nothing; warm alpha's growth is ported with
    JAX's default."""
    if name == "ls_alpha_growth":
        assert LBFGSOptions().ls_alpha_growth == JOptions().ls_alpha_growth == 8.0
        return
    with pytest.raises(TypeError):
        LBFGSOptions(**{name: 1.0})


def test_c2_is_honoured():
    """Wolfe's curvature constant: 0.9 by default, as JAX; c2 = 0.1 asks
    for longer steps, and the port follows JAX's trajectory with either."""
    from lbfgs_ffnn_tpu.objectives import analytic as ja
    from lbfgs_ffnn_torch.objectives import analytic as ta

    assert LBFGSOptions().c2 == JOptions().c2 == 0.9
    runs = {}
    for c2 in (0.9, 0.1):
        kw = dict(max_iters=15, tol=1e-12, m=5, line_search="wolfe", c2=c2)
        rj = j_lbfgs(ja.rosenbrock_problem(), ja.rosenbrock_start(6), opts=JOptions(**kw))
        rt = lbfgs(ta.rosenbrock_problem(), ta.rosenbrock_start(6), opts=LBFGSOptions(**kw))
        _assert_same_trajectory(rt, rj)
        runs[c2] = rt
    assert runs[0.1].n_fevals > runs[0.9].n_fevals
    assert not torch.equal(runs[0.1].loss_history, runs[0.9].loss_history)


def test_stops_on_tol_and_pads_history():
    js, ts, w0, x, y = _problem("shallow")

    def solve(tol):
        return lbfgs(tmlp.mlp_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
                     aux=(torch.tensor(x), torch.tensor(y)),
                     opts=LBFGSOptions(max_iters=50, tol=tol, m=5, line_search="armijo"))

    # a tol just above the smallest gnorm of the first 20 iterations
    tol = float(solve(1e-12).gnorm_history[:20].min()) * (1 + 1e-9)
    r = solve(tol)
    assert bool(r.converged) and 0 < r.n_iters <= 20
    assert torch.all(torch.isnan(r.loss_history[r.n_iters:]))
    assert not torch.any(torch.isnan(r.loss_history[:r.n_iters]))
    assert r.n_host_syncs == r.n_fevals  # the final stop test adds one


@pytest.mark.parametrize("kw", [
    {"line_search": "wolfe", "ls_alpha_init": "warm", "two_loop_impl": "xla"},
    {"line_search": "armijo_batched"},
    {"ls_alpha_init": "warm", "line_search": "armijo_batched"}, {"two_loop_impl": "xla"},
    {"two_loop_impl": "pallas"}, {"pair_dtype": "float16"},
    {"prefix_dtype": "bfloat16", "pair_dtype": "float16"},
    {"prefix_refresh": 16, "two_loop_impl": "pallas"},
])
def test_unported_options_raise(kw):
    js, ts, w0, x, y = _problem("shallow")
    opts = LBFGSOptions(**{"line_search": "armijo", **kw})
    with pytest.raises(NotImplementedError):
        lbfgs(tmlp.mlp_problem(ts), torch.tensor(w0), aux=(torch.tensor(x), torch.tensor(y)),
              opts=opts)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_compact_trajectory_matches_jax_mlp(spec_name):
    """two_loop_impl="compact" in both packages (each its single-device
    compact form) on the f64 MLPs under Armijo: equal counters, the
    trajectory to the rtols of test_trajectory_matches_jax."""
    js, ts, w0, x, y = _problem(spec_name)
    kw = dict(max_iters=ITERS, tol=1e-12, m=5, line_search="armijo", ls_max_iters=20,
              two_loop_impl="compact")
    rj = j_lbfgs(jmlp.mlp_problem(js), jnp.asarray(w0), aux=(jnp.asarray(x), jnp.asarray(y)),
                 opts=JOptions(**kw))
    rt = lbfgs(tmlp.mlp_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
               aux=(torch.tensor(x), torch.tensor(y)), opts=LBFGSOptions(**kw))
    assert rt.n_iters == int(rj.n_iters) == ITERS
    _assert_same_trajectory(rt, rj)
    np.testing.assert_allclose(rt.gnorm_history.numpy(), np.asarray(rj.gnorm_history), rtol=1e-9)


def test_compact_trajectory_matches_jax_rosenbrock_wolfe():
    """two_loop_impl="compact" under the Wolfe search on the f64 extended
    Rosenbrock (n = 6, m = 5, 20 iterations: the ring fills and wraps):
    equal counters and trajectory in both packages."""
    from lbfgs_ffnn_tpu.objectives import analytic as ja
    from lbfgs_ffnn_torch.objectives import analytic as ta

    kw = dict(max_iters=20, tol=1e-12, m=5, line_search="wolfe", two_loop_impl="compact")
    rj = j_lbfgs(ja.rosenbrock_problem(), ja.rosenbrock_start(6), opts=JOptions(**kw))
    rt = lbfgs(ta.rosenbrock_problem(), ta.rosenbrock_start(6), opts=LBFGSOptions(**kw))
    assert rt.n_iters == int(rj.n_iters) == 20
    _assert_same_trajectory(rt, rj)


def test_compact_option_follows_the_loop_form():
    """The compact form is the recursion: the port's f64 MLP solve with
    "compact" keeps the counters and trajectory of its solve with "plain"."""
    _, a = _solve_both("deep", 20, impl="plain")
    _, b = _solve_both("deep", 20, impl="compact")
    assert (a.n_fevals, a.n_gevals) == (b.n_fevals, b.n_gevals)
    np.testing.assert_allclose(b.loss_history.numpy(), a.loss_history.numpy(), rtol=1e-9)
    np.testing.assert_allclose(b.x.numpy(), a.x.numpy(), rtol=1e-8, atol=1e-10)


def test_mesh_not_ported():
    js, ts, w0, x, y = _problem("shallow")
    with pytest.raises(NotImplementedError):
        lbfgs(tmlp.mlp_problem(ts), torch.tensor(w0), aux=(torch.tensor(x), torch.tensor(y)),
              opts=LBFGSOptions(line_search="armijo"), mesh=object())


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_large_rosenbrock_matches_jax_blocked_kernel(line_search):
    """The large-n slice at a CPU size: f32 L-BFGS (m=3, 6 iterations) on
    the extended Rosenbrock at n = 600,000, where JAX's two_loop_impl=
    "pallas" dispatches its rows-blocked kernel (K3, interpret mode) and the
    port runs its plain two-loop on CPU tensors. Counters are equal; the
    losses are f32 sums of 600k terms taken in other orders in the two
    packages and agree to rtol 1e-2 (measured: 4.7e-3)."""
    from lbfgs_ffnn_tpu.objectives import analytic as ja
    from lbfgs_ffnn_tpu.ops.pallas_two_loop import pallas_dispatch
    from lbfgs_ffnn_torch.objectives import analytic as ta

    n = 600_000
    assert pallas_dispatch(-(-n // 1024) * 1024, 3, jnp.float32)[0] == "pallas-blocked"
    kw = dict(max_iters=6, tol=1e-12, m=3, line_search=line_search)
    rj = j_lbfgs(ja.rosenbrock_problem(), ja.rosenbrock_start(n, jnp.float32),
                 opts=JOptions(two_loop_impl="pallas", **kw))
    rt = lbfgs(ta.rosenbrock_problem(), ta.rosenbrock_start(n, torch.float32),
               opts=LBFGSOptions(**kw))
    assert rt.n_iters == int(rj.n_iters) == 6
    assert rt.n_fevals == int(rj.n_fevals) and rt.n_gevals == int(rj.n_gevals)
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history), rtol=1e-2)
    assert rt.loss_history[-1] < rt.loss_history[0] / 100
