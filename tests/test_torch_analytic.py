"""The port's analytic objectives and its L-BFGS on them, against the JAX
package in f64: values, gradients and dense Hessians at rtol 1e-12 (the
same arithmetic; sums run in other orders, so entries that cancel towards
zero get an absolute floor of 1e-12 of the largest entry), and whole
L-BFGS trajectories under Wolfe and Armijo at rtol 1e-9 with equal
counters.

Each trajectory runs until just before the two packages' f64 rounding
differences, amplified by the iteration, reach 1e-9 of the loss: on
Rosenbrock that happens after about 35 iterations at n = 4 and 22 at
n = 1000, where the solve is still far from its minimum."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu import types as jtypes
from lbfgs_ffnn_tpu.objectives import analytic as ja
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions, lbfgs as j_lbfgs
from lbfgs_ffnn_torch import types as ttypes
from lbfgs_ffnn_torch.objectives import analytic as ta
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs


def _close(t, j, rtol):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * np.abs(j).max())


@pytest.mark.parametrize("name", ["rosenbrock", "ackley", "rastrigin"])
@pytest.mark.parametrize("n", [4, 7, 500])
def test_objective_matches_jax(name, n):
    w = np.random.default_rng(n).normal(size=n)
    jp, tp = getattr(ja, f"{name}_problem")(), getattr(ta, f"{name}_problem")()
    for field in ("fun", "grad", "hess"):
        _close(getattr(tp, field)(torch.tensor(w), ()), getattr(jp, field)(jnp.asarray(w), ()),
               1e-12)
    f, g = tp.value_and_grad(torch.tensor(w))
    _close(f, jp.fun(jnp.asarray(w)), 1e-12)
    _close(g, jp.grad(jnp.asarray(w)), 1e-12)


@pytest.mark.parametrize("name", ["rosenbrock", "ackley", "rastrigin"])
def test_autodiff_problem_matches_analytic(name):
    """``analytic=False`` takes the gradient and the dense Hessian from
    torch.func, as JAX's does from jax.grad and jax.hessian."""
    w = torch.tensor(np.random.default_rng(3).normal(size=6))
    auto, exact = getattr(ta, f"{name}_problem")(False), getattr(ta, f"{name}_problem")()
    for field in ("grad", "hess"):
        np.testing.assert_allclose(getattr(auto, field)(w, ()).numpy(),
                                   getattr(exact, field)(w, ()).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_start_points_match_jax(dtype):
    for t, j in ((ta.rosenbrock_start(9, getattr(torch, dtype)),
                  ja.rosenbrock_start(9, getattr(jnp, dtype))),
                 (ta.rastrigin_start(8, getattr(torch, dtype)),
                  ja.rastrigin_start(8, getattr(jnp, dtype))),
                 (ta.ackley_start(getattr(torch, dtype)), ja.ackley_start(getattr(jnp, dtype)))):
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_problem_fields_in_jax_order():
    """``Problem`` and ``make_problem`` keep JAX's order, so a positional
    ``make_problem(f, g, h)`` binds ``h`` to ``hess`` in both."""
    assert ttypes.Problem._fields == jtypes.Problem._fields
    assert (list(inspect.signature(ttypes.make_problem).parameters)
            == list(inspect.signature(jtypes.make_problem).parameters))
    p = ttypes.make_problem(ta.rosenbrock, ta.rosenbrock_grad, ta.rosenbrock_hess)
    assert p.hess is ta.rosenbrock_hess and p.line_fun is None


# case -> (objective, n, max_iters, tol, m)
TRAJECTORIES = {
    "rosenbrock-4": ("rosenbrock", 4, 30, 1e-10, 10),
    "rosenbrock-1000": ("rosenbrock", 1000, 20, 1e-10, 10),
    "ackley-3": ("ackley", 3, 6, 1e-10, 10),
    "rastrigin-500": ("rastrigin", 500, 30, 1e-10, 10),
}


def _start(name, n, lib):
    mod = ja if lib == "jax" else ta
    return mod.ackley_start() if name == "ackley" else getattr(mod, f"{name}_start")(n)


@pytest.mark.parametrize("case", sorted(TRAJECTORIES))
@pytest.mark.parametrize("line_search", ["wolfe", "armijo"])
@pytest.mark.parametrize("ls_value_only", [None, True], ids=["default", "lean"])
def test_trajectory_matches_jax(case, line_search, ls_value_only):
    """Wolfe runs fused trials by default on these problems (no line
    restriction) and jvp trials when lean; Armijo runs loss-only trials
    either way."""
    name, n, iters, tol, m = TRAJECTORIES[case]
    kw = dict(max_iters=iters, tol=tol, m=m, line_search=line_search,
              ls_value_only=ls_value_only)
    rj = j_lbfgs(getattr(ja, f"{name}_problem")(), _start(name, n, "jax"), opts=JOptions(**kw))
    rt = lbfgs(getattr(ta, f"{name}_problem")(), _start(name, n, "torch"),
               opts=LBFGSOptions(**kw))
    assert rt.n_iters == int(rj.n_iters)
    assert rt.n_fevals == int(rj.n_fevals) and rt.n_gevals == int(rj.n_gevals)
    assert bool(rt.converged) == bool(rj.converged)
    k = rt.n_iters
    np.testing.assert_allclose(rt.loss_history[:k].numpy(), np.asarray(rj.loss_history)[:k],
                               rtol=1e-9)
    _close(rt.gnorm_history[:k], np.asarray(rj.gnorm_history)[:k], 1e-9)
    _close(rt.x, rj.x, 1e-9)
    assert torch.all(torch.isnan(rt.loss_history[k:]))


def test_harness_matches_jax():
    """The port's TestSuite against the JAX one on the reference suite's
    Rosenbrock n=4 and Rastrigin n=500 cases under Wolfe: the same
    iterations, statuses and final losses (rtol 1e-9), and a device name in
    each record."""
    from lbfgs_ffnn_tpu import harness as jh
    from lbfgs_ffnn_torch import harness as th

    kw = dict(max_iters=100, tol=1e-8, m=10)
    js = jh.TestSuite().add_implementation(
        "lbfgs", lambda p, x: j_lbfgs(p, x, opts=JOptions(**kw)))
    ts = th.TestSuite().add_implementation(
        "lbfgs", lambda p, x: lbfgs(p, x, opts=LBFGSOptions(**kw)))
    for suite, lib, mod, case in ((js, "jax", ja, jh.TestCase), (ts, "torch", ta, th.TestCase)):
        suite.add_test(case("rosenbrock-4", mod.rosenbrock_problem(),
                            _start("rosenbrock", 4, lib), np.ones(4)))
        suite.add_test(case("rastrigin-500", mod.rastrigin_problem(),
                            _start("rastrigin", 500, lib), np.zeros(500)))
    for rj, rt in zip(js.run(verbose=False), ts.run(verbose=False)):
        assert (rt.test, rt.n_iters, rt.status) == (rj.test, rj.n_iters, rj.status)
        np.testing.assert_allclose(rt.final_loss, rj.final_loss, rtol=1e-9, atol=1e-20)
        assert rt.device == "cpu" and rt.elapsed_s > 0
    assert [r.status for r in ts.records] == ["global-min", "stationary"]
    assert th.classify(1.0, np.zeros(2), None) == jh.classify(1.0, np.zeros(2), None)


# (test, implementation) rows whose stop the two libraries' f64 rounding
# decides: Ackley's slow L-BFGS tail, and Rastrigin from (+4, -4), whose
# Newton and L-BFGS steps reach a loss flat to its last bit (~796) where the
# Wolfe test compares values one ulp apart (ROADMAP, "Differences that are
# not faults"). Their statuses agree; their n_iters within ROUNDING_ITERS.
ROUNDING_ROWS = {("ackley n=3", "LBFGS"), ("rastrigin n=50", "LBFGS"),
                 ("rastrigin n=50", "Newton")}
ROUNDING_ITERS = 3


def test_deterministic_suite_matches_jax_harness():
    """The suite's four implementations (BFGS, L-BFGS m = 16, BFGS+GMRES,
    Newton) on its three cases at reduced size (Rastrigin n = 50,
    max_iters 200, tol 1e-9: JAX's own gate for Rastrigin) through both
    harnesses: the same statuses, and the same n_iters wherever the stop is
    not decided by rounding."""
    from lbfgs_ffnn_tpu import harness as jh
    from lbfgs_ffnn_tpu.solvers import (
        BFGSOptions as JB, NewtonOptions as JN, bfgs as j_bfgs, newton as j_newton,
    )
    from lbfgs_ffnn_torch import harness as th
    from lbfgs_ffnn_torch.solvers import BFGSOptions, NewtonOptions, bfgs, newton

    kw = dict(max_iters=200, tol=1e-9)
    suites = {}
    for lib, h, mod, B, L, N, b, l, nt, extra in (
            ("jax", jh, ja, JB, JOptions, JN, j_bfgs, j_lbfgs, j_newton, {}),
            ("torch", th, ta, BFGSOptions, LBFGSOptions, NewtonOptions, bfgs, lbfgs, newton,
             {"two_loop_impl": "plain"})):
        s = h.TestSuite()
        s.add_implementation("BFGS", lambda p, x, B=B, b=b: b(p, x, opts=B(**kw)))
        s.add_implementation("LBFGS", lambda p, x, L=L, l=l, e=extra: l(p, x, opts=L(m=16, **kw,
                                                                                    **e)))
        s.add_implementation("BFGS+GMRES", lambda p, x, B=B, b=b: b(
            p, x, opts=B(linear_solver="gmres", **kw)))
        s.add_implementation("Newton", lambda p, x, N=N, nt=nt: nt(p, x, opts=N(**kw)))
        s.add_test(h.TestCase("rosenbrock n=4", mod.rosenbrock_problem(), _start("rosenbrock", 4,
                                                                                  lib),
                              expected_min=np.ones(4), gtol=1e-8))
        s.add_test(h.TestCase("ackley n=3", mod.ackley_problem(), _start("ackley", 3, lib),
                              expected_min=np.zeros(3), gtol=1e-8))
        s.add_test(h.TestCase("rastrigin n=50", mod.rastrigin_problem(),
                              _start("rastrigin", 50, lib), gtol=1e-7))
        suites[lib] = s.run(verbose=False)
    assert len(suites["torch"]) == 12
    for rj, rt in zip(suites["jax"], suites["torch"]):
        row = (rt.test, rt.implementation)
        assert row == (rj.test, rj.implementation) and rt.status == rj.status, row
        if row in ROUNDING_ROWS:
            assert abs(rt.n_iters - rj.n_iters) <= ROUNDING_ITERS, row
        else:
            assert rt.n_iters == rj.n_iters, row
    assert {r.status for r in suites["torch"]} == {"global-min", "stationary"}


def test_suite_runner_runs_on_the_cpu(capsys):
    """``python -m lbfgs_ffnn_torch.experiments.run_deterministic_suite
    --device cpu --quick`` end to end: 12 runs, each line printed, the f64
    L-BFGS row on the plain two-loop; without a card the default device
    raises."""
    from lbfgs_ffnn_torch.experiments import run_deterministic_suite as runner

    records = runner.main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out
    assert "two_loop_impl='plain'" in out
    assert len(records) == 12 and len([ln for ln in out.splitlines() if ln.startswith("[")]) == 12
    assert all(r.device == "cpu" and r.n_iters > 0 for r in records)
    statuses = {(r.test, r.implementation): r.status for r in records}
    assert statuses[("ackley n=3", "BFGS")] == "stationary"  # converged in 8 iterations
    assert statuses[("rastrigin n=50", "BFGS")] == "stationary"
    assert statuses[("rosenbrock n=4", "Newton")] == "not-converged"  # needs 26 of the 20
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            runner.main([])


def test_suite_runner_cuts_only_the_gmres_rows(monkeypatch):
    """``--gmres-max-iters N`` (the card's f32 run) sets max_iters N on the
    BFGS+GMRES rows and nothing else: every other row keeps the suite's 5000
    iterations, Rastrigin its n = 500. Each solve is recorded, then run one
    iteration, so the full-size suite stays cheap here."""
    from lbfgs_ffnn_torch.experiments import run_deterministic_suite as runner

    seen = []

    def recording(name, solve):
        def run(p, x0, opts):
            seen.append((name, getattr(opts, "linear_solver", None), opts.max_iters,
                         x0.shape[0], getattr(opts, "two_loop_impl", None)))
            return solve(p, x0, opts=opts._replace(max_iters=1))
        return run

    for name in ("bfgs", "lbfgs", "newton"):
        monkeypatch.setattr(runner, name, recording(name, getattr(runner, name)))
    records = runner.main(["--device", "cpu", "--gmres-max-iters", "7"])
    assert len(records) == len(seen) == 12
    assert sorted({n for *_, n, _ in seen}) == [3, 4, 500]
    for name, solver, iters, _, impl in seen:
        assert iters == (7 if solver == "gmres" else runner.MAX_ITERS), (name, solver, iters)
        assert impl == ("plain" if name == "lbfgs" else None)
    assert sum(solver == "gmres" for _, solver, *_ in seen) == 3
