"""The Wolfe branch on the resident driver, on the CPU, against the JAX
package in f64:

* the device-form Wolfe search (``wolfe_line_search_device``: its carry in
  device tensors, its trials a ``control.loop``, eager here) against JAX's
  ``wolfe_line_search``, fused, lean and along a restriction: alpha, ``ok``
  and ``n_trials`` exact, values to rtol 1e-12 (the cases of
  tests/test_torch_wolfe.py);
* ``lbfgs_chunked(line_search="wolfe")`` against JAX's ``lbfgs`` on the
  extended Rosenbrock, the MLP (with its carried prefix) and a width-8
  Burgers net on a coarse grid, with and without ``curvature_pairs="hvp"``:
  loss histories to rtol 1e-9, ``n_fevals``/``n_gevals`` exact; and against
  the port's early-exit loop, bitwise;
* ``lbfgs()``'s routing: CUDA tensors to the resident driver under either
  search, CPU tensors to the early-exit loop;
* the Launcher's cpu style (Wolfe L-BFGS, 50 trials) in measured chunks
  against the JAX Launcher's, and the runner's ``--timed-chunks`` on it.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_wolfe
import torch

from lbfgs_ffnn_tpu.objectives import analytic as ja
from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.objectives import pinn as jp
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions, lbfgs as j_lbfgs
from lbfgs_ffnn_torch.objectives import analytic as ta
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.objectives import pinn as tp
from lbfgs_ffnn_torch.ops import linesearch as tls

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")  # the module, not lbfgs()


@pytest.mark.parametrize("mode", ["fused", "lean", "along"])
@pytest.mark.parametrize("case", sorted(test_torch_wolfe.CASES))
def test_device_wolfe_matches_jax(case, mode, monkeypatch):
    """The device form takes the trials of the early-exit search and of
    JAX's: the same alpha, ok and trial count (an int32 tensor), values to
    rtol 1e-12; lean and unaccepted, g_new is zeros."""
    monkeypatch.setattr(test_torch_wolfe, "t_wolfe", tls.wolfe_line_search_device)
    rj, rd = test_torch_wolfe.run_both(case, mode)
    assert isinstance(rd.n_trials, torch.Tensor) and rd.n_trials.dtype == torch.int32
    assert int(rd.n_trials) == int(rj.n_trials)
    assert float(rd.alpha) == float(rj.alpha)
    assert bool(rd.ok) == bool(rj.ok) == bool(rd.evaluated)
    np.testing.assert_allclose(float(rd.f_new), float(rj.f_new), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(rd.g_new.numpy(), np.asarray(rj.g_new), rtol=1e-12, atol=1e-15)


def test_device_wolfe_takes_no_trial_where_not_live():
    f = lambda w, aux=(): 0.5 * torch.sum(w * w)  # noqa: E731
    vag = lambda w, aux=(): (f(w), w)  # noqa: E731
    x = torch.ones(3, dtype=torch.float64)
    r = tls.wolfe_line_search_device(vag, x, -x, f(x), torch.tensor(-3.0, dtype=torch.float64),
                                     live=torch.tensor(False))
    assert int(r.n_trials) == 0 and not bool(r.ok) and float(r.alpha) == 1.0


# -- lbfgs_chunked under Wolfe against JAX ------------------------------------------

COARSE = dict(dx=0.1, dt=0.2, int_dx=0.25, int_dt=0.5)


def _rosenbrock():
    return ((ja.rosenbrock_problem(), ja.rosenbrock_start(6), ()),
            (ta.rosenbrock_problem(), ta.rosenbrock_start(6), ()))


def _mlp():
    dims, acts = [12, 8, 3], ["relu", "linear"]
    js, ts = jmlp.mlp_spec(dims, acts), tmlp.mlp_spec(dims, acts)
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=js.n_params) * 0.5
    x = rng.random((40, 12))
    y = np.eye(3)[rng.integers(0, 3, 40)]
    return ((jmlp.mlp_problem(js), jnp.asarray(w0), (jnp.asarray(x), jnp.asarray(y))),
            (tmlp.mlp_problem(ts), torch.tensor(w0), (torch.tensor(x), torch.tensor(y))))


def _burgers():
    js, ts = jp.default_burgers_spec(8), tp.default_burgers_spec(8)
    w0 = np.asarray(jp.pinn_init(js, jax.random.PRNGKey(2), dtype=jnp.float64))
    return ((jp.burgers_problem(js), jnp.asarray(w0),
             jp.burgers_points(**COARSE, dtype=jnp.float64)),
            (tp.burgers_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
             tp.burgers_points(**COARSE, dtype=torch.float64)))


PROBLEMS = {"rosenbrock": _rosenbrock, "mlp": _mlp, "burgers": _burgers}
# (problem, options beyond the base): fused and lean trials, both curvature pairs
SOLVES = [
    ("rosenbrock", {}), ("rosenbrock", {"ls_value_only": True, "curvature_pairs": "hvp"}),
    ("mlp", {}), ("mlp", {"ls_value_only": False, "curvature_pairs": "hvp"}),
    ("burgers", {"ls_value_only": True}), ("burgers", {"ls_value_only": True,
                                                       "curvature_pairs": "hvp"}),
]
ITERS = 12


def _opts(cls, extra):
    base = dict(max_iters=ITERS, tol=1e-12, m=5, line_search="wolfe", ls_max_iters=20)
    return cls(**{**base, **extra})


@pytest.mark.parametrize("name,extra", SOLVES,
                         ids=[f"{n}-{'-'.join(f'{v}' for v in e.values()) or 'default'}"
                              for n, e in SOLVES])
def test_chunked_wolfe_matches_jax_lbfgs(name, extra):
    """The resident body, run eagerly, takes JAX's trajectory (losses and
    gradient norms to rtol 1e-9, counters exact) and is bitwise the port's
    early-exit loop's; its host reads are the chunks' and the trial loops'."""
    (jprob, jw, jaux), (tprob, tw, taux) = PROBLEMS[name]()
    rj = j_lbfgs(jprob, jw, aux=jaux, opts=_opts(JOptions, extra))
    rt, time_ms = tl.lbfgs_chunked(tprob, tw, taux, _opts(tl.LBFGSOptions, extra), chunk=5)
    rl = tl.lbfgs(tprob, tw, taux, _opts(tl.LBFGSOptions, extra))
    assert rt.n_iters == int(rj.n_iters) == ITERS
    assert (rt.n_fevals, rt.n_gevals) == (int(rj.n_fevals), int(rj.n_gevals))
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history), rtol=1e-9)
    np.testing.assert_allclose(rt.gnorm_history.numpy(), np.asarray(rj.gnorm_history),
                               rtol=1e-9)
    assert (rl.n_fevals, rl.n_gevals) == (rt.n_fevals, rt.n_gevals)
    assert torch.equal(rl.loss_history, rt.loss_history) and torch.equal(rl.x, rt.x)
    # one read per chunk, and per trial loop one per trial plus the last
    assert rt.n_host_syncs >= -(-ITERS // 5) + ITERS - 1
    assert np.all(np.isfinite(time_ms)) and np.all(np.diff(time_ms) >= 0)


def test_chunked_wolfe_reevaluates_failed_searches_like_jax():
    """A one-trial budget with c2 = 0.1 fails some searches; the resident
    body re-evaluates at the last alpha and counts as JAX does, lean and
    fused."""
    for vo in (None, True):
        kw = dict(max_iters=25, tol=1e-10, m=5, line_search="wolfe", ls_max_iters=1,
                  ls_value_only=vo, c2=0.1)
        rj = j_lbfgs(ja.rosenbrock_problem(), ja.rosenbrock_start(6), opts=JOptions(**kw))
        rt, _ = tl.lbfgs_chunked(ta.rosenbrock_problem(), ta.rosenbrock_start(6),
                                 opts=tl.LBFGSOptions(**kw), chunk=7)
        assert rt.n_iters == int(rj.n_iters) == 25
        assert (rt.n_fevals, rt.n_gevals) == (int(rj.n_fevals), int(rj.n_gevals))
        np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history),
                                   rtol=1e-9)


def test_lbfgs_routes_cuda_tensors_to_the_resident_driver(monkeypatch):
    """lbfgs() sends CUDA tensors to the captured resident driver under
    either search, and CPU tensors to the early-exit loop; nothing on the
    card takes the early-exit loop."""
    calls = []
    monkeypatch.setattr(tl, "_solve_resident",
                        lambda *a, **kw: calls.append(("resident", kw["capture"])) or (None, None))
    monkeypatch.setattr(tl, "_lbfgs_loop", lambda *a, **kw: calls.append(("loop",)))

    class OnCard:  # what lbfgs() reads of x0 before it routes
        is_cuda = True

    for ls in ("wolfe", "armijo"):
        tl.lbfgs(None, OnCard(), (), tl.LBFGSOptions(line_search=ls))
        tl.lbfgs(None, torch.zeros(3), (), tl.LBFGSOptions(line_search=ls))
    assert calls == [("resident", True), ("loop",)] * 2


# -- the Launcher and the runner ------------------------------------------------------


def test_launcher_cpu_style_timed_chunks_matches_jax(tmp_path, monkeypatch):
    """The cpu style's Wolfe L-BFGS (50 trials) in measured chunks: the
    port's resident body against the JAX Launcher's lbfgs_chunked."""
    from lbfgs_ffnn_tpu.data.datasets import Dataset as JDataset
    from lbfgs_ffnn_tpu.launcher import Launcher as JLauncher, UnifiedConfig as JConfig
    from lbfgs_ffnn_tpu.recorder import read_history_csv as j_read
    from lbfgs_ffnn_torch.data.datasets import Dataset
    from lbfgs_ffnn_torch.launcher import Launcher, UnifiedConfig
    from lbfgs_ffnn_torch.recorder import read_history_csv

    monkeypatch.chdir(tmp_path)
    dims, acts = [12, 8, 3], ["relu", "linear"]
    rng = np.random.default_rng(2)
    x, y = rng.random((60, 12)), np.eye(3)[rng.integers(0, 3, 60)]
    w0 = rng.normal(size=12 * 8 + 8 + 8 * 3 + 3) * 0.4
    launchers = []
    for make, ds in ((lambda: JLauncher("cpu", dtype=jnp.float64), JDataset(x, y, x, y)),
                     (lambda: Launcher("cpu", dtype=torch.float64, device="cpu",
                                       out_dir=tmp_path), Dataset(x, y, x, y))):
        launcher = make()
        for d_in, d_out, act in zip(dims[:-1], dims[1:], acts):
            launcher.add_layer(d_in, d_out, act)
        launchers.append(launcher.build_network().set_data(ds))
    jl, tl_ = launchers
    jl.weights = jnp.asarray(w0)
    tl_.weights = tmlp.params_from_numpy(tl_.spec, w0, dtype=torch.float64)
    kw = dict(max_iters=13, tolerance=1e-12, m_param=5, log_interval=1, reset_params=False,
              timed_chunks=5)
    rj = jl.train("lbfgs", JConfig(name="J", **kw), verbose=False)
    rt = tl_.train("lbfgs", UnifiedConfig(name="T", **kw), verbose=False)
    assert tl_._lbfgs_opts(UnifiedConfig(**kw)).line_search == "wolfe"
    hj, ht = j_read(rj.csv_path), read_history_csv(rt.csv_path)
    assert ht.n == hj.n == 13 and rt.warmup_iters == 0
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-9)
    np.testing.assert_allclose(ht.gnorm, hj.gnorm, rtol=1e-9)
    assert np.all(np.diff(ht.time_ms) >= 0) and len(np.unique(ht.time_ms)) == 3


def test_runner_cpu_style_timed_chunks(tmp_path):
    """--style cpu --timed-chunks K runs the Wolfe L-BFGS row in measured
    K-iteration chunks on the resident driver."""
    from lbfgs_ffnn_torch.data.idx import write_idx_u8
    from lbfgs_ffnn_torch.experiments import run_mnist
    from lbfgs_ffnn_torch.recorder import read_history_csv

    rng = np.random.default_rng(4)
    write_idx_u8(tmp_path / "train-labels.idx1-ubyte", rng.integers(0, 10, 32, dtype=np.uint8))
    write_idx_u8(tmp_path / "t10k-labels.idx1-ubyte", rng.integers(0, 10, 8, dtype=np.uint8))
    out = tmp_path / "out"
    done = run_mnist.main(["--style", "cpu", "--iters", "7", "--timed-chunks", "3",
                           "--only", "MNIST_LBFGS", "--train-size", "32", "--data-root",
                           str(tmp_path), "--out-dir", str(out), "--device", "cpu"])
    assert [(s, c.timed_chunks) for s, c, _ in done] == [("lbfgs", 3)]
    (_, cfg, rep), = done
    h = read_history_csv(out / f"{cfg.name}_history.csv")
    assert h.n == rep.result.n_iters == 7 and rep.warmup_iters == 0
    assert len(np.unique(h.time_ms)) == 3 and np.all(np.diff(h.time_ms) >= 0)
