"""The resident L-BFGS driver on the CPU against the JAX package, in f64:

* the device-form Armijo search (``armijo_quad_line_search_device``, trial
  slots guarded by device flags) against JAX's ``armijo_quad_line_search``:
  the same ``n_trials``, ``ok`` and alpha; values to rtol 1e-12;
* ``lbfgs_chunked`` (the resident body run eagerly, its writes masked)
  against JAX's ``lbfgs`` and ``lbfgs_chunked`` on a small MLP (with the
  carried prefix) and on Rosenbrock: the same ``n_iters``, ``n_fevals`` and
  ``n_gevals``, loss and gnorm histories to rtol 1e-10, at chunks 1, 3 and
  7 with ``max_iters`` no multiple of them; the bf16 ring, the non-descent
  fallback, a stop on ``tol`` inside a chunk, resume, the measured time
  column and the host-sync bound;
* ``drive_chunks``'s protocol with a counting fake chunk;
* the Launcher's ``timed_chunks`` against the JAX Launcher's.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import functools
import importlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import analytic as ja
from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.ops.linesearch import armijo_quad_line_search as j_armijo
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions
from lbfgs_ffnn_tpu.solvers.lbfgs import lbfgs as j_lbfgs, lbfgs_chunked as j_lbfgs_chunked
from lbfgs_ffnn_torch.objectives import analytic as ta
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.ops.linesearch import (
    armijo_quad_line_search as t_armijo, armijo_quad_line_search_device as t_armijo_device,
)
from lbfgs_ffnn_torch.solvers.common import clone, drive_chunks

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")  # the module, not lbfgs()

MAX_ITERS = 23  # no multiple of any chunk below


# -- the device-form Armijo search ------------------------------------------

def _quadratic(lib, center):
    def f(w, aux=()):
        return 0.5 * lib.sum((w - center) ** 2)
    return f, lambda w, aux=(): (f(w), w - center)


def _octic(lib):
    def f(w, aux=()):
        return lib.sum(w ** 8)
    return f, lambda w, aux=(): (f(w), 8.0 * w ** 7)


# name -> (function factory, x0, direction sign, max_iters, trials wanted)
SEARCHES = {
    "accept_first": (lambda lib: _quadratic(lib, 0.5), [0.0, 0.0], -1.0, 20, 1),
    "several": (_octic, [1.5], -1.0, 20, None),  # > 1
    "exhausted": (lambda lib: _quadratic(lib, 0.0), [1.0, -2.0], 1.0, 4, 4),
}


@pytest.mark.parametrize("mode", ["fused", "lean"])
@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_device_armijo_matches_jax(case, mode):
    make, x0, sign, max_iters, trials = SEARCHES[case]
    out = {}
    for lib, arr in ((jnp, jnp.asarray), (torch, lambda a: torch.tensor(a, dtype=torch.float64))):
        f, vag = make(lib)
        x = arr(np.asarray(x0, dtype=np.float64))
        f0, g0 = vag(x)
        p = sign * g0
        dg0 = arr(np.float64(-abs(float((g0 * p).sum()))))
        kw = {"value": f} if mode == "lean" else {}
        searches = ((j_armijo,) if lib is jnp else (t_armijo_device, t_armijo))
        out[lib.__name__] = [s(vag, x, p, f0, dg0, max_iters=max_iters, **kw) for s in searches]
    (rj,), (rd, re) = out["jax.numpy"], out["torch"]
    n = int(rd.n_trials)
    assert isinstance(rd.n_trials, torch.Tensor) and rd.n_trials.dtype == torch.int32
    assert n == int(rj.n_trials) == re.n_trials
    assert (trials is None and n > 1) or n == trials
    assert bool(rd.ok) == bool(rj.ok) == bool(re.ok) == (case != "exhausted")
    assert float(rd.alpha) == float(rj.alpha) == float(re.alpha)
    np.testing.assert_allclose(float(rd.f_new), float(rj.f_new), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(rd.g_new.numpy(), np.asarray(rj.g_new), rtol=1e-12, atol=1e-15)


# -- lbfgs_chunked against JAX ----------------------------------------------

def _mlp(spec_dims=(12, 8, 3), n=40, seed=0):
    acts = ["relu"] * (len(spec_dims) - 2) + ["linear"]
    js, ts = jmlp.mlp_spec(list(spec_dims), acts), tmlp.mlp_spec(list(spec_dims), acts)
    rng = np.random.default_rng(seed)
    w0 = rng.normal(size=js.n_params) * 0.5
    x = rng.random((n, spec_dims[0]))
    y = np.eye(spec_dims[-1])[rng.integers(0, spec_dims[-1], n)]
    return ((jmlp.mlp_problem(js), jnp.asarray(w0), (jnp.asarray(x), jnp.asarray(y))),
            (tmlp.mlp_problem(ts), torch.tensor(w0), (torch.tensor(x), torch.tensor(y))))


def _rosenbrock(n=6):
    return ((ja.rosenbrock_problem(), ja.rosenbrock_start(n), ()),
            (ta.rosenbrock_problem(), ta.rosenbrock_start(n), ()))


def _cosine(n=6):
    """sum(-cos w) + 0.01 |w|^2 from a start near pi, where it is concave."""
    from lbfgs_ffnn_tpu.types import make_problem as j_make
    from lbfgs_ffnn_torch.types import make_problem as t_make

    x0 = np.pi + np.random.default_rng(4).uniform(-0.3, 0.3, n)
    out = []
    for lib, arr, make in ((jnp, jnp.asarray, j_make), (torch, torch.tensor, t_make)):
        def f(w, aux=(), lib=lib):
            return lib.sum(-lib.cos(w)) + 0.01 * lib.sum(w * w)

        def g(w, aux=(), lib=lib):
            return lib.sin(w) + 0.02 * w

        out.append((make(f, g), arr(x0), ()))
    return tuple(out)


PROBLEMS = {"mlp": _mlp, "rosenbrock": _rosenbrock, "cosine": _cosine}
VARIANTS = {
    "f32-ring": {},
    "bf16-ring": {"pair_dtype": "bfloat16"},
    # every pair enters the ring, negative curvature too: on the concave
    # start of "cosine" some directions are no descent, and the
    # steepest-descent fallback runs (test_nondescent_fallback_runs); tol
    # ends the solve at iteration 16 (|g| = 1.0e-6), before |g| sinks to
    # where it is a cancellation of O(0.1) terms and the packages' last
    # digits decide it
    "nondescent": {"curvature_eps": -1e300, "tol": 2e-6},
}
CASES = [("mlp", "f32-ring"), ("rosenbrock", "f32-ring"), ("mlp", "bf16-ring"),
         ("cosine", "nondescent")]


def _opts(cls, variant, **kw):
    base = dict(max_iters=MAX_ITERS, tol=1e-12, m=5, line_search="armijo", ls_max_iters=20)
    return cls(**{**base, **VARIANTS[variant], **kw})


@functools.lru_cache(maxsize=None)
def _jax_run(problem_name, variant, **kw):
    (jp, jw, jaux), _ = PROBLEMS[problem_name]()
    return j_lbfgs(jp, jw, aux=jaux, opts=_opts(JOptions, variant, **kw))


def _port_run(problem_name, variant, chunk, **kw):
    _, (tp, tw, taux) = PROBLEMS[problem_name]()
    return tl.lbfgs_chunked(tp, tw, taux, _opts(tl.LBFGSOptions, variant, **kw), chunk=chunk)


def _assert_matches(rt, rj):
    assert rt.n_iters == int(rj.n_iters)
    assert rt.n_fevals == int(rj.n_fevals) and rt.n_gevals == int(rj.n_gevals)
    np.testing.assert_allclose(rt.loss_history.double().numpy(), np.asarray(rj.loss_history),
                               rtol=1e-10)
    np.testing.assert_allclose(rt.gnorm_history.double().numpy(),
                               np.asarray(rj.gnorm_history), rtol=1e-10)
    assert bool(rt.converged) == bool(rj.converged)


@pytest.mark.parametrize("problem_name,variant", CASES)
@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_lbfgs_chunked_matches_jax_lbfgs(problem_name, variant, chunk):
    rt, time_ms = _port_run(problem_name, variant, chunk)
    rj = _jax_run(problem_name, variant)
    assert rt.n_iters == (16 if variant == "nondescent" else MAX_ITERS)
    _assert_matches(rt, rj)
    assert rt.n_host_syncs <= -(-rt.n_iters // chunk) + 2
    executed = time_ms[:rt.n_iters]
    assert np.all(np.isfinite(executed)) and np.all(np.diff(executed) >= 0)
    assert time_ms.shape == (MAX_ITERS,)


@pytest.mark.parametrize("problem_name", ["mlp", "rosenbrock"])
def test_lbfgs_chunked_matches_jax_lbfgs_chunked(problem_name):
    (jp, jw, jaux), _ = PROBLEMS[problem_name]()
    rj, jtime = j_lbfgs_chunked(jp, jw, aux=jaux, opts=_opts(JOptions, "f32-ring"), chunk=3)
    rt, ttime = _port_run(problem_name, "f32-ring", 3)
    _assert_matches(rt, rj)
    assert np.isfinite(ttime).sum() == np.isfinite(np.asarray(jtime)).sum() == MAX_ITERS


def test_nondescent_fallback_runs(monkeypatch):
    """The nondescent case's trajectory does take the fallback: the body's
    first ring reset of an iteration is the non-descent one (then the
    failed-search one); iterations past the end, run masked, are not
    counted."""
    flags = []
    reset = tl.ring_reset

    def spy(hist, do_reset):
        flags.append(bool(do_reset))
        return reset(hist, do_reset)

    monkeypatch.setattr(tl, "ring_reset", spy)
    res, _ = _port_run("cosine", "nondescent", 7)
    nondescent = flags[:2 * res.n_iters:2]
    assert any(nondescent) and not all(nondescent)


@pytest.mark.parametrize("problem_name", ["mlp", "rosenbrock"])
def test_stop_on_tol_inside_a_chunk(problem_name):
    """A tol first met at an iteration that ends no chunk stops the solve
    there, as JAX's solve stops; the host syncs stay within the bound."""
    gn = np.asarray(_jax_run(problem_name, "f32-ring").gnorm_history)
    j = next(j for j in range(5, MAX_ITERS - 1)
             if (j + 1) % 7 and gn[j] * (1 + 1e-6) < gn[:j].min())
    tol = float(gn[j]) * (1 + 1e-6)
    rt, time_ms = _port_run(problem_name, "f32-ring", 7, tol=tol)
    rj = _jax_run(problem_name, "f32-ring", tol=tol)
    assert rt.n_iters == int(rj.n_iters) == j + 1 and bool(rt.converged)
    _assert_matches(rt, rj)
    assert np.all(np.isnan(time_ms[rt.n_iters:]))
    assert rt.n_host_syncs <= -(-rt.n_iters // 7) + 2


def test_resume_equals_uninterrupted_run():
    """A state kept by the callback after a chunk, resumed with x0=None,
    ends where the uninterrupted run ends (the carried prefix recomputed
    from the restored iterate, so to rtol 1e-10); the resumed run's time
    column is NaN before its start."""
    _, (tp, tw, taux) = _mlp()
    opts = _opts(tl.LBFGSOptions, "f32-ring")
    kept = []
    full, _ = tl.lbfgs_chunked(tp, tw, taux, opts, chunk=5,
                               callback=lambda s, elapsed: kept.append(clone(s)))
    state = kept[1]
    k0 = int(state.k)
    assert 0 < k0 < MAX_ITERS
    resumed, time_ms = tl.lbfgs_chunked(tp, None, taux, opts, chunk=5, resume_state=state)
    assert resumed.n_iters == full.n_iters == MAX_ITERS
    assert (resumed.n_fevals, resumed.n_gevals) == (full.n_fevals, full.n_gevals)
    np.testing.assert_allclose(resumed.loss_history.numpy(), full.loss_history.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(resumed.x.numpy(), full.x.numpy(), rtol=1e-9, atol=1e-12)
    assert np.all(np.isnan(time_ms[:k0])) and np.all(np.isfinite(time_ms[k0:]))


def test_lbfgs_on_cpu_keeps_the_early_exit_loop():
    """lbfgs() on CPU tensors runs the early-exit loop (its host-sync
    accounting, one per trial and per stop test), lbfgs_chunked the
    resident body; their trajectories are bitwise equal in f64."""
    _, (tp, tw, taux) = _mlp()
    opts = _opts(tl.LBFGSOptions, "f32-ring")
    loop = tl.lbfgs(tp, tw, taux, opts)
    resident, _ = tl.lbfgs_chunked(tp, tw, taux, opts, chunk=4)
    assert loop.n_host_syncs == loop.n_fevals - 1
    assert resident.n_host_syncs <= -(-MAX_ITERS // 4) + 2
    assert torch.equal(loop.loss_history, resident.loss_history)
    assert torch.equal(loop.x, resident.x)


def test_chunked_refuses_what_it_does_not_run():
    _, (tp, tw, taux) = _mlp()
    with pytest.raises(NotImplementedError):
        tl.lbfgs_chunked(tp, tw, taux, tl.LBFGSOptions(line_search="armijo_batched",
                                                       ls_alpha_init="warm"))
    with pytest.raises(NotImplementedError):
        tl.lbfgs_chunked(tp, tw, taux, _opts(tl.LBFGSOptions, "f32-ring"), mesh=object())
    with pytest.raises(ValueError):
        tl.lbfgs_chunked(tp, None, taux, _opts(tl.LBFGSOptions, "f32-ring"))


# -- drive_chunks ------------------------------------------------------------

class _FakeChunks:
    """A counter that moves ``chunk`` per call up to ``stop``; counts calls."""

    def __init__(self, chunk, stop):
        self.chunk, self.stop, self.calls = chunk, stop, 0

    def run(self, k):
        self.calls += 1
        return min(k + self.chunk, self.stop)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("stop,total", [(10, 10), (7, 10), (9, 20)])
def test_drive_chunks_protocol(pipeline, stop, total):
    """Pipelined: one speculative chunk past the stop, its result
    discarded; sequential: none. Callback time (20 ms a call) is not in the
    measured column; the column covers the executed iterations only."""
    fake = _FakeChunks(3, stop)
    seen = []

    def callback(k, elapsed):
        seen.append(k)
        time.sleep(0.02)

    k, time_ms = drive_chunks(fake.run, 0, (), total, counter=lambda k: k,
                              done=lambda k: k >= stop, callback=callback,
                              pipeline=pipeline)
    chunks = -(-stop // 3)
    assert k == stop and seen[-1] == stop and len(seen) == chunks
    assert fake.calls == chunks + (1 if pipeline else 0)
    assert np.all(np.isfinite(time_ms[:stop])) and np.all(np.isnan(time_ms[stop:]))
    assert np.all(np.diff(time_ms[:stop]) >= 0)
    assert time_ms[stop - 1] < 20.0 * (chunks - 1)


def test_drive_chunks_stops_when_no_progress():
    """A chunk that moves the counter no further ends the run."""
    calls = []
    k, time_ms = drive_chunks(lambda k: calls.append(k) or k, 4, (), 10,
                              counter=lambda k: k, done=lambda k: False)
    assert k == 4 and np.all(np.isnan(time_ms))


# -- the Launcher's measured chunks --------------------------------------------

def test_launcher_timed_chunks_matches_jax(tmp_path, monkeypatch):
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
    for make, ds in ((lambda: JLauncher("cuda", dtype=jnp.float64), JDataset(x, y, x, y)),
                     (lambda: Launcher("cuda", dtype=torch.float64, device="cpu",
                                       out_dir=tmp_path), Dataset(x, y, x, y))):
        launcher = make()
        for d_in, d_out, act in zip(dims[:-1], dims[1:], acts):
            launcher.add_layer(d_in, d_out, act)
        launchers.append(launcher.build_network().set_data(ds))
    jl, tl_ = launchers
    jl.weights = jnp.asarray(w0)
    tl_.weights = tmlp.params_from_numpy(tl_.spec, w0, dtype=torch.float64)
    kw = dict(max_iters=17, tolerance=1e-12, m_param=5, log_interval=1, reset_params=False,
              timed_chunks=5)
    rj = jl.train("lbfgs", JConfig(name="J", **kw), verbose=False)
    rt = tl_.train("lbfgs", UnifiedConfig(name="T", **kw), verbose=False)
    hj, ht = j_read(rj.csv_path), read_history_csv(rt.csv_path)
    assert ht.n == hj.n == 17 and rt.warmup_iters == 0
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-9)
    np.testing.assert_allclose(ht.gnorm, hj.gnorm, rtol=1e-9)
    # measured per chunk: equal within a chunk, rising across, inside the wall
    assert np.all(np.diff(ht.time_ms) >= 0) and len(np.unique(ht.time_ms)) == 4
    assert 0 < ht.time_ms[-1] <= rt.wall_time_s * 1e3


def test_runner_timed_chunks_on_cpu(tmp_path):
    """--timed-chunks K runs the runner's L-BFGS rows in measured K-iteration
    chunks (TimeMs steps once per chunk); its GD row keeps the whole-solve
    time spread over the iterations."""
    from lbfgs_ffnn_torch.data.idx import write_idx_u8
    from lbfgs_ffnn_torch.experiments import run_mnist
    from lbfgs_ffnn_torch.recorder import read_history_csv

    rng = np.random.default_rng(4)
    write_idx_u8(tmp_path / "train-labels-idx1-ubyte", rng.integers(0, 10, 32, dtype=np.uint8))
    write_idx_u8(tmp_path / "t10k-labels-idx1-ubyte", rng.integers(0, 10, 8, dtype=np.uint8))
    out = tmp_path / "out"
    done = run_mnist.main(["--dataset", "fashion", "--iters", "7", "--timed-chunks", "3",
                           "--only", "LBFGS_m100", "--data-root", str(tmp_path), "--out-dir", str(out),
                           "--device", "cpu"])
    assert [(s, c.timed_chunks) for s, c, _ in done] == [("lbfgs", 3)]
    (_, cfg, rep), = done
    h = read_history_csv(out / f"{cfg.name}_history.csv")
    assert h.n == rep.result.n_iters == 7 and rep.warmup_iters == 0
    assert len(np.unique(h.time_ms)) == 3 and np.all(np.diff(h.time_ms) >= 0)
