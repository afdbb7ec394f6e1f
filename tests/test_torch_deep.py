"""The deep-net path of the port against the JAX package: the f64 L-BFGS
trajectory on a 4-layer net with f32-width and bf16 pairs, gradient descent
(momentum, fixed step and the Wolfe search), and the Fashion-MNIST loader.

Tolerances: both packages compute in f64 and store bf16 pairs with the same
rounding (f64 -> f32 -> bf16 in both, checked bit for bit in
tests/test_torch_two_loop.py), so only f64 summation order differs: rtol
1e-9 on losses and gradient norms over 30 iterations, with equal counters."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.data import datasets as jds
from lbfgs_ffnn_tpu.data import idx as jidx
from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.solvers.gd import GDOptions as JGDOptions, gradient_descent as j_gd
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions, lbfgs as j_lbfgs
from lbfgs_ffnn_torch.data import datasets as tds
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.solvers.gd import RESIDENT_CHUNK, GDOptions, gradient_descent
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs

DIMS, ACTS = [20, 16, 12, 8, 4], ["relu", "relu", "relu", "linear"]
N, ITERS = 256, 30


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    js, ts = jmlp.mlp_spec(DIMS, ACTS), tmlp.mlp_spec(DIMS, ACTS)
    w0 = rng.normal(size=js.n_params) * 0.4
    x = rng.random((N, DIMS[0]))
    y = np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], N)]
    return js, ts, w0, x, y


def _assert_same(rt, rj):
    assert rt.n_iters == int(rj.n_iters) == ITERS
    assert rt.n_fevals == int(rj.n_fevals) and rt.n_gevals == int(rj.n_gevals)
    np.testing.assert_allclose(rt.loss_history.numpy(), np.asarray(rj.loss_history), rtol=1e-9)
    np.testing.assert_allclose(rt.gnorm_history.numpy(), np.asarray(rj.gnorm_history), rtol=1e-9)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("pair_dtype", [None, "bfloat16"])
def test_deep_lbfgs_trajectory_matches_jax(pair_dtype):
    """m=5 over 30 iterations: the ring fills and wraps, on a bf16 ring too."""
    js, ts, w0, x, y = _problem()
    kw = dict(max_iters=ITERS, tol=1e-12, m=5, line_search="armijo", ls_max_iters=20,
              pair_dtype=pair_dtype)
    rj = j_lbfgs(jmlp.mlp_problem(js), jnp.asarray(w0), aux=(jnp.asarray(x), jnp.asarray(y)),
                 opts=JOptions(**kw))
    rt = lbfgs(tmlp.mlp_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
               aux=(torch.tensor(x), torch.tensor(y)), opts=LBFGSOptions(**kw))
    _assert_same(rt, rj)
    assert rt.n_host_syncs == rt.n_fevals - 1


def test_bf16_ring_changes_the_trajectory():
    """The narrow ring is really used: its trajectory parts from the f32 one."""
    js, ts, w0, x, y = _problem()
    runs = [lbfgs(tmlp.mlp_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
                  aux=(torch.tensor(x), torch.tensor(y)),
                  opts=LBFGSOptions(max_iters=ITERS, tol=1e-12, m=5, line_search="armijo",
                                    pair_dtype=pd))
            for pd in (None, "bfloat16")]
    assert not torch.equal(runs[0].x, runs[1].x)
    np.testing.assert_allclose(float(runs[1].final_loss), float(runs[0].final_loss), rtol=0.05)


@pytest.mark.parametrize("momentum,step", [(0.9, 0.02), (0.0, 0.05)])
def test_gd_trajectory_matches_jax(momentum, step):
    """Momentum (the cuda style's GD) and the fixed step (the cpu style's)."""
    js, ts, w0, x, y = _problem(1)
    kw = dict(max_iters=ITERS, tol=1e-12, step_size=step, momentum=momentum,
              use_line_search=False)
    rj = j_gd(jmlp.mlp_problem(js), jnp.asarray(w0), aux=(jnp.asarray(x), jnp.asarray(y)),
              opts=JGDOptions(**kw))
    rt = gradient_descent(tmlp.mlp_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
                          aux=(torch.tensor(x), torch.tensor(y)), opts=GDOptions(**kw))
    _assert_same(rt, rj)
    assert bool(rt.converged) == bool(rj.converged)
    # the resident driver: one read per chunk of iterations
    assert rt.n_host_syncs <= -(-ITERS // RESIDENT_CHUNK) + 2


def test_gd_stops_on_tol():
    js, ts, w0, x, y = _problem(1)

    def solve(tol):
        return gradient_descent(
            tmlp.mlp_problem(ts), tmlp.params_from_numpy(ts, w0, dtype=torch.float64),
            aux=(torch.tensor(x), torch.tensor(y)),
            opts=GDOptions(max_iters=50, tol=tol, step_size=0.05, use_line_search=False))

    tol = float(solve(0.0).gnorm_history[:10].min()) * (1 + 1e-9)
    r = solve(tol)
    assert bool(r.converged) and 0 < r.n_iters <= 10
    assert torch.all(torch.isnan(r.loss_history[r.n_iters:]))
    assert r.n_host_syncs <= -(-r.n_iters // RESIDENT_CHUNK) + 2
    assert r.n_fevals == r.n_gevals == r.n_iters + 1


def test_gd_wolfe_not_ported():
    """momentum 0 with the line search (the JAX default), once refused, is
    the Wolfe branch: JAX's trajectory on the deep net."""
    js, ts, w0, x, y = _problem()
    rj = j_gd(jmlp.mlp_problem(js), jnp.asarray(w0), aux=(jnp.asarray(x), jnp.asarray(y)),
              opts=JGDOptions(max_iters=ITERS, tol=1e-12))
    rt = gradient_descent(tmlp.mlp_problem(ts), torch.tensor(w0),
                          aux=(torch.tensor(x), torch.tensor(y)), opts=GDOptions(max_iters=ITERS,
                                                                                 tol=1e-12))
    _assert_same(rt, rj)


@pytest.mark.parametrize("with_images", [False, True])
def test_load_fashion_mnist_matches_jax(tmp_path, with_images):
    """The dashed Fashion file names and prototype seed 456: with only the
    label files both loaders synthesize the same images; with the image
    files both read them (the JAX native reader may differ by one float32
    ulp, see tests/test_torch_data.py)."""
    rng = np.random.default_rng(2)
    for split, n in (("train", 40), ("t10k", 12)):
        jidx.write_idx_u8(tmp_path / f"{split}-labels-idx1-ubyte",
                          rng.integers(0, 10, n, dtype=np.uint8))
        if with_images:
            jidx.write_idx_u8(tmp_path / f"{split}-images-idx3-ubyte",
                              rng.integers(0, 256, (n, 28, 28), dtype=np.uint8))
    t = tds.load_fashion_mnist(tmp_path, train_size=30, test_size=12)
    j = jds.load_fashion_mnist(train_size=30, test_size=12, root=tmp_path)
    assert t.synthetic_images == j.synthetic_images == (not with_images)
    assert t.n_train == 30 and t.test_x.shape == (12, 784)
    for name in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), rtol=1.2e-7, atol=0)
    if not with_images:  # prototype seed 456, not MNIST's 123
        assert not np.array_equal(
            t.train_x, tds.synthetic_images_for_labels(np.argmax(t.train_y, axis=1)))


def test_load_fashion_mnist_needs_root_and_labels(tmp_path):
    with pytest.raises(TypeError):
        tds.load_fashion_mnist()  # no default root outside the checkout
    with pytest.raises(OSError):
        tds.load_fashion_mnist(tmp_path, train_size=5, test_size=5)
