"""The traffic variants on the card: the bench's five configurations of the
MNIST L-BFGS solve (f32, bf16-traffic, u8-traffic, u8-warm, u8-warm-nr) at
a small N, each captured solve equal to its body run eagerly on the card
bitwise; the bf16 prefix's refresh, an IF node, fires on (k + 1) % 16 == 0
only and re-anchors the prefix exactly; a second solve on the same data
captures nothing (the prepared narrow copy is the same tensor); and SGD on
uint8 x, sequential and random, equals its eager epoch bodies.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda_traffic.py``.
Skips itself where ``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.experiments.bench import HEADLINE_ROWS, variants
from lbfgs_ffnn_torch.objectives.mlp import (
    mlp_batch_problem, mlp_init, mlp_spec, quantize_pixels,
)
from lbfgs_ffnn_torch.solvers.common import Resident, clear_graph_cache, clone, prepared

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
tsgd = importlib.import_module("lbfgs_ffnn_torch.solvers.sgd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(dev, n=2048, dims=(784, 64, 10), seed=0):
    """Pixel data on the k/255 grid, one-hot labels, a seeded start."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.integers(0, 256, (n, dims[0])) / 255.0, dtype=torch.float32,
                     device=dev)
    y = torch.tensor(np.eye(dims[-1])[rng.integers(0, dims[-1], n)], dtype=torch.float32,
                     device=dev)
    spec = mlp_spec(list(dims), ["relu"] * (len(dims) - 2) + ["linear"])
    w0 = mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32, device=dev)
    return spec, w0, x, y


def _same(a, b, fields=("x", "loss_history", "gnorm_history")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("row", HEADLINE_ROWS)
def test_captured_variant_equals_eager_body_and_captures_once(cuda, row):
    spec, w0, x, y = _case(cuda)
    iters = 37
    base = tl.LBFGSOptions(max_iters=iters, tol=1e-12, m=10, line_search="armijo",
                           ls_max_iters=20)
    problem, opts = variants(spec, base)[row]
    clear_graph_cache()
    c0 = Resident.captures
    cap = tl.lbfgs(problem, w0, (x, y), opts)
    assert Resident.captures == c0 + 1
    eager = tl._lbfgs_resident_eager(problem, w0, (x, y), opts)
    _same(cap, eager)
    assert (cap.n_iters, cap.n_fevals, cap.n_gevals) == (iters, eager.n_fevals, eager.n_gevals)
    lh = cap.loss_history.cpu().numpy()
    assert np.all(np.isfinite(lh)) and lh[-1] < lh[0]
    # the second solve, from another start, replays the cached graph on the
    # same prepared copy
    narrow = prepared(problem, (x, y))
    again = tl.lbfgs(problem, w0 * 0.5, (x, y), opts)
    assert Resident.captures == c0 + 1
    assert all(a is b for a, b in zip(prepared(problem, (x, y)), narrow, strict=True))
    _same(again, tl._lbfgs_resident_eager(problem, w0 * 0.5, (x, y), opts))
    clear_graph_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("refresh", [16, 5])
def test_refresh_node_fires_on_its_iterations_only(cuda, refresh):
    """The refresh's IF node fires on (k + 1) % N == 0 only: the state's
    device counter holds floor(k / N) after k iterations, and after a
    refresh iteration the carried prefix is round(init(x_k)) bitwise."""
    spec, w0, x, y = _case(cuda, seed=1)
    problem, opts = variants(spec, tl.LBFGSOptions(max_iters=40, tol=1e-12, m=10,
                                                   line_search="armijo"))["u8-warm"]
    opts = opts._replace(prefix_refresh=refresh)
    clear_graph_cache()
    seen = []
    tl.lbfgs_chunked(problem, w0, (x, y), opts, chunk=1,
                     callback=lambda s, t: seen.append(clone(s)))
    aux = prepared(problem, (x, y))
    assert {int(s.k) for s in seen} >= set(range(2, 41))
    for s in seen:
        k = int(s.k)
        assert int(s.n_refresh) == k // refresh, k
        if k % refresh == 0:
            with torch.no_grad():
                want = problem.line_prefix.init(s.x, aux).to(torch.bfloat16)
            assert torch.equal(s.prefix, want), k
    clear_graph_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["sequential", "random"])
def test_uint8_sgd_equals_eager_epochs(cuda, sampling):
    """SGD on the pixel-quantized x (uint8 rows gathered per step, the record
    reading uint8 x): the captured epochs equal the eager bodies bitwise,
    and the solve is the float solve on x to rounding."""
    spec, w0, x, y = _case(cuda, n=2000, seed=2)
    xq = quantize_pixels(x)
    problem = mlp_batch_problem(spec)
    opts = tsgd.SGDOptions(epochs=3, batch_size=128, step_size=0.05, momentum=0.9,
                           sampling=sampling, seed=5)
    clear_graph_cache()
    cap = tsgd.sgd(problem, w0, xq, y, opts)
    eager = tsgd._sgd_resident_eager(problem, w0, xq, y, opts)
    _same(cap, eager)
    ref = tsgd.sgd(problem, w0, x, y, opts)
    np.testing.assert_allclose(cap.loss_history.cpu().numpy(), ref.loss_history.cpu().numpy(),
                               rtol=1e-4)
    clear_graph_cache()
