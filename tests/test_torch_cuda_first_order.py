"""The first-order solvers on the card: ``gradient_descent`` on CUDA tensors
(the iteration replayed from its captured CUDA graph: fixed step, momentum,
and the Wolfe search with its trials a WHILE node and its re-evaluation an
IF node) and ``sgd`` (each epoch replayed from its start, segment and finish
graphs: sequential with a ragged tail, and random) equal their bodies run
eagerly on the card bitwise, with at most ceil(steps / chunk) + 2 host
syncs per solve; a later seed replays the same graphs; and a body that
raises under capture raises cleanly and leaves the next capture working.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda_first_order.py``.
Skips itself where ``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn_torch.solvers.common import Resident, clear_graph_cache

tgd = importlib.import_module("lbfgs_ffnn_torch.solvers.gd")
tsgd = importlib.import_module("lbfgs_ffnn_torch.solvers.sgd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(dev, n=2000, dims=(784, 32, 10), seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((n, dims[0])), dtype=torch.float32, device=dev)
    y = torch.tensor(np.eye(dims[-1])[rng.integers(0, dims[-1], n)], dtype=torch.float32,
                     device=dev)
    spec = mlp_spec(list(dims), ["relu"] * (len(dims) - 2) + ["linear"])
    w0 = mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32, device=dev)
    return spec, w0, x, y


def _same(a, b, fields=("x", "loss_history", "gnorm_history")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


GD_BRANCHES = {"fixed": dict(use_line_search=False, step_size=0.1),
               "momentum": dict(momentum=0.9, step_size=0.05),
               "wolfe": dict(),
               "wolfe_fused": dict(ls_value_only=False, ls_max_iters=3, c1=0.5)}


@pytest.mark.cuda
@pytest.mark.parametrize("branch", sorted(GD_BRANCHES))
def test_captured_gd_equals_eager_body(cuda, branch):
    spec, w0, x, y = _case(cuda)
    problem, iters = mlp_problem(spec), 23
    opts = tgd.GDOptions(max_iters=iters, tol=1e-12, **GD_BRANCHES[branch])
    clear_graph_cache()
    cap = tgd.gradient_descent(problem, w0, (x, y), opts)
    eager = tgd._gd_resident_eager(problem, w0, (x, y), opts)
    _same(cap, eager)
    assert (cap.n_iters, cap.n_fevals, cap.n_gevals) == (eager.n_iters, eager.n_fevals,
                                                         eager.n_gevals) and cap.n_iters == iters
    assert cap.n_host_syncs <= -(-iters // tgd.RESIDENT_CHUNK) + 2
    lh = cap.loss_history.cpu().numpy()
    assert np.all(np.isfinite(lh)) and lh[-1] < lh[0]
    # a second solve from another start replays the cached graph
    c0 = Resident.captures
    w1 = w0 * 0.5
    again = tgd.gradient_descent(problem, w1, (x, y), opts)
    assert Resident.captures == c0
    _same(again, tgd._gd_resident_eager(problem, w1, (x, y), opts))


def _acc(spec):
    from lbfgs_ffnn_torch.objectives.mlp import mlp_apply

    def acc(w, x, y):
        return (mlp_apply(spec, w, x).argmax(1) == y.argmax(1)).to(w.dtype).mean() * 100.0
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["sequential", "random"])
def test_captured_sgd_equals_eager_body(cuda, sampling, monkeypatch):
    """Segments of 4 steps: 15 full batches of 128 are 3 replays and 3 steps
    left over, then the 80-row tail (sequential)."""
    monkeypatch.setattr(tsgd, "SEGMENT", 4)
    spec, w0, x, y = _case(cuda)
    problem, epochs = mlp_batch_problem(spec), 13
    opts = tsgd.SGDOptions(epochs=epochs, batch_size=128, step_size=0.05, momentum=0.9,
                           sampling=sampling, lr_decay=0.8, lr_decay_step=4,
                           metric_fn=_acc(spec))
    clear_graph_cache()
    cap = tsgd.sgd(problem, w0, x, y, opts)
    eager = tsgd._sgd_resident_eager(problem, w0, x, y, opts)
    _same(cap, eager, ("x", "loss_history", "gnorm_history", "metric_history"))
    assert cap.n_iters == eager.n_iters == epochs
    assert cap.n_host_syncs <= -(-epochs // tsgd.RESIDENT_CHUNK) + 2
    lh = cap.loss_history.cpu().numpy()
    assert np.all(np.isfinite(lh)) and lh[-1] < lh[0]
    # another seed: the same graphs (the seed is in the state), its own draws
    c0 = Resident.captures
    other = tsgd.sgd(problem, w0, x, y, opts._replace(seed=7))
    assert Resident.captures == c0
    _same(other, tsgd._sgd_resident_eager(problem, w0, x, y, opts._replace(seed=7)))
    assert torch.equal(other.x, cap.x) == (sampling == "sequential")


@pytest.mark.cuda
def test_body_that_raises_under_capture_raises_cleanly(cuda):
    """A value-and-gradient that raises while the Wolfe search's fused trial
    is captured into its WHILE node, inside the iteration's IF node: the
    solve raises, no graph is cached, the caller's stream is current again,
    and the next captured solve works and equals its eager body."""
    from lbfgs_ffnn_torch.ops import control

    spec, w0, x, y = _case(cuda)
    good = mlp_problem(spec)

    def vag(w, aux):
        if control._CAPTURE is not None and not control._CAPTURE.flat:
            raise ValueError("the objective failed under capture")
        return good.value_and_grad(w, aux)

    bad = good._replace(value_and_grad=vag)
    opts = tgd.GDOptions(max_iters=5, tol=1e-12, ls_value_only=False)
    stream = torch.cuda.current_stream()
    clear_graph_cache()
    with pytest.raises((RuntimeError, ValueError)):
        tgd.gradient_descent(bad, w0, (x, y), opts)
    assert torch.cuda.current_stream() == stream
    torch.cuda.synchronize()
    cap = tgd.gradient_descent(good, w0, (x, y), opts)
    _same(cap, tgd._gd_resident_eager(good, w0, (x, y), opts))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gd", "sgd"])
def test_warm_up_captures_the_timed_solves_step(cuda, solver):
    """``gd_warm_up`` and ``sgd_warm_up`` capture the step of the solve
    they precede and run its first iterations (epochs) from its graphs: the
    whole solve after them captures nothing, and both equal the eager body
    bitwise."""
    spec, w0, x, y = _case(cuda)
    clear_graph_cache()
    if solver == "gd":
        problem, opts = mlp_problem(spec), tgd.GDOptions(max_iters=12, momentum=0.9,
                                                         step_size=0.05, tol=1e-12)
        c0 = Resident.captures
        warm = tgd.gd_warm_up(problem, w0, (x, y), opts, iters=3)
        c1 = Resident.captures
        whole = tgd.gradient_descent(problem, w0, (x, y), opts)
        eager = tgd._gd_resident_eager(problem, w0, (x, y), opts)
    else:
        problem = mlp_batch_problem(spec)
        opts = tsgd.SGDOptions(epochs=6, batch_size=128, step_size=0.05, momentum=0.9,
                               sampling="random", lr_decay=0.8, lr_decay_step=2)
        c0 = Resident.captures
        warm = tsgd.sgd_warm_up(problem, w0, x, y, opts, epochs=3)
        c1 = Resident.captures
        whole = tsgd.sgd(problem, w0, x, y, opts)
        eager = tsgd._sgd_resident_eager(problem, w0, x, y, opts)
    assert c1 == c0 + 1 and Resident.captures == c1 and warm.n_iters == 3
    _same(whole, eager)
    for f in ("loss_history", "gnorm_history"):
        assert torch.equal(getattr(warm, f)[:3], getattr(eager, f)[:3]), f
