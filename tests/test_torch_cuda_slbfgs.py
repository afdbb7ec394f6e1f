"""S-LBFGS on the card: the sampler draws on the card what it draws on the
CPU; ``slbfgs`` on CUDA tensors (each epoch replayed from its captured
CUDA graphs, the ``converged`` branch an IF node) equals the epoch's bodies
run eagerly on the card bitwise, its batches included; K1 runs once per inner step, counted
on the device; the kernel solve agrees with the plain one; the host syncs
once per chunk; the Launcher's S-LBFGS runs there.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda_slbfgs.py``.
Skips itself where ``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, two_loop_cuda
from lbfgs_ffnn_torch.ops.sampling import EpochSampler, sample_without_replacement, stream_key


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _reset():
    for kind in two_loop_cuda.LAUNCHES:
        two_loop_cuda.LAUNCHES[kind] = 0


def _case(dev, n=2048, dims=(784, 32, 10), seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((n, dims[0])), dtype=torch.float32, device=dev)
    y = torch.tensor(np.eye(dims[-1])[rng.integers(0, dims[-1], n)], dtype=torch.float32,
                     device=dev)
    spec = mlp_spec(list(dims), ["relu"] * (len(dims) - 2) + ["linear"])
    w0 = mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32, device=dev)
    return mlp_batch_problem(spec, lam=1e-4), w0, x, y


@pytest.mark.cuda
@pytest.mark.parametrize("n,size", [(96, 24), (5000, 256), (60000, 128)])
def test_sampler_draws_alike_on_cpu_and_card(cuda, n, size):
    for epoch in (0, 3, 999):
        for t in (0, 17):
            for purpose in (0, 1):
                e_cpu = torch.tensor(epoch, dtype=torch.int32)
                a = sample_without_replacement(stream_key(123, e_cpu, t, purpose), n, size)
                b = sample_without_replacement(stream_key(123, e_cpu.to(cuda), t, purpose),
                                               n, size)
                assert torch.equal(a, b.cpu())
    s = EpochSampler(5, n, size, size // 2)
    for epoch in range(20):
        e = torch.tensor(epoch, dtype=torch.int32)
        count = torch.tensor(11, dtype=torch.int64)
        assert int(s.anchor(e, count)) == int(s.anchor(e.to(cuda), count.to(cuda)))
        t = torch.tensor(epoch % 7)
        assert torch.equal(s.batches(e, t, 11), s.batches(e.to(cuda), t.to(cuda), 11).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("pair_dtype", [None, "bfloat16"])
def test_captured_epoch_equals_eager_body(cuda, pair_dtype):
    """slbfgs() on CUDA tensors replays a captured epoch: bitwise equal to
    the epoch body run eagerly on the card (anchor, ring and histories),
    K1 launched epochs x m_inner times (device count; the capture's eager
    run of one epoch reset away), at most ceil(epochs / chunk) + 2 host
    syncs."""
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache
    from lbfgs_ffnn_torch.solvers.slbfgs import (
        RESIDENT_CHUNK, SLBFGSOptions, _slbfgs_resident_eager, slbfgs,
    )

    problem, w0, x, y = _case(cuda)
    epochs = 13
    opts = SLBFGSOptions(epochs=epochs, tol=1e-12, history=10, L=5, batch_size=128,
                         hvp_batch_size=64, step_size=0.02, pair_dtype=pair_dtype)
    m_inner = 2048 // 128
    eager = _slbfgs_resident_eager(problem, w0, x, y, opts)
    slbfgs(problem, w0, x, y, opts)  # captures the epoch
    _reset()
    res = slbfgs(problem, w0, x, y, opts)
    launches = dict(two_loop_cuda.LAUNCHES)
    clear_graph_cache()
    assert res.n_iters == eager.n_iters == epochs
    for name in ("x", "loss_history", "gnorm_history", "final_gnorm"):
        assert torch.equal(getattr(res, name), getattr(eager, name)), name
    assert res.n_host_syncs <= -(-epochs // RESIDENT_CHUNK) + 2
    assert launches == {k: (epochs * m_inner if k == COOPERATIVE else 0) for k in launches}
    lh = res.loss_history.cpu().numpy()
    assert np.all(np.isfinite(lh)) and lh[-1] < float(problem.fun(w0, x, y))


@pytest.mark.cuda
def test_captured_chunks_and_ring_equal_eager(cuda):
    """slbfgs_chunked at chunk 3 on the card against the eager body: the
    ring (S, Y, rho, head, count), u_prev and has_u bitwise after 5 epochs."""
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache, clone
    from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions, _solve

    problem, w0, x, y = _case(cuda, seed=1)
    opts = SLBFGSOptions(epochs=5, tol=1e-12, history=6, L=4, batch_size=128, step_size=0.02)
    states = {}
    for capture in (False, True):
        kept = []
        _solve(problem, w0, x, y, opts, chunk=3, capture=capture,
               callback=lambda s, _e: kept.append(clone(s)))
        torch.cuda.synchronize()
        states[capture] = kept[-1]
    clear_graph_cache()
    a, b = states[False], states[True]
    assert int(a.epoch) == int(b.epoch) == 5 and int(a.hist.count) > 0
    for ta, tb in zip(a.hist, b.hist):
        assert torch.equal(ta, tb)
    for name in ("w", "u_prev", "has_u", "loss_h", "gnorm_h"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.cuda
def test_captured_solve_stops_on_tol(cuda):
    """A tol met at an epoch's anchor stops the solve there, mid-chunk: the
    replays past it are no-ops (no K1 launch)."""
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache
    from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions, slbfgs

    problem, w0, x, y = _case(cuda, seed=2)
    opts = SLBFGSOptions(epochs=20, tol=1e-12, history=10, L=5, batch_size=256, step_size=0.02)
    full = slbfgs(problem, w0, x, y, opts)
    gn = full.gnorm_history.double().cpu().numpy()
    j = next(j for j in range(3, 19) if (j + 1) % 10 and gn[j] < gn[:j].min())
    tol = float(gn[j]) * (1 + 1e-6)
    slbfgs(problem, w0, x, y, opts._replace(tol=tol))
    _reset()
    res = slbfgs(problem, w0, x, y, opts._replace(tol=tol))
    launches = two_loop_cuda.LAUNCHES[COOPERATIVE]
    clear_graph_cache()
    assert bool(res.converged) and res.n_iters == j + 1
    assert launches == (j + 1) * (2048 // 256)
    assert torch.equal(res.loss_history[:j + 1], full.loss_history[:j + 1])


@pytest.mark.cuda
def test_kernel_solve_agrees_with_plain(cuda):
    """K1 against the plain two-loop on the same batches: the first 3
    epochs' losses to rtol 1e-4 (f32 summation order), the final loss
    within 2%."""
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache
    from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions, slbfgs

    problem, w0, x, y = _case(cuda, seed=3)
    opts = SLBFGSOptions(epochs=10, tol=1e-12, history=10, L=5, batch_size=128, step_size=0.02)
    rk = slbfgs(problem, w0, x, y, opts)
    rp = slbfgs(problem, w0, x, y, opts._replace(two_loop_impl="plain"))
    clear_graph_cache()
    lk, lp = rk.loss_history.cpu().numpy(), rp.loss_history.cpu().numpy()
    np.testing.assert_allclose(lk[:3], lp[:3], rtol=1e-4)
    assert abs(lk[-1] - lp[-1]) <= 0.02 * lp[-1]


@pytest.mark.cuda
def test_launcher_slbfgs_on_card(cuda, tmp_path):
    """The Launcher's S-LBFGS on the card: the warm-up captures the epoch,
    the timed solve and the chunked one are the same solve."""
    from lbfgs_ffnn_torch.data.datasets import Dataset
    from lbfgs_ffnn_torch.launcher import Launcher, UnifiedConfig
    from lbfgs_ffnn_torch.recorder import read_history_csv
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache

    rng = np.random.default_rng(6)
    xs = rng.random((1024, 784)).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 1024)]
    launcher = (Launcher("cpu", out_dir=tmp_path).add_layer(784, 32, "relu")
                .add_layer(32, 10, "linear").build_network().set_data(Dataset(xs, ys, xs, ys)))
    reports = {k: launcher.train("slbfgs", UnifiedConfig(name=f"S{k}", max_iters=9,
                                                         batch_size=128, log_interval=1,
                                                         tolerance=1e-12, timed_chunks=k),
                                 verbose=False)
               for k in (0, 4)}
    clear_graph_cache()
    h = read_history_csv(reports[4].csv_path)
    assert h.n == 9 and len(np.unique(h.time_ms)) == 3 and np.all(np.diff(h.time_ms) >= 0)
    assert torch.equal(reports[0].result.x, reports[4].result.x)
    assert reports[4].result.n_host_syncs <= -(-9 // 4) + 2


@pytest.mark.cuda
def test_compact_two_loop_captures(cuda):
    """two_loop_impl="compact" in a captured solve: S-LBFGS and Armijo
    L-BFGS equal their bodies run eagerly on the card (its gamma once read
    M's diagonal at a tensor index, a host read the capture refused)."""
    import importlib

    from lbfgs_ffnn_torch.objectives.mlp import mlp_problem
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache
    from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions, _slbfgs_resident_eager, slbfgs

    tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
    problem, w0, x, y = _case(cuda)
    opts = SLBFGSOptions(epochs=3, tol=1e-12, history=10, L=5, batch_size=128,
                         hvp_batch_size=64, step_size=0.02, two_loop_impl="compact")
    res, eager = slbfgs(problem, w0, x, y, opts), _slbfgs_resident_eager(problem, w0, x, y, opts)
    assert torch.equal(res.x, eager.x) and torch.equal(res.loss_history, eager.loss_history)
    lopts = tl.LBFGSOptions(max_iters=12, tol=1e-12, m=10, line_search="armijo",
                            two_loop_impl="compact")
    mp = mlp_problem(mlp_spec([784, 32, 10], ["relu", "linear"]))
    res, eager = tl.lbfgs(mp, w0, (x, y), lopts), tl._lbfgs_resident_eager(mp, w0, (x, y), lopts)
    clear_graph_cache()
    assert torch.equal(res.x, eager.x) and torch.equal(res.loss_history, eager.loss_history)
