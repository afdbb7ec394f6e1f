"""The plain reference against the program at tiny sizes, on the CPU, in
float64 so that the two differ by rounding only."""

import numpy as np
import pytest
import torch

from benchmark import data, drive
from benchmark.reference import lbfgs as ref_lbfgs
from benchmark.reference import mlp, precision, sampling, stochastic

DIMS = {"shallow": ([30, 12, 4], ["relu", "linear"]),
        "deep": ([30, 16, 8, 6, 4], ["relu", "relu", "relu", "linear"])}


def _setup(which, n=96, seed=5):
    dims, acts = DIMS[which]
    nt = mlp.Net(tuple(dims), tuple(acts))
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, dims[0], generator=g, dtype=torch.float64)
    y = torch.nn.functional.one_hot(torch.randint(0, dims[-1], (n,), generator=g),
                                    dims[-1]).double()
    w0 = data.weights(nt, seed, "cpu").double()
    return nt, x, y, w0


@pytest.mark.parametrize("which", sorted(DIMS))
@pytest.mark.parametrize("lam", [0.0, 1e-4])
def test_loss_gradient_and_hvp_match_the_program(which, lam):
    from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_problem, mlp_spec
    nt, x, y, w = _setup(which)
    spec = mlp_spec(nt.dims, nt.acts)
    obj = mlp.Objective(nt, lam)
    f, g = obj.value_and_grad(w, x, y)
    pf, pg = mlp_problem(spec, lam=lam).value_and_grad(w, (x, y))
    torch.testing.assert_close(f, pf, rtol=1e-12, atol=0)
    torch.testing.assert_close(g, pg, rtol=1e-10, atol=1e-14)
    v = torch.linspace(-1, 1, w.shape[0], dtype=torch.float64)
    bp = mlp_batch_problem(spec, lam=lam)
    torch.testing.assert_close(obj.hvp(w, v, x, y), bp.hvp(w, v, x, y),
                               rtol=1e-10, atol=1e-13)


def test_leaves_cover_the_vector():
    nt = mlp.Net((784, 256, 128, 64, 10), ("relu", "relu", "relu", "linear"))
    leaves = nt.leaves()
    assert [name for name, _, _ in leaves] == ["W1", "b1", "W2", "b2", "W3", "b3", "W4", "b4"]
    assert leaves[0][1] == 0 and leaves[-1][2] == nt.n_params == 242_762
    assert all(a[2] == b[1] for a, b in zip(leaves, leaves[1:]))


@pytest.mark.parametrize("count", [0, 1, 3, 5])
@pytest.mark.parametrize("clamp", [False, True])
def test_two_loop_matches_the_program(count, clamp):
    from lbfgs_ffnn_torch.ops.two_loop import empty_history_state, ring_push, two_loop
    n, m = 50, 4
    g = torch.Generator().manual_seed(count)
    ring, pairs = empty_history_state(m, n, torch.float64), []
    for _ in range(count):
        s = torch.randn(n, generator=g, dtype=torch.float64)
        yv = s + 0.3 * torch.randn(n, generator=g, dtype=torch.float64)
        rho = 1.0 / torch.dot(yv, s)
        ring = ring_push(ring, s, yv, rho, torch.tensor(True))
        pairs = (pairs + [(s, yv, rho)])[-m:]
    v = torch.randn(n, generator=g, dtype=torch.float64)
    torch.testing.assert_close(ref_lbfgs.two_loop(v, pairs, clamp_gamma=clamp),
                               two_loop(v, ring, clamp_gamma=clamp), rtol=1e-12, atol=1e-12)
    # the harness's reading of the ring, rho worked out again: the same pairs
    read = ref_lbfgs.with_rho([(s.double(), y.double()) for s, y in drive.ring_rows(ring, n)])
    assert len(read) == len(pairs)
    for (s, y, rho), (s2, y2, rho2) in zip(pairs, read):
        torch.testing.assert_close((s2, y2), (s, y), rtol=1e-7, atol=0)
        torch.testing.assert_close(rho2, rho, rtol=1e-6, atol=0)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -1.2345678, 0.0, float("inf")])
    assert precision.tf32(x).tolist() == [1.0, 1.0, 1 + 2 ** -9, -1.234375, 0.0, float("inf")]
    r = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    assert float(((precision.tf32(r) - r) / r).abs().max()) <= 2 ** -11


@pytest.mark.parametrize("seed", [0, 123, 2 ** 31 + 7])
def test_sampler_copy_draws_the_program_batches(seed):
    from lbfgs_ffnn_torch.ops.sampling import EpochSampler
    n, b, b_h = 600, 64, 32
    s = EpochSampler(seed, n, b, b_h)
    epoch = torch.tensor(3, dtype=torch.int32)
    got = s.batches(epoch, 5, 4)
    for r in range(4):
        assert torch.equal(got[r], sampling.step_batch(seed, 3, 5 + r, n, b))
    assert torch.equal(s.hvp_batch(epoch, 20), sampling.hvp_batch(seed, 3, 20, n, b_h))
    for count in (1, 2, 11):
        assert int(s.anchor(epoch, torch.tensor(count))) == sampling.anchor_pick(seed, 3, count)


LBFGS = {"max_iters": 6, "tol": 1e-30, "m": 3, "line_search": "armijo", "ls_max_iters": 20,
         "c1": 1e-4, "ls_shrink": 0.5, "curvature_eps": 1e-10}


@pytest.mark.parametrize("which", sorted(DIMS))
def test_lbfgs_steps_match_the_program(which):
    from lbfgs_ffnn_torch.objectives.mlp import mlp_problem, mlp_spec
    from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs
    nt, x, y, w0 = _setup(which)
    ref = ref_lbfgs.steps(mlp.Objective(nt), w0, (x, y), LBFGS, 6)
    res = lbfgs(mlp_problem(mlp_spec(nt.dims, nt.acts)), w0, (x, y), LBFGSOptions(**LBFGS))
    np.testing.assert_allclose(res.loss_history.numpy(), ref["losses"], rtol=1e-9)
    torch.testing.assert_close(res.x, ref["iterates"][-1], rtol=1e-8, atol=1e-10)


SLBFGS = {"epochs": 3, "tol": 1e-30, "history": 3, "L": 3, "batch_size": 16,
          "hvp_batch_size": 8, "step_size": 0.05, "hvp_mode": "exact", "curvature_eps": 1e-10}


def test_slbfgs_epochs_match_the_program():
    from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_spec
    from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions, slbfgs
    nt, x, y, w0 = _setup("shallow")
    ref = stochastic.slbfgs_epochs(mlp.Objective(nt, 1e-4), w0, x, y, SLBFGS, 77, 3)
    res = slbfgs(mlp_batch_problem(mlp_spec(nt.dims, nt.acts), lam=1e-4), w0, x, y,
                 SLBFGSOptions(**SLBFGS, seed=77))
    np.testing.assert_allclose(res.loss_history.numpy(), ref["losses"], rtol=1e-9)
    torch.testing.assert_close(res.x, ref["iterates"][-1], rtol=1e-8, atol=1e-10)


def test_sgd_epochs_match_the_program():
    from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_spec
    from lbfgs_ffnn_torch.solvers.sgd import SGDOptions, sgd
    nt, x, y, w0 = _setup("deep", n=100)
    opts = {"epochs": 3, "batch_size": 32, "step_size": 0.1, "momentum": 0.0,
            "sampling": "sequential", "lr_decay": 0.5, "lr_decay_step": 2, "tol": 0.0}
    ref = stochastic.sgd_epochs(mlp.Objective(nt), w0, x, y, opts, 0, 3)
    res = sgd(mlp_batch_problem(mlp_spec(nt.dims, nt.acts)), w0, x, y, SGDOptions(**opts))
    np.testing.assert_allclose(res.loss_history.numpy(), ref["losses"], rtol=1e-9)
    torch.testing.assert_close(res.x, ref["iterates"][-1], rtol=1e-8, atol=1e-10)
