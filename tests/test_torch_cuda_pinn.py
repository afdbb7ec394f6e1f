"""The PINN path's pieces on the card: the CUDA graph WHILE node
(``ops.control.loop``) against its eager run, and a failing body that
invalidates the enclosing capture; the captured Wolfe L-BFGS solve (its
trials a WHILE node) bitwise equal to the resident body run eagerly, on an
MLP and on the Burgers and oscillator PINNs, the two-loop kernel launched
once per iteration; K2 and K1 against the plain two-loop at the PINN ring
shapes (Burgers n = 921, m = 100; oscillator n = 481, m = 16).

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda_pinn.py``.
Skips itself where ``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.ops.cuda_two_loop import (
    COOPERATIVE, STREAMING, group_size, kernel_dispatch, two_loop_cuda,
)
from lbfgs_ffnn_torch.ops.two_loop import empty_history_state, ring_push, two_loop


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _reset():
    for kind in two_loop_cuda.LAUNCHES:
        two_loop_cuda.LAUNCHES[kind] = 0


# -- the WHILE node --------------------------------------------------------------


def _counter(s, limit, outer=None):
    """``while i < limit: acc += i * x; x *= 1.5; i += 1`` on the device
    scalars of ``s``; inside ``guard(outer)`` when given, the guard's flag
    then also in the loop's condition (outside capture a guard's body runs
    whatever its flag)."""
    from lbfgs_ffnn_torch.ops.control import assign, guard, loop

    def body():
        s["acc"].copy_(s["acc"] + s["i"].to(torch.float32) * s["x"])
        s["x"].mul_(1.5)
        s["i"].add_(1)

    if outer is None:
        loop(lambda: s["i"] < limit, body)
        return
    with guard(outer):
        loop(lambda: (s["i"] < limit) & outer, body)
        assign(outer, s["done"], torch.ones_like(s["done"]))


def _fill(s):
    for name, v in (("acc", 0.0), ("x", 1.0), ("i", 0), ("done", 0.0)):
        s[name].fill_(v)


@pytest.mark.cuda
@pytest.mark.parametrize("nested", [False, True])
def test_while_node_equals_its_eager_run(cuda, nested):
    """A captured counter loop, replayed with limits read at replay (0, 1, 7,
    40 passes), equals the same loop run eagerly, bitwise; the eager run
    reads its flag once per pass and once at the end. Nested in an IF node,
    it runs only where the IF's flag holds."""
    from lbfgs_ffnn_torch.ops.control import Graph, capture, host_reads

    f32 = dict(dtype=torch.float32, device=cuda)
    s = {"acc": torch.zeros((), **f32), "x": torch.ones((), **f32),
         "i": torch.zeros((), dtype=torch.int32, device=cuda), "done": torch.zeros((), **f32)}
    limit = torch.zeros((), dtype=torch.int32, device=cuda)
    outer = torch.ones((), dtype=torch.bool, device=cuda) if nested else None
    graph = Graph()
    with capture(graph):
        _counter(s, limit, outer)
    runs = [(0, True), (1, True), (7, True), (40, True)] + ([(7, False)] if nested else [])
    for n, on in runs:
        limit.fill_(n)
        if nested:
            outer.fill_(on)
        _fill(s)
        graph.replay()
        torch.cuda.synchronize()
        captured = {k: t.clone() for k, t in s.items()}
        _fill(s)
        reads = host_reads()
        _counter(s, limit, outer)
        assert host_reads() - reads == (n + 1 if on else 1)
        assert all(torch.equal(captured[k], s[k]) for k in s)
        assert int(s["i"]) == (n if on else 0)
        assert float(s["done"]) == float(nested and on)


@pytest.mark.cuda
@pytest.mark.parametrize("nested", [False, True])
def test_failing_while_body_invalidates_the_capture(cuda, nested):
    """An exception raised inside a WHILE node's body (alone, or inside an
    IF node's) ends the bodies' captures and invalidates the outermost one
    (its end raises, so no graph holding the broken body is made); the
    process carries on on its own stream: a capture after it works."""
    from lbfgs_ffnn_torch.ops.control import Graph, capture, guard, loop

    i = torch.zeros((), dtype=torch.int32, device=cuda)
    flag = torch.ones((), dtype=torch.bool, device=cuda)
    stream = torch.cuda.current_stream()

    def failing():
        i.add_(1)
        raise ValueError("body failed")

    with pytest.raises(RuntimeError, match="captur"):
        with capture(Graph()):
            if nested:
                with guard(flag):
                    loop(lambda: i < 3, failing)
            else:
                loop(lambda: i < 3, failing)
    assert torch.cuda.current_stream() == stream
    torch.cuda.synchronize()
    i.zero_()
    graph = Graph()
    with capture(graph):
        loop(lambda: i < 3, lambda: i.add_(1))
    graph.replay()
    torch.cuda.synchronize()
    assert int(i) == 3


# -- the captured Wolfe solve ------------------------------------------------------


def _mlp(dev):
    from lbfgs_ffnn_torch.objectives.mlp import mlp_problem, mlp_spec

    spec = mlp_spec([784, 32, 10], ["relu", "linear"])
    rng = np.random.default_rng(0)
    w0 = torch.tensor(rng.normal(size=spec.n_params) * 0.1, dtype=torch.float32, device=dev)
    x = torch.tensor(rng.random((2048, 784)), dtype=torch.float32, device=dev)
    y = torch.tensor(np.eye(10)[rng.integers(0, 10, 2048)], dtype=torch.float32, device=dev)
    return mlp_problem(spec), w0, (x, y), {"m": 10}


def _burgers(dev):
    from lbfgs_ffnn_torch.experiments.run_burgers import options
    from lbfgs_ffnn_torch.objectives.pinn import (
        burgers_points, burgers_problem, default_burgers_spec, pinn_init,
    )

    spec = default_burgers_spec()
    pts = burgers_points(dx=0.01, dt=0.02, int_dx=0.04, int_dt=0.08, device=dev)
    w0 = pinn_init(spec, torch.Generator().manual_seed(123), device=dev)
    return burgers_problem(spec), w0, pts, options(0, False)._asdict()


def _oscillator(dev):
    from lbfgs_ffnn_torch.objectives.mlp import mlp_spec
    from lbfgs_ffnn_torch.objectives.pinn import oscillator_problem, pinn_init

    spec = mlp_spec([1, 20, 20, 1], ["tanh", "tanh", "linear"])
    xs = torch.arange(0.0, 6.28, 0.1, device=dev).reshape(-1, 1)
    w0 = pinn_init(spec, torch.Generator().manual_seed(123), device=dev)
    return oscillator_problem(spec, w_ode=float(xs.shape[0])), w0, xs, {"m": 16}


# case -> (make, options beyond max_iters, the kernel the ring goes to)
_WOLFE_CASES = {
    "mlp-fused": (_mlp, {"ls_value_only": False}, COOPERATIVE),
    "mlp-lean": (_mlp, {}, COOPERATIVE),
    "burgers-lean": (_burgers, {}, STREAMING),
    "burgers-hvp": (_burgers, {"curvature_pairs": "hvp"}, STREAMING),
    "oscillator-fused": (_oscillator, {}, COOPERATIVE),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_WOLFE_CASES))
def test_captured_wolfe_solve_equals_eager_body(cuda, case):
    """lbfgs() on CUDA tensors under Wolfe replays the captured iteration
    (the trials a WHILE node): bitwise equal to the resident body run
    eagerly, the same counters, host syncs within ceil(iters / chunk) + 2,
    the ring's kernel launched once per iteration on the device, and the
    first losses equal to the plain two-loop's to rtol 1e-4."""
    from lbfgs_ffnn_torch.solvers.lbfgs import (
        RESIDENT_CHUNK, LBFGSOptions, _lbfgs_resident_eager, clear_graph_cache, lbfgs,
    )

    make, extra, impl = _WOLFE_CASES[case]
    problem, w0, aux, base = make(cuda)
    iters = 23
    opts = LBFGSOptions(**{**base, "max_iters": iters, "tol": 1e-12, "line_search": "wolfe",
                           **extra})
    eager = _lbfgs_resident_eager(problem, w0, aux, opts)
    lbfgs(problem, w0, aux, opts)  # captures the iteration
    _reset()
    res = lbfgs(problem, w0, aux, opts)
    launches = dict(two_loop_cuda.LAUNCHES)
    plain = lbfgs(problem, w0, aux, opts._replace(two_loop_impl="plain", max_iters=5))
    clear_graph_cache()
    assert res.n_iters == eager.n_iters == iters
    assert (res.n_fevals, res.n_gevals) == (eager.n_fevals, eager.n_gevals)
    assert torch.equal(res.x, eager.x)
    assert torch.equal(res.loss_history, eager.loss_history)
    assert torch.equal(res.gnorm_history, eager.gnorm_history)
    assert res.n_host_syncs <= -(-iters // RESIDENT_CHUNK) + 2
    assert launches == {k: (iters if k == impl else 0) for k in launches}
    np.testing.assert_allclose(res.loss_history[:5].cpu().numpy(),
                               plain.loss_history[:5].cpu().numpy(), rtol=1e-4)
    assert float(res.final_loss) < float(problem.fun(w0, aux))


# -- K2 and K1 at the PINN ring shapes ----------------------------------------------


def _ring(m, n, k, dev, seed=0):
    rng = np.random.default_rng(seed)
    hist = empty_history_state(m, n, torch.float32, device=dev)
    for _ in range(k):
        s = rng.normal(size=n)
        y = torch.tensor(rng.normal(size=n) + 0.5 * s, dtype=torch.float32, device=dev)
        s = torch.tensor(s, dtype=torch.float32, device=dev)
        hist = ring_push(hist, s, y, 1.0 / torch.dot(y, s), torch.dot(y, s) > 1e-3)
    return hist


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,impl,k", [(100, 921, STREAMING, 0), (100, 921, STREAMING, 37),
                                        (100, 921, STREAMING, 100), (100, 921, STREAMING, 130),
                                        (16, 481, COOPERATIVE, 0), (16, 481, COOPERATIVE, 9),
                                        (16, 481, COOPERATIVE, 16), (16, 481, COOPERATIVE, 21)])
@pytest.mark.parametrize("clamp", [False, True])
def test_pinn_rings_against_plain(cuda, m, n, impl, k, clamp):
    """The dispatch gives the Burgers ring (n_pad = 1024, m = 100) to K2 at
    k = 8 and the oscillator's (n_pad = 512, m = 16) to K1, each one block;
    the kernel agrees with the plain two-loop to 1e-4 of max|plain|, twice
    bitwise, two launches counted on the device."""
    hist = _ring(m, n, k, cuda)
    n_pad = hist.S.shape[1]
    assert kernel_dispatch(n_pad, m, torch.float32)[0] == impl
    if impl == STREAMING:
        assert (n_pad, group_size(n_pad, m, 4)) == (1024, 8)
    v = torch.tensor(np.random.default_rng(1).normal(size=n), dtype=torch.float32, device=cuda)
    _reset()
    r_k = two_loop_cuda(v, hist, clamp_gamma=clamp)
    r_k2 = two_loop_cuda(v, hist, clamp_gamma=clamp)
    torch.cuda.synchronize()
    assert two_loop_cuda.LAUNCHES == {kind: 2 * (kind == impl) for kind in two_loop_cuda.LAUNCHES}
    r_p = two_loop(v, hist, clamp_gamma=clamp)
    assert torch.equal(r_k, r_k2)
    assert float((r_k - r_p).abs().max()) <= 1e-4 * float(r_p.abs().max())
