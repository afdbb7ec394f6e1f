"""BFGS and Newton on the card: every storage and solver mode captured (the
iteration replayed from its CUDA graph: Krylov iterations, damping and
Wolfe trials as WHILE nodes, Newton-CG's CG a WHILE node inside the damping
WHILE node inside the iteration's IF node) equal to the resident body run
eagerly on the card, bitwise, counters and all, with at most
ceil(iters / 10) + 2 host syncs and no capture on a second solve; the
direct solve (``dense_solve``) captured at n = 500 and 8192, and inside a
WHILE node inside an IF node at sizes where other routes failed; the
autodiff dense Hessian captured, and its limit; a body that raises three
nodes deep; and the least-squares kernel of GMRES against its plain
version on full-rank and rank-deficient Hessenberg matrices.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda_bfgs_newton.py``.
Skips itself where ``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.objectives.analytic import rosenbrock_problem, rosenbrock_start
from lbfgs_ffnn_torch.solvers.common import Resident, clear_graph_cache

tb = importlib.import_module("lbfgs_ffnn_torch.solvers.bfgs")
tn = importlib.import_module("lbfgs_ffnn_torch.solvers.newton")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


BFGS_MODES = {"dense-direct": dict(), "dense-cg": dict(linear_solver="cg"),
              "dense-gmres": dict(linear_solver="gmres"),
              "factors-cg": dict(storage="factors", linear_solver="cg"),
              "factors-gmres": dict(storage="factors", linear_solver="gmres")}
NEWTON_MODES = {"dense": dict(), "hvp_cg": dict(hess_mode="hvp_cg")}
COUNTERS = ("n_iters", "n_fevals", "n_gevals", "n_matvecs", "n_hevals")


def _same(a, b):
    for f in ("x", "loss_history", "gnorm_history", "final_loss", "final_gnorm"):
        u, v = getattr(a, f), getattr(b, f)
        differ = (u != v) & ~(torch.isnan(u) & torch.isnan(v))
        assert not differ.any(), (f, differ.nonzero()[:3].flatten().tolist(),
                                  u[differ][:3].tolist(), v[differ][:3].tolist())
    assert [getattr(a, c) for c in COUNTERS] == [getattr(b, c) for c in COUNTERS]


def _solvers(kind):
    if kind == "bfgs":
        return tb.bfgs, tb._bfgs_resident_eager, tb.BFGSOptions, BFGS_MODES, tb.RESIDENT_CHUNK
    return tn.newton, tn._newton_resident_eager, tn.NewtonOptions, NEWTON_MODES, tn.RESIDENT_CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode", [("bfgs", m) for m in BFGS_MODES]
                         + [("newton", m) for m in NEWTON_MODES])
def test_captured_solve_equals_eager_body(cuda, kind, mode):
    """Rosenbrock n = 4, f64, 30 iterations: the captured solve equals the
    eager body bitwise; host syncs within ceil(30 / 10) + 2; a second solve
    from another start replays the cached graph (no capture) and equals
    its own eager body."""
    solve, eager, Options, modes, chunk = _solvers(kind)
    iters = 30
    opts = Options(max_iters=iters, tol=1e-14, **modes[mode])
    problem = rosenbrock_problem()
    x0 = rosenbrock_start(4, device=cuda)
    clear_graph_cache()
    c0 = Resident.captures
    cap = solve(problem, x0, opts=opts)
    assert Resident.captures == c0 + 1
    _same(cap, eager(problem, x0, opts=opts))
    assert cap.n_host_syncs <= -(-cap.n_iters // chunk) + 2
    lh = cap.loss_history[:cap.n_iters].cpu().numpy()
    assert np.all(np.isfinite(lh)) and lh[-1] < lh[0]
    x1 = x0 * 0.9
    again = solve(problem, x1, opts=opts)
    assert Resident.captures == c0 + 1
    _same(again, eager(problem, x1, opts=opts))


def _mlp(dev):
    from lbfgs_ffnn_torch.objectives.mlp import mlp_init, mlp_problem, mlp_spec

    spec = mlp_spec([784, 32, 10], ["relu", "linear"])
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random((2048, 784)), dtype=torch.float32, device=dev)
    y = torch.tensor(np.eye(10)[rng.integers(0, 10, 2048)], dtype=torch.float32, device=dev)
    w0 = mlp_init(spec, torch.Generator().manual_seed(0), torch.float32, device=dev)
    return mlp_problem(spec), w0, (x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["newton", "bfgs"])
def test_matrix_free_mlp_solve_equals_eager_body(cuda, kind):
    """The matrix-free modes on a 784-32-10 MLP in f32 (lean Wolfe trials
    through the line restriction): Newton-CG and factor-form BFGS with CG,
    10 iterations, captured = eager body bitwise, the loss falling."""
    problem, w0, aux = _mlp(cuda)
    if kind == "newton":
        solve, eager = tn.newton, tn._newton_resident_eager
        opts = tn.NewtonOptions(max_iters=10, tol=1e-12, hess_mode="hvp_cg", cg_max_iters=20)
    else:
        solve, eager = tb.bfgs, tb._bfgs_resident_eager
        opts = tb.BFGSOptions(max_iters=10, tol=1e-12, storage="factors", linear_solver="cg",
                              solver_max_iters=50)
    clear_graph_cache()
    cap = solve(problem, w0, aux, opts)
    _same(cap, eager(problem, w0, aux, opts))
    assert cap.n_iters == 10 and cap.n_host_syncs <= 1 + 2
    lh = cap.loss_history.cpu().numpy()
    assert np.all(np.isfinite(lh)) and lh[-1] < lh[0]
    assert (cap.n_hevals if kind == "newton" else cap.n_matvecs) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("n", [500, 8192])
def test_direct_solve_is_captured(cuda, n):
    """Dense BFGS with the direct solve (``dense_solve``, its LU in the
    graph) on the extended Rosenbrock at n = 500 and 8192, f64, 3
    iterations: captured = eager body bitwise."""
    problem = rosenbrock_problem()
    x0 = rosenbrock_start(n, device=cuda)
    opts = tb.BFGSOptions(max_iters=3, tol=1e-14)
    clear_graph_cache()
    c0 = Resident.captures
    cap = tb.bfgs(problem, x0, opts=opts)
    assert Resident.captures == c0 + 1 and cap.n_iters == 3
    _same(cap, tb._bfgs_resident_eager(problem, x0, opts=opts))
    clear_graph_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16, 64, 128, 513, 514, 516, 520, 528, 576, 577, 1025, 2056,
                               4112, 7681, 7745, 8192])
def test_dense_solve_in_while_in_if(cuda, n):
    """``dense_solve`` captured where Newton's damping loop puts it, in a
    WHILE node inside an IF node, after a captured BFGS solve, replayed
    twice: equal to its eager result bitwise and solving the system. Once
    cuSOLVER's getrf has run on other streams (as after any captured solve),
    an unpadded factorization failed to capture there at n = 512 k + r for
    r in {1, 2, 4, 8, 16, 64, 65} and k = 1 ... 15 (an H100, torch 2.11);
    the sizes above cover every such remainder, small and large k."""
    from lbfgs_ffnn_torch.ops.control import Graph, capture, guard, loop
    from lbfgs_ffnn_torch.ops.iterative import dense_solve

    clear_graph_cache()
    tb.bfgs(rosenbrock_problem(), rosenbrock_start(4, device=cuda),
            opts=tb.BFGSOptions(max_iters=3, tol=1e-14))
    rng = np.random.default_rng(n)
    A = torch.tensor(rng.normal(size=(n, n)) + n * np.eye(n), device=cuda)
    b = torch.tensor(rng.normal(size=n), device=cuda)
    want = dense_solve(A, b)
    out = torch.zeros_like(b)
    i = torch.zeros((), dtype=torch.int32, device=cuda)
    flag = torch.ones((), dtype=torch.bool, device=cuda)

    def once():
        out.copy_(dense_solve(A, b))
        i.add_(1)

    graph = Graph()
    with capture(graph):
        with guard(flag):
            loop(lambda: (i < 2) & flag, once)
    for _ in range(2):
        out.zero_()
        i.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert int(i) == 2 and torch.equal(out, want)
    torch.testing.assert_close(A @ out, b, rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [513, 1025])
def test_dense_newton_after_bfgs_at_awkward_sizes(cuda, n):
    """Dense Newton (the autodiff Hessian) on the extended Rosenbrock after a
    captured dense BFGS solve, at sizes where the unpadded factorization's
    capture failed: captured = eager body bitwise."""
    clear_graph_cache()
    x0 = rosenbrock_start(n, device=cuda)
    tb.bfgs(rosenbrock_problem(), x0, opts=tb.BFGSOptions(max_iters=2, tol=1e-14))
    problem, opts = rosenbrock_problem(analytic=False), tn.NewtonOptions(max_iters=4, tol=1e-14)
    cap = tn.newton(problem, x0, opts=opts)
    _same(cap, tn._newton_resident_eager(problem, x0, opts=opts))
    assert cap.n_iters == 4
    clear_graph_cache()


@pytest.mark.cuda
def test_autodiff_dense_hessian_is_captured(cuda):
    """Dense Newton on the autodiff Hessian (``torch.func.hessian``) of the
    extended Rosenbrock at n = 64, f64: captured = eager body bitwise; the
    Hessian equals the analytic one; n = 8193 is refused before anything
    n^2 is allocated."""
    from lbfgs_ffnn_torch.types import DENSE_HESSIAN_LIMIT

    auto, exact = rosenbrock_problem(analytic=False), rosenbrock_problem()
    x0 = rosenbrock_start(64, device=cuda)
    torch.testing.assert_close(auto.hess(x0, ()), exact.hess(x0, ()), rtol=1e-12, atol=1e-12)
    opts = tn.NewtonOptions(max_iters=20, tol=1e-14)
    clear_graph_cache()
    cap = tn.newton(auto, x0, opts=opts)
    _same(cap, tn._newton_resident_eager(auto, x0, opts=opts))
    w = torch.zeros(DENSE_HESSIAN_LIMIT + 1, dtype=torch.float64, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="hvp_cg"):
        auto.hess(w, ())
    assert torch.cuda.max_memory_allocated() - before < 2**20


@pytest.mark.cuda
def test_while_in_while_in_if(cuda):
    """Newton-CG's nesting alone: an IF node holding a WHILE node holding a
    WHILE node, replayed with the bounds read at replay, equals the same
    code run eagerly; the inner loop's passes are summed."""
    from lbfgs_ffnn_torch.ops.control import Graph, assign, capture, guard, loop

    i32 = dict(dtype=torch.int32, device=cuda)
    s = {k: torch.zeros((), **i32) for k in ("i", "j", "total")}
    outer_n, inner_n = torch.zeros((), **i32), torch.zeros((), **i32)
    flag = torch.ones((), dtype=torch.bool, device=cuda)

    def code():
        with guard(flag):
            def outer():
                s["j"].zero_()

                def inner():
                    s["total"].add_(s["i"] + 1)
                    s["j"].add_(1)

                loop(lambda: s["j"] < inner_n, inner)
                s["i"].add_(1)

            loop(lambda: (s["i"] < outer_n) & flag, outer)
            assign(flag, s["total"], s["total"] * 2)

    graph = Graph()
    with capture(graph):
        code()
    for no, ni, on in ((0, 3, True), (4, 0, True), (3, 5, True), (6, 2, False)):
        outer_n.fill_(no)
        inner_n.fill_(ni)
        flag.fill_(on)
        for t in s.values():
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        got = {k: int(v) for k, v in s.items()}
        for t in s.values():
            t.zero_()
        code()  # eagerly the guard's body runs; its loop's condition holds the flag
        want = {k: int(v) for k, v in s.items()}
        assert got == want, (no, ni, on)


@pytest.mark.cuda
def test_body_that_raises_three_nodes_deep(cuda):
    """A Hessian-vector product that raises while Newton-CG's CG is captured
    (a WHILE node in a WHILE node in the iteration's IF node): the solve
    raises, only the outermost capture is invalidated (no crash when it
    ends), the caller's stream is current again, nothing is cached, and the
    next captured solve works and equals its eager body."""
    from lbfgs_ffnn_torch.ops import control

    good = rosenbrock_problem()

    class Failing(type(good)):
        def hvp(self, w, v, aux=()):
            if control._CAPTURE is not None and not control._CAPTURE.flat:
                raise ValueError("the product failed under capture")
            return good.hvp(w, v, aux)

    bad = Failing(*good)
    opts = tn.NewtonOptions(max_iters=5, tol=1e-14, hess_mode="hvp_cg")
    x0 = rosenbrock_start(4, device=cuda)
    stream = torch.cuda.current_stream()
    clear_graph_cache()
    c0 = Resident.captures
    with pytest.raises((RuntimeError, ValueError)):
        tn.newton(bad, x0, opts=opts)
    assert torch.cuda.current_stream() == stream
    torch.cuda.synchronize()
    cap = tn.newton(good, x0, opts=opts)
    assert Resident.captures == c0 + 2
    _same(cap, tn._newton_resident_eager(good, x0, opts=opts))


def _hessenberg(rng, m, n, rank, dtype, dev):
    H = np.triu(rng.normal(size=(m, n)), -1)
    if rank < n:  # a happy breakdown at column rank - 1: zero columns and rows after it
        H[:, rank:] = 0.0
        H[rank + 1:, :] = 0.0
        H[rank, rank - 1] = 0.0
    b = np.zeros(m)
    b[0] = rng.normal()
    return (torch.tensor(H, dtype=dtype, device=dev), torch.tensor(b, dtype=dtype, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,rank", [((21, 20), 20), ((21, 20), 2), ((21, 20), 7),
                                        ((5, 4), 4), ((7, 6), 1)])
def test_lstsq_kernel_matches_plain(cuda, dtype, shape, rank):
    """The least-squares kernel against its plain version (the SVD formula,
    computed in f64 on the CPU) on GMRES-shaped Hessenberg matrices, full
    rank and after a happy breakdown: the minimum-norm solution (zero
    weight on the zero columns), f64 to 1e-10 of its largest entry, f32's
    error (against the f64 plain solution) at most 4 times the plain
    version's own in f32, plus 10 eps; a launch counted on the device; a
    captured launch equals the eager one bitwise."""
    from lbfgs_ffnn_torch.ops.control import Graph, capture
    from lbfgs_ffnn_torch.ops.cuda_lstsq import lstsq_min_norm, lstsq_plain

    H, b = _hessenberg(np.random.default_rng(rank), *shape, rank, dtype, cuda)
    lstsq_min_norm.LAUNCHES.reset()
    y = lstsq_min_norm(H, b)
    assert int(lstsq_min_norm.LAUNCHES) == 1
    ref = lstsq_plain(H.cpu().double(), b.cpu().double())

    def err(t):
        return float((t.cpu().double() - ref).abs().max() / ref.abs().max())

    if dtype == torch.float64:
        assert err(y) <= 1e-10
    else:
        assert err(y) <= 4 * err(lstsq_plain(H.cpu(), b.cpu())) + 10 * 2.0**-23
    assert torch.all(y[rank:] == 0)
    out = torch.empty_like(y)
    graph = Graph()
    with capture(graph):
        out.copy_(lstsq_min_norm(H, b))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, y) and int(lstsq_min_norm.LAUNCHES) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["dense", "factors"])
def test_gmres_bfgs_from_the_optimum_with_a_fresh_counter(cuda, monkeypatch, storage):
    """BFGS+GMRES started where the gradient is zero, as the first GMRES
    solve of a process (a fresh launch counter, nothing cached): the eager
    run before the capture never enters GMRES's loop, yet the capture of
    the loop's body finds the least-squares kernel's counter made; 0
    iterations, as JAX's. A solve from the usual start then counts its
    launches on that counter."""
    from lbfgs_ffnn_torch.ops.cuda_lstsq import LaunchCount, lstsq_min_norm

    monkeypatch.setattr(lstsq_min_norm, "LAUNCHES", LaunchCount())
    clear_graph_cache()
    problem = rosenbrock_problem()
    opts = tb.BFGSOptions(max_iters=20, tol=1e-12, storage=storage, linear_solver="gmres")
    at_min = torch.ones(4, dtype=torch.float64, device=cuda)
    r = tb.bfgs(problem, at_min, opts=opts)
    assert r.n_iters == 0 and r.n_matvecs == 0 and torch.equal(r.x, at_min)
    assert int(lstsq_min_norm.LAUNCHES) == 0  # no GMRES cycle ran
    r = tb.bfgs(problem, rosenbrock_start(4, device=cuda), opts=opts)
    _same(r, tb._bfgs_resident_eager(problem, rosenbrock_start(4, device=cuda), opts=opts))
    assert r.n_iters > 0 and int(lstsq_min_norm.LAUNCHES) > 0
    clear_graph_cache()


@pytest.mark.cuda
def test_f32_bfgs_nan_follows_an_exhausted_search(cuda):
    """The suite's f32 BFGS row on Rosenbrock n = 4: where its history turns
    NaN, the iteration before exhausted its search (50 trials and the
    re-evaluation) without moving x, so s = y = 0 and the unguarded rank-2
    update (the reference's and JAX's) divided 0 by 0; where the f32
    trajectory reaches the minimum exactly instead (as on the CPU), the row
    converges."""
    problem = rosenbrock_problem()
    x0 = rosenbrock_start(4, torch.float32, cuda)
    clear_graph_cache()
    r = tb.bfgs(problem, x0, opts=tb.BFGSOptions(max_iters=5000, tol=1e-12))
    nan = torch.isnan(r.loss_history[:r.n_iters]).nonzero().flatten().tolist()
    if not nan:
        assert r.converged
        return
    k = nan[0]  # iteration k + 1 made the first NaN
    assert k >= 2 and r.n_iters == k + 1
    a, b = (tb._bfgs_resident_eager(problem, x0, opts=tb.BFGSOptions(max_iters=i, tol=1e-12))
            for i in (k, k - 1))
    assert a.n_fevals - b.n_fevals == 50 + 1 and torch.equal(a.x, b.x)
    assert torch.isfinite(a.x).all() and torch.isnan(r.x).all()
    clear_graph_cache()


@pytest.mark.cuda
def test_gmres_happy_breakdown_on_the_card(cuda):
    """GMRES on a right-hand side in a 2-dimensional Krylov subspace, eager
    and captured: a happy breakdown in the first cycle (exact in binary
    arithmetic), the minimum-norm update, the exact solution, 21 matvecs."""
    from lbfgs_ffnn_torch.ops.control import Graph, capture
    from lbfgs_ffnn_torch.ops.iterative import gmres_counted

    A = torch.diag(torch.arange(1.0, 41.0, dtype=torch.float64, device=cuda))
    A[0, 0], A[0, 1], A[1, 0], A[1, 1] = 0.0, 2.0, 0.5, 0.0
    b = torch.zeros(40, dtype=torch.float64, device=cuda)
    b[0] = 3.0
    x, nmv = gmres_counted(lambda v: A @ v, b, tol=1e-12, maxiter=5)
    want = torch.zeros_like(b)
    want[1] = 1.5
    assert torch.equal(x, want) and int(nmv) == 21
    out, count = torch.empty_like(b), torch.zeros((), dtype=torch.int32, device=cuda)
    graph = Graph()
    with capture(graph):
        xc, nc = gmres_counted(lambda v: A @ v, b, tol=1e-12, maxiter=5)
        out.copy_(xc)
        count.copy_(nc)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want) and int(count) == 21
