"""The Hopper two-loop kernels (K1, K2, K3) against their plain torch version
on the card; K1 also against the compact form it computes
(two_loop_compact), K2 at each of its group sizes also against the grouped
algebra it computes (two_loop_grouped), K3 at each of several L2 prefetch
distances. Then the resident L-BFGS solve: a guarded kernel call in a
replayed CUDA graph, the captured solve bitwise equal to the resident body
run eagerly, its host syncs, and the kernels' launches counted on the
device.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda.py``.
Skips itself where ``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import functools

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.ops.cuda_two_loop import (
    BLOCKED, COOPERATIVE, N_STAMPS, RESIDENT_MAX_M, STREAMING, group_size, kernel_dispatch,
    launch, two_loop_cuda,
)
from lbfgs_ffnn_torch.ops.two_loop import (
    empty_history_state, ring_push, two_loop, two_loop_compact, two_loop_grouped,
)

PAIR_DTYPES = pytest.mark.parametrize("pair_dtype", [torch.float32, torch.bfloat16],
                                      ids=["f32", "bf16"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _ring(m, n, k, dev, pair_dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    hist = empty_history_state(m, n, torch.float32, pair_dtype, device=dev)
    for _ in range(k):
        s = rng.normal(size=n)
        y = torch.tensor(rng.normal(size=n) + 0.5 * s, dtype=torch.float32, device=dev)
        s = torch.tensor(s, dtype=torch.float32, device=dev)
        hist = ring_push(hist, s, y, 1.0 / torch.dot(y, s), torch.dot(y, s) > 1e-3)
    return hist


def _ring_on_card(m, n, k, dev, pair_dtype=torch.float32, seed=0):
    """As _ring, with the pairs drawn on the card (n in the millions)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = empty_history_state(m, n, torch.float32, pair_dtype, device=dev)
    for _ in range(k):
        s = torch.randn(n, generator=gen, device=dev)
        y = torch.randn(n, generator=gen, device=dev) + 0.5 * s
        hist = ring_push(hist, s, y, 1.0 / torch.dot(y, s), torch.dot(y, s) > 1e-3)
    return hist


def _check_against_plain(hist, n, clamp, dev, impl=None, **launch_kw):
    """Bound: max|kernel - plain| <= 1e-4 * max|plain| (f32 arithmetic on the
    same ring, reduced in different orders); two calls are bitwise equal;
    exactly two launches of the expected kernel and none of the other.
    ``launch_kw`` goes to ``launch`` with ``impl``."""
    m, n_pad = hist.S.shape
    want = impl or kernel_dispatch(n_pad, m, torch.float32, hist.S.dtype)[0]
    v = torch.tensor(np.random.default_rng(1).normal(size=n), dtype=torch.float32, device=dev)
    before = dict(two_loop_cuda.LAUNCHES)
    call = two_loop_cuda if impl is None else functools.partial(launch, impl, **launch_kw)
    r_k = call(v, hist, clamp_gamma=clamp)
    r_k2 = call(v, hist, clamp_gamma=clamp)
    torch.cuda.synchronize()
    assert two_loop_cuda.LAUNCHES == {k: c + 2 * (k == want) for k, c in before.items()}
    r_p = two_loop(v, hist, clamp_gamma=clamp)
    assert r_k.shape == (n,) and torch.equal(r_k, r_k2)
    assert float((r_k - r_p).abs().max()) <= 1e-4 * float(r_p.abs().max())


@pytest.mark.cuda
@PAIR_DTYPES
@pytest.mark.parametrize("m,k,n,clamp", [(10, 0, 1000, False), (10, 4, 101770, False),
                                         (10, 10, 101770, True), (10, 13, 101770, False),
                                         (4, 9, 257, True), (100, 100, 242762, False),
                                         (100, 130, 242762, True)])
def test_kernel_matches_plain_on_card(cuda, m, k, n, clamp, pair_dtype):
    """The kernel the dispatch picks, on f32 and bf16 rings: empty, partial,
    full and wrapped, the deep net at m=100 among them."""
    _check_against_plain(_ring(m, n, k, cuda, pair_dtype), n, clamp, cuda)


@pytest.mark.cuda
@PAIR_DTYPES
@pytest.mark.parametrize("impl", [COOPERATIVE, STREAMING, BLOCKED])
@pytest.mark.parametrize("k", [0, 3, 13])
def test_each_kernel_on_a_ring_both_take(cuda, impl, k, pair_dtype):
    """Each kernel forced onto the MNIST m=10 ring, which all three take."""
    _check_against_plain(_ring(10, 101770, k, cuda, pair_dtype), 101770, False, cuda, impl)


@pytest.mark.cuda
@PAIR_DTYPES
@pytest.mark.parametrize("n", [257, 3000, 101770])
@pytest.mark.parametrize("m,k,clamp", [(5, 0, False), (5, 3, True), (4, 9, False)])
def test_blocked_kernel_forced(cuda, n, m, k, clamp, pair_dtype):
    """The blocked kernel (K3) forced onto small rings: ragged last slices
    and grids of fewer blocks than SMs, empty, partial and wrapped rings."""
    _check_against_plain(_ring(m, n, k, cuda, pair_dtype), n, clamp, cuda, BLOCKED)


@pytest.mark.cuda
@pytest.mark.parametrize("k,clamp", [(20, False), (53, True)])
def test_blocked_kernel_dispatched_at_two_million(cuda, k, clamp):
    """The large-n path's ring: m=50, n=2,000,000, f32 pairs go to K3 (and
    so do bf16 pairs, which K2 would take only at k = 1)."""
    n = 2_000_000
    assert kernel_dispatch(n, 50, torch.float32)[0] == BLOCKED
    assert kernel_dispatch(n, 50, torch.float32, torch.bfloat16)[0] == BLOCKED
    _check_against_plain(_ring_on_card(50, n, k, cuda), n, clamp, cuda)


PREFETCH = pytest.mark.parametrize("prefetch", [1, 2, 3, 4, None],
                                   ids=["d1", "d2", "d3", "d4", "d_dispatch"])


@pytest.mark.cuda
@PAIR_DTYPES
@PREFETCH
@pytest.mark.parametrize("n", [2100, 101770])
@pytest.mark.parametrize("pushes,clamp", [(0, False), (1, True), (2, False), (6, True),
                                          (9, False)])
def test_blocked_prefetch_distances(cuda, n, pushes, clamp, prefetch, pair_dtype):
    """K3 at prefetch distances 1-4 and at prefetch_rows's (None), on an
    m=6 ring: counts 0, 1, 2, m and wrapped (m + 3 pushes). Both n give a
    ragged last slice (3 and 100 blocks over 2,176 and 101,888 padded
    entries); the distance runs past the end of the 4 count rows the call
    reads at low counts, and prefetch_rows's (~1,900 and ~40 rows) always."""
    _check_against_plain(_ring(6, n, pushes, cuda, pair_dtype), n, clamp, cuda, BLOCKED,
                         prefetch=prefetch)


@functools.lru_cache(maxsize=None)
def _large_ring(pair_name):
    """The large path's m=50, n=2M ring, wrapped (53 pushes), on the card."""
    pair_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[pair_name]
    return _ring_on_card(50, 2_000_000, 53, torch.device("cuda"), pair_dtype, seed=12)


@pytest.mark.cuda
@PREFETCH
@pytest.mark.parametrize("pair_name,clamp", [("f32", False), ("bf16", True)])
def test_blocked_prefetch_at_two_million(cuda, pair_name, clamp, prefetch):
    """K3 on the large path's wrapped m=50, n=2M ring (ragged over the
    card's grid) at each distance, f32 and bf16 pairs."""
    _check_against_plain(_large_ring(pair_name), 2_000_000, clamp, cuda, BLOCKED,
                         prefetch=prefetch)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    hist = _ring(5, 300, 2, cuda)
    v = torch.ones(300, device=cuda)
    with pytest.raises(ValueError):
        two_loop_cuda(v.double(), hist)
    with pytest.raises(ValueError):  # longer than the ring's padded rows
        two_loop_cuda(torch.ones(hist.S.shape[1] + 1, device=cuda), hist)
    with pytest.raises(ValueError):
        two_loop_cuda(v, hist._replace(head=hist.head.long()))
    with pytest.raises(ValueError):  # a pair type no kernel takes
        two_loop_cuda(v, _ring(5, 300, 2, cuda, torch.float16))
    with pytest.raises(ValueError):
        launch("cuda-nonesuch", v, hist)
    with pytest.raises(ValueError, match="cap"):  # m=100 is above the resident kernel's cap
        launch(COOPERATIVE, torch.ones(242762, device=cuda), _ring(100, 242762, 1, cuda))
    with pytest.raises(RuntimeError):  # the resident slices of m=16 at n = 1M do not fit
        launch(COOPERATIVE, torch.ones(1_000_000, device=cuda), _ring(16, 1_000_000, 1, cuda))
    with pytest.raises(ValueError, match="blocked kernel"):  # above K3's capacity
        two_loop_cuda(torch.ones(7_434_248, device=cuda), _ring_on_card(1, 7_434_248, 0, cuda))


N_DEEP = 242762  # the deep 784-256-128-64-10 net


@functools.lru_cache(maxsize=None)
def _deep_ring(pushes, pair_name):
    """The deep net's m=100 ring after `pushes` seeded pushes, on the card."""
    pair_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[pair_name]
    return _ring_on_card(100, N_DEEP, pushes, torch.device("cuda"), pair_dtype, seed=11)


@pytest.mark.cuda
@pytest.mark.parametrize("pair_name,group", [("f32", 1), ("f32", 2), ("f32", 4), ("bf16", 1),
                                             ("bf16", 2), ("bf16", 4), ("bf16", 8)])
@pytest.mark.parametrize("pushes,clamp", [(0, False), (3, True), (37, False), (130, True)])
def test_streaming_groups_on_card(cuda, pair_name, group, pushes, clamp):
    """K2 forced to each group size the deep m=100 ring takes (f32 k = 8
    does not fit), on counts that are no multiple of k and a wrapped ring:
    against the plain loop and the grouped algebra in plain torch (f32 on
    the card, reduced in other orders: 1e-4 of max|r|), bitwise equal over
    two calls, one launch of K2 each."""
    hist = _deep_ring(pushes, pair_name)
    v = torch.tensor(np.random.default_rng(1).normal(size=N_DEEP), dtype=torch.float32,
                     device=cuda)
    before = dict(two_loop_cuda.LAUNCHES)
    r_k = launch(STREAMING, v, hist, group=group, clamp_gamma=clamp)
    r_k2 = launch(STREAMING, v, hist, group=group, clamp_gamma=clamp)
    torch.cuda.synchronize()
    assert two_loop_cuda.LAUNCHES == {k: c + 2 * (k == STREAMING) for k, c in before.items()}
    assert r_k.shape == (N_DEEP,) and torch.equal(r_k, r_k2)
    for ref in (two_loop(v, hist, clamp_gamma=clamp),
                two_loop_grouped(v, hist, group, clamp_gamma=clamp)):
        assert float((r_k - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_streaming_group_sizes_of_the_deep_rings(cuda):
    """The dispatch's pick for the deep rings: K2 at k = 4 (f32) and 8
    (bf16); forcing k = 8 on the f32 ring raises, it does not shrink k."""
    for pair_name, want in (("f32", 4), ("bf16", 8)):
        hist = _deep_ring(3, pair_name)
        assert kernel_dispatch(hist.S.shape[1], 100, torch.float32, hist.S.dtype)[0] == STREAMING
        assert group_size(hist.S.shape[1], 100, hist.S.dtype.itemsize) == want
    v = torch.ones(N_DEEP, device=cuda)
    before = dict(two_loop_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="groups of k=8"):
        launch(STREAMING, v, _deep_ring(3, "f32"), group=8)
    assert two_loop_cuda.LAUNCHES == before


@functools.lru_cache(maxsize=None)
def _resident_ring(m, pushes, n, pair_name):
    pair_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[pair_name]
    return _ring(m, n, pushes, torch.device("cuda"), pair_dtype, seed=13)


@pytest.mark.cuda
@pytest.mark.parametrize("pair_name", ["f32", "bf16"])
@pytest.mark.parametrize("n", [257, 3000, 101770])
@pytest.mark.parametrize("m", [1, 5, 10, RESIDENT_MAX_M])
@pytest.mark.parametrize("pushes", ["0", "1", "2", "m", "wrapped"])
@pytest.mark.parametrize("clamp", [False, True])
def test_resident_kernel_compact_form(cuda, pushes, m, n, pair_name, clamp):
    """K1 on counts 0, 1, 2, m and a wrapped ring (m + 3 pushes), m from 1
    to the cap, ragged grids (n = 257 and 3000 give one and three blocks)
    and the MNIST ring: against the plain loop and the plain compact form
    (1e-4 of max|r|: f32 on the card, reduced in other orders), bitwise
    equal over two calls, one launch each; count 0 returns v bit for bit."""
    k = {"0": 0, "1": 1, "2": 2, "m": m, "wrapped": m + 3}[pushes]
    hist = _resident_ring(m, k, n, pair_name)
    assert kernel_dispatch(hist.S.shape[1], m, torch.float32, hist.S.dtype)[0] == COOPERATIVE
    v = torch.tensor(np.random.default_rng(2).normal(size=n), dtype=torch.float32, device=cuda)
    before = dict(two_loop_cuda.LAUNCHES)
    r_k = two_loop_cuda(v, hist, clamp_gamma=clamp)
    r_k2 = two_loop_cuda(v, hist, clamp_gamma=clamp)
    torch.cuda.synchronize()
    assert two_loop_cuda.LAUNCHES == {i: c + 2 * (i == COOPERATIVE) for i, c in before.items()}
    assert r_k.shape == (n,) and torch.equal(r_k, r_k2)
    if k == 0:
        assert torch.equal(r_k, v)
    for ref in (two_loop(v, hist, clamp_gamma=clamp),
                two_loop_compact(v, hist, clamp_gamma=clamp)):
        assert float((r_k - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_resident_kernel_head_ahead_of_count(cuda):
    """A ring whose count is below m with head != count (as after pushes,
    a reset and new pushes into a ring the caller rearranged): K1 reads the
    logical order from head and count on the device."""
    hist = _ring(10, 3000, 13, cuda)
    hist = hist._replace(count=torch.tensor(6, dtype=torch.int32, device=cuda))
    v = torch.tensor(np.random.default_rng(3).normal(size=3000), dtype=torch.float32, device=cuda)
    r_k = two_loop_cuda(v, hist)
    ref = two_loop(v, hist)
    assert int(hist.head) != 6
    assert float((r_k - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_resident_kernel_refuses_above_its_cap(cuda):
    """m = cap + 1: the dispatch sends the ring to K2 with the cap as its
    reason, and a launch of K1 by name raises naming the cap."""
    m = RESIDENT_MAX_M + 1
    hist = _ring(m, 3000, 2, cuda)
    impl, reason = kernel_dispatch(hist.S.shape[1], m, torch.float32)
    assert impl == STREAMING and f"cap of {RESIDENT_MAX_M}" in reason
    before = dict(two_loop_cuda.LAUNCHES)
    with pytest.raises(ValueError, match=f"at most {RESIDENT_MAX_M} pairs"):
        launch(COOPERATIVE, torch.ones(3000, device=cuda), hist)
    assert two_loop_cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("pair_name", ["f32", "bf16"])
def test_resident_stamped_build_agrees(cuda, pair_name):
    """K1's timestamped build (the phase study's) computes the same r as the
    launched one, bitwise, and writes rising stamps; it is not counted."""
    hist = _resident_ring(10, 13, 101770, pair_name)
    v = torch.tensor(np.random.default_rng(4).normal(size=101770), dtype=torch.float32,
                     device=cuda)
    stamps = torch.zeros(2 * N_STAMPS, dtype=torch.int64, device=cuda)
    before = dict(two_loop_cuda.LAUNCHES)
    r_s = launch(COOPERATIVE, v, hist, stamps=stamps)
    torch.cuda.synchronize()
    assert two_loop_cuda.LAUNCHES == before
    assert torch.equal(r_s, launch(COOPERATIVE, v, hist))
    ns = stamps.view(N_STAMPS, 2)[:, 0].cpu()
    assert bool((ns[1:] >= ns[:-1]).all()) and int(ns[-1]) > int(ns[0])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", [COOPERATIVE, STREAMING, BLOCKED])
def test_kernels_read_v_in_place(cuda, impl):
    """The kernels read v's n entries in place, zero beyond (the wrapper
    pads nothing): an n that is no multiple of 4, a v that starts 4 bytes
    off a 16-byte boundary and a strided v give the plain loop's r."""
    n = 3001
    hist = _ring(10, n, 13, cuda)
    base = torch.tensor(np.random.default_rng(5).normal(size=2 * n + 2), dtype=torch.float32,
                        device=cuda)
    for v in (base[:n], base[1:n + 1], base[::2][:n]):
        r_k = launch(impl, v, hist)
        ref = two_loop(v.contiguous(), hist)
        assert r_k.shape == (n,)
        assert float((r_k - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


# -- the resident solve: conditional nodes, capture, device-side launch counts


@pytest.mark.cuda
def test_conditional_nodes_supported(cuda):
    from lbfgs_ffnn_torch.ops.control import conditional_nodes_supported

    ok, why = conditional_nodes_supported()
    assert ok, why


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False])
def test_guarded_kernel_in_a_replayed_graph(cuda, first):
    """K1 under guard(flag) in a captured graph: each replay launches it
    (counted on the device) and writes its result where the flag is true,
    and neither where it is false; the flag is read at replay, not at
    capture."""
    from lbfgs_ffnn_torch.ops.control import Graph, assign, capture, guard

    n = 101770
    hist = _ring(10, n, 13, cuda)
    v = torch.tensor(np.random.default_rng(3).normal(size=n), dtype=torch.float32, device=cuda)
    want = two_loop_cuda(v, hist)  # eager first: the launch configuration and the counters
    out = torch.zeros(n, dtype=torch.float32, device=cuda)
    flag = torch.tensor(first, device=cuda)
    graph = Graph()
    with capture(graph):
        with guard(flag):
            assign(flag, out, two_loop_cuda(v, hist))
    for value in (first, not first):
        flag.fill_(value)
        out.zero_()
        two_loop_cuda.LAUNCHES[COOPERATIVE] = 0
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert two_loop_cuda.LAUNCHES[COOPERATIVE] == (2 if value else 0)
        assert torch.equal(out, want) if value else not bool(out.any())


def _mlp_case(dims, n_samples, dev, seed=0):
    from lbfgs_ffnn_torch.objectives.mlp import mlp_problem, mlp_spec

    acts = ["relu"] * (len(dims) - 2) + ["linear"]
    spec = mlp_spec(dims, acts)
    rng = np.random.default_rng(seed)
    w0 = torch.tensor(rng.normal(size=spec.n_params) * 0.1, dtype=torch.float32, device=dev)
    x = torch.tensor(rng.random((n_samples, dims[0])), dtype=torch.float32, device=dev)
    y = torch.tensor(np.eye(dims[-1])[rng.integers(0, dims[-1], n_samples)],
                     dtype=torch.float32, device=dev)
    return mlp_problem(spec), w0, (x, y)


# (dims, m, the kernel the dispatch gives the ring, pair dtype)
_RESIDENT_CASES = {
    "mlp-k1": ([784, 32, 10], 10, COOPERATIVE, None),
    "mlp-k1-bf16": ([784, 32, 10], 10, COOPERATIVE, "bfloat16"),
    "deep-k2": ([784, 64, 32, 10], 20, STREAMING, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_RESIDENT_CASES))
@pytest.mark.parametrize("iters", [23, 40])
def test_captured_solve_equals_eager_resident_body(cuda, case, iters):
    """lbfgs() on CUDA tensors under Armijo replays a captured iteration:
    bitwise equal to the resident body run eagerly (the same kernels in the
    same order), the same counters, at most ceil(iters / chunk) + 2 host
    syncs, and the two-loop kernel launched once per direction, counted on
    the device across replays."""
    from lbfgs_ffnn_torch.solvers.lbfgs import (
        RESIDENT_CHUNK, LBFGSOptions, _lbfgs_resident_eager, clear_graph_cache, lbfgs,
    )

    dims, m, impl, pair_dtype = _RESIDENT_CASES[case]
    problem, w0, aux = _mlp_case(dims, 2048, cuda)
    opts = LBFGSOptions(max_iters=iters, tol=1e-12, m=m, line_search="armijo", ls_max_iters=20,
                        pair_dtype=pair_dtype)
    eager = _lbfgs_resident_eager(problem, w0, aux, opts)
    lbfgs(problem, w0, aux, opts)  # captures the iteration
    for kind in two_loop_cuda.LAUNCHES:
        two_loop_cuda.LAUNCHES[kind] = 0
    res = lbfgs(problem, w0, aux, opts)
    launches = dict(two_loop_cuda.LAUNCHES)
    clear_graph_cache()
    assert res.n_iters == eager.n_iters == iters
    assert (res.n_fevals, res.n_gevals) == (eager.n_fevals, eager.n_gevals)
    assert torch.equal(res.x, eager.x)
    assert torch.equal(res.loss_history, eager.loss_history)
    assert torch.equal(res.gnorm_history, eager.gnorm_history)
    assert res.n_host_syncs <= -(-iters // RESIDENT_CHUNK) + 2
    assert launches == {k: (iters if k == impl else 0) for k in launches}
    assert float(res.final_loss) < float(problem.fun(w0, aux))


@pytest.mark.cuda
def test_captured_solve_stops_on_tol_mid_chunk(cuda):
    """A tol reached inside a chunk stops the solve there: the replays past
    it are no-ops on the device (no launch, no write)."""
    from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, clear_graph_cache, lbfgs

    problem, w0, aux = _mlp_case([784, 32, 10], 2048, cuda)
    opts = LBFGSOptions(max_iters=60, tol=1e-12, m=10, line_search="armijo", ls_max_iters=20)
    full = lbfgs(problem, w0, aux, opts)
    gn = full.gnorm_history.double().cpu().numpy()
    # the first new minimum of |g| from iteration 20 on that ends no chunk
    j = next(j for j in range(20, 60)
             if (j + 1) % 10 and gn[j] * (1 + 1e-6) < gn[:j].min())
    tol, stop = float(gn[j]) * (1 + 1e-6), j + 1
    lbfgs(problem, w0, aux, opts._replace(tol=tol))
    for kind in two_loop_cuda.LAUNCHES:
        two_loop_cuda.LAUNCHES[kind] = 0
    res = lbfgs(problem, w0, aux, opts._replace(tol=tol))
    launches = two_loop_cuda.LAUNCHES[COOPERATIVE]
    clear_graph_cache()
    assert bool(res.converged) and res.n_iters == stop
    assert launches == stop
    assert torch.equal(res.loss_history[:stop], full.loss_history[:stop])
    assert bool(torch.isnan(res.loss_history[stop:]).all())


@pytest.mark.cuda
def test_capture_raises_on_a_host_sync(cuda):
    """The capture runs in the mode that raises on any host sync: an
    objective that reads a value back cannot be captured (its trial sits
    in a guarded body, so the failure travels out through the enclosing
    captures), and the process carries on."""
    from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, clear_graph_cache, lbfgs
    from lbfgs_ffnn_torch.types import make_problem

    def fun(w, aux=()):
        return torch.sum(w * w) * float(w.abs().max() < 1e9)  # float() syncs

    w0 = torch.ones(64, device=cuda)
    problem = make_problem(fun, grad=lambda w, aux=(): 2.0 * w)
    with pytest.raises(Exception, match="captur"):
        lbfgs(problem, w0, (), LBFGSOptions(max_iters=5, line_search="armijo"))
    clear_graph_cache()
    torch.cuda.synchronize()
    res = lbfgs(make_problem(lambda w, aux=(): torch.sum(w * w), lambda w, aux=(): 2.0 * w),
                w0, (), LBFGSOptions(max_iters=5, line_search="armijo"))
    assert float(res.final_loss) < 64.0
    clear_graph_cache()


@pytest.mark.cuda
def test_launcher_timed_chunks_on_card(cuda, tmp_path):
    """UnifiedConfig(timed_chunks=K) on the card: lbfgs_chunked replays the
    captured iteration, TimeMs is measured per chunk, and the solve equals
    the Launcher's plain timed solve of the same weights bitwise."""
    from lbfgs_ffnn_torch.data.datasets import Dataset
    from lbfgs_ffnn_torch.launcher import Launcher, UnifiedConfig
    from lbfgs_ffnn_torch.recorder import read_history_csv
    from lbfgs_ffnn_torch.solvers.lbfgs import clear_graph_cache

    rng = np.random.default_rng(6)
    x = rng.random((1024, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 1024)]
    launcher = (Launcher("cuda", out_dir=tmp_path).add_layer(784, 32, "relu")
                .add_layer(32, 10, "linear").build_network().set_data(Dataset(x, y, x, y)))
    reports = {k: launcher.train("lbfgs", UnifiedConfig(name=f"T{k}", max_iters=23, m_param=10,
                                                        tolerance=1e-12, log_interval=1,
                                                        timed_chunks=k),
                                 verbose=False)
               for k in (0, 5)}
    clear_graph_cache()
    h = read_history_csv(reports[5].csv_path)
    assert h.n == 23 and len(np.unique(h.time_ms)) == 5 and np.all(np.diff(h.time_ms) >= 0)
    assert torch.equal(reports[0].result.x, reports[5].result.x)
    assert reports[5].result.n_host_syncs <= -(-23 // 5) + 2
