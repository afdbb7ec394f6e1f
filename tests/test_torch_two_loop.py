"""The port's curvature ring and two-loop recursion: ring mechanics, the plain
torch recursion against the JAX loop form (f64) and the Pallas kernels
(f32, interpret mode: the streaming and the rows-blocked one) and a dense
inverse-Hessian oracle; the grouped algebra of the streaming Hopper kernel
(two_loop_grouped) against the same references and against the f64
recursion in f32; the compact form of the resident Hopper kernel
(two_loop_compact) against JAX's two_loop_compact and the f64 recursion in
f32; the Hopper dispatch's picks and reasons, the resident kernel's cap and
the streaming kernel's group sizes. The Hopper kernels' own tests, which
need the card, are in tests/test_torch_cuda.py."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgs_ffnn_tpu.ops.two_loop
import lbfgs_ffnn_torch.ops.two_loop
from lbfgs_ffnn_tpu.ops.pallas_two_loop import (
    _two_loop_pallas_blocked, pallas_dispatch, two_loop_pallas,
)
from lbfgs_ffnn_torch.ops.cuda_two_loop import (
    BLOCKED, COOPERATIVE, RESIDENT_MAX_M, STREAMING, group_size, kernel_dispatch, launch,
    prefetch_rows, two_loop_cuda,
)

# the modules (their packages re-export a function of the same name)
jtl = sys.modules["lbfgs_ffnn_tpu.ops.two_loop"]
ttl = sys.modules["lbfgs_ffnn_torch.ops.two_loop"]


def make_pairs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < k:
        s = rng.normal(size=n)
        y = rng.normal(size=n) + 0.5 * s  # bias towards y^T s > 0
        if s @ y > 1e-3:
            pairs.append((s, y))
    return pairs


def torch_ring(m, n, pairs, dtype=torch.float64, device=None, pair_dtype=None):
    hist = ttl.empty_history_state(m, n, dtype, pair_dtype, device=device)
    for s, y in pairs:
        s_t = torch.tensor(s, dtype=dtype, device=device)
        y_t = torch.tensor(y, dtype=dtype, device=device)
        hist = ttl.ring_push(hist, s_t, y_t, 1.0 / torch.dot(y_t, s_t),
                             torch.tensor(True, device=device))
    return hist


def jax_ring(m, n, pairs, dtype=jnp.float64, pair_dtype=None):
    hist = jtl.empty_history_state(m, n, dtype, pair_dtype=pair_dtype)
    for s, y in pairs:
        s_j, y_j = jnp.asarray(s, dtype=dtype), jnp.asarray(y, dtype=dtype)
        hist = jtl.ring_push(hist, s_j, y_j, 1.0 / jnp.vdot(y_j, s_j), jnp.array(True))
    return hist


def bf16_bits(a):
    """The bit patterns of a bf16 array from either framework."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def dense_inverse_hessian(S, Y, n):
    """Oracle: explicit BFGS inverse Hessian from the (s, y) pairs,
    H_{k+1} = (I - rho s y^T) H_k (I - rho y s^T) + rho s s^T,
    with H_0 = gamma I from the newest pair."""
    s_last, y_last = S[-1], Y[-1]
    H = float(s_last @ y_last) / float(y_last @ y_last) * np.eye(n)
    for s, y in zip(S, Y):
        rho = 1.0 / float(y @ s)
        V = np.eye(n) - rho * np.outer(s, y)
        H = V @ H @ V.T + rho * np.outer(s, s)
    return H


# (m, k pairs pushed, n): empty, partial, full, wrapped; odd and aligned n
CASES = [(5, 0, 300), (5, 3, 301), (5, 5, 300), (4, 9, 257), (6, 4, 2048)]


@pytest.mark.parametrize("m,k,n", CASES)
@pytest.mark.parametrize("clamp", [False, True])
def test_plain_matches_jax_f64(m, k, n, clamp):
    """Same recursion in f64; only dot summation order differs: rtol 1e-12."""
    pairs = make_pairs(n, k, seed=m + k)
    v = np.random.default_rng(1).normal(size=n)
    r_t = ttl.two_loop(torch.tensor(v), torch_ring(m, n, pairs), clamp_gamma=clamp)
    r_j = jtl.two_loop(jnp.asarray(v), jax_ring(m, n, pairs), clamp_gamma=clamp)
    assert r_t.shape == (n,)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12, atol=1e-12)


def test_clamp_gamma_guards():
    """clamp_gamma: tiny y^T y -> gamma = 1, then clipped; finite output."""
    n, m = 4, 2
    s, y = np.ones(n), np.full(n, 1e-10)
    v = np.ones(n)
    r_t = ttl.two_loop(torch.tensor(v), torch_ring(m, n, [(s, y)]), clamp_gamma=True)
    r_j = jtl.two_loop(jnp.asarray(v), jax_ring(m, n, [(s, y)]), clamp_gamma=True)
    assert torch.all(torch.isfinite(r_t))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12)


@pytest.mark.parametrize("m,k", [(5, 0), (5, 3), (5, 5), (4, 9)])
def test_plain_matches_pallas_f32(m, k):
    """f32 against the TPU kernel in interpret mode: the two reduce in
    different orders, so 2e-5 as in tests/test_pallas_two_loop.py."""
    n = 300
    pairs = [(s.astype(np.float32), y.astype(np.float32)) for s, y in make_pairs(n, k)]
    v = np.random.default_rng(1).normal(size=n).astype(np.float32)
    r_t = ttl.two_loop(torch.tensor(v), torch_ring(m, n, pairs, torch.float32))
    r_p = two_loop_pallas(jnp.asarray(v), jax_ring(m, n, pairs, jnp.float32))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_p), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,m,k", [(8, 5, 3), (8, 5, 5), (16, 4, 9)])
def test_plain_matches_dense_oracle(n, m, k):
    """H @ g from the explicit inverse Hessian of the newest min(k, m) pairs."""
    pairs = make_pairs(n, k)
    g = np.random.default_rng(2).normal(size=n)
    r = ttl.two_loop(torch.tensor(g), torch_ring(m, n, pairs))
    kept = pairs[-m:]
    H = dense_inverse_hessian([s for s, _ in kept], [y for _, y in kept], n)
    np.testing.assert_allclose(r.numpy(), H @ g, rtol=1e-10, atol=1e-12)


def test_empty_history_is_identity():
    hist = ttl.empty_history_state(4, 6, torch.float64)
    g = torch.arange(6.0, dtype=torch.float64)
    assert torch.equal(ttl.two_loop(g, hist), g)


def test_ring_push_overwrites_oldest():
    n, m = 3, 2
    hist = ttl.empty_history_state(m, n, torch.float64)
    assert hist.S.shape == (m, 128) and hist.head.dtype == torch.int32
    for i in range(3):
        v = torch.full((n,), float(i + 1), dtype=torch.float64)
        hist = ttl.ring_push(hist, v, v, torch.dot(v, v), torch.tensor(True))
    assert int(hist.count) == m and int(hist.head) == 1
    # slots now hold vecs[2] (head wrapped) and vecs[1]; padding stays zero
    assert sorted(float(hist.S[i, 0]) for i in range(m)) == [2.0, 3.0]
    assert float(hist.S[0, 0]) == 3.0 and float(hist.rho[0]) == 27.0
    assert torch.all(hist.S[:, n:] == 0)


def test_ring_push_rejected_pair_is_noop():
    hist = ttl.empty_history_state(2, 3, torch.float64)
    v = torch.ones(3, dtype=torch.float64)
    hist2 = ttl.ring_push(hist, v, v, torch.tensor(1.0), torch.tensor(False))
    assert int(hist2.count) == 0 and int(hist2.head) == 0
    assert torch.all(hist2.S == 0) and torch.all(hist2.Y == 0) and torch.all(hist2.rho == 0)


def test_ring_reset():
    hist = ttl.empty_history_state(2, 3, torch.float64)
    v = torch.ones(3, dtype=torch.float64)
    hist = ttl.ring_push(hist, v, v, torch.tensor(1.0), torch.tensor(True))
    kept = ttl.ring_reset(hist, torch.tensor(False))
    assert int(kept.count) == 1 and int(kept.head) == 1
    hist = ttl.ring_reset(hist, torch.tensor(True))
    assert int(hist.count) == 0 and int(hist.head) == 0


def test_kernel_dispatch_reasons():
    assert kernel_dispatch(102400, 10, torch.float32) == ("cuda-cooperative", "")
    for args, why in (((102400, 10, torch.float64), "dtype torch.float64"),
                      ((102400, 10, torch.float32, torch.float16), "pair dtype torch.float16"),
                      ((8 * 1024 * 1024, 10, torch.float32), "shared memory"),
                      ((7_434_248, 50, torch.float32), "blocked kernel"),
                      ((7_434_248, 50, torch.float32, torch.bfloat16), "n_pad <= 7434240"),
                      ((102404, 10, torch.float32), "multiple of 8"),
                      ((1024, 0, torch.float32), "m=0")):
        impl, reason = kernel_dispatch(*args)
        assert impl == "unsupported" and why in reason


@pytest.mark.parametrize("n_pad,m,pair_dtype,want", [
    (101888, 10, torch.float32, COOPERATIVE),   # MNIST m=10
    (101888, 10, torch.bfloat16, COOPERATIVE),
    (242816, 10, torch.float32, COOPERATIVE),   # deep net m=10
    (242816, 100, torch.float32, STREAMING),    # deep net m=100
    (242816, 100, torch.bfloat16, STREAMING),
    (101888, 100, torch.bfloat16, STREAMING),   # MNIST m=100
    (1048576, 50, torch.float32, STREAMING),    # scripts/diag_two_loop_large.py, n = 1M
    (2_000_000, 50, torch.float32, BLOCKED),    # the large Rosenbrock path
    (2_000_000, 50, torch.bfloat16, BLOCKED),   # K2 fits only at k = 1, and K3 is faster
    (4_000_000, 50, torch.float32, BLOCKED),    # scripts/diag_two_loop_large.py, n = 4M
    (4_000_000, 50, torch.bfloat16, BLOCKED),
    (7_434_240, 50, torch.float32, BLOCKED),    # K3's capacity: q alone fills the grid
])
def test_kernel_dispatch_picks(n_pad, m, pair_dtype, want):
    """The port's size policy at the shapes its paths give it: bf16 pairs
    are taken, the resident kernel only where all m pairs fit, the blocked
    one where not even two staged pairs fit beside q, and from n_pad = 2M
    also where they fit only one pair at a time (k = 1)."""
    assert kernel_dispatch(n_pad, m, torch.float32, pair_dtype) == (want, "")


@pytest.mark.parametrize("n_pad,m,pair_dtype,want", [
    (242816, 100, torch.float32, 4),     # deep net m=100: k = 8 needs 32 MB
    (242816, 100, torch.bfloat16, 8),
    (2_000_000, 50, torch.bfloat16, 1),  # the large path's bf16 ring: K2 fits, K3 takes it
    (1024, 3, torch.float32, 2),         # k <= m
    (2_000_000, 50, torch.float32, None),  # not even two f32 pairs fit (K3's ring)
])
def test_group_size(n_pad, m, pair_dtype, want):
    """The streaming kernel's group: the largest of 8, 4, 2, 1 pairs (at
    most m) whose two buffers fit beside q; none where its k = 1 does not,
    which is where the dispatch gives the ring to K3. The dispatch picks K2
    only where it has a group; at k = 1 from n_pad = 2M it picks K3."""
    assert group_size(n_pad, m, pair_dtype.itemsize) == want
    impl = kernel_dispatch(n_pad, m, torch.float32, pair_dtype)[0]
    if want is None or (want == 1 and n_pad >= 2_000_000):
        assert impl == BLOCKED
    else:
        assert impl in (COOPERATIVE, STREAMING)


@pytest.mark.parametrize("impl,m,n,group,why", [
    (STREAMING, 8, 240_000, 8, "need 31680000 bytes"),  # two groups of 8 f32 pairs
    (STREAMING, 8, 1000, 3, "k not in"),
    (STREAMING, 3, 1000, 4, "k > m=3"),
    (BLOCKED, 3, 1000, 2, "takes no group size"),
])
def test_launch_refuses_a_group_the_ring_cannot_take(impl, m, n, group, why):
    """A k the ring cannot take raises with its reason before anything is
    launched; no smaller k is taken instead."""
    hist = ttl.empty_history_state(m, n, torch.float32)
    with pytest.raises(ValueError, match=why):
        launch(impl, torch.zeros(n), hist, group=group)


@pytest.mark.parametrize("n_pad,pair_dtype,want", [
    (2_000_000, torch.float32, 1),    # the large path's ring: an 8 MB row overruns 4 MiB
    (4_000_000, torch.float32, 1),
    (2_000_000, torch.bfloat16, 1),   # 4,000,000 bytes: one row fits
    (4_000_000, torch.bfloat16, 1),
    (2_000_000 // 2, torch.bfloat16, 2),
    (7_434_240, torch.float32, 1),    # K3's reach: a 29.7 MB row
    (1024, torch.float32, 1024),      # tiny rows: the distance outruns any sequence
    (8, torch.bfloat16, 262144),
])
def test_prefetch_rows(n_pad, pair_dtype, want):
    """The blocked kernel's L2 prefetch distance: the most rows that fit
    4 MiB, at least 1."""
    assert prefetch_rows(n_pad, pair_dtype.itemsize) == want


@pytest.mark.parametrize("impl,prefetch,why", [
    (BLOCKED, 0, "must be >= 1"),
    (BLOCKED, -2, "must be >= 1"),
    (COOPERATIVE, 2, "takes no prefetch distance"),
    (STREAMING, 1, "takes no prefetch distance"),
])
def test_launch_refuses_a_prefetch_distance(impl, prefetch, why):
    """A distance the blocked kernel cannot run, or any distance for the
    kernels that prefetch nothing, raises before anything is launched (here
    before the device check: the tensors are on the CPU)."""
    hist = ttl.empty_history_state(4, 1000, torch.float32)
    before = dict(two_loop_cuda.LAUNCHES)
    with pytest.raises(ValueError, match=why):
        launch(impl, torch.zeros(1000), hist, prefetch=prefetch)
    assert two_loop_cuda.LAUNCHES == before


@pytest.mark.parametrize("n_pad,m,pair_dtype,want", [
    (101888, RESIDENT_MAX_M, torch.float32, COOPERATIVE),   # the cap itself
    (101888, RESIDENT_MAX_M, torch.bfloat16, COOPERATIVE),
    (101888, RESIDENT_MAX_M + 1, torch.float32, STREAMING),  # K1's slices fit, the cap refuses
    (101888, 30, torch.bfloat16, STREAMING),
    (1024, 20, torch.float32, STREAMING),
])
def test_kernel_dispatch_resident_cap(n_pad, m, pair_dtype, want):
    """The resident kernel takes m <= RESIDENT_MAX_M (16) wherever its
    slices fit; a ring above the cap whose slices would fit goes to the
    streaming kernel with the cap as its reason."""
    impl, reason = kernel_dispatch(n_pad, m, torch.float32, pair_dtype)
    assert impl == want
    assert (reason == "") == (m <= RESIDENT_MAX_M)
    if m > RESIDENT_MAX_M:
        assert reason == f"m={m} is above the resident kernel's cap of {RESIDENT_MAX_M} pairs"


def test_launch_refuses_the_resident_kernel_above_its_cap():
    """launch(COOPERATIVE) on m = cap + 1 raises naming the cap, before the
    device check (the tensors here are on the CPU) and before any launch."""
    hist = ttl.empty_history_state(RESIDENT_MAX_M + 1, 1000, torch.float32)
    before = dict(two_loop_cuda.LAUNCHES)
    with pytest.raises(ValueError, match=f"at most {RESIDENT_MAX_M} pairs"):
        launch(COOPERATIVE, torch.zeros(1000), hist)
    assert two_loop_cuda.LAUNCHES == before


def test_resident_phase_study_parses():
    """K1's phase study: one label per interval between the kernel's
    N_STAMPS stamps, the mean per phase from (ns, cycles) stamps, a refusal
    of stamps of another shape, and of a run without a card."""
    from lbfgs_ffnn_torch.experiments import resident_phase_study as study
    from lbfgs_ffnn_torch.ops.cuda_two_loop import N_STAMPS

    src = (_build_csrc() / "two_loop.cu").read_text()
    assert f"constexpr int kStamps = {N_STAMPS};" in src
    assert len(study.PHASES) == N_STAMPS - 1 == src.count("stamp<kStamps>(p, ") - 1
    stamps = np.zeros((2, N_STAMPS, 2), dtype=np.int64)
    stamps[0, :, 0] = np.arange(N_STAMPS) * 1000          # 1 us per phase
    stamps[1, :, 0] = np.arange(N_STAMPS) ** 2 * 1000     # 2k + 1 us
    stamps[:, :, 1] = np.arange(N_STAMPS) * 1980
    split = study.phase_split(stamps)
    assert list(split) == list(study.PHASES)
    for k, (us, cycles) in enumerate(split.values()):
        assert us == pytest.approx((1 + 2 * k + 1) / 2) and cycles == 1980
    with pytest.raises(ValueError):
        study.phase_split(stamps[:, 1:])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
            study.main([])


def _build_csrc():
    from lbfgs_ffnn_torch import _build

    return _build.CSRC


def test_blocked_stage_study_finds_its_anchors():
    """The K3 stage study builds its variants by replacing text of
    csrc/two_loop.cu; each piece it replaces is there exactly once, and
    without a card it refuses to run."""
    from lbfgs_ffnn_torch import _build
    from lbfgs_ffnn_torch.experiments import blocked_stage_study as study

    src = (_build.CSRC / "two_loop.cu").read_text()
    for old, _ in [(study.PREFETCH, None), *sum(study.VARIANTS.values(), [])]:
        assert src.count(old) == 1
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
            study.main([])


def test_cuda_wrapper_on_cpu_is_plain():
    """A CPU tensor takes the plain version and launches nothing; launching
    a kernel on it is an error."""
    n, m = 300, 5
    hist = torch_ring(m, n, make_pairs(n, 3), torch.float32)
    v = torch.tensor(np.random.default_rng(3).normal(size=n), dtype=torch.float32)
    before = dict(two_loop_cuda.LAUNCHES)
    assert torch.equal(two_loop_cuda(v, hist), ttl.two_loop(v, hist))
    assert two_loop_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        launch(STREAMING, v, hist)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bf16_ring_pushes_bitwise_equal_to_jax(dtype):
    """Pushes narrow the padded rows to bf16 the same way in both packages
    (both round f64 through f32: checked bit for bit here); rho, head and
    count stay in the solver dtype, rho equal up to the f32 rounding of the
    dot it comes from. The JAX ring pads to 2048, the port to
    128: the rows agree on the first n entries and are zero after."""
    m, n = 4, 1000
    pairs = make_pairs(n, 6, seed=7)
    t = torch_ring(m, n, pairs, getattr(torch, dtype), pair_dtype=torch.bfloat16)
    j = jax_ring(m, n, pairs, getattr(jnp, dtype), pair_dtype=jnp.bfloat16)
    assert t.S.dtype == torch.bfloat16 and t.S.shape == (m, 1024) and t.rho.dtype == getattr(
        torch, dtype)
    for tb, jb in ((t.S, j.S), (t.Y, j.Y)):
        np.testing.assert_array_equal(bf16_bits(tb)[:, :n], bf16_bits(jb).reshape(m, -1)[:, :n])
        assert not bf16_bits(tb)[:, n:].any()
    # rho = 1/(y.s) from the unnarrowed pair; the dots sum in other orders
    np.testing.assert_allclose(t.rho.numpy(), np.asarray(j.rho), rtol=1e-6)
    assert (int(t.head), int(t.count)) == (int(j.head), int(j.count))


@pytest.mark.parametrize("m,k,n", [(5, 3, 301), (4, 9, 257), (6, 4, 2048)])
@pytest.mark.parametrize("clamp", [False, True])
def test_plain_bf16_ring_matches_jax_f64(m, k, n, clamp):
    """An f64 solve with bf16 pairs: the same stored rows (bitwise, above),
    upcast before every dot and axpy in both: rtol 1e-12 as in f64."""
    pairs = make_pairs(n, k, seed=m + k)
    v = np.random.default_rng(1).normal(size=n)
    r_t = ttl.two_loop(torch.tensor(v), torch_ring(m, n, pairs, pair_dtype=torch.bfloat16),
                       clamp_gamma=clamp)
    r_j = jtl.two_loop(jnp.asarray(v), jax_ring(m, n, pairs, pair_dtype=jnp.bfloat16),
                       clamp_gamma=clamp)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12, atol=1e-12)


@pytest.fixture
def machine_threads():
    """torch's intra-op threads at every core this process may use, for the
    test's length (``tests/_torch_threads.py`` caps a worker's below that).
    The plain loops' f32 dots are BLAS dots whose rounding depends on how
    many threads split them: at n = 400k on one thread the plain loop's
    error is 3.1 times the Pallas kernel's, on two or more within the 2
    times these tests hold, so they run with the threads they were written
    for."""
    saved = torch.get_num_threads()
    torch.set_num_threads(len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                          else os.cpu_count())
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("n,pair", [(400_000, "bfloat16"), (200_000, "float32")])
def test_plain_matches_pallas_streaming(n, pair, machine_threads):
    """The plain loop against JAX's streaming kernel (interpret mode) on the
    same f32 ring of 8 pushes into m=6 (wrapped), at sizes where
    pallas_dispatch picks "pallas-streaming". Both are f32 evaluations of a
    recursion whose dots run over 400k elements, so they are held to the f64
    recursion on the same stored rows: the port's error at most twice the
    kernel's, and the two within 1e-3 of max|r| of each other (JAX's own
    loop form and its kernel differ by 1.2e-4 there)."""
    m = 6
    pairs = [(s.astype(np.float32), y.astype(np.float32)) for s, y in make_pairs(n, 8, seed=5)]
    v = np.random.default_rng(6).normal(size=n).astype(np.float32)
    j = jax_ring(m, n, pairs, jnp.float32, pair_dtype=getattr(jnp, pair))
    assert pallas_dispatch(jtl.ring_n_pad(j), m, jnp.float32, j.S.dtype) == ("pallas-streaming", "")
    t = torch_ring(m, n, pairs, torch.float32, pair_dtype=getattr(torch, pair))
    r_p = np.asarray(two_loop_pallas(jnp.asarray(v), j), dtype=np.float64)
    r_t = ttl.two_loop(torch.tensor(v), t).double().numpy()
    t64 = t._replace(S=t.S.double(), Y=t.Y.double(), rho=t.rho.double())
    r_64 = ttl.two_loop(torch.tensor(v, dtype=torch.float64), t64).numpy()
    err_t, err_p = np.abs(r_t - r_64).max(), np.abs(r_p - r_64).max()
    assert err_t <= 2 * err_p
    assert np.abs(r_t - r_p).max() <= 1e-3 * np.abs(r_p).max()


def _blocked_reference(hist_j, v, n, blk, clamp):
    rows = hist_j.S.shape[1]
    v2 = jnp.zeros((rows * 128,), jnp.float32).at[:n].set(jnp.asarray(v)).reshape(rows, 128)
    out = _two_loop_pallas_blocked(v2, hist_j.S, hist_j.Y, hist_j.rho, hist_j.head,
                                   hist_j.count, clamp, 1e-6, 1e6, True, blk)
    return np.asarray(out[:n])


@pytest.mark.parametrize("m,k,n,blk", [
    (5, 0, 3000, 8),    # empty history
    (5, 3, 3000, 8),    # partial fill, even chunks
    (4, 9, 3000, 8),    # wrapped ring
    (5, 4, 3000, 10),   # ragged tail chunk (rows=24, cblk=10, tail=4)
])
@pytest.mark.parametrize("clamp", [False, True])
def test_plain_matches_pallas_blocked(m, k, n, blk, clamp):
    """The plain loop against JAX's rows-blocked kernel (K3) in interpret
    mode, at the shapes and tolerance of tests/test_pallas_two_loop.py
    (3e-5: both f32, reduced in other orders; K3 takes gamma from an XLA
    prelude, the plain loop from its own dots)."""
    pairs = [(s.astype(np.float32), y.astype(np.float32))
             for s, y in make_pairs(n, k, seed=m + k)]
    v = np.random.default_rng(1).normal(size=n).astype(np.float32)
    r_p = _blocked_reference(jax_ring(m, n, pairs, jnp.float32), v, n, blk, clamp)
    r_t = ttl.two_loop(torch.tensor(v), torch_ring(m, n, pairs, torch.float32), clamp_gamma=clamp)
    np.testing.assert_allclose(r_t.numpy(), r_p, rtol=3e-5, atol=3e-5)


def test_plain_bf16_ring_matches_pallas_blocked():
    """The bf16 ring through JAX's blocked kernel (chunk 10, rounded to 16
    rows) against the plain loop on the same bf16 rows: 5e-5, as
    tests/test_pallas_two_loop.py holds the kernel to the XLA loop."""
    m, n, k = 4, 5000, 6
    pairs = [(s.astype(np.float32), y.astype(np.float32)) for s, y in make_pairs(n, k, seed=21)]
    v = np.random.default_rng(22).normal(size=n).astype(np.float32)
    r_p = _blocked_reference(jax_ring(m, n, pairs, jnp.float32, pair_dtype=jnp.bfloat16), v, n,
                             10, False)
    t = torch_ring(m, n, pairs, torch.float32, pair_dtype=torch.bfloat16)
    np.testing.assert_allclose(ttl.two_loop(torch.tensor(v), t).numpy(), r_p, rtol=5e-5,
                               atol=5e-5)


GROUPS = pytest.mark.parametrize("group", [1, 2, 4, 8])
# CASES and rings whose counts are no multiple of 4 or 8: partial last groups
GROUP_CASES = CASES + [(20, 13, 301), (12, 17, 257)]


@GROUPS
@pytest.mark.parametrize("m,k,n", GROUP_CASES)
@pytest.mark.parametrize("clamp", [False, True])
def test_grouped_matches_jax_f64(group, m, k, n, clamp):
    """The grouped algebra of the streaming kernel is the recursion: in f64
    it equals JAX's loop form on empty, partial, full and wrapped rings at
    odd n to rtol 1e-10 (the group's cross dots reorder the sums)."""
    v, hist, r_j = _jax_f64_case(m, k, n, clamp)
    r_t = ttl.two_loop_grouped(v, hist, group, clamp_gamma=clamp)
    assert r_t.shape == (n,)
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=1e-10, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_f64_case(m, k, n, clamp):
    """The inputs of one GROUP_CASES ring in f64 and JAX's loop form on them
    (shared by the group sizes)."""
    pairs = make_pairs(n, k, seed=m + k)
    v = np.random.default_rng(1).normal(size=n)
    r_j = jtl.two_loop(jnp.asarray(v), jax_ring(m, n, pairs), clamp_gamma=clamp)
    return torch.tensor(v), torch_ring(m, n, pairs), np.asarray(r_j)


@functools.lru_cache(maxsize=None)
def _pallas_streaming_case(pair):
    """One wrapped f32 ring (13 pushes into m=10) at a size where JAX's
    dispatch picks its streaming kernel; the kernel's result in interpret
    mode and the f64 recursion on the same stored rows."""
    n, m = {"bfloat16": 400_000, "float32": 200_000}[pair], 10
    pairs = [(s.astype(np.float32), y.astype(np.float32)) for s, y in make_pairs(n, 13, seed=8)]
    v = np.random.default_rng(9).normal(size=n).astype(np.float32)
    j = jax_ring(m, n, pairs, jnp.float32, pair_dtype=getattr(jnp, pair))
    assert pallas_dispatch(jtl.ring_n_pad(j), m, jnp.float32, j.S.dtype) == ("pallas-streaming", "")
    t = torch_ring(m, n, pairs, torch.float32, pair_dtype=getattr(torch, pair))
    r_p = np.asarray(two_loop_pallas(jnp.asarray(v), j), dtype=np.float64)
    t64 = t._replace(S=t.S.double(), Y=t.Y.double(), rho=t.rho.double())
    r_64 = ttl.two_loop(torch.tensor(v, dtype=torch.float64), t64).numpy()
    return torch.tensor(v), t, r_p, r_64


@GROUPS
@pytest.mark.parametrize("pair", ["float32", "bfloat16"])
def test_grouped_matches_pallas_streaming(group, pair, machine_threads):
    """The grouped algebra in f32 against JAX's streaming kernel (K2's TPU
    counterpart, interpret mode), held as test_plain_matches_pallas_streaming
    holds the plain loop: both to the f64 recursion on the same stored rows,
    the grouped error at most twice the kernel's, and the two within 1e-3 of
    max|r| of each other."""
    v, t, r_p, r_64 = _pallas_streaming_case(pair)
    r_g = ttl.two_loop_grouped(v, t, group).double().numpy()
    err_g, err_p = np.abs(r_g - r_64).max(), np.abs(r_p - r_64).max()
    assert err_g <= 2 * err_p
    assert np.abs(r_g - r_p).max() <= 1e-3 * np.abs(r_p).max()


@functools.lru_cache(maxsize=None)
def _f64_ring(name):
    """(v, ring) in f64: random rings, or the last ring and gradient a
    30-iteration f64 L-BFGS m=20 ("mlp") or m=10 ("mlp-m10") solve of a
    64-64-32-10 MLP hands its two-loop, where the pairs are correlated and
    rho spans two decades (m=20) or more than one (m=10)."""
    if not name.startswith("mlp"):
        m, k, n = {"random": (100, 37, 3001), "random-wrapped": (100, 130, 3001)}[name]
        v = torch.tensor(np.random.default_rng(4).normal(size=n))
        return v, torch_ring(m, n, make_pairs(n, k, seed=k))
    from lbfgs_ffnn_torch.objectives import mlp as tmlp
    from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs

    solver = sys.modules["lbfgs_ffnn_torch.solvers.lbfgs"]
    dims = [64, 64, 32, 10]
    spec = tmlp.mlp_spec(dims, ["relu", "relu", "linear"])
    rng = np.random.default_rng(0)
    w0 = tmlp.params_from_numpy(spec, rng.normal(size=spec.n_params) * 0.5, dtype=torch.float64)
    aux = (torch.tensor(rng.random((64, dims[0]))),
           torch.tensor(np.eye(dims[-1])[rng.integers(0, dims[-1], 64)]))
    seen, plain = [], solver.two_loop

    def capture(v, hist, **kw):
        seen.append((v, hist._replace(S=hist.S.clone(), Y=hist.Y.clone(), rho=hist.rho.clone())))
        return plain(v, hist, **kw)

    m = 10 if name == "mlp-m10" else 20
    solver.two_loop = capture
    try:
        lbfgs(tmlp.mlp_problem(spec), w0, aux,
              LBFGSOptions(max_iters=30, tol=1e-12, m=m, two_loop_impl="plain"))
    finally:
        solver.two_loop = plain
    v, hist = seen[-1]
    spread = 100 if m == 20 else 10  # rho's spread on each ring, max / min
    assert int(hist.count) == m and float(hist.rho.max()) > spread * float(hist.rho.min())
    return v, hist


def _assert_f32_error_within_twice_plain(fn, ring):
    """In f32 ``fn(v, ring)`` is about as accurate as the sequential loop:
    against the f64 recursion on the same f32 ring, its error is at most
    twice the plain f32 loop's, over eight vectors (the ring's own v and
    seven random ones), both as the worst entry's error (relative to that
    vector's max |ref|) and as the RMS of the relative 2-norm errors. Both
    are near f32 rounding, so one vector's max error alone is noisy."""
    v64, h64 = _f64_ring(ring)
    h32 = h64._replace(S=h64.S.float(), Y=h64.Y.float(), rho=h64.rho.float())
    href = h32._replace(S=h32.S.double(), Y=h32.Y.double(), rho=h32.rho.double())
    rng = np.random.default_rng(5)
    vs = [v64.float()] + [torch.tensor(rng.normal(size=v64.shape[0]), dtype=torch.float32)
                          for _ in range(7)]
    sq_g = sq_p = max_g = max_p = 0.0
    for v in vs:
        ref = ttl.two_loop(v.double(), href)
        d_g = fn(v, h32).double() - ref
        d_p = ttl.two_loop(v, h32).double() - ref
        scale, peak = float(ref.norm()), float(ref.abs().max())
        sq_g += (float(d_g.norm()) / scale) ** 2
        sq_p += (float(d_p.norm()) / scale) ** 2
        max_g = max(max_g, float(d_g.abs().max()) / peak)
        max_p = max(max_p, float(d_p.abs().max()) / peak)
    assert 0 < max_p and max_g <= 2 * max_p  # worst entry over the eight vectors
    assert 0 < sq_p and sq_g <= 4 * sq_p  # RMS ratio <= 2


@GROUPS
@pytest.mark.parametrize("ring", ["random", "random-wrapped", "mlp"])
def test_grouped_f32_error_within_twice_plain(group, ring):
    """The grouped algebra at each k, held as
    _assert_f32_error_within_twice_plain says."""
    _assert_f32_error_within_twice_plain(functools.partial(ttl.two_loop_grouped, k=group), ring)


@pytest.mark.parametrize("ring", ["random", "random-wrapped", "mlp", "mlp-m10"])
def test_compact_f32_error_within_twice_plain(ring):
    """The compact form (K1's algebra: every product against v or z0 at
    once) is as accurate in f32 as the sequential loop, on the m=100 random
    rings and the rings of the MLP solves at m = 20 and m = 10."""
    _assert_f32_error_within_twice_plain(ttl.two_loop_compact, ring)


# (m, pairs pushed, n): empty, one pair, partial, full and wrapped, at m = 5
# and 10, odd and aligned n
COMPACT_CASES = [(5, 0, 300), (5, 1, 301), (5, 3, 301), (5, 5, 300), (5, 9, 257),
                 (10, 0, 257), (10, 1, 300), (10, 4, 2048), (10, 10, 301), (10, 13, 3000)]


@pytest.mark.parametrize("m,k,n", COMPACT_CASES)
@pytest.mark.parametrize("clamp", [False, True])
def test_compact_matches_jax_f64(m, k, n, clamp):
    """The port's two_loop_compact is JAX's (same algebra, same logical
    order): f64, rtol 1e-12; it is also the loop form's H v."""
    pairs = make_pairs(n, k, seed=m + k)
    v = np.random.default_rng(1).normal(size=n)
    hist = torch_ring(m, n, pairs)
    r_t = ttl.two_loop_compact(torch.tensor(v), hist, clamp_gamma=clamp)
    r_j = jtl.two_loop_compact(jnp.asarray(v), jax_ring(m, n, pairs), clamp_gamma=clamp)
    assert r_t.shape == (n,)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r_t.numpy(), ttl.two_loop(torch.tensor(v), hist,
                                                         clamp_gamma=clamp).numpy(),
                               rtol=1e-10, atol=1e-12)
    if k == 0:
        assert torch.equal(r_t, torch.tensor(v))


@pytest.mark.parametrize("m,k,n", [(5, 3, 301), (10, 10, 301), (10, 13, 3000)])
@pytest.mark.parametrize("pair", ["float32", "bfloat16"])
def test_compact_matches_jax_f32(m, k, n, pair):
    """f32 solver, f32 or bf16 ring (the same stored rows in both packages,
    upcast before every product): the two compact forms agree to 1e-5 of
    max|r| (f32 sums taken in other orders)."""
    pairs = [(s.astype(np.float32), y.astype(np.float32))
             for s, y in make_pairs(n, k, seed=m + k)]
    v = np.random.default_rng(1).normal(size=n).astype(np.float32)
    t = torch_ring(m, n, pairs, torch.float32, pair_dtype=getattr(torch, pair))
    j = jax_ring(m, n, pairs, jnp.float32, pair_dtype=getattr(jnp, pair))
    r_t = ttl.two_loop_compact(torch.tensor(v), t).numpy()
    r_j = np.asarray(jtl.two_loop_compact(jnp.asarray(v), j))
    assert np.abs(r_t - r_j).max() <= 1e-5 * np.abs(r_j).max()


def test_compact_head_ahead_of_count():
    """count < m with head != count: both packages read the logical order
    (oldest at (head - count) % m) on the device, and agree with the loop."""
    m, n = 10, 301
    pairs = make_pairs(n, 13, seed=3)
    v = np.random.default_rng(2).normal(size=n)
    t = torch_ring(m, n, pairs)._replace(count=torch.tensor(6, dtype=torch.int32))
    j = jax_ring(m, n, pairs)._replace(count=jnp.array(6, dtype=jnp.int32))
    r_t = ttl.two_loop_compact(torch.tensor(v), t)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(jtl.two_loop_compact(jnp.asarray(v), j)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r_t.numpy(), ttl.two_loop(torch.tensor(v), t).numpy(),
                               rtol=1e-10, atol=1e-12)
