"""The port's curvature ring and two-loop recursion: ring mechanics, the plain
torch recursion against the JAX loop form (f64) and the Pallas kernels
(f32, interpret mode: the streaming and the rows-blocked one) and a dense
inverse-Hessian oracle; the Hopper dispatch's picks and reasons. The Hopper
kernel's own test, which needs the card, is tests/test_torch_cuda.py."""

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
    BLOCKED, COOPERATIVE, STREAMING, kernel_dispatch, launch, two_loop_cuda,
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
    (2_000_000, 50, torch.bfloat16, STREAMING),  # K2's slices of q + 2 bf16 pairs still fit
    (4_000_000, 50, torch.float32, BLOCKED),    # scripts/diag_two_loop_large.py, n = 4M
    (4_000_000, 50, torch.bfloat16, BLOCKED),
    (7_434_240, 50, torch.float32, BLOCKED),    # K3's capacity: q alone fills the grid
])
def test_kernel_dispatch_picks(n_pad, m, pair_dtype, want):
    """The port's size policy at the shapes its paths give it: bf16 pairs
    are taken, the resident kernel only where all m pairs fit, the blocked
    one where not even two staged pairs fit beside q."""
    assert kernel_dispatch(n_pad, m, torch.float32, pair_dtype) == (want, "")


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


@pytest.mark.parametrize("n,pair", [(400_000, "bfloat16"), (200_000, "float32")])
def test_plain_matches_pallas_streaming(n, pair):
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
