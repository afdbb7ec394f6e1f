"""The port's curvature ring and two-loop recursion: ring mechanics, the plain
torch recursion against the JAX loop form (f64) and the Pallas kernel
(f32, interpret mode) and a dense inverse-Hessian oracle. The Hopper
kernel's own test, which needs the card, is tests/test_torch_cuda.py."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgs_ffnn_tpu.ops.two_loop
import lbfgs_ffnn_torch.ops.two_loop
from lbfgs_ffnn_tpu.ops.pallas_two_loop import two_loop_pallas
from lbfgs_ffnn_torch.ops.cuda_two_loop import kernel_dispatch, two_loop_cuda

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


def torch_ring(m, n, pairs, dtype=torch.float64, device=None):
    hist = ttl.empty_history_state(m, n, dtype, device=device)
    for s, y in pairs:
        s_t = torch.tensor(s, dtype=dtype, device=device)
        y_t = torch.tensor(y, dtype=dtype, device=device)
        hist = ttl.ring_push(hist, s_t, y_t, 1.0 / torch.dot(y_t, s_t),
                             torch.tensor(True, device=device))
    return hist


def jax_ring(m, n, pairs, dtype=jnp.float64):
    hist = jtl.empty_history_state(m, n, dtype)
    for s, y in pairs:
        s_j, y_j = jnp.asarray(s, dtype=dtype), jnp.asarray(y, dtype=dtype)
        hist = jtl.ring_push(hist, s_j, y_j, 1.0 / jnp.vdot(y_j, s_j), jnp.array(True))
    return hist


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
    for args in ((102400, 10, torch.float64), (102400, 10, torch.float32, torch.bfloat16),
                 (8 * 1024 * 1024, 10, torch.float32), (1024, 0, torch.float32)):
        impl, reason = kernel_dispatch(*args)
        assert impl == "unsupported" and reason


def test_cuda_wrapper_on_cpu_is_plain():
    """A CPU tensor takes the plain version and launches nothing."""
    n, m = 300, 5
    hist = torch_ring(m, n, make_pairs(n, 3), torch.float32)
    v = torch.tensor(np.random.default_rng(3).normal(size=n), dtype=torch.float32)
    before = two_loop_cuda.LAUNCHES
    assert torch.equal(two_loop_cuda(v, hist), ttl.two_loop(v, hist))
    assert two_loop_cuda.LAUNCHES == before
