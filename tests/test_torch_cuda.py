"""The Hopper two-loop kernel against its plain torch version on the card.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda.py``.
Skips itself where ``torch.cuda.is_available()`` is false."""

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda
from lbfgs_ffnn_torch.ops.two_loop import empty_history_state, ring_push, two_loop


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


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
@pytest.mark.parametrize("m,k,n,clamp", [(10, 0, 1000, False), (10, 4, 101770, False),
                                         (10, 10, 101770, True), (10, 13, 101770, False),
                                         (4, 9, 257, True), (100, 100, 242762, False)])
def test_kernel_matches_plain_on_card(cuda, m, k, n, clamp):
    """Bound: max|kernel - plain| <= 1e-4 * max|plain| (f32, the two reduce
    in different orders); two calls are bitwise equal; one launch each."""
    hist = _ring(m, n, k, cuda)
    v = torch.tensor(np.random.default_rng(1).normal(size=n), dtype=torch.float32, device=cuda)
    before = two_loop_cuda.LAUNCHES
    r_k = two_loop_cuda(v, hist, clamp_gamma=clamp)
    r_k2 = two_loop_cuda(v, hist, clamp_gamma=clamp)
    torch.cuda.synchronize()
    assert two_loop_cuda.LAUNCHES == before + 2
    r_p = two_loop(v, hist, clamp_gamma=clamp)
    assert r_k.shape == (n,) and torch.equal(r_k, r_k2)
    assert float((r_k - r_p).abs().max()) <= 1e-4 * float(r_p.abs().max())


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
