"""Minibatch index sampling without replacement, drawn on the device.

Counterpart of :mod:`lbfgs_ffnn_tpu.ops.sampling`. The JAX package keys its
draws with ``jax.random.fold_in`` chains; here a draw is a function of the
integers ``(seed, epoch, step, purpose)``, hashed by :func:`stream_key`, so
that the epoch can be a device tensor: a CUDA graph captured once draws new
batches on every replay, and a chunked or resumed run draws exactly what a
whole run draws. No ``torch.Generator`` is involved (a generator under
capture advances its offset on every replay, so a captured run and an eager
one would draw different indices).

The generator is counter-based: every value is a 32-bit integer held in an
int64 tensor, mixed by a finalizer of the ``lowbias32`` form (xor-shifts
and two multiplications by odd constants modulo 2^32, an invertible map).
Both multipliers are below 2^31, so no product of a 32-bit value reaches
2^63 and the CPU and the card compute the same bits without signed
overflow; a mix is ten elementwise kernels. The stream is the port's own
and differs from ``jax.random``'s; tests that hold the port to the JAX
package pass JAX's indices in instead (``sampler=`` of
:func:`lbfgs_ffnn_torch.solvers.slbfgs.slbfgs`).

A draw gives every index ``i < n`` the key ``h_i * 2^bits + i`` (``h_i`` a
32-bit hash of the stream key and ``i``, ``bits`` enough for ``n - 1``) and
takes the ``size`` largest. The index in the low bits makes the keys
distinct by construction, so ties cannot order differently on the CPU and
the card. (For one stream key, ``h_i`` is an invertible function of ``i``,
so no two indices share a hash either: the collision bias JAX's ``"topk"``
documents, n^2/2^33 colliding pairs broken by index, does not arise.)
``"topk"`` takes them with ``torch.topk``, ``"sort"`` with a full argsort:
the keys being distinct, both give the same indices in the same order.

The seed may be a device tensor as well as an int: the solvers keep it in
their device state, so that a captured epoch takes its seed at run time and
one capture serves every seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_M32 = 0xFFFFFFFF
ANCHOR_PURPOSE = 2 ** 20  # the anchor pick's stream (JAX: fold_in(k_epoch, 2**20))


_C1, _C2 = 0x7FEB352D, 0x5BD1E995  # lowbias32's first multiplier, MurmurHash2's


def _mix(x):
    """An invertible map of [0, 2^32) onto itself (an int, or an int64
    tensor of such values): x ^= x >> 16; x *= C1; x ^= x >> 15;
    x *= C2; x ^= x >> 16, the products taken modulo 2^32."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def stream_key(seed, *path) -> torch.Tensor | int:
    """The key of one draw: ``seed`` (an int, or an int64 tensor) hashed
    with each element of ``path`` in turn (Python ints or int tensors, each
    in [0, 2^31)), the counterpart
    of ``fold_in(...fold_in(PRNGKey(seed), path[0])..., path[-1])``."""
    h = _mix(seed & _M32)
    for p in path:
        if isinstance(p, torch.Tensor):
            p = p.long()
        h = _mix(h ^ p)
    return h


def device_seed(seed: int, device) -> torch.Tensor:
    """``seed`` as the int64 device scalar the solvers' states hold."""
    return torch.full((), seed, dtype=torch.int64, device=device)


def sample_without_replacement(key: torch.Tensor, n: int, size: int,
                               impl: str = "topk") -> torch.Tensor:
    """``size`` distinct indices from ``range(n)`` (int64, on ``key``'s
    device), uniformly, as a function of the int64 ``key`` (from
    :func:`stream_key`). A key of shape ``(k,)`` draws ``k`` batches at once,
    ``(k, size)``, row r the draw of ``key[r]`` alone. See the module
    docstring for the two impls."""
    if impl not in ("topk", "sort"):
        raise ValueError(f"unknown sampler impl {impl!r}")
    if not 0 < size <= n < 2 ** 31:
        raise ValueError(f"need 0 < size <= n < 2^31, got size={size}, n={n}")
    key = torch.as_tensor(key, dtype=torch.int64).unsqueeze(-1)  # () -> (1,), (k,) -> (k, 1)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    h = _mix(_mix(i ^ key) ^ _mix(key ^ 0x9E3779B9))
    keys = (h << max((n - 1).bit_length(), 1)) | i
    if impl == "topk":
        return torch.topk(keys, size, dim=-1).indices
    return torch.argsort(keys, dim=-1, descending=True)[..., :size]


class EpochSampler(NamedTuple):
    """The index draws of one S-LBFGS epoch, from the device epoch tensor:
    the port's default sampler (the protocol ``sampler=`` takes).

    ``batches(epoch, t, count)`` are the ``(count, b)`` gradient batches of
    inner steps t, ..., t + count - 1, ``hvp_batch(epoch, t)`` the ``(b_h,)``
    HVP batch of the curvature pair made after step t, and
    ``anchor(epoch, count)`` the index j in ``[0, max(count - 1, 1))`` of the
    recent iterate that becomes the next anchor (the newest excluded);
    ``epoch`` and ``count`` are device tensors, ``t`` a Python int or a
    device tensor. The streams are JAX's key paths: ``(epoch, t, 0)``,
    ``(epoch, t, 1)`` and ``(epoch, 2**20)``; a step's batch is the same
    whichever call draws it."""

    seed: int | torch.Tensor
    n: int
    b: int
    b_h: int
    impl: str = "topk"

    def batches(self, epoch: torch.Tensor, t, count: int) -> torch.Tensor:
        ts = t + torch.arange(count, device=epoch.device)
        return sample_without_replacement(stream_key(self.seed, epoch, ts, 0), self.n, self.b,
                                          self.impl)

    def hvp_batch(self, epoch: torch.Tensor, t) -> torch.Tensor:
        return sample_without_replacement(stream_key(self.seed, epoch, t, 1), self.n, self.b_h,
                                          self.impl)

    def anchor(self, epoch: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        h = stream_key(self.seed, epoch, ANCHOR_PURPOSE)
        return h % torch.clamp(count.long() - 1, min=1)


class SGDSampler(NamedTuple):
    """The gradient batches of one random-sampling SGD epoch of ``m`` steps,
    from the device epoch tensor: ``batches(epoch, t, count)`` are the
    ``(count, b)`` batches of steps t, ..., t + count - 1 (``t`` a Python
    int or a device tensor), step t's drawn from the stream ``(seed, epoch
    * m + t)``, JAX's ``fold_in(PRNGKey(seed), epoch * m + t)``. The
    protocol of :class:`EpochSampler`'s ``batches``, which ``sampler=`` of
    :func:`lbfgs_ffnn_torch.solvers.sgd.sgd` takes."""

    seed: int | torch.Tensor
    n: int
    b: int
    m: int
    impl: str = "topk"

    def batches(self, epoch: torch.Tensor, t, count: int) -> torch.Tensor:
        ts = t + torch.arange(count, device=epoch.device)
        return sample_without_replacement(stream_key(self.seed, epoch.long() * self.m + ts),
                                          self.n, self.b, self.impl)
