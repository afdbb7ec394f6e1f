"""A frozen copy of the program's minibatch draw.

A draw is a function of the integers ``(seed, epoch, step, purpose)``: each
is folded into a 32-bit key by an invertible mix (``x ^= x >> 16; x *= C1;
x ^= x >> 15; x *= C2; x ^= x >> 16``, products modulo 2^32); index ``i``
of ``n`` gets the key ``h_i * 2^bits + i`` and a draw of ``size`` takes the
``size`` largest keys, largest first. The S-LBFGS epoch draws its step
batches on ``(epoch, t, 0)``, the HVP batch of the pair made after step t
on ``(epoch, t, 1)`` and the anchor pick on ``(epoch, 2^20)``.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x7FEB352D, 0x5BD1E995
ANCHOR_PURPOSE = 2 ** 20


def _mix(x):
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def key(seed: int, *path: int) -> int:
    h = _mix(seed & _M32)
    for p in path:
        h = _mix(h ^ p)
    return h


def draw(k: int, n: int, size: int, device=None) -> torch.Tensor:
    """``size`` distinct indices of ``range(n)`` for the key ``k``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    h = _mix(_mix(i ^ k) ^ _mix(k ^ 0x9E3779B9))
    keys = (h << max((n - 1).bit_length(), 1)) | i
    return torch.argsort(keys, descending=True)[:size]


def step_batch(seed: int, epoch: int, t: int, n: int, b: int, device=None) -> torch.Tensor:
    return draw(key(seed, epoch, t, 0), n, b, device)


def hvp_batch(seed: int, epoch: int, t: int, n: int, b_h: int, device=None) -> torch.Tensor:
    return draw(key(seed, epoch, t, 1), n, b_h, device)


def anchor_pick(seed: int, epoch: int, count: int) -> int:
    """The index, oldest first, of the recent iterate that becomes the
    next anchor: in ``[0, max(count - 1, 1))``, the newest excluded."""
    return key(seed, epoch, ANCHOR_PURPOSE) % max(count - 1, 1)
