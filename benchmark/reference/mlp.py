"""A dense MLP over one flat parameter vector, in plain PyTorch.

Layout: per layer the weight ``(d_in, d_out)`` row-major, then the bias.
Loss: ``0.5 * ||out - y||^2 / rows``, plus ``0.5 * lam * ||w||^2`` when
``lam`` is set. Gradients and Hessian-vector products come from autograd.
:class:`Objective` is what the reference solvers call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_ACT = {"relu": torch.relu, "linear": lambda z: z, "tanh": torch.tanh,
        "sigmoid": torch.sigmoid}
_INIT_SCALE = {"relu": math.sqrt(2.0), "linear": 1.0, "tanh": 1.0, "sigmoid": 1.0}


class Net(NamedTuple):
    dims: tuple[int, ...]
    acts: tuple[str, ...]

    @property
    def n_params(self) -> int:
        return sum(a * b + b for a, b in zip(self.dims[:-1], self.dims[1:]))

    def leaves(self) -> list[tuple[str, int, int]]:
        """``(name, start, stop)`` of each weight and bias in the flat vector."""
        out, off = [], 0
        for i, (a, b) in enumerate(zip(self.dims[:-1], self.dims[1:]), start=1):
            out.append((f"W{i}", off, off + a * b))
            out.append((f"b{i}", off + a * b, off + a * b + b))
            off += a * b + b
        return out

    def init_std(self) -> list[float]:
        """Each layer's init standard deviation, scale * sqrt(1 / fan_in)."""
        return [_INIT_SCALE[act] * math.sqrt(1.0 / a) for a, act in zip(self.dims, self.acts)]


def net(config: dict) -> Net:
    return Net(tuple(config["dims"]), tuple(config["activations"]))


def forward(nt: Net, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h, off = x, 0
    for a, b, act in zip(nt.dims[:-1], nt.dims[1:], nt.acts):
        h = _ACT[act](h @ w[off:off + a * b].view(a, b) + w[off + a * b:off + a * b + b])
        off += a * b + b
    return h


def loss(nt: Net, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
         lam: float = 0.0) -> torch.Tensor:
    diff = forward(nt, w, x) - y
    f = 0.5 * torch.sum(diff * diff) / x.shape[0]
    if lam:
        f = f + 0.5 * lam * torch.sum(w * w)
    return f


def value_and_grad(nt: Net, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   lam: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.enable_grad():
        wg = w.detach().requires_grad_(True)
        f = loss(nt, wg, x, y, lam)
        (g,) = torch.autograd.grad(f, wg)
    return f.detach(), g


def hvp(nt: Net, w: torch.Tensor, v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
        lam: float = 0.0) -> torch.Tensor:
    """The exact Hessian-vector product H(w) v of the loss on (x, y)."""
    with torch.enable_grad():
        wg = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(nt, wg, x, y, lam), wg, create_graph=True)
        (hv,) = torch.autograd.grad(torch.dot(g, v), wg)
    return hv


class Objective(NamedTuple):
    """One network's loss with its regulariser, as the reference solvers
    call it: ``loss``, ``value_and_grad`` and ``hvp`` over the rows given."""

    net: Net
    lam: float = 0.0

    @property
    def n_params(self) -> int:
        return self.net.n_params

    def leaves(self) -> list[tuple[str, int, int]]:
        return self.net.leaves()

    def loss(self, w, x, y):
        return loss(self.net, w, x, y, self.lam)

    def value_and_grad(self, w, x, y):
        return value_and_grad(self.net, w, x, y, self.lam)

    def hvp(self, w, v, x, y):
        return hvp(self.net, w, v, x, y, self.lam)
