"""Inputs and initial weights, made on the device from the run's seed.

The images are MNIST-shaped stand-ins (no image files are in the
repository): each class has a smooth prototype, a sum of 8 x 8 cosine
modes with normal weights scaled to [0, 1]; a sample is its class's
prototype plus N(0, noise) per pixel, clipped to [0, 1] and put on the
k/255 grid of 8-bit pixels. Labels are uniform over the classes; targets
are one-hot. Weights are N(0, std) with std = scale * sqrt(1 / fan_in)
(scale sqrt(2) before a ReLU), biases drawn alike. Everything comes from
``torch.Generator``s on the device, in a few large calls, so one seed gives
the same tensors in every run on the same card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import mlp


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one purpose, from the run's seed and a path of
    small integers (``SeedSequence`` takes seeds of any size)."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *path]).generate_state(2)
    return int((int(state[0]) << 32 | int(state[1])) & (2 ** 63 - 1))


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def images(n: int, side: int, classes: int, noise: float, seed: int,
           device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x, y)``: ``(n, side * side)`` float32 pixels and ``(n, classes)``
    one-hot float32 targets."""
    g = _gen(device, seed)
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    modes = torch.randn(classes, 64, generator=g, device=device, dtype=torch.float64)
    grid = torch.linspace(0.0, 1.0, side, device=device, dtype=torch.float64)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    ij = torch.arange(8, device=device, dtype=torch.float64)
    basis = torch.cos(math.pi * (ij.view(8, 1, 1, 1) * yy + ij.view(1, 8, 1, 1) * xx))
    protos = modes @ basis.reshape(64, side * side)
    lo, hi = protos.min(1, keepdim=True).values, protos.max(1, keepdim=True).values
    protos = ((protos - lo) / (hi - lo + 1e-12)).to(torch.float32)
    x = protos[labels] + noise * torch.randn(n, side * side, generator=g, device=device)
    x = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0
    y = torch.nn.functional.one_hot(labels, classes).to(torch.float32)
    return x, y


def weights(nt: mlp.Net, seed: int, device) -> torch.Tensor:
    """The flat initial parameter vector, one normal draw scaled per layer."""
    sizes = [a * b + b for a, b in zip(nt.dims[:-1], nt.dims[1:])]
    std = torch.repeat_interleave(torch.tensor(nt.init_std(), device=device),
                                  torch.tensor(sizes, device=device))
    return torch.randn(nt.n_params, generator=_gen(device, seed), device=device) * std


def inputs(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The configuration's training set for this seed."""
    d = config["data"]
    return images(config["n_train"], d["side"], d["classes"], d["noise"],
                  sub_seed(seed, 0), device)
