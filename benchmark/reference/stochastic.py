"""The stochastic solvers' epochs, plainly.

S-LBFGS (Moritz et al. 2016; the reference CPU flagship, SignorB/lbfgs-FFNN
``src/minimizer/s_lbfgs.hpp:166-290``): at the epoch's anchor w the full
gradient mu; then ``m_inner`` steps, each on a batch drawn without
replacement, ``v = g_B(w_t) - g_B(w) + mu``, ``w_t -= step * H v`` (the
two-loop with the clamped gamma), ``w_t`` pushed into a ring of the last
``L + 1`` iterates (the anchor first); after steps L, 2L, ..., nb L (nb =
(m_inner - 1) // L) the average u of that ring, ``s = u - u_prev``, ``y =
H(u) s`` on a batch of ``b_H``, the pair kept when ``|y.s|`` passes the gate
and an earlier average exists; at the end the anchor moves to a recent
iterate drawn from the ring, the newest excluded, and the full loss is
recorded there.

SGD with sequential batches (the reference CUDA SGD, ``src/cuda/sgd.cuh``):
the ``N // b`` contiguous batches, then the ragged tail once; the step-wise
decay ``lr *= decay`` before epoch e when ``e > 0`` and ``e % every == 0``;
the full loss recorded after each epoch.

Both take the loss as an objective (``loss``, ``value_and_grad``,
``hvp``, its regulariser inside), as
:class:`benchmark.reference.mlp.Objective`.
"""

from __future__ import annotations

import torch

from benchmark.reference import sampling
from benchmark.reference.lbfgs import two_loop


def slbfgs_epochs(obj, w0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  solve: dict, seed: int, k: int) -> dict:
    """``k`` epochs from ``w0``: ``{"losses": [f_1..f_k], "iterates":
    [w_1..w_k], "g0": the first anchor's full gradient}``."""
    n = x.shape[0]
    b, L, M = solve["batch_size"], solve["L"], solve["history"]
    b_h, step, eps = solve["hvp_batch_size"], solve["step_size"], solve["curvature_eps"]
    m_inner = n // b
    nb = (m_inner - 1) // L
    pair_steps = {L * j for j in range(1, nb + 1)}
    w, pairs, u_prev = w0.clone(), [], None
    losses, iterates, g0 = [], [], None
    for epoch in range(k):
        _, mu = obj.value_and_grad(w, x, y)
        g0 = mu.clone() if g0 is None else g0
        ring, wt = [w], w
        for t in range(m_inner):
            idx = sampling.step_batch(seed, epoch, t, n, b, x.device)
            xb, yb = x[idx], y[idx]
            v = obj.value_and_grad(wt, xb, yb)[1] - obj.value_and_grad(w, xb, yb)[1] + mu
            wt = wt - step * two_loop(v, pairs, clamp_gamma=True)
            ring = (ring + [wt])[-(L + 1):]
            if t in pair_steps:
                u = torch.stack(ring).sum(0) / len(ring)
                if u_prev is not None:
                    s = u - u_prev
                    hidx = sampling.hvp_batch(seed, epoch, t, n, b_h, x.device)
                    yv = obj.hvp(u, s, x[hidx], y[hidx])
                    ys = torch.dot(yv, s)
                    if abs(float(ys)) > eps:
                        pairs = (pairs + [(s, yv, 1.0 / ys)])[-M:]
                u_prev = u
        w = ring[sampling.anchor_pick(seed, epoch, len(ring))] if len(ring) >= 2 else wt
        losses.append(float(obj.loss(w, x, y)))
        iterates.append(w.clone())
    return {"losses": losses, "iterates": iterates, "g0": g0}


def sgd_epochs(obj, w0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               solve: dict, seed: int, k: int) -> dict:
    """``k`` epochs of sequential SGD from ``w0`` (``seed`` unused: the
    batches are contiguous); the same record as :func:`slbfgs_epochs`, with
    the first batch's gradient as ``g0``."""
    if solve.get("sampling") != "sequential" or solve.get("momentum", 0.0):
        raise ValueError("the reference SGD is sequential and without momentum")
    n, b = x.shape[0], solve["batch_size"]
    m = n // b
    lr, decay, every = solve["step_size"], solve["lr_decay"], solve["lr_decay_step"]
    w, losses, iterates, g0 = w0.clone(), [], [], None
    for epoch in range(k):
        if every > 0 and epoch > 0 and epoch % every == 0:
            lr = lr * decay
        bounds = [(t * b, (t + 1) * b) for t in range(m)] + ([(m * b, n)] if n > m * b else [])
        for lo, hi in bounds:
            g = obj.value_and_grad(w, x[lo:hi], y[lo:hi])[1]
            g0 = g.clone() if g0 is None else g0
            w = w - lr * g
        losses.append(float(obj.loss(w, x, y)))
        iterates.append(w.clone())
    return {"losses": losses, "iterates": iterates, "g0": g0}
