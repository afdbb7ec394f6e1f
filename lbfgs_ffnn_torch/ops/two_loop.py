"""L-BFGS two-loop recursion and curvature-pair ring buffer, plain PyTorch.

Counterpart of :mod:`lbfgs_ffnn_tpu.ops.two_loop`. The history is a pair of
``(m, n_pad)`` row stacks plus ``head``/``count`` ring indices held as int32
tensors on the device, so pushes, resets and the recursion never hand a
value to the host. ``n_pad`` is the parameter count rounded up to a
multiple of 128; the zero padding is inert in every dot and axpy. The rows
may be stored narrower than the solver (``pair_dtype=torch.bfloat16``, half
the ring's bytes): they are cast once, at :func:`ring_push`, and upcast
before every dot and axpy, so rho and the recursion stay in the solver dtype
(the JAX package pads bf16 rows to 2048 for its TPU tiles; here 128 serves
both widths).

:func:`two_loop` is the plain version: the path for CPU tensors and the
oracle for the Hopper kernels in :mod:`lbfgs_ffnn_torch.ops.cuda_two_loop`.
:func:`two_loop_grouped` and :func:`two_loop_compact` are the algebra of the
streaming and the resident kernel in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

ROW_ALIGN = 128  # floats; keeps every row 512-byte aligned for the kernel


def _round_up(x: int, k: int = ROW_ALIGN) -> int:
    return -(-x // k) * k


class RingState(NamedTuple):
    """Fixed-shape curvature history (see ``lbfgs_ffnn_tpu.ops.two_loop``)."""

    S: torch.Tensor      # (m, n_pad), pair dtype
    Y: torch.Tensor      # (m, n_pad), pair dtype
    rho: torch.Tensor    # (m,), solver dtype
    head: torch.Tensor   # int32 scalar: next physical slot to write
    count: torch.Tensor  # int32 scalar: number of valid pairs (<= m)


def empty_history_state(m: int, n: int, dtype=torch.float32, pair_dtype=None,
                        device=None) -> RingState:
    """An empty ring of capacity ``m`` for ``n`` parameters on ``device``,
    its (S, Y) rows stored in ``pair_dtype`` (defaults to ``dtype``)."""
    pd = pair_dtype if pair_dtype is not None else dtype
    n_pad = _round_up(n)
    return RingState(
        S=torch.zeros((m, n_pad), dtype=pd, device=device),
        Y=torch.zeros((m, n_pad), dtype=pd, device=device),
        rho=torch.zeros((m,), dtype=dtype, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _pad_to(v: torch.Tensor, n_pad: int) -> torch.Tensor:
    return F.pad(v, (0, n_pad - v.shape[0])) if v.shape[0] != n_pad else v


def ring_push(hist: RingState, s: torch.Tensor, y: torch.Tensor, rho, accept) -> RingState:
    """Conditionally push a curvature pair (overwrite-oldest ring semantics).

    Updates ``hist.S``, ``hist.Y`` and ``hist.rho`` IN PLACE and returns a
    state with new ``head``/``count``. The head row is always rewritten,
    with either the new pair or its own old contents, selected on the device
    by ``accept`` (a bool tensor), so the decision never reaches the host.
    When ``accept`` is false the state is unchanged. The rows are cast to
    the ring's pair dtype here, after padding, as in the JAX package.
    """
    m, n_pad = hist.S.shape
    idx = hist.head.long().view(1)
    accept = torch.as_tensor(accept, device=hist.S.device)
    rho = torch.as_tensor(rho, dtype=hist.rho.dtype, device=hist.rho.device)
    for buf, row in ((hist.S, s), (hist.Y, y)):
        old = buf.index_select(0, idx)
        new = _pad_to(row, n_pad).to(buf.dtype).view(1, n_pad)
        buf.index_copy_(0, idx, torch.where(accept, new, old))
    hist.rho.index_copy_(0, idx, torch.where(accept, rho, hist.rho.index_select(0, idx)))
    head = torch.where(accept, (hist.head + 1) % m, hist.head)
    count = torch.where(accept, torch.clamp(hist.count + 1, max=m), hist.count)
    return RingState(S=hist.S, Y=hist.Y, rho=hist.rho, head=head, count=count)


def ring_reset(hist: RingState, do_reset) -> RingState:
    """Conditionally drop all pairs (``do_reset`` a bool tensor)."""
    zero = torch.zeros_like(hist.head)
    return hist._replace(head=torch.where(do_reset, zero, hist.head),
                         count=torch.where(do_reset, zero, hist.count))


def two_loop(
    v: torch.Tensor,
    hist: RingState,
    *,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> torch.Tensor:
    """Compute ``r = H_k @ v`` via the two-loop recursion (not negated).

    With empty history returns ``v`` (identity initial Hessian). The initial
    scaling is ``gamma = (s^T y)/(y^T y)`` of the newest pair (1 when
    ``y^T y <= 0``); with ``clamp_gamma``, gamma -> 1 when ``|y^T y| < 1e-12``
    and is clipped to ``[gamma_min, gamma_max]``.

    The rows are gathered once newest-first; both passes then run over all
    ``m`` slots with static indices, slots past ``count`` contributing a zero
    coefficient (on a row of the oldest valid pair, as in the JAX loop
    form), so no ring index is read on the host. Narrow rows are upcast to
    ``v``'s dtype when gathered, before any dot or axpy.
    """
    S, Y, rho, head, count = hist
    m, n_pad = S.shape
    n = v.shape[0]
    c = count.long()
    j = torch.arange(m, device=S.device)
    valid = j < c
    # physical slot of the j-th newest pair; invalid j repeat the oldest one
    phys = (head.long() - 1 - torch.minimum(j, torch.clamp(c - 1, min=0))) % m
    Sb = S.index_select(0, phys).to(v.dtype)
    Yb = Y.index_select(0, phys).to(v.dtype)
    rb = rho.index_select(0, phys)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)

    # Backward pass: newest -> oldest.
    q = _pad_to(v, n_pad)
    alphas = []
    for k in range(m):
        a = torch.where(valid[k], rb[k] * torch.dot(Sb[k], q), zero)
        q = q - a * Yb[k]
        alphas.append(a)

    gamma = _gamma(torch.dot(Sb[0], Yb[0]), torch.dot(Yb[0], Yb[0]), clamp_gamma, gamma_min,
                   gamma_max)
    gamma = torch.where(c > 0, gamma, torch.ones_like(gamma))

    # Forward pass: oldest -> newest.
    z = gamma * q
    for k in reversed(range(m)):
        b = rb[k] * torch.dot(Yb[k], z)
        z = z + torch.where(valid[k], alphas[k] - b, zero) * Sb[k]
    return z[:n]


def two_loop_grouped(
    v: torch.Tensor,
    hist: RingState,
    k: int,
    *,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> torch.Tensor:
    """:func:`two_loop` with the pairs taken ``k`` at a time: the algebra of
    the grouped streaming kernel (``cuda-streaming``), in plain PyTorch.

    Each pass runs in groups of ``k`` consecutive stages, the last group of a
    pass holding what is left. Within a group every coefficient comes from
    dots against the vector at the group's start (``q0``, ``z0``) and the
    group's cross dots, newest first backward and oldest first forward:

        alpha_j = rho_j (s_j.q0 - sum_{l<j} alpha_l s_j.y_l);  q = q0 - sum alpha_j y_j
        beta_j  = rho_j (y_j.z0 + sum_{l<j} (alpha_l - beta_l) y_j.s_l);
        z = z0 + sum (alpha_j - beta_j) s_j

    which equals the sequential recursion in exact arithmetic. A test
    oracle: it reads ``count`` and ``head`` on the host, which the solver's
    path never does. ``k = 1`` is the sequential recursion.
    """
    if k < 1:
        raise ValueError(f"group size k={k} must be at least 1")
    S, Y, rho, head, count = hist
    m, n_pad = S.shape
    n = v.shape[0]
    c = min(int(count), m)
    q = _pad_to(v, n_pad)
    if c == 0:
        return q[:n].clone()
    phys = (int(head) - 1 - torch.arange(c, device=S.device)) % m  # j-th newest
    Sb = S.index_select(0, phys).to(v.dtype)
    Yb = Y.index_select(0, phys).to(v.dtype)
    rb = rho.index_select(0, phys)

    gamma = _gamma(torch.dot(Sb[0], Yb[0]), torch.dot(Yb[0], Yb[0]), clamp_gamma, gamma_min,
                   gamma_max)

    alphas = [None] * c
    for g0 in range(0, c, k):  # backward, newest first
        grp = range(g0, min(g0 + k, c))
        dots = [torch.dot(Sb[j], q) for j in grp]
        for a, j in enumerate(grp):
            acc = dots[a]
            for b in range(a):
                acc = acc - alphas[grp[b]] * torch.dot(Sb[j], Yb[grp[b]])
            alphas[j] = rb[j] * acc
        for j in grp:
            q = q - alphas[j] * Yb[j]

    z = q * gamma
    oldest_first = range(c - 1, -1, -1)
    for u0 in range(0, c, k):  # forward, oldest first
        grp = oldest_first[u0:u0 + k]
        dots = [torch.dot(Yb[j], z) for j in grp]
        coefs = []
        for a, j in enumerate(grp):
            acc = dots[a]
            for b in range(a):
                acc = acc + coefs[b] * torch.dot(Yb[j], Sb[grp[b]])
            coefs.append(alphas[j] - rb[j] * acc)
        for coef, j in zip(coefs, grp):
            z = z + coef * Sb[j]
    return z[:n]


def _gamma(ys, yy, clamp_gamma: bool, gamma_min: float, gamma_max: float):
    """The initial scaling from the newest pair's s.y and y.y."""
    one = torch.ones_like(ys)
    safe_yy = torch.where(yy == 0, one, yy)
    if clamp_gamma:
        gamma = torch.where(torch.abs(yy) < 1e-12, one, ys / safe_yy)
        return torch.clamp(gamma, gamma_min, gamma_max)
    return torch.where(yy > 0, ys / safe_yy, one)


def two_loop_compact(
    v: torch.Tensor,
    hist: RingState,
    *,
    clamp_gamma: bool = False,
    gamma_min: float = 1e-6,
    gamma_max: float = 1e6,
) -> torch.Tensor:
    """:func:`two_loop` in the compact form: the JAX package's
    ``two_loop_compact`` with its scalar core ``_compact_recurrences``, and
    the algebra of the resident kernel (``cuda-cooperative``).

    In logical order l (oldest first; physical slot ``(head - count + l) %
    m``) the recursion collapses to products over the whole ring and two
    scalar recurrences of length m:

        c_l = s_l.v ;  M_lj = s_l.y_j
        a_l = rho_l (c_l - sum_{j>l} M_lj a_j)            (newest first)
        z0  = gamma (v - sum_l a_l y_l) ;  d_l = y_l.z0
        b_l = rho_l (d_l + sum_{j<l} M_jl (a_j - b_j))    (oldest first)
        r   = z0 + sum_l (a_l - b_l) s_l

    gamma takes the newest pair's s.y from ``M`` and its y.y from one more
    dot, by :func:`two_loop`'s rules. Slots past ``count`` carry zero
    coefficients, so nothing is read on the host; ``count = 0`` returns
    ``v``. Narrow rows are upcast to ``v``'s dtype before any product.
    """
    S, Y, rho, head, count = hist
    m, n_pad = S.shape
    n = v.shape[0]
    c = count.long()
    li = torch.arange(m, device=S.device)
    phys = (head.long() - c + li) % m
    valid = li < c
    Sl = S.index_select(0, phys).to(v.dtype)
    Yl = Y.index_select(0, phys).to(v.dtype)
    rhol = torch.where(valid, rho.index_select(0, phys), torch.zeros_like(rho))
    v1 = _pad_to(v, n_pad)
    # The n-long dots as sums of products, summed as torch.dot sums (on the
    # CPU a GEMM accumulates f32 along the row: 2.02x the loop's error on an
    # m=10 MLP ring, against 1.2x this way).
    cv = (Sl * v1).sum(dim=1)
    M = torch.stack([(Yl * Sl[l]).sum(dim=1) for l in range(m)])  # M[l, j] = s_l . y_j

    last = torch.clamp(c - 1, min=0)
    y_last = Yl.index_select(0, last.view(1))[0]
    # M's diagonal read by index_select: M[last, last] with a tensor index
    # reads it on the host, which a captured solve refuses
    sy_last = M.diagonal().index_select(0, last.view(1))[0]
    gamma = _gamma(sy_last, torch.dot(y_last, y_last), clamp_gamma, gamma_min, gamma_max)
    gamma = torch.where(c > 0, gamma, torch.ones_like(gamma))

    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    a = torch.zeros(m, dtype=v.dtype, device=v.device)
    for l in reversed(range(m)):  # backward, newest first
        acc = torch.sum(torch.where((li > l) & valid, M[l] * a, zero))
        a = torch.where(li == l, torch.where(valid[l], rhol[l] * (cv[l] - acc), zero), a)
    z0 = gamma * (v1 - a @ Yl)
    d = (Yl * z0).sum(dim=1)
    b = torch.zeros(m, dtype=v.dtype, device=v.device)
    for l in range(m):  # forward, oldest first
        acc = torch.sum(torch.where((li < l) & valid, M[:, l] * (a - b), zero))
        b = torch.where(li == l, torch.where(valid[l], rhol[l] * (d[l] + acc), zero), b)
    return (z0 + (a - b) @ Sl)[:n]
