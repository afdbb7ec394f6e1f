"""Out-of-core evaluation: a data set that stays in host memory.

Counterpart of :mod:`lbfgs_ffnn_tpu.data.outofcore`. The in-memory solvers
take ``x``/``y`` whole on the device, the fastest path whenever the data
fit; this module is the escape hatch for data that do not. The data set
lives on the host in a :class:`ChunkStore`, and the device holds one chunk
at a time (a full-gradient sweep) or one minibatch (a stochastic step).

Where JAX fetches a chunk with ``io_callback`` (a host round trip inside one
XLA program), the port's solves are captured CUDA graphs, which allow no
host sync. So on CUDA the store keeps x and y zero-padded to ``num_chunks *
chunk_rows`` rows in page-locked host memory, made once; a chunk fetch is an
asynchronous host-to-device copy into one fixed device buffer on the
current stream (a memcpy node when captured), and a sweep's chunks are
unrolled into the graph. Minibatch rows are gathered by the card itself
from the pinned store (:func:`~lbfgs_ffnn_torch.ops.cuda_gather.gather_rows`,
indices on the device). On the CPU a fetch is a slice of the store and a
gather is ``index_select``.

Two adapters:

* :func:`outofcore_problem` - a full-batch :class:`Problem` whose ``fun``,
  ``grad`` and ``value_and_grad`` sum over the chunks; any full-gradient
  solver takes it unchanged.
* :func:`outofcore_mlp_problem` - the MLP with its carried line prefix on
  the device: two chunk sweeps an iteration, every line-search trial an
  on-device combine.

Trajectories match the in-memory run up to summation-order rounding (the
chunks' partial sums against one flat mean). Autodiff never crosses a
fetch: every differentiated function takes the fetched chunk as an input.
``Problem.hvp`` is not supported by these adapters (use
``curvature_pairs="grad_diff"``).
"""

from __future__ import annotations

import numpy as np
import torch

from lbfgs_ffnn_torch.types import BatchProblem, LinePrefix, Problem, zero_masked_rows


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(a))


class ChunkStore:
    """A host-resident ``(x, y)`` data set served to the device in pieces of
    ``chunk_rows`` rows; the trailing ragged chunk is zero-padded and masked.

    ``x``, ``y``: numpy arrays or CPU tensors with the same number of rows.
    ``device`` is where chunks and batches land ("cuda" by default, as every
    entry point of the port; the tests pass "cpu"). On CUDA the padded rows
    are held in page-locked memory and a chunk is copied into one fixed
    device buffer, valid until the next :meth:`fetch_chunk`. ``x`` and
    ``y`` (attributes) are the store's first ``n`` rows. Reuse ONE store
    across solves: the adapters built from it key the captured graphs by
    identity."""

    def __init__(self, x, y, chunk_rows: int, device="cuda"):
        x, y = _host_tensor(x), _host_tensor(y)
        if len(x) != len(y):
            raise ValueError(f"x/y length mismatch: {len(x)} vs {len(y)}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.n = int(len(x))
        self.chunk_rows = int(min(chunk_rows, self.n))
        self.num_chunks = -(-self.n // self.chunk_rows)  # ceil
        pin = self.device.type == "cuda"
        n_pad = self.num_chunks * self.chunk_rows
        self._x_pad = torch.zeros((n_pad,) + tuple(x.shape[1:]), dtype=x.dtype, pin_memory=pin)
        self._y_pad = torch.zeros((n_pad,) + tuple(y.shape[1:]), dtype=y.dtype, pin_memory=pin)
        self._x_pad[:self.n] = x
        self._y_pad[:self.n] = y
        self.x, self.y = self._x_pad[:self.n], self._y_pad[:self.n]
        self._mask = (torch.arange(n_pad) < self.n).to(x.dtype).to(self.device)
        if pin:
            from lbfgs_ffnn_torch.ops.cuda_gather import mapped_pointer

            rows = self.chunk_rows
            self._xb = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=self.device)
            self._yb = torch.empty((rows,) + tuple(y.shape[1:]), dtype=y.dtype, device=self.device)
            for t in (self.x, self.y):
                mapped_pointer(t)  # looked up now, never under capture

    def fetch_chunk(self, c: int):
        """``(xb, yb, mask)`` for chunk ``c`` (a Python int), zero-padded, on
        the store's device."""
        lo, hi = c * self.chunk_rows, (c + 1) * self.chunk_rows
        mask = self._mask[lo:hi]
        if self.device.type != "cuda":
            return self._x_pad[lo:hi], self._y_pad[lo:hi], mask
        self._xb.copy_(self._x_pad[lo:hi], non_blocking=True)
        self._yb.copy_(self._y_pad[lo:hi], non_blocking=True)
        return self._xb, self._yb, mask

    def fetch_rows(self, idx: torch.Tensor):
        """``(x[idx], y[idx])`` on the store's device for an index tensor
        there: the out-of-core counterpart of the in-memory ``take_batch``.
        On CUDA the card gathers the rows from the pinned store itself."""
        if idx.device != self.device:
            raise ValueError(f"indices on {idx.device}, the store serves {self.device}")
        if self.device.type != "cuda":
            return self.x.index_select(0, idx), self.y.index_select(0, idx)
        from lbfgs_ffnn_torch.ops.cuda_gather import gather_rows

        return gather_rows(self.x, self.y, idx)


def _tree_add(a, b):
    if isinstance(a, tuple):
        return tuple(_tree_add(u, v) for u, v in zip(a, b, strict=True))
    return a + b


def accumulate_chunks(store: ChunkStore, contrib, init):
    """``init + sum_c contrib(xb_c, yb_c, mask_c)`` over all chunks, in
    order, one chunk on the device at a time (a tree of tuples of tensors
    adds leaf by leaf). ``contrib`` must be pure: the fetch happens outside
    it, so autodiff never crosses a fetch."""
    acc = init
    for c in range(store.num_chunks):
        xb, yb, mask = store.fetch_chunk(c)
        acc = _tree_add(acc, contrib(xb, yb, mask))
    return acc


def _value_and_grad(f):
    gv = torch.func.grad_and_value(f)

    def value_and_grad(*args):
        g, v = gv(*args)
        return v, g

    return value_and_grad


def masked_chunk_sums(bp: BatchProblem):
    """``(sum_loss, sum_grad, sum_vag)`` over ONE zero-padded masked chunk,
    each taking ``(w, xb, yb, mask)``. The masking discipline lives here:
    padding rows are zeroed before ``per_sample`` (they may hold anything,
    NaN included; :func:`~lbfgs_ffnn_torch.types.zero_masked_rows`) and
    their losses dropped, so both the value and the cotangents of masked
    rows are exactly zero."""

    def sum_loss(w, xb, yb, mask):
        xb = zero_masked_rows(mask, xb)
        yb = zero_masked_rows(mask, yb)
        ls = bp.per_sample(w, xb, yb)
        return torch.sum(torch.where(mask > 0, ls, torch.zeros_like(ls)))

    return sum_loss, torch.func.grad(sum_loss), _value_and_grad(sum_loss)


def chunked_mean_evals(bp: BatchProblem, store: ChunkStore):
    """``(full_loss, full_grad)``, callables ``w -> scalar / (n,)`` that sum
    the masked per-chunk sums over the whole store, divide by N once and add
    the regulariser once: the chunked equivalent of ``bp.fun``/``bp.grad``
    over the whole data set."""
    N = store.n
    sum_loss, sum_grad, _ = masked_chunk_sums(bp)

    def full_loss(w):
        total = accumulate_chunks(store, lambda xb, yb, m: sum_loss(w, xb, yb, m),
                                  torch.zeros((), dtype=w.dtype, device=w.device))
        out = total / N
        return out + bp.reg(w) if bp.reg is not None else out

    def full_grad(w):
        g = accumulate_chunks(store, lambda xb, yb, m: sum_grad(w, xb, yb, m),
                              torch.zeros_like(w)) / N
        return g + torch.func.grad(bp.reg)(w) if bp.reg is not None else g

    return full_loss, full_grad


def outofcore_problem(bp: BatchProblem, store: ChunkStore) -> Problem:
    """Full-batch :class:`Problem` over a host-resident data set: the
    in-memory ``bp.fun(w, x, y)`` (mean per-sample loss plus the
    regulariser once) up to chunked-summation rounding. ``aux`` is unused
    (pass ``()``). No line restriction (each trial is a chunk sweep) and no
    ``hess``; for the MLP prefer :func:`outofcore_mlp_problem`."""
    N = store.n
    _, _, sum_vag = masked_chunk_sums(bp)
    full_loss, full_grad = chunked_mean_evals(bp, store)

    def fun(w, aux=()):
        return full_loss(w)

    def grad(w, aux=()):
        return full_grad(w)

    def value_and_grad(w, aux=()):
        total, g = accumulate_chunks(
            store, lambda xb, yb, m: sum_vag(w, xb, yb, m),
            (torch.zeros((), dtype=w.dtype, device=w.device), torch.zeros_like(w)))
        f, g = total / N, g / N
        if bp.reg is not None:
            rf, rg = _value_and_grad(bp.reg)(w)
            f, g = f + rf, g + rg
        return f, g

    return Problem(fun=fun, grad=grad, value_and_grad=value_and_grad)


def outofcore_mlp_problem(spec, store: ChunkStore, lam: float = 0.0) -> Problem:
    """Out-of-core MLP :class:`Problem` whose line-search trials stay on the
    device, through the carried line prefix.

    The first-layer preactivation along a direction, ``z1(alpha) = A +
    alpha*B``, is linear in the step, and the carried ``A`` (N, d1) with
    the padded targets and row mask are far smaller than x (128 + 10 + 1
    against 784 columns at MNIST width), so they live on the device. An
    iteration makes exactly two chunk sweeps: the new direction's ``B =
    x@W1_p + b1_p`` and the accepted point's ``value_and_grad``; every trial
    is a combine over (N, d1) and the rest layers, as on the in-memory lean
    path.

    ``aux``: pass ``()``; the solver's one-time ``prepare`` puts the padded
    targets and the row mask on the device (a prepared 2-tuple passes
    through). The restriction masks the padded rows and divides by the true
    N, so it mirrors :mod:`lbfgs_ffnn_torch.objectives.mlp`'s forms instead
    of importing them (those are unmasked batch means); it has no narrow
    input variants, as in JAX.
    """
    from lbfgs_ffnn_torch.objectives.mlp import (
        _ACTIVATIONS, MLPSpec, mlp_apply, mlp_batch_problem,
    )

    base = outofcore_problem(mlp_batch_problem(spec, lam=lam), store)
    w_off, b_off, d_in, d_out0 = next(iter(spec.layer_slices()))
    first_elems = d_in * d_out0 + d_out0
    act0 = _ACTIVATIONS[spec.activations[0]]
    rest_spec = (MLPSpec(dims=spec.dims[1:], activations=spec.activations[1:])
                 if spec.n_layers > 1 else None)
    N, rows = store.n, store.chunk_rows

    def _affine_sweep(v):
        """(n_pad, d1) first-layer preactivation over the whole store, one
        chunk on the device at a time; the padded rows hold b1 (x = 0
        there) and are masked out by the restriction."""
        W = v[w_off:w_off + d_in * d_out0].view(d_in, d_out0)
        b = v[b_off:b_off + d_out0]
        out = torch.empty((store.num_chunks * rows, d_out0), dtype=v.dtype, device=v.device)
        for c in range(store.num_chunks):
            xb, _yb, _m = store.fetch_chunk(c)
            torch.addmm(b, xb, W, out=out[c * rows:(c + 1) * rows])
        return out

    def prepare(aux):
        # the zero-padded targets and the row mask, on the device once
        if isinstance(aux, tuple) and len(aux) == 2:
            return aux
        return store._y_pad.to(store.device), store._mask

    def restrict(A, B, w, p, aux):
        y, mask = aux[0], aux[1]
        w_rest, p_rest = w[first_elems:], p[first_elems:]

        def value(alpha):
            # a narrow prefix (the solver's prefix_dtype) upcast first
            h = act0(A.to(w.dtype) + alpha * B.to(w.dtype))
            out = mlp_apply(rest_spec, w_rest + alpha * p_rest, h) if rest_spec is not None else h
            diff = out - y
            row = 0.5 * torch.sum(diff * diff, dim=tuple(range(1, diff.dim())))
            loss = torch.sum(torch.where(mask > 0, row, torch.zeros_like(row))) / N
            if lam:
                wa = w + alpha * p
                loss = loss + 0.5 * lam * torch.dot(wa, wa)
            return loss

        return value

    line_prefix = LinePrefix(
        init=lambda w, aux: _affine_sweep(w),
        direction=lambda p, aux: _affine_sweep(p),
        restrict=restrict,
        # the accepted point's value_and_grad sweeps the chunks: x must be
        # read once per accepted step whatever the restriction
        vag_restrict=None,
        vag_restrict_carry=None,
    )
    return Problem(fun=base.fun, grad=base.grad, value_and_grad=base.value_and_grad,
                   line_prefix=line_prefix, prepare=prepare)
