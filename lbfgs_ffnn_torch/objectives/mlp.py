"""Flat-parameter dense MLP objective.

Counterpart of :mod:`lbfgs_ffnn_tpu.objectives.mlp`: the network is a pure
function of one flat parameter tensor with the same layout (per layer, W
row-major ``(d_in, d_out)`` then b), the forward pass is a chain of
``torch.matmul``, and gradients come from ``torch.func``. No ``nn.Module``:
the objective holds no state.

Conventions (the JAX package's, from the reference):
  * loss = 0.5*||out - y||^2 / batch, optional L2 term 0.5*lam*||w||^2
  * init std = act_scale * sqrt(1/fan_in), act_scale = sqrt(2) for ReLU else 1
  * ``bias_init`` "random" (same distribution as weights) or "zeros"

The narrow input copies are ported: ``mlp_problem``'s ``*_input_dtype``
options ("bfloat16" or "uint8") share one prepared copy of x, and a uint8
input (``quantize_pixels``, round(x*255)) is read by every first-layer GEMM
upcast to the parameters' dtype with the 1/255 rescale on the GEMM's
output. torch has no mixed-dtype matmul, so where JAX's dot upcasts the
narrow operand inside the product the port upcasts x first (an (N, in)
temporary of the parameters' dtype per GEMM); the values are JAX's. Not
ported (each raises ``NotImplementedError`` when asked for):
``compute_dtype`` and ``remat``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from lbfgs_ffnn_torch.types import (
    BatchProblem, LinePrefix, Problem, make_batch_problem, make_problem,
)


def _relu_tie(z: torch.Tensor) -> torch.Tensor:
    """JAX's relu, ``jnp.maximum(z, 0)``, its derivative at z == 0
    included: 0.5, where ``torch.relu``'s is 0. Exact zeros are common in
    z1 = A + alpha*B on a narrow prefix (A and -alpha*B the same bf16
    value), so the restriction uses this form there. Elsewhere an exact 0
    is rare (an f32 combine cancels exactly about once in 2**24 entries)
    and moves a trajectory no more than f32 rounding does, and
    ``torch.relu`` stays: one kernel each way, where this form's backward
    takes several (on the card it slowed GD's Wolfe iteration by a
    quarter)."""
    return torch.maximum(z, z.new_zeros(()))


_ACTIVATIONS = {
    "linear": lambda z: z,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

_INIT_SCALE = {
    "linear": 1.0,
    "relu": math.sqrt(2.0),
    "sigmoid": 1.0,
    "tanh": 1.0,
}


class MLPSpec(NamedTuple):
    """Static architecture description: ``dims[i] -> dims[i+1]`` per layer."""

    dims: tuple[int, ...]
    activations: tuple[str, ...]

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def n_params(self) -> int:
        return sum(
            self.dims[i] * self.dims[i + 1] + self.dims[i + 1]
            for i in range(self.n_layers)
        )

    def layer_slices(self):
        """Yield (w_offset, b_offset, in_dim, out_dim) per layer."""
        off = 0
        for i in range(self.n_layers):
            d_in, d_out = self.dims[i], self.dims[i + 1]
            yield off, off + d_in * d_out, d_in, d_out
            off += d_in * d_out + d_out


def mlp_spec(dims: Sequence[int], activations: Sequence[str]) -> MLPSpec:
    dims = tuple(int(d) for d in dims)
    activations = tuple(a.lower() for a in activations)
    if len(activations) != len(dims) - 1:
        raise ValueError("need one activation per layer")
    for a in activations:
        if a not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {a!r}")
    return MLPSpec(dims=dims, activations=activations)


def mlp_init(
    spec: MLPSpec,
    generator: torch.Generator,
    dtype=torch.float32,
    bias_init: str = "random",
    device=None,
) -> torch.Tensor:
    """Seeded N(0, sigma) init into one flat tensor, drawn from ``generator``
    on its own device and moved to ``device``. The stream differs from
    ``jax.random``'s for the same seed; parity tests pass ``w0`` in."""
    if bias_init not in ("random", "zeros"):
        raise ValueError(f"unknown bias_init {bias_init!r}")
    parts = []
    for li, (w_off, b_off, d_in, d_out) in enumerate(spec.layer_slices()):
        std = _INIT_SCALE[spec.activations[li]] * math.sqrt(1.0 / d_in)
        w = std * torch.randn(d_in * d_out, generator=generator, dtype=dtype,
                              device=generator.device)
        if bias_init == "random":
            b = std * torch.randn(d_out, generator=generator, dtype=dtype,
                                  device=generator.device)
        else:
            b = torch.zeros(d_out, dtype=dtype, device=generator.device)
        parts.append(w)
        parts.append(b)
    return torch.cat(parts).to(device)


def params_from_numpy(spec: MLPSpec, w: np.ndarray, device=None,
                      dtype=torch.float32) -> torch.Tensor:
    """Carry a flat parameter vector over from the JAX package (or any numpy
    source): the layouts are identical, so this is a length-checked copy."""
    w = np.asarray(w)
    if w.ndim != 1 or w.shape[0] != spec.n_params:
        raise ValueError(
            f"expected a flat vector of {spec.n_params} parameters for dims "
            f"{spec.dims}, got shape {w.shape}")
    return torch.tensor(w, dtype=dtype, device=device)


def slbfgs_state_from_numpy(spec: MLPSpec, state, device=None, dtype=torch.float32):
    """Carry an S-LBFGS state over from the JAX package: ``state`` has the
    fields of ``lbfgs_ffnn_tpu.solvers.slbfgs._State`` as numpy arrays or anything ``np.asarray`` takes, e.g.
    ``jax.tree.map(np.asarray, state)``. The curvature rows are cut to the
    parameter count and padded to this package's row length; a 2-byte pair
    type becomes the bfloat16 ring (its values carried exactly). Returns the
    :class:`lbfgs_ffnn_torch.solvers.slbfgs._State` that ``slbfgs_chunked``
    resumes from."""
    from lbfgs_ffnn_torch.ops.two_loop import RingState, _round_up
    from lbfgs_ffnn_torch.solvers.slbfgs import _State

    n = spec.n_params

    def vec(a):
        return params_from_numpy(spec, np.asarray(a), device, dtype)

    def arr(a, dt):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    def rows(a):
        a = np.asarray(a)
        a = a.reshape(a.shape[0], -1)[:, :n]
        pd = torch.bfloat16 if a.dtype.itemsize == 2 else dtype
        out = torch.zeros((a.shape[0], _round_up(n)), dtype=pd, device=device)
        out[:, :n] = torch.tensor(a.astype(np.float32) if a.dtype.itemsize == 2 else a,
                                  device=device)
        return out

    h = state.hist
    return _State(
        epoch=arr(state.epoch, torch.int32), w=vec(state.w),
        hist=RingState(S=rows(h.S), Y=rows(h.Y), rho=arr(h.rho, dtype),
                       head=arr(h.head, torch.int32), count=arr(h.count, torch.int32)),
        u_prev=vec(state.u_prev), has_u=arr(state.has_u, torch.bool),
        stop=arr(state.stop, torch.bool), gnorm=arr(state.gnorm, dtype),
        loss_h=arr(state.loss_h, dtype), gnorm_h=arr(state.gnorm_h, dtype),
        metric_h=arr(state.metric_h, dtype),
    )


def _layer(w: torch.Tensor, w_off: int, b_off: int, d_in: int, d_out: int):
    return w[w_off: w_off + d_in * d_out].view(d_in, d_out), w[b_off: b_off + d_out]


def _quantized(x: torch.Tensor) -> bool:
    """Whether ``x`` is a uint8 pixel-quantized input; any other non-float
    input is a caller error (raw counts, labels in the wrong slot) and
    raises, as JAX's ``mlp_apply`` does."""
    if torch.is_floating_point(x):
        return False
    if x.dtype != torch.uint8:
        raise ValueError(f"integer inputs to mlp_apply must be uint8 pixel-quantized "
                         f"(quantize_pixels convention), got {x.dtype}")
    return True


def _input_matmul(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``x @ W`` in W's dtype for an input ``x`` of any dtype the MLP takes:
    a narrow x (bf16, or uint8 holding round(x*255)) is upcast first, the
    uint8 product rescaled by 1/255 on its output (JAX's
    ``preferred_element_type`` dot with the scale in its epilogue)."""
    if _quantized(x):
        return (x.to(W.dtype) @ W) * (1.0 / 255.0)
    return x.to(W.dtype) @ W


def mlp_apply(spec: MLPSpec, w: torch.Tensor, x: torch.Tensor,
              compute_dtype=None) -> torch.Tensor:
    """Forward pass. ``x`` is batch-major ``(B, in_dim)`` -> ``(B, out_dim)``.
    A uint8 ``x`` holds round(x*255) (:func:`quantize_pixels`): the first
    layer reads it upcast and rescales its output by 1/255."""
    if compute_dtype is not None:
        raise NotImplementedError("compute_dtype is not ported yet")
    h = x
    for li, (w_off, b_off, d_in, d_out) in enumerate(spec.layer_slices()):
        W, b = _layer(w, w_off, b_off, d_in, d_out)
        z = _input_matmul(h, W) if li == 0 else h @ W
        h = _ACTIVATIONS[spec.activations[li]](z + b)
    return h


def mlp_apply_single(spec: MLPSpec, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Forward pass for one sample ``x (in_dim,) -> (out_dim,)``, written as
    vector-matrix products so that ``torch.func.vmap`` over samples batches
    them into ``(B, in) @ (in, out)`` GEMMs: the per-point form the PINN
    residuals vmap over."""
    h = x
    for li, (w_off, b_off, d_in, d_out) in enumerate(spec.layer_slices()):
        W, b = _layer(w, w_off, b_off, d_in, d_out)
        h = _ACTIVATIONS[spec.activations[li]](h @ W + b)
    return h


def mlp_loss(spec: MLPSpec, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             lam: float = 0.0, compute_dtype=None) -> torch.Tensor:
    """Mean 0.5*MSE over the batch, optionally L2-regularized."""
    out = mlp_apply(spec, w, x, compute_dtype)
    diff = out - y
    loss = 0.5 * torch.sum(diff * diff) / x.shape[0]
    if lam:
        loss = loss + 0.5 * lam * torch.dot(w, w)
    return loss


def _narrow_dtype(name, value) -> torch.dtype:
    """The torch dtype of an ``*_input_dtype`` option: a name ("bfloat16",
    "uint8", ...) or a torch dtype. An integer dtype other than uint8
    raises ``ValueError``, as in the JAX package."""
    d = value if isinstance(value, torch.dtype) else getattr(torch, str(value), None)
    if not isinstance(d, torch.dtype):
        raise ValueError(f"{name}={value!r} is not a dtype")
    if not d.is_floating_point and d != torch.uint8:
        raise ValueError(f"integer narrow input dtype must be uint8 (the pixel quantization "
                         f"convention), got {d}")
    return d


def mlp_problem(
    spec: MLPSpec, lam: float = 0.0, compute_dtype=None, remat: bool = False,
    grad_input_dtype=None, line_input_dtype=None, fun_input_dtype=None,
) -> Problem:
    """Full-batch Problem; ``aux = (x, y)``.

    Along a fixed direction ``p`` the first-layer preactivation is affine in
    the step length, ``z1(alpha) = (x@W1_w + b1_w) + alpha*(x@W1_p + b1_p)
    = A + alpha*B``; the carried ``line_prefix`` keeps A in the solver state,
    so a line-search trial is one elementwise combine over ``(batch, d1)``
    plus the rest layers, and the input matrix is read once per iteration
    for B and once for the accepted point's ``dW1 = x^T dz1``. A narrow
    prefix (the solver's ``prefix_dtype``) is upcast to the parameters'
    dtype before every combine.

    The ``*_input_dtype`` options (JAX's) read one prepared narrow copy of
    x instead of x: ``grad_input_dtype`` in the accepted point's dW1,
    ``line_input_dtype`` in the prefix GEMMs (A and each B),
    ``fun_input_dtype`` in the full objective's first layer (forward and,
    by autodiff, dW1). Each is "bfloat16" or "uint8" (pixel data on the
    k/255 grid: the copy is round(x*255), clipped to [0, 255]; every
    consumer computes ``(xq @ W) * (1/255)``); they must agree, as they
    share the copy, which ``Problem.prepare`` makes (aux becomes ``(x, y,
    x_narrow)``; the solvers prepare once per data, see
    :func:`lbfgs_ffnn_torch.solvers.common.prepared`). The full ``fun``
    reads raw x unless ``fun_input_dtype`` is set, and the copy only in a
    prepared 3-element aux.
    """
    if compute_dtype is not None:
        raise NotImplementedError(f"mlp_problem(compute_dtype={compute_dtype!r}) is not "
                                  "ported yet")
    if remat:
        raise NotImplementedError("mlp_problem(remat=True) is not ported yet")

    w_off, b_off, d_in, d_out = next(iter(spec.layer_slices()))
    first_elems = d_in * d_out + d_out
    act0 = _ACTIVATIONS[spec.activations[0]]
    act0_tie = _relu_tie if spec.activations[0] == "relu" else act0
    rest_spec = (
        MLPSpec(dims=spec.dims[1:], activations=spec.activations[1:])
        if spec.n_layers > 1 else None
    )

    def _first_affine(v, x):
        W, b = _layer(v, w_off, b_off, d_in, d_out)
        return _input_matmul(x, W) + b

    def _line_x(aux):
        # aux[2] is this problem's prepared copy only when it asked for one
        return aux[2] if line_input_dtype is not None and len(aux) > 2 else aux[0]

    def _loss_from_z1(w_rest_alpha, z1, y, n_batch, tie=False):
        """Shared loss body for the restriction and its value-and-grad form;
        ``tie``: z1 combines a narrow prefix, so exact zeros are common and
        the first relu takes JAX's derivative there (:func:`_relu_tie`)."""
        h = (act0_tie if tie else act0)(z1)
        out = mlp_apply(rest_spec, w_rest_alpha, h) if rest_spec is not None else h
        diff = out - y
        return 0.5 * torch.sum(diff * diff) / n_batch

    def _combine(A, B, alpha, dtype):
        # A + alpha*B in the solver dtype: a narrow prefix is upcast first
        # (torch would compute bf16 + 0-dim f32 * bf16 in bf16)
        return A.to(dtype) + alpha * B.to(dtype)

    def _narrow(A, B, dtype):
        return A.dtype != dtype or B.dtype != dtype

    def restrict(A, B, w, p, aux):
        x, y = aux[0], aux[1]
        w_rest = w[first_elems:]
        p_rest = p[first_elems:]

        tie = _narrow(A, B, w.dtype)

        def value(alpha):
            loss = _loss_from_z1(w_rest + alpha * p_rest, _combine(A, B, alpha, w.dtype), y,
                                 x.shape[0], tie)
            if lam:
                wa = w + alpha * p
                loss = loss + 0.5 * lam * torch.dot(wa, wa)
            return loss

        return value

    def line_fun(w, p, aux):
        x = _line_x(aux)
        return restrict(_first_affine(w, x), _first_affine(p, x), w, p, aux)

    def _vag_restrict_full(A, B, w, p, aux):
        """Full (loss, grad, z1) at ``w + alpha*p`` computed from the prefix:
        the forward never recomputes ``x @ W1`` (z1 = A + alpha*B); the rest
        layers' gradient and dz1 come from one ``torch.func.vjp`` and the
        first layer's is assembled as dW1 = x^T dz1 (from the prepared copy
        under ``grad_input_dtype``), db1 = sum(dz1). The returned ``z1`` is
        the post-step prefix the solver carries."""
        x, y = aux[0], aux[1]
        xg = aux[2] if grad_input_dtype is not None and len(aux) > 2 else x
        tie = _narrow(A, B, w.dtype)

        def value_and_grad_at(alpha):
            z1 = _combine(A, B, alpha, w.dtype)
            w_rest = w[first_elems:] + alpha * p[first_elems:]

            def from_z1(w_r, z1_):
                return _loss_from_z1(w_r, z1_, y, x.shape[0], tie)

            loss, vjp_fn = torch.func.vjp(from_z1, w_rest, z1)
            g_rest, dz1 = vjp_fn(torch.ones_like(loss))
            # upcast, then the transposed view: no transposed narrow copy
            gW1 = xg.to(x.dtype).t() @ dz1
            if _quantized(xg):
                gW1 = gW1 * (1.0 / 255.0)
            gb1 = torch.sum(dz1, dim=0)
            g = torch.cat([gW1.reshape(-1), gb1, g_rest])
            if lam:
                wa = w + alpha * p
                loss = loss + 0.5 * lam * torch.dot(wa, wa)
                g = g + lam * wa
            return loss, g, z1

        return value_and_grad_at

    def vag_restrict(A, B, w, p, aux):
        inner = _vag_restrict_full(A, B, w, p, aux)

        def value_and_grad_at(alpha):
            loss, g, _z1 = inner(alpha)
            return loss, g

        return value_and_grad_at

    line_prefix = LinePrefix(
        init=lambda w, aux: _first_affine(w, _line_x(aux)),
        direction=lambda p, aux: _first_affine(p, _line_x(aux)),
        restrict=restrict,
        vag_restrict=vag_restrict,
        vag_restrict_carry=_vag_restrict_full,
    )

    if fun_input_dtype is None:
        def fun(w, aux):
            return mlp_loss(spec, w, aux[0], aux[1], lam)
    else:
        def fun(w, aux):
            # the first layer reads the prepared copy (its backward dW1 too,
            # by autodiff); un-prepared 2-tuple aux reads raw x
            xn = aux[2] if len(aux) > 2 else aux[0]
            loss = _loss_from_z1(w[first_elems:], _first_affine(w, xn), aux[1],
                                 aux[0].shape[0])
            if lam:
                loss = loss + 0.5 * lam * torch.dot(w, w)
            return loss

    # one prepared narrow copy serves every consumer, so the dtypes must agree
    narrow = None
    for name, value in (("grad_input_dtype", grad_input_dtype),
                        ("line_input_dtype", line_input_dtype),
                        ("fun_input_dtype", fun_input_dtype)):
        if value is None:
            continue
        d = _narrow_dtype(name, value)
        if narrow is not None and d != narrow:
            raise ValueError(f"{name}={value!r} conflicts with an earlier narrow input dtype "
                             f"{narrow}: all *_input_dtype options must match; they share "
                             "one prepared input copy")
        narrow = d

    prepare = None
    if narrow == torch.uint8:
        def prepare(aux):
            return (aux[0], aux[1], quantize_pixels(aux[0]))
    elif narrow is not None:
        def prepare(aux, _d=narrow):
            return (aux[0], aux[1], aux[0].to(_d))

    return make_problem(fun, line_fun=line_fun, line_prefix=line_prefix, prepare=prepare)


def quantize_pixels(x: torch.Tensor) -> torch.Tensor:
    """Pixel-quantize an in-[0, 1] input matrix to the uint8 grid,
    ``round(x*255)`` (half to even) clipped to [0, 255]: the storage every
    ``*_input_dtype="uint8"`` consumer and a uint8 ``mlp_apply`` input
    expect. Exact for k/255 pixel data; off-grid values round, and values
    outside [0, 1] clip."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def mlp_batch_problem(spec: MLPSpec, lam: float = 0.0, compute_dtype=None) -> BatchProblem:
    """Per-batch problem for the stochastic solvers; its callables take
    ``(w, xb, yb)``: the per-sample loss 0.5*||out - y||^2 and, when ``lam``
    is set, the L2 term 0.5*lam*||w||^2 on every batch loss (the reference
    S-LBFGS training's, src/unified_optimization.hpp:375,398). A batch may
    be uint8 (:func:`quantize_pixels`; a quarter of f32's bytes per gathered
    row), read as :func:`mlp_apply` reads it; ``compute_dtype`` raises."""

    def per_sample(w, xb, yb):
        out = mlp_apply(spec, w, xb, compute_dtype)
        diff = out - yb
        return 0.5 * torch.sum(diff * diff, dim=1)

    if compute_dtype is not None:
        raise NotImplementedError("mlp_batch_problem(compute_dtype=...) is not ported yet")
    # sum(w * w), not dot(w, w): S-LBFGS vmaps the gradient over two iterates,
    # and a vmapped dot becomes a batched GEMM with k = n, which cuBLAS runs
    # as a slow gemv (45 us of device time per step at n = 101,770 on an H100)
    reg = (lambda w: 0.5 * lam * torch.sum(w * w)) if lam else None
    return make_batch_problem(per_sample, reg)


def take_batch(x: torch.Tensor, y: torch.Tensor,
               indices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather a minibatch by index set (one ``index_select`` per operand)."""
    return x.index_select(0, indices), y.index_select(0, indices)


def evaluate(spec: MLPSpec, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> dict:
    """Accuracy (argmax match) and total 0.5*||out-y||^2."""
    out = mlp_apply(spec, w, x)
    correct = int(torch.sum(out.argmax(dim=1) == y.argmax(dim=1)))
    diff = out - y
    n = x.shape[0]
    return {
        "n": n,
        "correct": correct,
        "accuracy": correct / n * 100.0,
        "total_mse": float(0.5 * torch.sum(diff * diff)),
    }
