"""Line searches: Wolfe bisection and Armijo backtracking.

Counterparts of :func:`lbfgs_ffnn_tpu.ops.linesearch.wolfe_line_search`
(the reference CPU backend's policy, src/minimizer/full_batch_minimizer.hpp:
126-157) and :func:`~lbfgs_ffnn_tpu.ops.linesearch.armijo_quad_line_search`
(the reference CUDA backend's policy, src/cuda/lbfgs.cuh:108-147), each with
the same trial sequence. The JAX versions are ``lax.while_loop``s that never
leave the device; here each loop runs on the host and exits early on the
accept test, which costs exactly one host sync per trial. Every other
quantity (alpha, the bracket, the interpolation, the accept flag) stays a
device tensor. The device forms, for the captured L-BFGS iteration
(:mod:`lbfgs_ffnn_torch.ops.control`), have no host sync at all under
capture: :func:`armijo_quad_line_search_device` is a fixed budget of trial
slots, each guarded by a device flag; :func:`wolfe_line_search_device` is
one WHILE node around one trial (its budget is 100 on the PINN path, where
nested slots would capture 100 copies of the trial). The batched Armijo
search is not ported.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple

import torch

from lbfgs_ffnn_torch.ops.control import assign, guard, loop


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor      # accepted (or last-evaluated) step length
    ok: torch.Tensor         # bool: did any trial satisfy the accept test?
    evaluated: bool          # do f_new/g_new correspond to `alpha`?
    f_new: torch.Tensor      # loss at x + alpha*p
    g_new: torch.Tensor      # grad at x + alpha*p
    n_trials: Any = 0        # objective evaluations: an int (= host syncs) in the
                             # early-exit searches, an int32 tensor in the device form
    carry: Any = ()          # accept-point carry from ``vag_carry_along``


def wolfe_line_search(
    value_and_grad: Callable[..., tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    p: torch.Tensor,
    f0: torch.Tensor,
    dg0: torch.Tensor,
    aux: Any = (),
    *,
    c1: float = 1e-4,
    c2: float = 0.9,
    shrink: float = 0.5,
    max_iters: int = 50,
    alpha0: torch.Tensor | float = 1.0,
    value: Callable[..., torch.Tensor] | None = None,
    value_along: Callable[[torch.Tensor], torch.Tensor] | None = None,
    vag_along: Callable[[torch.Tensor], tuple] | None = None,
) -> LineSearchResult:
    """Bracketing bisection Wolfe search. Per trial at ``alpha``:

    * Armijo fails (``f > f0 + c1*alpha*dg0``): bracket above,
      ``alpha = shrink*(lo + alpha)``;
    * curvature fails (``g.p < c2*dg0``): bracket below; double ``alpha``
      while unbracketed, else ``alpha = shrink*(alpha + hi)``;
    * both hold: accept.

    If no trial is accepted within ``max_iters``, returns the last *updated*
    alpha unevaluated (``evaluated=False``), as the reference does; the
    caller re-evaluates there.

    Without ``value`` every trial is a fused ``value_and_grad``. With
    ``value`` (loss-only) each trial computes ``(f, df/dalpha)`` with one
    forward-mode ``torch.func.jvp`` along ``p`` (through ``value_along``,
    ``alpha -> f(x + alpha*p)``, when given), and the gradient comes from
    one ``vag_along`` (else ``value_and_grad``) at the accepted point; the
    returned ``f_new`` is the accepted trial's value.
    """
    fused = value is None
    a = torch.as_tensor(alpha0, dtype=x.dtype, device=x.device)
    lo = torch.zeros((), dtype=x.dtype, device=x.device)
    hi = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    ok = torch.zeros((), dtype=torch.bool, device=x.device)
    f_new, g_new = f0, None
    n_trials, accepted = 0, False
    while n_trials < max_iters and not accepted:
        if fused:
            f_new, g_new = value_and_grad(x + a * p, aux)
            dg_new = torch.dot(g_new, p)
        elif value_along is not None:
            f_new, dg_new = torch.func.jvp(value_along, (a,), (torch.ones_like(a),))
        else:
            f_new, dg_new = torch.func.jvp(lambda u: value(u, aux), (x + a * p,), (p,))
        armijo_fail = f_new > f0 + c1 * a * dg0
        curv_fail = dg_new < c2 * dg0
        ok = ~armijo_fail & ~curv_fail
        alpha_a = shrink * (lo + a)  # Armijo failure: shrink into [lo, alpha]
        alpha_c = torch.where(torch.isinf(hi), a * 2.0, shrink * (a + hi))
        lo, hi, a = (torch.where(ok | armijo_fail, lo, a),
                     torch.where(ok | ~armijo_fail, hi, a),
                     torch.where(ok, a, torch.where(armijo_fail, alpha_a, alpha_c)))
        n_trials += 1
        accepted = bool(ok)  # the one host sync of a trial

    if not fused and accepted:  # the full gradient at the accepted point only
        g_new = vag_along(a)[1] if vag_along is not None else value_and_grad(x + a * p, aux)[1]
    elif g_new is None:  # lean and unaccepted, or no trial at all
        g_new = torch.zeros_like(x)
    return LineSearchResult(alpha=a, ok=ok, evaluated=accepted, f_new=f_new,
                            g_new=g_new, n_trials=n_trials)


def armijo_quad_line_search(
    value_and_grad: Callable[..., tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    p: torch.Tensor,
    f0: torch.Tensor,
    dg0: torch.Tensor,
    aux: Any = (),
    *,
    c1: float = 1e-4,
    shrink: float = 0.5,
    max_iters: int = 20,
    alpha0: torch.Tensor | float = 1.0,
    value: Callable[..., torch.Tensor] | None = None,
    value_along: Callable[[torch.Tensor], torch.Tensor] | None = None,
    vag_along: Callable[[torch.Tensor], tuple] | None = None,
    vag_carry_along: Callable[[torch.Tensor], tuple] | None = None,
) -> LineSearchResult:
    """Per trial: evaluate at ``alpha``; if ``f <= f0 + c1*alpha*dg0``,
    accept. Otherwise propose the minimizer of the quadratic fit
    ``a* = -dg0*a^2 / (2*(f_new - f0 - dg0*a))`` and take it if it lies in
    ``[0.1a, 0.9a]`` (and ``|denominator| > 1e-20``); else ``a *= shrink``.
    When every trial fails, the result carries the last *evaluated* alpha
    with ``ok`` false.

    With ``value`` (loss-only) the trials run forward-only, through
    ``value_along`` (``alpha -> f(x + alpha*p)``) when given, and one
    value-and-gradient at the chosen alpha produces ``f_new``/``g_new``:
    ``vag_carry_along`` (which also returns a carry, handed back in
    ``carry``), else ``vag_along``, else ``value_and_grad``. Without
    ``value`` every trial is a fused ``value_and_grad``.
    """
    if max_iters < 1:
        raise ValueError("armijo_quad_line_search needs max_iters >= 1")
    fused = value is None
    a = torch.as_tensor(alpha0, dtype=x.dtype, device=x.device)
    g_new = None
    for i in range(max_iters):
        if fused:
            f_new, g_new = value_and_grad(x + a * p, aux)
        elif value_along is not None:
            f_new = value_along(a)
        else:
            f_new = value(x + a * p, aux)
        ok = f_new <= f0 + c1 * a * dg0
        if bool(ok) or i == max_iters - 1:  # the one host sync of a trial
            break
        denom = 2.0 * (f_new - f0 - dg0 * a)
        a_quad = -(dg0 * a * a) / torch.where(denom == 0.0, torch.ones_like(denom), denom)
        quad_ok = (torch.abs(denom) > 1e-20) & (a_quad >= 0.1 * a) & (a_quad <= 0.9 * a)
        a = torch.where(quad_ok, a_quad, a * shrink)
    n_trials = i + 1

    carry = ()
    if not fused:
        if vag_carry_along is not None:
            f_new, g_new, carry = vag_carry_along(a)
        elif vag_along is not None:
            f_new, g_new = vag_along(a)
        else:
            f_new, g_new = value_and_grad(x + a * p, aux)
    return LineSearchResult(alpha=a, ok=ok, evaluated=True, f_new=f_new,
                            g_new=g_new, n_trials=n_trials, carry=carry)


def armijo_quad_line_search_device(
    value_and_grad: Callable[..., tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    p: torch.Tensor,
    f0: torch.Tensor,
    dg0: torch.Tensor,
    aux: Any = (),
    *,
    c1: float = 1e-4,
    shrink: float = 0.5,
    max_iters: int = 20,
    alpha0: torch.Tensor | float = 1.0,
    value: Callable[..., torch.Tensor] | None = None,
    value_along: Callable[[torch.Tensor], torch.Tensor] | None = None,
    vag_along: Callable[[torch.Tensor], tuple] | None = None,
    vag_carry_along: Callable[[torch.Tensor], tuple] | None = None,
) -> LineSearchResult:
    """:func:`armijo_quad_line_search` with every decision on the device.

    The carry is the JAX search's ``_C`` (``i``, ``alpha_next``,
    ``alpha_eval``, ``ok``, ``f_new``, and ``g_new`` for fused trials) in
    device tensors. There are ``max_iters`` trial slots; slot j is
    ``guard(~ok & (i < max_iters))`` around one trial, which updates the
    carry with :func:`~lbfgs_ffnn_torch.ops.control.assign`, and slot j + 1
    sits inside slot j's body. Captured, the slot after acceptance is an IF
    node that does not fire, and the slots inside it are never reached; run
    eagerly, every slot computes and its writes are masked. Then comes the one
    value-and-gradient at ``alpha_eval`` (lean trials): ``vag_carry_along``,
    else ``vag_along``, else ``value_and_grad``. ``n_trials`` is the device
    ``i``; the trial sequence and the result are the early-exit search's.
    """
    if max_iters < 1:
        raise ValueError("armijo_quad_line_search_device needs max_iters >= 1")
    fused = value is None
    like = dict(dtype=x.dtype, device=x.device)
    a0 = torch.as_tensor(alpha0, **like).reshape(())
    i = torch.zeros((), dtype=torch.int32, device=x.device)
    alpha_next, alpha_eval = a0.clone(), a0.clone()
    ok = torch.zeros((), dtype=torch.bool, device=x.device)
    f_new = f0.clone()
    g_new = torch.zeros_like(x) if fused else None
    # Slot j + 1 opens inside slot j's body: a search that accepts at trial
    # j skips one slot, not max_iters - j (captured, a slot that does not
    # fire costs a few kernels; its nested slots are never reached).
    with contextlib.ExitStack() as nest:
        for _ in range(max_iters):
            live = ~ok & (i < max_iters)
            nest.enter_context(guard(live))
            a = alpha_next
            if fused:
                f, g = value_and_grad(x + a * p, aux)
            elif value_along is not None:
                f = value_along(a)
            else:
                f = value(x + a * p, aux)
            accept = f <= f0 + c1 * a * dg0
            denom = 2.0 * (f - f0 - dg0 * a)
            a_quad = -(dg0 * a * a) / torch.where(denom == 0.0, torch.ones_like(denom), denom)
            quad_ok = (torch.abs(denom) > 1e-20) & (a_quad >= 0.1 * a) & (a_quad <= 0.9 * a)
            a_next = torch.where(accept, a, torch.where(quad_ok, a_quad, a * shrink))
            # alpha_eval reads alpha_next, so it is written first
            assign(live, alpha_eval, a)
            assign(live, alpha_next, a_next)
            assign(live, ok, accept)
            assign(live, f_new, f)
            if fused:
                assign(live, g_new, g)
            assign(live, i, i + 1)

    carry = ()
    if not fused:
        if vag_carry_along is not None:
            f_new, g_new, carry = vag_carry_along(alpha_eval)
        elif vag_along is not None:
            f_new, g_new = vag_along(alpha_eval)
        else:
            f_new, g_new = value_and_grad(x + alpha_eval * p, aux)
    return LineSearchResult(alpha=alpha_eval, ok=ok, evaluated=True, f_new=f_new,
                            g_new=g_new, n_trials=i, carry=carry)


def wolfe_line_search_device(
    value_and_grad: Callable[..., tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    p: torch.Tensor,
    f0: torch.Tensor,
    dg0: torch.Tensor,
    aux: Any = (),
    *,
    c1: float = 1e-4,
    c2: float = 0.9,
    shrink: float = 0.5,
    max_iters: int = 50,
    alpha0: torch.Tensor | float = 1.0,
    value: Callable[..., torch.Tensor] | None = None,
    value_along: Callable[[torch.Tensor], torch.Tensor] | None = None,
    vag_along: Callable[[torch.Tensor], tuple] | None = None,
    live: torch.Tensor | None = None,
) -> LineSearchResult:
    """:func:`wolfe_line_search` with every decision on the device: JAX's
    ``lax.while_loop`` as :func:`~lbfgs_ffnn_torch.ops.control.loop`.

    The carry (the trial counter ``i``, int32, ``alpha``, the bracket
    ``lo``/``hi``, ``ok``, ``f_new``, and ``g_new`` for fused trials) lives
    in device tensors; each pass of the loop is one trial while
    ``(i < max_iters) & ~ok`` (and ``live``, when given: the enclosing
    guard's flag, so that a run outside capture spends no trials where the
    caller's writes are masked anyway). Lean trials take the full gradient
    at the accepted point only, in ``guard(ok)``; ``g_new`` is zeros
    otherwise. ``evaluated`` is the device bool ``ok`` and ``n_trials`` the
    device ``i``; the trial sequence is the early-exit search's and JAX's.
    Under capture nothing is read on the host; outside it the loop reads
    its flag once per trial and once at the end.
    """
    fused = value is None
    like = dict(dtype=x.dtype, device=x.device)
    # torch.full, not torch.tensor: no host-to-device copy under capture
    alpha = (alpha0.to(**like).reshape(()).clone() if isinstance(alpha0, torch.Tensor)
             else torch.full((), alpha0, **like))
    lo = torch.zeros((), **like)
    hi = torch.full((), float("inf"), **like)
    ok = torch.zeros((), dtype=torch.bool, device=x.device)
    i = torch.zeros((), dtype=torch.int32, device=x.device)
    f_new = f0.clone()
    g_new = torch.zeros_like(x)

    def more():
        go = (i < max_iters) & ~ok
        return go if live is None else go & live

    def trial():
        a = alpha
        if fused:
            f, g = value_and_grad(x + a * p, aux)
            dg = torch.dot(g, p)
        elif value_along is not None:
            f, dg = torch.func.jvp(value_along, (a,), (torch.ones_like(a),))
        else:
            f, dg = torch.func.jvp(lambda u: value(u, aux), (x + a * p,), (p,))
        armijo_fail = f > f0 + c1 * a * dg0
        curv_fail = dg < c2 * dg0
        accept = ~armijo_fail & ~curv_fail
        alpha_a = shrink * (lo + a)  # Armijo failure: shrink into [lo, alpha]
        alpha_c = torch.where(torch.isinf(hi), a * 2.0, shrink * (a + hi))
        new = ((lo, torch.where(accept | armijo_fail, lo, a)),
               (hi, torch.where(accept | ~armijo_fail, hi, a)),
               (alpha, torch.where(accept, a, torch.where(armijo_fail, alpha_a, alpha_c))),
               (ok, accept), (f_new, f), (i, i + 1))
        if fused:
            new += ((g_new, g),)
        for dst, v in new:  # every new value is computed; now the carry moves
            dst.copy_(v)

    loop(more, trial)
    if not fused:  # the full gradient at the accepted point only
        with guard(ok):
            g = vag_along(alpha)[1] if vag_along is not None else value_and_grad(x + alpha * p,
                                                                                  aux)[1]
            assign(ok, g_new, g)
    return LineSearchResult(alpha=alpha, ok=ok, evaluated=ok, f_new=f_new, g_new=g_new,
                            n_trials=i)
