"""The port's Armijo search against the JAX package's on analytic functions,
in f64: the accepted (or last-evaluated) alpha, ``ok`` and ``n_trials``
must be equal; values agree to rtol 1e-12, atol 1e-15 (same arithmetic,
but XLA may contract ``x + a*p`` into one fused multiply-add, which moves
a value that cancels to zero by ~1e-17)."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.ops.linesearch import armijo_quad_line_search as j_armijo
from lbfgs_ffnn_torch.ops.linesearch import armijo_quad_line_search as t_armijo


def quadratic(lib, center):
    def f(w, aux=()):
        return 0.5 * lib.sum((w - center) ** 2)
    return f, lambda w, aux=(): (f(w), w - center)


def octic(lib):
    def f(w, aux=()):
        return lib.sum(w ** 8)
    return f, lambda w, aux=(): (f(w), 8.0 * w ** 7)


# name -> (function factory, x0, direction sign, max_iters). Each case
# drives one branch of the policy; the assertions below pin which.
CASES = {
    "accept_first": (lambda lib: quadratic(lib, 0.5), [0.0, 0.0], -1.0, 20),
    # three times the Newton step: the exact quadratic fit lands on 1/3
    "interpolate": (lambda lib: quadratic(lib, 0.0), [1.0], -3.0, 20),
    "shrink": (octic, [1.5], -1.0, 20),
    # an ascent direction reported with a negative slope: nothing passes
    "all_fail": (lambda lib: quadratic(lib, 0.0), [1.0, -2.0], 1.0, 4),
}


def run_both(case, mode):
    make, x0, sign, max_iters = CASES[case]
    out = {}
    for lib, search, arr in ((jnp, j_armijo, jnp.asarray),
                             (torch, t_armijo, lambda a: torch.tensor(a, dtype=torch.float64))):
        f, vag = make(lib)
        x = arr(np.asarray(x0, dtype=np.float64))
        f0, g0 = vag(x)
        p = sign * g0
        dg0 = -abs(float((g0 * p).sum()))
        kw = {}
        if mode in ("lean", "along"):
            kw["value"] = f
        if mode == "along":
            kw["value_along"] = lambda a, x=x, p=p, f=f: f(x + a * p)
            kw["vag_carry_along"] = lambda a, x=x, p=p, vag=vag: (*vag(x + a * p), 2.0 * a)
        out[lib.__name__] = search(vag, x, p, f0, arr(np.float64(dg0)), max_iters=max_iters, **kw)
    return out["jax.numpy"], out["torch"]


@pytest.mark.parametrize("mode", ["fused", "lean", "along"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_armijo_matches_jax(case, mode):
    rj, rt = run_both(case, mode)
    assert float(rt.alpha) == float(rj.alpha)
    assert bool(rt.ok) == bool(rj.ok)
    assert rt.n_trials == int(rj.n_trials)
    np.testing.assert_allclose(float(rt.f_new), float(rj.f_new), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(rt.g_new.numpy(), np.asarray(rj.g_new), rtol=1e-12, atol=1e-15)
    if mode == "along":
        assert float(rt.carry) == float(rj.carry) == 2.0 * float(rt.alpha)
    a, n = float(rt.alpha), rt.n_trials
    if case == "accept_first":
        assert bool(rt.ok) and n == 1 and a == 1.0
    elif case == "interpolate":   # a quadratic-fit step: not a power of 1/2
        assert bool(rt.ok) and n > 1 and np.log2(a) != round(np.log2(a))
    elif case == "shrink":        # every rejected fit fell outside [0.1a, 0.9a]
        assert bool(rt.ok) and n > 1 and a == 0.5 ** (n - 1)
    else:                          # the last evaluated alpha, not accepted
        assert not bool(rt.ok) and n == CASES[case][3]


def test_max_iters_must_be_positive():
    f, vag = quadratic(torch, 0.5)
    x = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError):
        t_armijo(vag, x, -x, f(x), torch.tensor(-1.0), max_iters=0)
