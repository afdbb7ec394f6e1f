"""The port's MLP objective against the JAX package's, in float64 on the same
numpy inputs. Tolerance rtol 1e-12: both sides run the same f64 arithmetic
and differ only in summation order inside the matmuls and reductions."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_torch.objectives import mlp as tmlp

RTOL = 1e-12
SPECS = [
    ([12, 8, 3], ["relu", "linear"]),
    ([12, 8, 6, 3], ["relu", "tanh", "linear"]),
]


def _case(dims, acts, seed=0, n=40):
    rng = np.random.default_rng(seed)
    js, ts = jmlp.mlp_spec(dims, acts), tmlp.mlp_spec(dims, acts)
    w = rng.normal(size=js.n_params) * 0.5
    p = rng.normal(size=js.n_params) * 0.5
    x = rng.random((n, dims[0]))
    y = np.eye(dims[-1])[rng.integers(0, dims[-1], n)]
    return js, ts, w, p, x, y


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(t, j, rtol=RTOL, atol=1e-14):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dims,acts", SPECS)
@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_apply_loss_and_grad(dims, acts, lam):
    js, ts, w, p, x, y = _case(dims, acts)
    assert ts.n_params == js.n_params and list(ts.layer_slices()) == list(js.layer_slices())
    _close(tmlp.mlp_apply(ts, _t(w), _t(x)), jmlp.mlp_apply(js, jnp.asarray(w), jnp.asarray(x)))
    jp, tp = jmlp.mlp_problem(js, lam=lam), tmlp.mlp_problem(ts, lam=lam)
    jaux, taux = (jnp.asarray(x), jnp.asarray(y)), (_t(x), _t(y))
    fj, gj = jp.value_and_grad(jnp.asarray(w), jaux)
    ft, gt = tp.value_and_grad(_t(w), taux)
    _close(ft, fj)
    _close(gt, gj)
    _close(tp.fun(_t(w), taux), jp.fun(jnp.asarray(w), jaux))
    _close(tp.grad(_t(w), taux), jp.grad(jnp.asarray(w), jaux))
    _close(tmlp.mlp_loss(ts, _t(w), _t(x), _t(y), lam),
           jmlp.mlp_loss(js, jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), lam))


@pytest.mark.parametrize("dims,acts", SPECS)
def test_restrict_matches_fun(dims, acts):
    js, ts, w, p, x, y = _case(dims, acts, seed=1)
    tp, jp = tmlp.mlp_problem(ts), jmlp.mlp_problem(js)
    taux, jaux = (_t(x), _t(y)), (jnp.asarray(x), jnp.asarray(y))
    lp = tp.line_prefix
    A, B = lp.init(_t(w), taux), lp.direction(_t(p), taux)
    jA = jp.line_prefix.init(jnp.asarray(w), jaux)
    _close(A, jA)
    restrict = lp.restrict(A, B, _t(w), _t(p), taux)
    line = tp.line_fun(_t(w), _t(p), taux)
    for alpha in (0.0, 0.3, 1.7):
        a = torch.tensor(alpha, dtype=torch.float64)
        ref = tp.fun(_t(w) + a * _t(p), taux)
        _close(restrict(a), ref)
        _close(line(a), ref)
        _close(restrict(a), jp.fun(jnp.asarray(w) + alpha * jnp.asarray(p), jaux))


@pytest.mark.parametrize("dims,acts", SPECS)
def test_vag_restrict_full_matches_jax(dims, acts):
    js, ts, w, p, x, y = _case(dims, acts, seed=2)
    tp, jp = tmlp.mlp_problem(ts), jmlp.mlp_problem(js)
    taux, jaux = (_t(x), _t(y)), (jnp.asarray(x), jnp.asarray(y))
    tl, jl = tp.line_prefix, jp.line_prefix
    A, B = tl.init(_t(w), taux), tl.direction(_t(p), taux)
    jA, jB = jl.init(jnp.asarray(w), jaux), jl.direction(jnp.asarray(p), jaux)
    tfull = tl.vag_restrict_carry(A, B, _t(w), _t(p), taux)
    jfull = jl.vag_restrict_carry(jA, jB, jnp.asarray(w), jnp.asarray(p), jaux)
    tvag = tl.vag_restrict(A, B, _t(w), _t(p), taux)
    for alpha in (0.25, 1.0):
        lt, gt, zt = tfull(torch.tensor(alpha, dtype=torch.float64))
        lj, gj, zj = jfull(jnp.asarray(alpha))
        _close(lt, lj)
        _close(gt, gj)
        _close(zt, zj)
        # the carried prefix is A + alpha*B, the post-step first layer
        _close(zt, tl.init(_t(w) + alpha * _t(p), taux))
        lv, gv = tvag(torch.tensor(alpha, dtype=torch.float64))
        assert torch.equal(lv, lt) and torch.equal(gv, gt)


@pytest.mark.parametrize("dims,acts", SPECS)
def test_evaluate_matches_jax(dims, acts):
    js, ts, w, p, x, y = _case(dims, acts, seed=3)
    et = tmlp.evaluate(ts, _t(w), _t(x), _t(y))
    ej = jmlp.evaluate(js, jnp.asarray(w), jnp.asarray(x), jnp.asarray(y))
    assert et["n"] == ej["n"] and et["correct"] == ej["correct"]
    assert et["accuracy"] == ej["accuracy"]
    np.testing.assert_allclose(et["total_mse"], ej["total_mse"], rtol=RTOL)


def test_params_from_numpy_checks_length():
    ts = tmlp.mlp_spec([12, 8, 3], ["relu", "linear"])
    w = np.random.default_rng(0).normal(size=ts.n_params)
    out = tmlp.params_from_numpy(ts, w, dtype=torch.float64)
    assert out.dtype == torch.float64 and np.array_equal(out.numpy(), w)
    w[0] = 99.0  # a copy, not a view
    assert out[0] != 99.0
    for bad in (w[:-1], np.concatenate([w, [0.0]]), w.reshape(1, -1)):
        with pytest.raises(ValueError):
            tmlp.params_from_numpy(ts, bad)


def test_mlp_init_conventions():
    ts = tmlp.mlp_spec([784, 128, 10], ["relu", "linear"])
    w = tmlp.mlp_init(ts, torch.Generator().manual_seed(0), dtype=torch.float64)
    assert w.shape == (ts.n_params,)
    for (w_off, b_off, d_in, d_out), scale in zip(ts.layer_slices(), (2.0 ** 0.5, 1.0)):
        std = scale * (1.0 / d_in) ** 0.5
        # sample std of >= 1280 draws: within 10% of the convention's
        assert abs(float(w[w_off:b_off].std()) / std - 1.0) < 0.1
    wz = tmlp.mlp_init(ts, torch.Generator().manual_seed(0), bias_init="zeros")
    for _, b_off, _, d_out in ts.layer_slices():
        assert torch.all(wz[b_off:b_off + d_out] == 0)
    again = tmlp.mlp_init(ts, torch.Generator().manual_seed(0), dtype=torch.float64)
    assert torch.equal(w, again)
    with pytest.raises(ValueError):
        tmlp.mlp_init(ts, torch.Generator(), bias_init="ones")


@pytest.mark.parametrize("kw", [
    {"compute_dtype": "bfloat16"}, {"remat": True},
    {"compute_dtype": "bfloat16", "grad_input_dtype": "bfloat16"},
    {"remat": True, "line_input_dtype": "uint8"}, {"remat": True, "fun_input_dtype": "uint8"},
])
def test_unported_options_raise(kw):
    ts = tmlp.mlp_spec([12, 8, 3], ["relu", "linear"])
    with pytest.raises(NotImplementedError):
        tmlp.mlp_problem(ts, **kw)


def test_uint8_input_not_ported():
    """uint8 inputs are ported now (round(x*255), rescaled on the first
    layer's output: the float read of k/255 to rounding); any other integer
    input still raises."""
    ts = tmlp.mlp_spec([12, 8, 3], ["relu", "linear"])
    w = torch.linspace(-1.0, 1.0, ts.n_params, dtype=torch.float64)
    xq = torch.arange(24, dtype=torch.uint8).reshape(2, 12) * 10
    torch.testing.assert_close(tmlp.mlp_apply(ts, w, xq),
                               tmlp.mlp_apply(ts, w, xq.double() / 255.0), rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        tmlp.mlp_apply(ts, w, torch.zeros((2, 12), dtype=torch.int32))
