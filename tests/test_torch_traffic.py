"""The narrow input copies of the MLP objective against the JAX package's, in
f64 on the same numpy inputs:

* ``quantize_pixels`` and ``Problem.prepare`` (bfloat16 and uint8), off-grid
  values, half points and out-of-range values included: equal contents;
* ``fun``, ``value_and_grad`` and the carried line prefix (``init``,
  ``direction``, ``restrict``, ``vag_restrict``, ``vag_restrict_carry``,
  ``line_fun``) under each ``*_input_dtype`` alone and all three together,
  on the prepared aux: rtol 1e-12 (both sides upcast the same narrow values);
* ``mlp_apply`` and ``mlp_batch_problem`` on uint8 batches, the masked
  ragged tail included;
* the ``ValueError`` for integer inputs other than uint8 and for mismatched
  narrow dtypes;
* the prepared copy is made once per problem and data
  (``solvers.common.prepared``): a second solve gets the same tensors.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.solvers import common

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")  # the module, not lbfgs()

DIMS, ACTS = [12, 8, 6, 3], ["relu", "tanh", "linear"]
N = 40


def _data(seed=0, grid=True):
    """x on the k/255 grid (pixel data) or off it, y one-hot, w and p."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (N, DIMS[0])) / 255.0 if grid else rng.random((N, DIMS[0]))
    y = np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], N)]
    n = jmlp.mlp_spec(DIMS, ACTS).n_params
    return x, y, rng.normal(size=n) * 0.5, rng.normal(size=n) * 0.2


def _specs():
    return jmlp.mlp_spec(DIMS, ACTS), tmlp.mlp_spec(DIMS, ACTS)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.itemsize == 2 and a.dtype.kind == "V" else a


def _close(t, j, rtol=1e-12):
    np.testing.assert_allclose(_np(t), np.asarray(j, dtype=_np(t).dtype), rtol=rtol, atol=1e-15)


OFF_GRID = np.array([[-0.3, 0.0, 0.5 / 255, 1.5 / 255, 2.5 / 255, 0.49999, 1.0, 1.2,
                      254.5 / 255, 127.5 / 255, 3.7 / 255, 0.1]])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantize_pixels_matches_jax(dtype):
    """round(x*255) half to even, then clip to [0, 255], as JAX: half points,
    values outside [0, 1] and random off-grid values."""
    rng = np.random.default_rng(1)
    x = np.concatenate([OFF_GRID, rng.uniform(-0.2, 1.2, (5, 12))]).astype(dtype)
    q = tmlp.quantize_pixels(torch.tensor(x))
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jmlp.quantize_pixels(jnp.asarray(x))))
    grid = np.arange(256, dtype=dtype)[None, :] / 255.0  # k/255 round-trips exactly
    np.testing.assert_array_equal(tmlp.quantize_pixels(torch.tensor(grid)).numpy()[0],
                                  np.arange(256))


@pytest.mark.parametrize("narrow", ["bfloat16", "uint8"])
@pytest.mark.parametrize("grid", [True, False])
def test_prepare_matches_jax(narrow, grid):
    """``Problem.prepare`` appends one narrow copy of x: equal to JAX's."""
    js, ts = _specs()
    x, y, _, _ = _data(grid=grid)
    if not grid:
        x[:1] = OFF_GRID
    jp = jmlp.mlp_problem(js, line_input_dtype=narrow)
    tp = tmlp.mlp_problem(ts, line_input_dtype=narrow)
    jx = jp.prepare((jnp.asarray(x), jnp.asarray(y)))
    tx = tp.prepare((torch.tensor(x), torch.tensor(y)))
    assert len(tx) == len(jx) == 3
    assert tx[2].dtype == getattr(torch, narrow)
    np.testing.assert_array_equal(_np(tx[2]), np.asarray(jx[2]).astype(_np(tx[2]).dtype))
    assert tx[0] is not tx[2] and torch.equal(tx[0], torch.tensor(x))
    assert tmlp.mlp_problem(ts).prepare is None


# which options, as (grad, line, fun)
OPTIONS = {"grad": ("N", None, None), "line": (None, "N", None), "fun": (None, None, "N"),
           "all": ("N", "N", "N")}


@pytest.mark.parametrize("lam", [0.0, 1e-3])
@pytest.mark.parametrize("which", sorted(OPTIONS))
@pytest.mark.parametrize("narrow", ["bfloat16", "uint8"])
def test_objective_under_input_dtype_matches_jax(narrow, which, lam):
    """Every callable of the problem on the prepared aux, against JAX's."""
    js, ts = _specs()
    x, y, w, p = _data(seed=2)
    kw = {name: (narrow if v else None) for name, v in
          zip(("grad_input_dtype", "line_input_dtype", "fun_input_dtype"), OPTIONS[which])}
    jp, tp = jmlp.mlp_problem(js, lam=lam, **kw), tmlp.mlp_problem(ts, lam=lam, **kw)
    ja = jp.prepare((jnp.asarray(x), jnp.asarray(y)))
    ta = tp.prepare((torch.tensor(x), torch.tensor(y)))
    jw, jpp, tw, tpp = jnp.asarray(w), jnp.asarray(p), torch.tensor(w), torch.tensor(p)
    _close(tp.fun(tw, ta), jp.fun(jw, ja))
    (tf, tg), (jf, jg) = tp.value_and_grad(tw, ta), jp.value_and_grad(jw, ja)
    _close(tf, jf)
    _close(tg, jg)
    if which in ("fun", "all") and narrow == "bfloat16":  # the narrow read, not raw x
        assert abs(float(tp.fun(tw, ta)) - float(tp.fun(tw, ta[:2]))) > 0
    jl, tlp = jp.line_prefix, tp.line_prefix
    jA, tA = jl.init(jw, ja), tlp.init(tw, ta)
    jB, tB = jl.direction(jpp, ja), tlp.direction(tpp, ta)
    _close(tA, jA)
    _close(tB, jB)
    for alpha in (0.0, 0.37, 1.0):
        ja_, ta_ = jnp.asarray(alpha, jnp.float64), torch.tensor(alpha, dtype=torch.float64)
        _close(tlp.restrict(tA, tB, tw, tpp, ta)(ta_), jl.restrict(jA, jB, jw, jpp, ja)(ja_))
        _close(tp.line_fun(tw, tpp, ta)(ta_), jp.line_fun(jw, jpp, ja)(ja_))
        for got, want in zip(tlp.vag_restrict(tA, tB, tw, tpp, ta)(ta_),
                             jl.vag_restrict(jA, jB, jw, jpp, ja)(ja_)):
            _close(got, want)
        for got, want in zip(tlp.vag_restrict_carry(tA, tB, tw, tpp, ta)(ta_),
                             jl.vag_restrict_carry(jA, jB, jw, jpp, ja)(ja_)):
            _close(got, want)


@pytest.mark.parametrize("prefix", ["bfloat16", None])
def test_restrictions_upcast_a_narrow_prefix(prefix):
    """A bf16 prefix (A, B) is combined in the solver dtype, as JAX promotes
    bf16 + f64 scalar * bf16 to f64: restrict, vag_restrict and the carry
    against JAX's on the same narrow A and B; the carried z1 is f64."""
    js, ts = _specs()
    x, y, w, p = _data(seed=3)
    jp, tp = jmlp.mlp_problem(js), tmlp.mlp_problem(ts)
    ja, ta = (jnp.asarray(x), jnp.asarray(y)), (torch.tensor(x), torch.tensor(y))
    jw, jpp, tw, tpp = jnp.asarray(w), jnp.asarray(p), torch.tensor(w), torch.tensor(p)
    jA, jB = jp.line_prefix.init(jw, ja), jp.line_prefix.direction(jpp, ja)
    tA, tB = tp.line_prefix.init(tw, ta), tp.line_prefix.direction(tpp, ta)
    if prefix:
        jA, jB = jA.astype(jnp.bfloat16), jB.astype(jnp.bfloat16)
        tA, tB = tA.to(torch.bfloat16), tB.to(torch.bfloat16)
    a_j, a_t = jnp.asarray(0.625, jnp.float64), torch.tensor(0.625, dtype=torch.float64)
    _close(tp.line_prefix.restrict(tA, tB, tw, tpp, ta)(a_t),
           jp.line_prefix.restrict(jA, jB, jw, jpp, ja)(a_j))
    tf, tg, tz = tp.line_prefix.vag_restrict_carry(tA, tB, tw, tpp, ta)(a_t)
    jf, jg, jz = jp.line_prefix.vag_restrict_carry(jA, jB, jw, jpp, ja)(a_j)
    assert tz.dtype == torch.float64 and jz.dtype == jnp.float64
    for got, want in ((tf, jf), (tg, jg), (tz, jz)):
        _close(got, want)


def test_relu_tie_gradient_is_jaxs():
    """On a narrow prefix, z1 = A + alpha*B is exactly 0 wherever A and
    -alpha*B are the same bf16 value; there the first relu's derivative is
    JAX's 0.5 (``jnp.maximum``), not ``torch.relu``'s 0: the restriction's
    value and gradient equal JAX's on such A and B."""
    import jax

    js, ts = _specs()
    x, y, w, p = _data(seed=6)
    jp, tp = jmlp.mlp_problem(js), tmlp.mlp_problem(ts)
    ta = (torch.tensor(x), torch.tensor(y))
    tw, tpp = torch.tensor(w), torch.tensor(p)
    A = tp.line_prefix.init(tw, ta).to(torch.bfloat16)
    B = tp.line_prefix.direction(tpp, ta).to(torch.bfloat16)
    B[:, :3] = -A[:, :3]  # alpha = 1: exact zeros in three units of every row
    ja = (jnp.asarray(x), jnp.asarray(y))
    jA, jB = jnp.asarray(A.float().numpy()).astype(jnp.bfloat16), \
        jnp.asarray(B.float().numpy()).astype(jnp.bfloat16)
    one_t, one_j = torch.tensor(1.0, dtype=torch.float64), jnp.asarray(1.0, jnp.float64)
    tf, tg, tz = tp.line_prefix.vag_restrict_carry(A, B, tw, tpp, ta)(one_t)
    jf, jg, _ = jp.line_prefix.vag_restrict_carry(jA, jB, jnp.asarray(w), jnp.asarray(p),
                                                  ja)(one_j)
    assert bool((tz[:, :3] == 0).all())
    _close(tf, jf)
    _close(tg, jg)
    relu = jax.grad(lambda z: jnp.maximum(z, 0.0).sum())(jnp.zeros(3))
    tie = torch.func.grad(lambda z: tmlp._relu_tie(z).sum())(torch.zeros(3))
    np.testing.assert_array_equal(tie.numpy(), np.asarray(relu))


@pytest.mark.parametrize("lam", [0.0, 1e-4])
def test_uint8_batches_match_jax(lam):
    """``mlp_apply`` and ``mlp_batch_problem`` on uint8 batches (the masked
    ragged tail included) against JAX's on the same uint8 batches, and
    against the float read of x/255."""
    js, ts = _specs()
    x, y, w, _ = _data(seed=4)
    xq = np.round(x * 255.0).astype(np.uint8)
    jp, tp = jmlp.mlp_batch_problem(js, lam=lam), tmlp.mlp_batch_problem(ts, lam=lam)
    jw, tw = jnp.asarray(w), torch.tensor(w)
    jx, tx = jnp.asarray(xq), torch.tensor(xq)
    jy, ty = jnp.asarray(y), torch.tensor(y)
    _close(tmlp.mlp_apply(ts, tw, tx), jmlp.mlp_apply(js, jw, jx))
    _close(tmlp.mlp_apply(ts, tw, tx), tmlp.mlp_apply(ts, tw, torch.tensor(xq / 255.0)))
    for name in ("fun", "grad"):
        _close(getattr(tp, name)(tw, tx, ty), getattr(jp, name)(jw, jx, jy))
    mask = (np.arange(N) < N - 7).astype(np.float64)
    for name in ("fun_masked", "grad_masked"):
        _close(getattr(tp, name)(tw, tx, ty, torch.tensor(mask)),
               getattr(jp, name)(jw, jx, jy, jnp.asarray(mask)))
    (tf, tg), (jf, jg) = tp.value_and_grad(tw, tx, ty), jp.value_and_grad(jw, jx, jy)
    _close(tf, jf)
    _close(tg, jg)
    take = torch.tensor([3, 0, 17, 39])
    xb, yb = tmlp.take_batch(tx, ty, take)
    assert xb.dtype == torch.uint8 and torch.equal(xb, tx[take])


@pytest.mark.parametrize("bad", [np.int32, np.int8, np.int64])
def test_integer_inputs_other_than_uint8_raise(bad):
    js, ts = _specs()
    x, _, w, _ = _data()
    xi = np.round(x * 255.0).astype(bad)
    for apply, arr, spec, wv in ((tmlp.mlp_apply, torch.tensor, ts, torch.tensor(w)),
                                 (jmlp.mlp_apply, jnp.asarray, js, jnp.asarray(w))):
        with pytest.raises(ValueError, match="uint8"):
            apply(spec, wv, arr(xi))


@pytest.mark.parametrize("kw", [
    {"grad_input_dtype": "bfloat16", "line_input_dtype": "uint8"},
    {"line_input_dtype": "uint8", "fun_input_dtype": "bfloat16"},
    {"grad_input_dtype": "int8"},
    {"fun_input_dtype": "int32"},
])
def test_narrow_dtypes_must_agree_and_be_uint8_integers(kw):
    """Mismatched narrow dtypes and integer copies other than uint8 raise
    ``ValueError`` in both packages."""
    js, ts = _specs()
    with pytest.raises(ValueError):
        jmlp.mlp_problem(js, **kw)
    with pytest.raises(ValueError):
        tmlp.mlp_problem(ts, **kw)


def test_prepared_copy_is_made_once_per_problem_and_data():
    """``prepared`` hands back the same prepared tensors for the same problem
    and data (so a second captured solve finds its graph), a new copy after
    the cache is cleared, for other data, for another problem, or after an
    in-place change of x; a problem without ``prepare`` gets aux itself."""
    _, ts = _specs()
    x, y, _, _ = _data()
    aux = (torch.tensor(x), torch.tensor(y))
    tp = tmlp.mlp_problem(ts, line_input_dtype="uint8")
    common.clear_graph_cache()
    a1 = common.prepared(tp, aux)
    a2 = common.prepared(tp, aux)
    assert a1 is a2 and a1[2] is a2[2] and a1[0] is aux[0]
    assert common.prepared(tp, (aux[0].clone(), aux[1]))[2] is not a1[2]
    assert common.prepared(tmlp.mlp_problem(ts, line_input_dtype="uint8"), aux)[2] is not a1[2]
    plain = tmlp.mlp_problem(ts)
    assert common.prepared(plain, aux) is aux
    common.clear_graph_cache()
    a3 = common.prepared(tp, aux)
    assert a3[2] is not a1[2] and torch.equal(a3[2], a1[2])
    aux[0].mul_(0.5)  # in place: the old copy is stale
    a4 = common.prepared(tp, aux)
    assert a4[2] is not a3[2] and torch.equal(a4[2], tmlp.quantize_pixels(aux[0]))
    common.clear_graph_cache()


@pytest.mark.parametrize("solve", ["lbfgs", "lbfgs_chunked", "gd", "gd_loop", "lbfgs_loop"])
def test_solves_prepare_once_per_data(solve):
    """Two solves of a problem with a ``prepare`` on the same data call it
    once: the second gets the first's narrow copy."""
    from lbfgs_ffnn_torch.solvers import gd as tgd

    _, ts = _specs()
    x, y, w, _ = _data()
    aux = (torch.tensor(x), torch.tensor(y))
    base = tmlp.mlp_problem(ts, grad_input_dtype="uint8", line_input_dtype="uint8",
                            fun_input_dtype="uint8")
    calls = []

    def prepare(a):
        calls.append(1)
        return base.prepare(a)

    tp = base._replace(prepare=prepare)
    run = {"lbfgs": lambda: tl.lbfgs(tp, torch.tensor(w), aux,
                                     tl.LBFGSOptions(max_iters=3, line_search="armijo")),
           "lbfgs_chunked": lambda: tl.lbfgs_chunked(tp, torch.tensor(w), aux,
                                                     tl.LBFGSOptions(max_iters=3), chunk=2),
           "lbfgs_loop": lambda: tl._lbfgs_loop(tp, torch.tensor(w), aux,
                                                tl.LBFGSOptions(max_iters=3)),
           "gd": lambda: tgd.gradient_descent(tp, torch.tensor(w), aux,
                                              tgd.GDOptions(max_iters=3)),
           "gd_loop": lambda: tgd._gd_loop(tp, torch.tensor(w), aux,
                                           tgd.GDOptions(max_iters=3))}[solve]
    common.clear_graph_cache()
    run()
    run()
    assert len(calls) == 1
    common.clear_graph_cache()
    run()
    assert len(calls) == 2
    common.clear_graph_cache()


def test_sgd_streaming_reads_uint8_batches():
    """A streamer over uint8 x hands uint8 batches (a quarter of the bytes),
    and ``sgd_streaming`` trains on them as on the float batches x/255."""
    from lbfgs_ffnn_torch.runtime.streamer import BatchStreamer
    from lbfgs_ffnn_torch.solvers.sgd import SGDOptions, sgd_streaming

    _, ts = _specs()
    x, y, w, _ = _data(seed=5)
    xq = np.round(x * 255.0).astype(np.uint8)
    problem = tmlp.mlp_batch_problem(ts)
    opts = SGDOptions(epochs=2, batch_size=16, step_size=0.05, momentum=0.5)
    out = {}
    for name, xs in (("u8", xq), ("f32", (xq / 255.0).astype(np.float32))):
        with BatchStreamer(xs, y, opts.batch_size, seed=3) as s:
            xb = s.next()[0]
            assert xb.dtype == (torch.uint8 if name == "u8" else torch.float32)
        with BatchStreamer(xs, y, opts.batch_size, seed=3) as s:
            out[name] = sgd_streaming(problem, torch.tensor(w, dtype=torch.float32), s, opts)
    assert out["u8"].n_iters == 2
    np.testing.assert_allclose(out["u8"].x.numpy(), out["f32"].x.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["u8"].loss_history.numpy(),
                               out["f32"].loss_history.numpy(), rtol=1e-5)
