"""The out-of-core path on the CPU against the JAX package's
(``lbfgs_ffnn_tpu/data/outofcore.py``, the cases of
``tests/test_outofcore.py``), on seeded numpy data rather than MNIST files:
MLP 784-16-10 in f64, N = 400, ``chunk_rows = 96`` (5 chunks, a ragged
16-row tail), each JAX function run on the JAX ``ChunkStore`` of the same
arrays beside the port's:

* ``ChunkStore`` (sizes, the zero-padded tail and its mask, chunks and
  gathers against JAX's host callbacks);
* ``outofcore_problem`` with and without lambda: f to rtol 1e-12, g to
  1e-10, against JAX's and the in-memory batch problem;
* L-BFGS over the fused-trial problem, 12 iterations: x to 1e-9, losses to
  1e-10, ``n_fevals`` equal;
* ``outofcore_mlp_problem``'s device-resident lean trials under both
  searches and with lambda: ``n_fevals`` and ``n_gevals`` equal to JAX's;
* ``slbfgs(store=)`` over 3 epochs with JAX's indices injected, and its
  guards;
* padding rows filled with NaN change nothing;
* the eager resident body (``lbfgs_chunked``) equals the early-exit loop,
  and a kill-and-resume through a checkpoint file on the out-of-core
  problem (the prefix recomputed from the iterate).
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.data import outofcore as jooc
from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.ops.sampling import sample_without_replacement as j_sample
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions
from lbfgs_ffnn_tpu.solvers.lbfgs import lbfgs as j_lbfgs
from lbfgs_ffnn_tpu.solvers.slbfgs import SLBFGSOptions as JSOptions
from lbfgs_ffnn_tpu.solvers.slbfgs import slbfgs as j_slbfgs
from lbfgs_ffnn_torch import checkpoint as cp
from lbfgs_ffnn_torch.data import outofcore as tooc
from lbfgs_ffnn_torch.objectives import mlp as tmlp

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")

DIMS, ACTS = [784, 16, 10], ["relu", "linear"]
N, ROWS = 400, 96
SPEC_T = tmlp.mlp_spec(DIMS, ACTS)
SPEC_J = jmlp.mlp_spec(DIMS, ACTS)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (N, DIMS[0])) / 255.0
    y = np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], N)]
    w0 = rng.normal(size=SPEC_T.n_params) * np.sqrt(2.0 / DIMS[0])
    return x, y, w0


X, Y, W0 = _data()
J_STORE = jooc.ChunkStore(X, Y, chunk_rows=ROWS)


@functools.lru_cache(maxsize=None)
def _store(nan_padding=False):
    st = tooc.ChunkStore(X, Y, ROWS, device="cpu")
    if nan_padding:
        st._x_pad[N:] = float("nan")
        st._y_pad[N:] = float("nan")
    return st


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def test_chunk_store_matches_jax():
    st = _store()
    assert (st.n, st.chunk_rows, st.num_chunks) == (J_STORE.n, J_STORE.chunk_rows,
                                                    J_STORE.num_chunks) == (400, 96, 5)
    for c in range(st.num_chunks):
        xb, yb, m = st.fetch_chunk(c)
        jx, jy, jm = J_STORE._chunk_np(c)
        assert torch.equal(xb, _t(jx)) and torch.equal(yb, _t(jy)) and torch.equal(m, _t(jm))
    assert int(st.fetch_chunk(4)[2].sum()) == 16  # the ragged tail
    idx = np.array([399, 0, 5, 5, 305, 384])  # repeats, the tail's rows
    xb, yb = st.fetch_rows(torch.tensor(idx))
    jx, jy = J_STORE._rows_np(idx)
    assert torch.equal(xb, _t(jx)) and torch.equal(yb, _t(jy))
    assert tooc.ChunkStore(X, Y, 1000, device="cpu").chunk_rows == N  # capped at n
    with pytest.raises(ValueError, match="length mismatch"):
        tooc.ChunkStore(X, Y[:-1], ROWS, device="cpu")


@pytest.mark.parametrize("lam", [0.0, 1e-3])
@pytest.mark.parametrize("nan_padding", [False, True])
def test_outofcore_problem_matches_jax(lam, nan_padding):
    """f to rtol 1e-12 and g to 1e-10 against JAX's out-of-core problem and
    the in-memory batch problem; NaN in the padding rows changes nothing."""
    tb, jb = tmlp.mlp_batch_problem(SPEC_T, lam=lam), jmlp.mlp_batch_problem(SPEC_J, lam=lam)
    tp = tooc.outofcore_problem(tb, _store(nan_padding))
    jp = jooc.outofcore_problem(jb, J_STORE)
    w = _t(W0)
    f, g = tp.value_and_grad(w, ())
    jf, jg = jp.value_and_grad(jnp.asarray(W0), ())
    rf, rg = tb.value_and_grad(w, _t(X), _t(Y))
    for ref_f, ref_g in ((np.asarray(jf), np.asarray(jg)), (rf.numpy(), rg.numpy())):
        np.testing.assert_allclose(float(f), ref_f, rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(float(tp.fun(w, ())), float(jf), rtol=1e-12)
    np.testing.assert_allclose(tp.grad(w, ()).numpy(), np.asarray(jg), rtol=1e-10, atol=1e-14)
    assert torch.isfinite(g).all()


def _assert_same_trajectory(res, jres, iters):
    assert res.n_iters == int(jres.n_iters) == iters
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(res.loss_history[:iters].numpy(),
                               np.asarray(jres.loss_history[:iters]), rtol=1e-10)
    assert res.n_fevals == int(jres.n_fevals)


def test_lbfgs_outofcore_trajectory_matches_jax():
    """The fused-trial policy (the plain adapter has no line restriction)."""
    kw = dict(max_iters=12, tol=1e-14, m=5, prefix_vag=False, ls_value_only=False)
    res = tl.lbfgs(tooc.outofcore_problem(tmlp.mlp_batch_problem(SPEC_T), _store()), _t(W0), (),
                   tl.LBFGSOptions(**kw))
    jres = j_lbfgs(jooc.outofcore_problem(jmlp.mlp_batch_problem(SPEC_J), J_STORE),
                   jnp.asarray(W0), aux=(), opts=JOptions(**kw))
    _assert_same_trajectory(res, jres, 12)


@pytest.mark.parametrize("line_search,lam,iters", [("armijo", 0.0, 12), ("wolfe", 0.0, 12),
                                                    ("armijo", 1e-3, 8)])
def test_outofcore_mlp_lean_trials_match_jax(line_search, lam, iters):
    """The carried (N, d1) prefix on the device: the trial sequence and the
    lean accounting (trials + one value_and_grad an iteration) are JAX's."""
    kw = dict(max_iters=iters, tol=1e-14, m=5 if iters == 12 else 4, line_search=line_search,
              prefix_vag=False)
    res = tl.lbfgs(tooc.outofcore_mlp_problem(SPEC_T, _store(), lam=lam), _t(W0), (),
                   tl.LBFGSOptions(**kw))
    jres = j_lbfgs(jooc.outofcore_mlp_problem(SPEC_J, J_STORE, lam=lam), jnp.asarray(W0),
                   aux=(), opts=JOptions(**kw))
    _assert_same_trajectory(res, jres, iters)
    assert res.n_gevals == int(jres.n_gevals)


def test_nan_padding_changes_nothing_in_a_solve():
    opts = tl.LBFGSOptions(max_iters=6, tol=1e-14, m=4, line_search="armijo")
    a = tl.lbfgs(tooc.outofcore_mlp_problem(SPEC_T, _store()), _t(W0), (), opts)
    b = tl.lbfgs(tooc.outofcore_mlp_problem(SPEC_T, _store(True)), _t(W0), (), opts)
    assert torch.equal(a.x, b.x) and torch.equal(a.loss_history, b.loss_history)
    assert (a.n_fevals, a.n_gevals) == (b.n_fevals, b.n_gevals)


def test_eager_resident_body_equals_early_exit_loop():
    """``lbfgs_chunked`` on the CPU runs the resident body (masked writes):
    on the out-of-core problem it takes the early-exit loop's counters and
    trajectory."""
    opts = tl.LBFGSOptions(max_iters=10, tol=1e-14, m=5, line_search="armijo")
    prob = tooc.outofcore_mlp_problem(SPEC_T, _store())
    loop = tl._lbfgs_loop(prob, _t(W0), (), opts)
    body, _ = tl.lbfgs_chunked(prob, _t(W0), (), opts, chunk=4)
    assert (body.n_iters, body.n_fevals, body.n_gevals) == (loop.n_iters, loop.n_fevals,
                                                            loop.n_gevals)
    np.testing.assert_allclose(body.loss_history.numpy(), loop.loss_history.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(body.x.numpy(), loop.x.numpy(), rtol=1e-11, atol=1e-14)


def test_lbfgs_chunked_kill_and_resume_out_of_core(tmp_path):
    """Saved at the first callback with k >= 6 and resumed with x0=None on
    the out-of-core problem: the prefix A (the padded rows, (480, 16)) is
    recomputed by a chunk sweep from the restored iterate, so the resumed
    run follows the uninterrupted one to rounding."""
    opts = tl.LBFGSOptions(max_iters=15, tol=1e-14, m=5, line_search="armijo")
    prob = tooc.outofcore_mlp_problem(SPEC_T, _store())
    full, _ = tl.lbfgs_chunked(prob, _t(W0), (), opts, chunk=3)
    kept = {}

    def cb(state, _elapsed):
        if int(state.k) >= 6 and not kept:
            cp.save_checkpoint(tmp_path / "mid", state)
            kept["t"] = state._replace(**{f: torch.zeros_like(getattr(state, f))
                                          for f in ("x", "g", "prefix")})
            raise KeyboardInterrupt  # the kill

    with pytest.raises(KeyboardInterrupt):
        tl.lbfgs_chunked(prob, _t(W0), (), opts, chunk=3, callback=cb)
    restored = cp.restore_checkpoint(tmp_path / "mid", kept["t"])
    assert int(restored.k) == 6 and restored.prefix.shape == (480, 16)
    resumed, time_ms = tl.lbfgs_chunked(prob, None, (), opts, chunk=3, resume_state=restored)
    assert (resumed.n_iters, resumed.n_fevals, resumed.n_gevals) == (full.n_iters, full.n_fevals,
                                                                      full.n_gevals)
    np.testing.assert_allclose(resumed.loss_history.numpy(), full.loss_history.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(resumed.x.numpy(), full.x.numpy(), rtol=1e-9, atol=1e-13)
    assert np.isnan(time_ms[:6]).all()


class JaxIndices:
    """JAX's S-LBFGS index draws for ``jopts`` over N samples (its fold_in
    keys, as ``tests/test_torch_slbfgs.py::JaxIndices`` draws them), as a
    sampler of the port."""

    def __init__(self, jopts):
        b, m_inner, b_h = tsl._sizes(jopts, N)
        nb = (m_inner - 1) // jopts.L
        key = jax.random.PRNGKey(jopts.seed)
        E = jopts.epochs
        steps = np.zeros((E, m_inner, b), np.int64)
        hvps = np.zeros((E, max(nb, 1), b_h), np.int64)
        anchors = np.zeros(E, np.int64)
        for e in range(E):
            ke = jax.random.fold_in(key, e)
            for t in range(m_inner):
                kt = jax.random.fold_in(ke, t)
                steps[e, t] = np.asarray(j_sample(jax.random.fold_in(kt, 0), N, b,
                                                  jopts.sampler))
            for k in range(nb):
                kt = jax.random.fold_in(ke, (k + 1) * jopts.L)
                hvps[e, k] = np.asarray(j_sample(jax.random.fold_in(kt, 1), N, b_h,
                                                 jopts.sampler))
            count = min(m_inner + 1, jopts.L + 1)
            anchors[e] = int(jax.random.randint(jax.random.fold_in(ke, 2 ** 20), (), 0,
                                                max(count - 1, 1)))
        self.L, self.E = jopts.L, E
        self.steps, self.hvps, self.anchors = map(torch.tensor, (steps, hvps, anchors))

    def _row(self, table, epoch):
        return table.index_select(0, torch.clamp(epoch.long(), max=self.E - 1).view(1))[0]

    def batches(self, epoch, t, count):
        return self._row(self.steps, epoch).index_select(0, t + torch.arange(count))

    def hvp_batch(self, epoch, t):
        k = torch.as_tensor(t).view(1) // self.L - 1
        return self._row(self.hvps, epoch).index_select(0, k)[0]

    def anchor(self, epoch, count):
        return self._row(self.anchors, epoch)


def test_slbfgs_store_matches_jax():
    """The flagship with the anchor summed over chunks and the minibatches
    gathered from the store, JAX's index streams injected: the anchor to
    rtol 1e-9, losses to 1e-10, gnorms to 1e-9 (JAX's own out-of-core
    gates), and the in-memory run with the same streams beside it."""
    kw = dict(epochs=3, tol=1e-12, history=4, L=3, batch_size=64, step_size=0.05)
    tb = tmlp.mlp_batch_problem(SPEC_T, lam=1e-4)
    jres = j_slbfgs(jmlp.mlp_batch_problem(SPEC_J, lam=1e-4), jnp.asarray(W0), None, None,
                    JSOptions(**kw), store=J_STORE)
    indices = JaxIndices(JSOptions(**kw))
    res = tsl.slbfgs(tb, _t(W0), None, None, tsl.SLBFGSOptions(**kw), store=_store(),
                     sampler=indices)
    mem = tsl.slbfgs(tb, _t(W0), _t(X), _t(Y), tsl.SLBFGSOptions(**kw), sampler=indices)
    for ref in (jres, mem):
        assert res.n_iters == int(ref.n_iters) == 3
        np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-9, atol=1e-13)
        np.testing.assert_allclose(res.loss_history.numpy(), np.asarray(ref.loss_history),
                                   rtol=1e-10)
        np.testing.assert_allclose(res.gnorm_history.numpy(), np.asarray(ref.gnorm_history),
                                   rtol=1e-9)


def test_slbfgs_store_guardrails():
    tb = tmlp.mlp_batch_problem(SPEC_T)
    w = _t(W0)
    with pytest.raises(ValueError, match="x=y=None"):
        tsl.slbfgs(tb, w, _t(X), _t(Y), tsl.SLBFGSOptions(epochs=1), store=_store())
    with pytest.raises(ValueError, match="metric_fn"):
        tsl.slbfgs(tb, w, None, None,
                   tsl.SLBFGSOptions(epochs=1, metric_fn=lambda w, x, y: 0.0), store=_store())
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsl.slbfgs(tb, w, None, None, tsl.SLBFGSOptions(epochs=1), mesh=object(),
                   store=_store())
    assert "store" not in tsl.slbfgs_chunked.__code__.co_varnames  # JAX's has none either
