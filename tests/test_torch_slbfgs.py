"""S-LBFGS on the CPU against the JAX package, in f64:

* ``BatchProblem`` (fun, grad, value_and_grad, hvp, fd_hvp and the masked
  pair) and ``mlp_batch_problem`` against JAX's at 1e-12;
* the sampler: distinct indices in range, a function of (seed, epoch, step)
  whether the epoch is a Python int or a tensor, "topk" and "sort" equal,
  its stream pinned, and uniform by a chi-squared check;
* ``slbfgs`` and ``slbfgs_chunked`` (the resident epoch run eagerly, its
  writes masked) against JAX's ``slbfgs`` and its per-epoch chunks
  (``_cached_chunk_fns``) with JAX's own indices passed in through a table
  sampler: the anchor after every epoch to rtol 1e-9, atol 1e-12,
  ``n_iters`` equal, loss and gnorm histories to rtol 1e-10, at chunks 1, 3
  and 7 with ``epochs`` no multiple of them; the bf16 ring, the "fd" HVP,
  the relative curvature gate, the compact two-loop and epochs of 3, 4, 8
  and 17 inner steps (no pair; one; segments and a tail); a stop on ``tol``
  inside a chunk; a run resumed from a JAX state after 3 epochs
  (``slbfgs_state_from_numpy``); the host-sync bound and the time column.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives.mlp import mlp_batch_problem as j_batch_problem
from lbfgs_ffnn_tpu.ops.sampling import sample_without_replacement as j_sample
from lbfgs_ffnn_tpu.solvers.slbfgs import SLBFGSOptions as JOptions
from lbfgs_ffnn_tpu.solvers.slbfgs import _cached_chunk_fns, _finalize_state
from lbfgs_ffnn_tpu.solvers.slbfgs import slbfgs as j_slbfgs
from lbfgs_ffnn_tpu.types import make_batch_problem as j_make_batch_problem
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.ops.sampling import (
    EpochSampler, sample_without_replacement, stream_key,
)
from lbfgs_ffnn_torch.types import make_batch_problem

tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")  # the module, not slbfgs()

DIMS, ACTS = [16, 12, 8, 4], ["relu", "tanh", "linear"]
N, B, L, M = 96, 24, 3, 5
EPOCHS = 11  # no multiple of any chunk below
SPEC_T = tmlp.mlp_spec(DIMS, ACTS)


def _data(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, DIMS[0]))
    y = np.eye(DIMS[-1])[np.arange(N) % DIMS[-1]]
    w0 = rng.normal(size=SPEC_T.n_params) * 0.3
    return x, y, w0


X, Y, W0 = _data()


@functools.lru_cache(maxsize=None)
def _problems(lam=1e-4):
    from lbfgs_ffnn_tpu.objectives.mlp import mlp_spec as j_spec

    return (j_batch_problem(j_spec(DIMS, ACTS), lam=lam),
            tmlp.mlp_batch_problem(SPEC_T, lam=lam))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# -- BatchProblem -------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.0, 1e-4])
def test_batch_problem_matches_jax(lam):
    jp, tp = _problems(lam)
    rng = np.random.default_rng(5)
    idx = rng.choice(N, B, replace=False)
    v = rng.normal(size=SPEC_T.n_params)
    jxb, jyb = jnp.asarray(X[idx]), jnp.asarray(Y[idx])
    txb, tyb = tmlp.take_batch(_t(X), _t(Y), torch.tensor(idx))
    assert torch.equal(txb, _t(X[idx])) and torch.equal(tyb, _t(Y[idx]))
    jw, tw, jv, tv = jnp.asarray(W0), _t(W0), jnp.asarray(v), _t(v)
    pairs = [(jp.fun(jw, jxb, jyb), tp.fun(tw, txb, tyb)),
             (jp.grad(jw, jxb, jyb), tp.grad(tw, txb, tyb)),
             (jp.hvp(jw, jv, jxb, jyb), tp.hvp(tw, tv, txb, tyb)),
             (jp.fd_hvp(jw, jv, jxb, jyb, eps=1e-4), tp.fd_hvp(tw, tv, txb, tyb, eps=1e-4)),
             (jp.per_sample(jw, jxb, jyb), tp.per_sample(tw, txb, tyb))]
    (jf, jg), (tf, tg) = jp.value_and_grad(jw, jxb, jyb), tp.value_and_grad(tw, txb, tyb)
    pairs += [(jf, tf), (jg, tg)]
    mask = (np.arange(B) % 3 != 0).astype(np.float64)
    xpad = X[idx].copy()
    xpad[mask == 0] = np.nan  # padding rows must not poison the masked pair
    pairs += [(jp.fun_masked(jw, jnp.asarray(xpad), jyb, jnp.asarray(mask)),
               tp.fun_masked(tw, _t(xpad), tyb, _t(mask))),
              (jp.grad_masked(jw, jnp.asarray(xpad), jyb, jnp.asarray(mask)),
               tp.grad_masked(tw, _t(xpad), tyb, _t(mask)))]
    for k, (j, t) in enumerate(pairs):
        # the central difference divides rounding of |g| ~ 1e-16 by 2 eps = 2e-4
        atol = 1e-12 if k == 3 else 1e-14
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=atol)
    assert (tp.reg is None) == (lam == 0.0)


def test_make_batch_problem_matches_jax():
    def per_sample(lib):
        def f(w, xb, yb):
            return lib.sum((xb * w[:4] - yb) ** 2, axis=1) if lib is jnp else \
                torch.sum((xb * w[:4] - yb) ** 2, dim=1)
        return f

    jp = j_make_batch_problem(per_sample(jnp), reg=lambda w: 0.5 * jnp.vdot(w, w))
    tp = make_batch_problem(per_sample(torch), reg=lambda w: 0.5 * torch.dot(w, w))
    rng = np.random.default_rng(2)
    w, v, xb, yb = rng.normal(size=4), rng.normal(size=4), rng.normal(size=(7, 4)), \
        rng.normal(size=(7, 4))
    for name in ("fun", "grad"):
        np.testing.assert_allclose(getattr(tp, name)(_t(w), _t(xb), _t(yb)).numpy(),
                                   np.asarray(getattr(jp, name)(jnp.asarray(w), xb, yb)),
                                   rtol=1e-12)
    np.testing.assert_allclose(tp.hvp(_t(w), _t(v), _t(xb), _t(yb)).numpy(),
                               np.asarray(jp.hvp(jnp.asarray(w), jnp.asarray(v), xb, yb)),
                               rtol=1e-12)


def test_mlp_batch_problem_refuses_unported_inputs():
    """``compute_dtype`` still raises; a uint8 batch (ported) reads as the
    float batch k/255 and a batch of another integer type raises."""
    with pytest.raises(NotImplementedError):
        tmlp.mlp_batch_problem(SPEC_T, compute_dtype="bfloat16")
    tp = tmlp.mlp_batch_problem(SPEC_T)
    xq = torch.arange(2 * DIMS[0], dtype=torch.int64).reshape(2, DIMS[0]) % 256
    np.testing.assert_allclose(
        float(tp.fun(_t(W0), xq.to(torch.uint8), _t(Y[:2]))),
        float(tp.fun(_t(W0), xq.double() / 255.0, _t(Y[:2]))), rtol=1e-12)
    with pytest.raises(ValueError):
        tp.fun(_t(W0), xq.to(torch.int32), _t(Y[:2]))


# -- the sampler --------------------------------------------------------------

@pytest.mark.parametrize("impl", ["topk", "sort"])
@pytest.mark.parametrize("n,size", [(1, 1), (96, 24), (1000, 1000), (60000, 128)])
def test_sampler_draws_distinct_indices_in_range(n, size, impl):
    for epoch in (0, 7):
        for t in (0, 5):
            a = sample_without_replacement(stream_key(123, epoch, t, 0), n, size, impl)
            b = sample_without_replacement(stream_key(123, torch.tensor(epoch, dtype=torch.int32),
                                                      t, 0), n, size, impl)
            assert a.dtype == torch.int64 and a.shape == (size,)
            assert torch.equal(a, b)  # a Python int epoch and a device epoch draw alike
            assert len(set(a.tolist())) == size and 0 <= int(a.min()) and int(a.max()) < n
    assert torch.equal(sample_without_replacement(stream_key(1, 2, 3, 0), n, size, "topk"),
                       sample_without_replacement(stream_key(1, 2, 3, 0), n, size, "sort"))


def test_sampler_streams_differ_and_are_pinned():
    draws = {path: sample_without_replacement(stream_key(123, *path), 1000, 16).tolist()
             for path in [(0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0)]}
    assert len({tuple(d) for d in draws.values()}) == 4
    assert sample_without_replacement(stream_key(124, 0, 0, 0), 1000, 16).tolist() != \
        draws[(0, 0, 0)]
    # the stream is part of what a run reproduces: pinned
    assert stream_key(123, 3, 5, 0) == 244329418
    assert draws[(0, 0, 0)][:4] == sample_without_replacement(
        torch.tensor(stream_key(123, 0, 0, 0)), 1000, 4).tolist()
    # a step's batch is the same whichever block of steps draws it
    s, e = EpochSampler(123, 1000, 16, 8), torch.tensor(2, dtype=torch.int32)
    block = s.batches(e, torch.tensor(5), 3)
    for r in range(3):
        assert torch.equal(block[r], s.batches(e, 5 + r, 1)[0])
        assert torch.equal(block[r], sample_without_replacement(stream_key(123, 2, 5 + r, 0),
                                                                1000, 16))


def test_sampler_is_uniform():
    """Chi-squared over index frequencies and over anchor picks: 4000 draws
    of 10 from 50 (49 degrees of freedom; the bound is ~6 sigma above the
    mean), and 4000 picks in [0, 10)."""
    n, size, draws = 50, 10, 4000
    s = EpochSampler(7, n, size, 5)
    counts = np.zeros(n)
    picks = np.zeros(10)
    for e in range(draws // 4):
        ep = torch.tensor(e, dtype=torch.int32)
        counts += np.bincount(s.batches(ep, e % 13, 4).numpy().ravel(), minlength=n)
    for e in range(draws):
        ep = torch.tensor(e, dtype=torch.int32)
        picks[int(s.anchor(ep, torch.tensor(11)))] += 1
    expect = draws * size / n
    assert np.sum((counts - expect) ** 2 / expect) < 49 + 6 * np.sqrt(2 * 49)
    assert np.sum((picks - draws / 10) ** 2 / (draws / 10)) < 9 + 6 * np.sqrt(2 * 9)
    assert int(s.anchor(torch.tensor(3), torch.tensor(1))) == 0  # one iterate: j = 0


# -- the solver against JAX ---------------------------------------------------

def _opts(**kw):
    # m_inner 8: the start's 4 steps and first pair, a segment (3 steps and a
    # pair), a tail step
    base = dict(epochs=EPOCHS, tol=1e-14, history=M, L=L, batch_size=B, step_size=0.05,
                m_inner=8)
    base.update(kw)
    return base


class JaxIndices:
    """The index draws of JAX's S-LBFGS for ``opts`` (its fold_in keys, as
    tests/test_solver_parity_mlp.py draws them), as a sampler of the port."""

    def __init__(self, jopts):
        b, m_inner, b_h = tsl._sizes(jopts, N)
        nb = (m_inner - 1) // jopts.L
        cap = jopts.L + 1
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
            count = min(m_inner + 1, cap)
            anchors[e] = int(jax.random.randint(jax.random.fold_in(ke, 2 ** 20), (), 0,
                                                max(count - 1, 1)))
        self.L, self.E = jopts.L, E
        self.steps, self.hvps, self.anchors = map(torch.tensor, (steps, hvps, anchors))

    def _row(self, table, epoch):
        # clamped: the masked (eager) epoch past the last one reads in bounds
        return table.index_select(0, torch.clamp(epoch.long(), max=self.E - 1).view(1))[0]

    def batches(self, epoch, t, count):  # t: an int, or a device step in the segments
        return self._row(self.steps, epoch).index_select(0, t + torch.arange(count))

    def hvp_batch(self, epoch, t):
        k = torch.as_tensor(t).view(1) // self.L - 1
        return self._row(self.hvps, epoch).index_select(0, k)[0]

    def anchor(self, epoch, count):
        return self._row(self.anchors, epoch)


@functools.lru_cache(maxsize=None)
def _jax_run(items: tuple):
    """JAX's solve in chunks of one epoch (``_cached_chunk_fns``): its result
    and its anchor after every epoch."""
    jopts = JOptions(**dict(items))
    x, y = jnp.asarray(X), jnp.asarray(Y)
    init, run_chunk = _cached_chunk_fns(_problems()[0], jopts, N, None, "data", 1)
    state, anchors = init(jnp.asarray(W0), x, y), {}
    for _ in range(jopts.epochs):
        state = run_chunk(state, x, y)
        if bool(state.stop):
            break
        anchors[int(state.epoch)] = np.asarray(state.w)
    return _finalize_state(state, jopts), anchors, JaxIndices(jopts)


def _port_run(kw: dict, chunk: int, **extra):
    """The port's slbfgs_chunked with JAX's indices; its anchors by epoch,
    read from the callback after each chunk."""
    jres, janchors, indices = _jax_run(tuple(sorted(kw.items())))
    seen = {}

    def cb(s, _elapsed):
        seen[int(s.epoch)] = s.w.clone().numpy()

    res, time_ms = tsl.slbfgs_chunked(_problems()[1], _t(W0), _t(X), _t(Y),
                                      tsl.SLBFGSOptions(**kw), chunk=chunk, callback=cb,
                                      sampler=indices, **extra)
    return res, time_ms, seen, jres, janchors


def _assert_matches(res, seen, jres, janchors, hist_rtol=1e-10):
    assert res.n_iters == int(jres.n_iters)
    assert bool(res.converged) == bool(jres.converged)
    for e, w in seen.items():
        np.testing.assert_allclose(w, janchors[e], rtol=1e-9, atol=1e-12,
                                   err_msg=f"anchor after epoch {e}")
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-9, atol=1e-12)
    for name in ("loss_history", "gnorm_history"):
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(jres, name)),
                                   rtol=hist_rtol, err_msg=name)
    np.testing.assert_allclose(float(res.final_loss), float(jres.final_loss), rtol=hist_rtol)
    np.testing.assert_allclose(float(res.final_gnorm), float(jres.final_gnorm), rtol=hist_rtol)


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_slbfgs_chunked_matches_jax(chunk):
    res, time_ms, seen, jres, janchors = _port_run(_opts(), chunk)
    assert sorted(seen) == sorted({min(c, EPOCHS) for c in range(chunk, EPOCHS + chunk, chunk)})
    if chunk == 1:
        assert sorted(seen) == list(range(1, EPOCHS + 1))  # every epoch's anchor
    _assert_matches(res, seen, jres, janchors)
    assert res.n_host_syncs <= -(-EPOCHS // chunk) + 2
    assert np.all(np.isfinite(time_ms)) and np.all(np.diff(time_ms) >= 0)
    assert len(np.unique(time_ms)) == -(-EPOCHS // chunk)


def test_slbfgs_matches_jax():
    """slbfgs against JAX's whole solve (one while_loop) and its chunks."""
    kw = _opts()
    jchunks, _, indices = _jax_run(tuple(sorted(kw.items())))
    jres = j_slbfgs(_problems()[0], jnp.asarray(W0), jnp.asarray(X), jnp.asarray(Y),
                    JOptions(**kw))
    res = tsl.slbfgs(_problems()[1], _t(W0), _t(X), _t(Y), tsl.SLBFGSOptions(**kw),
                     sampler=indices)
    _assert_matches(res, {}, jres, {})
    _assert_matches(res, {}, jchunks, {})
    assert res.n_host_syncs <= -(-EPOCHS // tsl.RESIDENT_CHUNK) + 2
    # and the eager body's private entry is the same solve
    eager = tsl._slbfgs_resident_eager(_problems()[1], _t(W0), _t(X), _t(Y),
                                       tsl.SLBFGSOptions(**kw), sampler=indices)
    assert torch.equal(eager.x, res.x) and torch.equal(eager.loss_history, res.loss_history)


@pytest.mark.parametrize("variant", ["bf16_ring", "fd_hvp", "rel_gate", "compact", "m_inner",
                                     "no_pair", "long_epoch"])
def test_slbfgs_variants_match_jax(variant):
    extra = {"bf16_ring": dict(pair_dtype="bfloat16"),
             "fd_hvp": dict(hvp_mode="fd"),  # fd_eps 1e-4, the default
             "rel_gate": dict(curvature_rel_eps=1e-3),
             "compact": dict(two_loop_impl="compact"),
             # N // b = 4 steps: one pair, no segment, no tail
             "m_inner": dict(m_inner=0, hvp_batch_size=30),
             "no_pair": dict(m_inner=3),  # no pair at all: the start, then the finish
             "long_epoch": dict(m_inner=17)}[variant]  # 4 segment replays, a 1-step tail
    kw = _opts(**extra)
    jres, janchors, indices = _jax_run(tuple(sorted(kw.items())))
    seen = {}
    res, _ = tsl.slbfgs_chunked(_problems()[1], _t(W0), _t(X), _t(Y), tsl.SLBFGSOptions(**kw),
                                chunk=3, sampler=indices,
                                callback=lambda s, _e: seen.__setitem__(int(s.epoch),
                                                                        s.w.clone().numpy()))
    _assert_matches(res, seen, jres, janchors)


def test_slbfgs_stops_on_tol_inside_a_chunk():
    """tol just above the gradient norm recorded after some epoch j: the
    next epoch's anchor gradient is that one, so the solve stops there,
    inside a chunk of 7, as JAX's does."""
    full, _, _ = _jax_run(tuple(sorted(_opts().items())))
    gn = np.asarray(full.gnorm_history)
    j = next(j for j in range(3, EPOCHS - 1)
             if (j + 1) % 7 and gn[j] < gn[:j].min())
    kw = _opts(tol=float(gn[j]) * (1 + 1e-6))
    res, time_ms, seen, jres, janchors = _port_run(kw, 7)
    assert int(jres.n_iters) == j + 1 and bool(jres.converged)
    _assert_matches(res, seen, jres, janchors)
    assert bool(torch.isnan(res.loss_history[j + 1:]).all())
    assert np.all(np.isnan(time_ms[j + 1:])) and np.all(np.isfinite(time_ms[:j + 1]))


@pytest.mark.parametrize("pair_dtype", [None, "bfloat16"])
def test_slbfgs_resumes_from_a_jax_state(pair_dtype):
    """JAX's state after 3 epochs, carried over with slbfgs_state_from_numpy
    (its bf16 rows padded to 2048 there, to 384 here), continues in the port
    as JAX's own run does."""
    kw = _opts(pair_dtype=pair_dtype)
    jopts = JOptions(**kw)
    jres, janchors, indices = _jax_run(tuple(sorted(kw.items())))
    jp = _problems()[0]
    init, run_chunk = _cached_chunk_fns(jp, jopts, N, None, "data", 3)
    jstate = run_chunk(init(jnp.asarray(W0), jnp.asarray(X), jnp.asarray(Y)),
                       jnp.asarray(X), jnp.asarray(Y))
    assert int(jstate.epoch) == 3
    state = tmlp.slbfgs_state_from_numpy(SPEC_T, jax.tree.map(np.asarray, jstate),
                                         dtype=torch.float64)
    assert state.hist.S.dtype == (torch.bfloat16 if pair_dtype else torch.float64)
    assert state.hist.S.shape == (M, 384) and int(state.hist.count) == int(jstate.hist.count)
    seen = {}
    res, time_ms = tsl.slbfgs_chunked(
        _problems()[1], None, _t(X), _t(Y), tsl.SLBFGSOptions(**kw), chunk=4,
        resume_state=state, sampler=indices,
        callback=lambda s, _e: seen.__setitem__(int(s.epoch), s.w.clone().numpy()))
    assert sorted(seen) == [7, 11]
    _assert_matches(res, seen, jres, janchors)
    assert np.all(np.isnan(time_ms[:3])) and np.all(np.isfinite(time_ms[3:]))


def test_default_sampler_is_chunk_invariant():
    """The port's own stream: the same draws whatever the chunking, and a
    seed changes them."""
    opts = tsl.SLBFGSOptions(**_opts())
    runs = {c: tsl.slbfgs_chunked(_problems()[1], _t(W0), _t(X), _t(Y), opts, chunk=c)[0]
            for c in (1, 3, 7)}
    for c in (3, 7):
        assert torch.equal(runs[c].x, runs[1].x)
        assert torch.equal(runs[c].loss_history, runs[1].loss_history)
    other = tsl.slbfgs(_problems()[1], _t(W0), _t(X), _t(Y), opts._replace(seed=124))
    assert not torch.equal(other.x, runs[1].x)
    lh = runs[1].loss_history.numpy()
    assert np.all(np.isfinite(lh)) and lh[-1] < float(_problems()[1].fun(_t(W0), _t(X), _t(Y)))


def test_slbfgs_metric_history_matches_jax():
    """metric_fn with a held-out split as metric_args: [train, test]
    accuracy at each epoch's new anchor, JAX's to rtol 1e-12, through the
    chunked driver; the solve itself is unchanged."""
    from lbfgs_ffnn_tpu.objectives.mlp import mlp_apply as j_apply, mlp_spec as j_spec

    rng = np.random.default_rng(11)
    tx, ty = rng.normal(size=(20, DIMS[0])), np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], 20)]

    def j_metric(w, x, y, a, b):
        def acc(u, v):
            pred = jnp.argmax(j_apply(j_spec(DIMS, ACTS), w, u), axis=1)
            return jnp.mean((pred == jnp.argmax(v, axis=1)).astype(w.dtype)) * 100.0
        return jnp.stack([acc(x, y), acc(a, b)])

    def t_metric(w, x, y, a, b):
        def acc(u, v):
            return (tmlp.mlp_apply(SPEC_T, w, u).argmax(1) == v.argmax(1)).to(w.dtype).mean() * 100
        return torch.stack([acc(x, y), acc(a, b)])

    kw = _opts()
    jopts = JOptions(metric_fn=j_metric, **kw)
    jres = j_slbfgs(_problems()[0], jnp.asarray(W0), jnp.asarray(X), jnp.asarray(Y), jopts,
                    metric_args=(jnp.asarray(tx), jnp.asarray(ty)))
    _, _, indices = _jax_run(tuple(sorted(kw.items())))
    res, _ = tsl.slbfgs_chunked(_problems()[1], _t(W0), _t(X), _t(Y),
                                tsl.SLBFGSOptions(metric_fn=t_metric, **kw), chunk=4,
                                sampler=indices, metric_args=(_t(tx), _t(ty)))
    assert res.metric_history.shape == (EPOCHS, 2)
    np.testing.assert_allclose(res.metric_history.numpy(), np.asarray(jres.metric_history),
                               rtol=1e-12)
    _assert_matches(res, {}, jres, {})


def test_slbfgs_refuses_what_is_not_ported():
    p, w, x, y = _problems()[1], _t(W0), _t(X), _t(Y)
    with pytest.raises(NotImplementedError):
        tsl.slbfgs(p, w, x, y, mesh=object())
    with pytest.raises(ValueError, match="x=y=None"):  # store= is ported: JAX's guard
        tsl.slbfgs(p, w, x, y, store=object())
    with pytest.raises(NotImplementedError):
        tsl.slbfgs_chunked(p, w, x, y, mesh=object())
    with pytest.raises(TypeError):
        tsl.SLBFGSOptions(scan_unroll=2)
    with pytest.raises(TypeError):
        tsl.SLBFGSOptions(sampling="global")
    with pytest.raises(ValueError):
        tsl.slbfgs(p, w, x, y, tsl.SLBFGSOptions(two_loop_impl="pallas"))
    with pytest.raises(ValueError):
        tsl.slbfgs_chunked(p, None, x, y)
