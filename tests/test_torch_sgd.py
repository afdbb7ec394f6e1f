"""SGD on the CPU against the JAX package, in f64, on a 6-5-3 MLP with
N = 60:

* ``sgd`` (the epoch's bodies run eagerly, their writes masked) against
  JAX's ``sgd``: sequential sampling with b dividing N and with a ragged
  tail, both with momentum, the lr decay and the relative-improvement stop;
  random sampling with JAX's indices passed in through ``sampler=`` (both
  of JAX's draws); ``record_full=False``; a two-column ``metric_fn`` with a
  held-out split as its operands. Per-epoch loss and gradient-norm
  histories to rtol 1e-9, ``n_iters``, the stop and the final iterate; each
  with segments of 32 steps (one segment per epoch) and of 2 (several
  replays and steps left over);
* ``sgd_chunked`` against JAX's ``sgd_chunked`` at chunk 3, a stop inside a
  chunk, and a resume from a mid-solve state equal to the whole solve;
* the port's own sampler: chunk-invariant, keyed on the seed.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.ops.sampling import sample_without_replacement as j_sample
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.solvers.common import clone

jsgd = importlib.import_module("lbfgs_ffnn_tpu.solvers.sgd")  # the modules, not sgd()
tsgd = importlib.import_module("lbfgs_ffnn_torch.solvers.sgd")

DIMS, ACTS = [6, 5, 3], ["relu", "linear"]
N, N_TEST, EPOCHS = 60, 16, 11
SPEC_T = tmlp.mlp_spec(DIMS, ACTS)
VARIANTS = {
    "sequential": dict(sampling="sequential", batch_size=12, momentum=0.9, lr_decay=0.5,
                       lr_decay_step=3, tol=1e-4),
    "sequential_tail": dict(sampling="sequential", batch_size=7, momentum=0.9, lr_decay=0.5,
                            lr_decay_step=3, tol=1e-4),
    "random": dict(sampling="random", batch_size=7),
    "random_sort": dict(sampling="random", batch_size=8, sampler="sort", momentum=0.5),
    "record_full_off": dict(sampling="random", batch_size=7, record_full=False),
    "metric": dict(sampling="sequential", batch_size=7, momentum=0.9),
}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N + N_TEST, DIMS[0]))
    y = np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], N + N_TEST)]
    return x[:N], y[:N], x[N:], y[N:], rng.normal(size=SPEC_T.n_params) * 0.4


X, Y, TX, TY, W0 = _data()


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _problems():
    return jmlp.mlp_batch_problem(jmlp.mlp_spec(DIMS, ACTS)), tmlp.mlp_batch_problem(SPEC_T)


def _j_metric(w, x, y, tx, ty):  # two columns: train and held-out accuracy
    def acc(a, b):
        pred = jnp.argmax(jmlp.mlp_apply(jmlp.mlp_spec(DIMS, ACTS), w, a), axis=1)
        return jnp.mean((pred == jnp.argmax(b, axis=1)).astype(w.dtype)) * 100.0
    return jnp.stack([acc(x, y), acc(tx, ty)])


def _t_metric(w, x, y, tx, ty):
    def acc(a, b):
        pred = tmlp.mlp_apply(SPEC_T, w, a).argmax(dim=1)
        return (pred == b.argmax(dim=1)).to(w.dtype).mean() * 100.0
    return torch.stack([acc(x, y), acc(tx, ty)])


def _opts(variant, **extra):
    kw = dict(epochs=EPOCHS, step_size=0.1, **VARIANTS[variant])
    kw.update(extra)
    metric = variant == "metric"
    return (jsgd.SGDOptions(metric_fn=_j_metric if metric else None, **kw),
            tsgd.SGDOptions(metric_fn=_t_metric if metric else None, **kw),
            ((jnp.asarray(TX), jnp.asarray(TY)), (_t(TX), _t(TY))) if metric else ((), ()))


class JaxIndices:
    """JAX's random-sampling draws (``fold_in(PRNGKey(seed), epoch * m +
    t)``), as a sampler of the port."""

    def __init__(self, jopts):
        b = min(jopts.batch_size, N)
        m = max(N // b, 1)
        key = jax.random.PRNGKey(jopts.seed)
        self.table = torch.tensor(np.stack([np.stack([
            np.asarray(j_sample(jax.random.fold_in(key, e * m + t), N, b, jopts.sampler))
            for t in range(m)]) for e in range(jopts.epochs)]))

    def batches(self, epoch, t, count):
        # clamped: the masked (eager) epoch past the last one reads in bounds
        row = self.table.index_select(
            0, torch.clamp(epoch.long(), max=self.table.shape[0] - 1).view(1))[0]
        return row.index_select(0, t + torch.arange(count))


def _jax_sgd(jopts, margs):
    return jsgd.sgd(_problems()[0], jnp.asarray(W0), jnp.asarray(X), jnp.asarray(Y), jopts,
                    metric_args=margs)


def _assert_matches(res, rj):
    assert res.n_iters == int(rj.n_iters)
    assert bool(res.converged) == bool(rj.converged)
    for name in ("loss_history", "gnorm_history"):
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(float(res.final_loss), float(rj.final_loss), rtol=1e-9)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-12)
    if rj.metric_history is None:
        assert res.metric_history is None
    else:
        np.testing.assert_allclose(res.metric_history.numpy(), np.asarray(rj.metric_history),
                                   rtol=1e-12)


@pytest.mark.parametrize("segment", [32, 2])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sgd_matches_jax(variant, segment, monkeypatch):
    monkeypatch.setattr(tsgd, "SEGMENT", segment)
    jopts, topts, (jm, tm) = _opts(variant)
    rj = _jax_sgd(jopts, jm)
    sampler = JaxIndices(jopts) if jopts.sampling == "random" else None
    res = tsgd.sgd(_problems()[1], _t(W0), _t(X), _t(Y), topts, metric_args=tm, sampler=sampler)
    _assert_matches(res, rj)
    assert res.n_host_syncs <= -(-EPOCHS // tsgd.RESIDENT_CHUNK) + 2
    if variant == "record_full_off":
        assert bool(torch.isnan(res.gnorm_history).all())
    if variant == "metric":
        assert res.metric_history.shape == (EPOCHS, 2)
        assert bool(torch.isfinite(res.metric_history).all())


def test_sgd_stops_on_tol_inside_a_chunk():
    """tol just above the relative improvement of an epoch j that is the
    smallest so far (the epoch losses from a run without the full record):
    JAX and the port stop after epoch j, inside a chunk of 4, NaN past it."""
    jopts, topts, _ = _opts("sequential_tail", tol=0.0)
    lh = np.asarray(_jax_sgd(jopts._replace(record_full=False), ()).loss_history)
    rel = np.abs(np.diff(lh)) / np.maximum(1.0, np.abs(lh[:-1]))  # rel[j - 1]: epoch j's
    j = next(j for j in range(2, EPOCHS - 1) if (j + 1) % 4 and rel[j - 1] < rel[:j - 1].min())
    tol = float(rel[j - 1]) * (1 + 1e-6)
    rj = _jax_sgd(jopts._replace(tol=tol), ())
    res, time_ms = tsgd.sgd_chunked(_problems()[1], _t(W0), _t(X), _t(Y),
                                    topts._replace(tol=tol), chunk=4)
    assert int(rj.n_iters) == j + 1 and bool(rj.converged)
    _assert_matches(res, rj)
    assert bool(torch.isnan(res.loss_history[j + 1:]).all())
    assert np.all(np.isnan(time_ms[j + 1:])) and np.all(np.isfinite(time_ms[:j + 1]))


@pytest.mark.parametrize("variant", ["sequential_tail", "random"])
def test_sgd_chunked_matches_jax(variant):
    jopts, topts, _ = _opts(variant)
    rj, _ = jsgd.sgd_chunked(_problems()[0], jnp.asarray(W0), jnp.asarray(X), jnp.asarray(Y),
                             jopts, chunk=3)
    sampler = JaxIndices(jopts) if variant == "random" else None
    res, time_ms = tsgd.sgd_chunked(_problems()[1], _t(W0), _t(X), _t(Y), topts, chunk=3,
                                    sampler=sampler)
    _assert_matches(res, rj)
    n = res.n_iters
    assert np.all(np.isfinite(time_ms[:n])) and np.all(np.diff(time_ms[:n]) >= 0)
    assert len(np.unique(time_ms[:n])) == -(-n // 3)


@pytest.mark.parametrize("variant", ["sequential", "metric"])
def test_sgd_resumes_from_a_mid_solve_state(variant):
    """The state after 4 epochs (momentum, decayed lr, the stop test's
    previous loss, the metric rows), carried into a new sgd_chunked: the
    rest equals the whole solve."""
    _, topts, (_, tm) = _opts(variant, tol=0.0)
    kept = {}
    whole, _ = tsgd.sgd_chunked(_problems()[1], _t(W0), _t(X), _t(Y), topts, chunk=2,
                                metric_args=tm,
                                callback=lambda s, _e: kept.setdefault(int(s.epoch), clone(s)))
    state = kept[4]
    if variant == "sequential":
        assert float(state.lr) < topts.step_size  # decayed before epoch 3
    res, time_ms = tsgd.sgd_chunked(_problems()[1], None, _t(X), _t(Y), topts, chunk=3,
                                    resume_state=state, metric_args=tm)
    assert res.n_iters == whole.n_iters == EPOCHS
    assert torch.equal(res.x, whole.x) and torch.equal(res.loss_history, whole.loss_history)
    if variant == "metric":
        assert torch.equal(res.metric_history, whole.metric_history)
    assert np.all(np.isnan(time_ms[:4])) and np.all(np.isfinite(time_ms[4:]))


def test_default_sampler_is_chunk_invariant_and_seeded():
    _, topts, _ = _opts("random")
    p = _problems()[1]
    runs = {c: tsgd.sgd_chunked(p, _t(W0), _t(X), _t(Y), topts, chunk=c)[0] for c in (1, 4)}
    assert torch.equal(runs[1].x, runs[4].x)
    assert torch.equal(runs[1].loss_history, runs[4].loss_history)
    other = tsgd.sgd(p, _t(W0), _t(X), _t(Y), topts._replace(seed=124))
    assert not torch.equal(other.x, runs[1].x)
    lh = runs[1].loss_history.numpy()
    assert np.all(np.isfinite(lh)) and lh[-1] < float(p.fun(_t(W0), _t(X), _t(Y)))


def test_sgd_refuses_bad_options():
    p, w, x, y = _problems()[1], _t(W0), _t(X), _t(Y)
    with pytest.raises(TypeError):  # no counterpart
        tsgd.SGDOptions(scan_unroll=2)
    for bad in (dict(sampling="global"), dict(sampler="gumbel"), dict(epochs=0)):
        with pytest.raises(ValueError):
            tsgd.sgd(p, w, x, y, tsgd.SGDOptions(**bad))
    with pytest.raises(ValueError):
        tsgd.sgd_chunked(p, None, x, y)
    fields = {k: v for k, v in jsgd.SGDOptions()._asdict().items() if k != "scan_unroll"}
    assert tsgd.SGDOptions()._asdict() == fields
