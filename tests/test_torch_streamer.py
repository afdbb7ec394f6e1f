"""The port's BatchStreamer and sgd_streaming against the JAX package's, on
the CPU:

* three epochs of batches, with ``drop_last`` both ways, bitwise equal to
  JAX's ``BatchStreamer(force_fallback=True)`` (its numpy stream), the rows
  past a short batch's count zero;
* ``sgd_streaming`` fed by the port's streamer against JAX's fed by the JAX
  fallback streamer, in f32 (each package's own f32 arithmetic): the loss
  and gradient-norm histories and the final loss to rtol 1e-6, with and
  without ``full_eval_fn``; and the zero-epoch case;
* the streamer's checks, its close and its producer's failure.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.runtime.streamer import BatchStreamer as JStreamer
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.runtime import BatchStreamer

jsgd = importlib.import_module("lbfgs_ffnn_tpu.solvers.sgd")
tsgd = importlib.import_module("lbfgs_ffnn_torch.solvers.sgd")

DIMS, ACTS = [6, 5, 3], ["relu", "linear"]
N, B = 45, 8  # a short last batch of 5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, DIMS[0])).astype(np.float32)
    y = np.eye(DIMS[-1], dtype=np.float32)[rng.integers(0, DIMS[-1], N)]
    w0 = (rng.normal(size=tmlp.mlp_spec(DIMS, ACTS).n_params) * 0.4).astype(np.float32)
    return x, y, w0


X, Y, W0 = _data()


@pytest.mark.parametrize("drop_last", [False, True])
def test_stream_equals_jax_fallback(drop_last):
    j = JStreamer(X, Y, B, seed=5, drop_last=drop_last, force_fallback=True)
    short = 0
    with BatchStreamer(X, Y, B, seed=5, drop_last=drop_last, depth=3) as t:
        while True:
            jx, jy, jc, je = j.next()
            tx, ty, tc, te = t.next()
            assert (tc, te) == (jc, je)
            assert tx.dtype == torch.float32 and tx.shape == (B, DIMS[0])
            assert np.array_equal(tx.numpy(), jx) and np.array_equal(ty.numpy(), jy)
            if tc < B:
                short += 1
                assert not tx[tc:].any() and not ty[tc:].any()
            if te == 3:
                break
    assert short == (0 if drop_last else 3)


def _problems():
    return (jmlp.mlp_batch_problem(jmlp.mlp_spec(DIMS, ACTS)),
            tmlp.mlp_batch_problem(tmlp.mlp_spec(DIMS, ACTS)))


@pytest.mark.parametrize("full_eval", [False, True])
def test_sgd_streaming_matches_jax(full_eval):
    jp, tp = _problems()
    kw = dict(epochs=3, batch_size=B, step_size=0.1, momentum=0.9, lr_decay=0.5,
              lr_decay_step=2)
    jx, jy, tx, ty = jnp.asarray(X), jnp.asarray(Y), torch.tensor(X), torch.tensor(Y)
    j_eval = t_eval = None
    if full_eval:
        def j_eval(w):
            return jp.fun(w, jx, jy), jnp.linalg.norm(jp.grad(w, jx, jy))

        def t_eval(w):
            return tp.fun(w, tx, ty), torch.linalg.norm(tp.grad(w, tx, ty))

    rj = jsgd.sgd_streaming(jp, jnp.asarray(W0), JStreamer(X, Y, B, seed=5, force_fallback=True),
                            jsgd.SGDOptions(**kw), full_eval_fn=j_eval)
    with BatchStreamer(X, Y, B, seed=5) as st:
        rt = tsgd.sgd_streaming(tp, torch.tensor(W0), st, tsgd.SGDOptions(**kw),
                                full_eval_fn=t_eval)
    assert rt.n_iters == int(rj.n_iters) == 3 and not bool(rt.converged)
    for name in ("loss_history", "gnorm_history", "final_loss", "final_gnorm"):
        np.testing.assert_allclose(np.asarray(getattr(rt, name)), np.asarray(getattr(rj, name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-6, atol=1e-6)
    assert bool(torch.isnan(rt.gnorm_history).all()) != full_eval


def test_sgd_streaming_zero_epochs():
    _, tp = _problems()
    with BatchStreamer(X, Y, B) as st:
        r = tsgd.sgd_streaming(tp, torch.tensor(W0), st, tsgd.SGDOptions(epochs=0))
    assert r.n_iters == 0 and r.loss_history.shape == (0,) and bool(torch.isnan(r.final_loss))
    assert torch.equal(r.x, torch.tensor(W0))


def test_streamer_checks_closes_and_reports():
    with pytest.raises(ValueError):
        BatchStreamer(X, Y[:-1], B)
    with pytest.raises(ValueError):
        BatchStreamer(X, Y, B, depth=0)
    st = BatchStreamer(X, Y, 100)  # the batch clamps to n
    assert st.batch_size == N and not st.pinned
    assert st.next()[2] == N
    st.close()
    st.close()  # idempotent
    with pytest.raises(RuntimeError):
        st.next()
    bad = BatchStreamer(X, Y, B, depth=2)
    bad._x = None  # the producer's next gather fails on it
    with pytest.raises(RuntimeError, match="producer failed"):
        for _ in range(4):
            bad.next()
    bad.close()
