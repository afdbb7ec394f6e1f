"""The port's checkpoint module against the JAX package's
(``lbfgs_ffnn_tpu/checkpoint.py``, ``tests/test_harness_checkpoint.py``),
on the same trees with the same outcomes: the round trip of a solver state
(a bf16 ring comes back bf16), the npz weight files (the same format both
ways), the migration shim's fills, warnings and raises, and errors that
propagate. Then kill-and-resume through a file: ``lbfgs_chunked`` (f32 and
bf16 pairs, with and without the carried prefix, a stale prefix healed, the
grad-input copy), ``slbfgs_chunked``, ``gd_chunked`` and ``sgd_chunked``:
each run is abandoned at the first callback past a point, its state saved
there, restored into a template in the shape of a fresh state and resumed
with ``x0=None``. Where the driver recomputes nothing a resumed run equals
the uninterrupted one bitwise; the L-BFGS runs are also held against JAX's
resumed runs (f64: losses to rtol 1e-9, x to 1e-8, the rtols of
``tests/test_torch_lbfgs.py``)."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib
import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu import checkpoint as jcp
from lbfgs_ffnn_tpu.objectives import analytic as ja
from lbfgs_ffnn_tpu.objectives import mlp as jmlp
from lbfgs_ffnn_tpu.solvers.lbfgs import LBFGSOptions as JOptions
from lbfgs_ffnn_tpu.solvers.lbfgs import lbfgs_chunked as j_lbfgs_chunked
from lbfgs_ffnn_torch import checkpoint as cp
from lbfgs_ffnn_torch.objectives import analytic as ta
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.ops.two_loop import empty_history_state, ring_push

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")
tgd = importlib.import_module("lbfgs_ffnn_torch.solvers.gd")
tsgd = importlib.import_module("lbfgs_ffnn_torch.solvers.sgd")


def _zeros_like(tree):
    """A template: the tree's structure with every tensor zeroed."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_zeros_like(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zeros_like(v) for v in tree)
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


# -- the file and the migration shim ------------------------------------------

def test_checkpoint_roundtrip_solver_state(tmp_path):
    """The quasi-Newton memory (ring and weights) survives save/restore, as
    in JAX's test: S, count and k equal, JAX's own round trip beside it."""
    hist = empty_history_state(4, 16, torch.float32)
    v = torch.arange(16.0)
    hist = ring_push(hist, v, 2 * v, torch.tensor(0.5), torch.tensor(True))
    state = {"w": torch.ones(16) * 3, "hist": hist, "k": torch.tensor(7, dtype=torch.int32)}
    cp.save_checkpoint(tmp_path / "ckpt", state)
    restored = cp.restore_checkpoint(tmp_path / "ckpt", _zeros_like(state))
    assert type(restored["hist"]) is type(hist)
    for a, b in zip(_leaves(restored), _leaves(state), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored["hist"].count) == 1 and int(restored["k"]) == 7

    from lbfgs_ffnn_tpu.ops.two_loop import empty_history_state as j_empty
    from lbfgs_ffnn_tpu.ops.two_loop import ring_push as j_push

    jh = j_push(j_empty(4, 16, jnp.float32), jnp.arange(16.0), 2 * jnp.arange(16.0),
                jnp.asarray(0.5, jnp.float32), jnp.array(True))
    jstate = {"w": jnp.ones(16, jnp.float32) * 3, "hist": jh, "k": jnp.int32(7)}
    jcp.save_checkpoint(tmp_path / "jckpt", jstate)
    jr = jcp.restore_checkpoint(tmp_path / "jckpt", jax.tree_util.tree_map(jnp.zeros_like,
                                                                            jstate))
    np.testing.assert_array_equal(restored["hist"].S[:, :16].numpy(),
                                  np.asarray(jr["hist"].S).reshape(4, -1)[:, :16])
    assert int(jr["hist"].count) == int(restored["hist"].count)


def test_bf16_ring_comes_back_bf16_and_a_dtype_change_raises(tmp_path):
    hist = empty_history_state(3, 8, torch.float32, pair_dtype=torch.bfloat16)
    v = torch.linspace(-1, 1, 8)
    hist = ring_push(hist, v, v / 3, torch.tensor(0.25), torch.tensor(True))
    cp.save_checkpoint(tmp_path / "r", hist)
    back = cp.restore_checkpoint(tmp_path / "r", _zeros_like(hist))
    assert back.S.dtype == torch.bfloat16 and torch.equal(back.S, hist.S)
    f32 = hist._replace(S=hist.S.float(), Y=hist.Y.float())
    with pytest.raises(ValueError, match="bfloat16"):
        cp.restore_checkpoint(tmp_path / "r", _zeros_like(f32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_weights_npz_roundtrip_across_packages(tmp_path, writer):
    """The npz weight files are one format: each package reads its own and
    the other's."""
    w = np.arange(10.0)
    p = tmp_path / "w.npz"
    if writer == "port":
        cp.save_weights_npz(p, torch.tensor(w))
    else:
        jcp.save_weights_npz(p, jnp.asarray(w))
    for load in (cp.load_weights_npz, jcp.load_weights_npz):
        np.testing.assert_array_equal(load(p), w)


class _Old(NamedTuple):
    k: torch.Tensor
    x: torch.Tensor


class _New(NamedTuple):
    k: torch.Tensor
    x: torch.Tensor
    nf: torch.Tensor  # added after the checkpoint was written
    ng: torch.Tensor


class _NewPrefix(NamedTuple):
    k: torch.Tensor
    x: torch.Tensor
    prefix: torch.Tensor  # a derived array field added after the checkpoint


def test_checkpoint_restore_fills_new_fields(tmp_path):
    cp.save_checkpoint(tmp_path / "old", _Old(k=torch.tensor(7), x=torch.arange(4.0)))
    template = _New(k=torch.tensor(0), x=torch.zeros(4), nf=torch.tensor(0), ng=torch.tensor(0))
    with pytest.warns(UserWarning, match="nf"):
        restored = cp.restore_checkpoint(tmp_path / "old", template)
    assert isinstance(restored, _New)
    assert int(restored.k) == 7 and int(restored.nf) == 0 and int(restored.ng) == 0
    np.testing.assert_allclose(restored.x.numpy(), np.arange(4.0))


def test_checkpoint_migration_raises_on_nonscalar_fill(tmp_path):
    cp.save_checkpoint(tmp_path / "old", _Old(k=torch.tensor(3), x=torch.arange(4.0)))
    template = _NewPrefix(k=torch.tensor(0), x=torch.zeros(4), prefix=torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="prefix"):
        cp.restore_checkpoint(tmp_path / "old", template)
    with pytest.warns(UserWarning, match="missing fields"):
        restored = cp.restore_checkpoint(tmp_path / "old", template, allow_partial=True)
    assert int(restored.k) == 3


def test_checkpoint_migration_warns_on_scalar_fill(tmp_path):
    class OldX(NamedTuple):
        x: torch.Tensor

    class NewX(NamedTuple):
        x: torch.Tensor
        nf: torch.Tensor

    cp.save_checkpoint(tmp_path / "old", OldX(x=torch.arange(4.0)))
    with pytest.warns(UserWarning, match="nf"):
        restored = cp.restore_checkpoint(tmp_path / "old",
                                         NewX(x=torch.zeros(4), nf=torch.tensor(0)))
    assert int(restored.nf) == 0
    np.testing.assert_allclose(restored.x.numpy(), np.arange(4.0))


def test_empty_container_fills_quietly(tmp_path):
    """The L-BFGS ``prefix=()`` placeholder is benign to fill (there is
    nothing in it to go stale)."""
    cp.save_checkpoint(tmp_path / "old", {"x": torch.arange(3.0)})
    with pytest.warns(UserWarning, match="prefix"):
        out = cp.restore_checkpoint(tmp_path / "old", {"x": torch.zeros(3), "prefix": ()})
    assert out["prefix"] == () and torch.equal(out["x"], torch.arange(3.0))
    assert cp.filled_kinds({"p": (), "a": torch.zeros(2), "c": 0}, ["/p", "/a", "/c"]) == [
        ("/p", True), ("/a", False), ("/c", True)]


def test_checkpoint_restore_propagates_nonstructural_errors(tmp_path):
    """A missing checkpoint, or a file that is no checkpoint, is NOT a
    migration case: both raise, in either package."""
    with pytest.raises(FileNotFoundError):
        cp.restore_checkpoint(tmp_path / "never_saved", {"x": torch.zeros(3)})
    with pytest.raises(Exception):
        jcp.restore_checkpoint(tmp_path / "never_saved", {"x": jnp.zeros(3)})
    (tmp_path / "junk").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception) as ei:
        cp.restore_checkpoint(tmp_path / "junk", {"x": torch.zeros(3)})
    assert not isinstance(ei.value, UserWarning)


def test_checkpoint_value_error_with_matching_structure_propagates(tmp_path):
    """A leaf that disagrees (dtype or shape) within a matching structure is
    a genuine error, not a migration: it propagates."""
    cp.save_checkpoint(tmp_path / "c", {"x": torch.arange(3.0, dtype=torch.float64)})
    with pytest.raises(ValueError, match="float64"):
        cp.restore_checkpoint(tmp_path / "c", {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match=r"\(4,\)"):
        cp.restore_checkpoint(tmp_path / "c", {"x": torch.zeros(4, dtype=torch.float64)})


def test_checkpoint_extra_saved_fields_is_structure_mismatch(tmp_path):
    """Downgrade: the saved tree holds MORE fields than the template; the
    overlay drops the extra one and restores the rest."""
    cp.save_checkpoint(tmp_path / "c", {"x": torch.arange(3.0), "retired_field": torch.zeros(2)})
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # nothing filled: no warning
        out = cp.restore_checkpoint(tmp_path / "c", {"x": torch.zeros(3)})
    np.testing.assert_allclose(out["x"].numpy(), np.arange(3.0))
    assert set(out) == {"x"}


def test_checkpoint_shim_failure_propagates_original_error(tmp_path):
    """When the overlay itself fails (here on a leaf of the wrong dtype),
    the structured restore's error propagates, the overlay's as its
    cause."""
    cp.save_checkpoint(tmp_path / "c", {"x": torch.arange(3.0, dtype=torch.float64),
                                        "retired": torch.zeros(1)})
    with pytest.raises(ValueError, match="not in the template") as ei:
        cp.restore_checkpoint(tmp_path / "c", {"x": torch.zeros(3)})
    assert isinstance(ei.value.__cause__, ValueError)
    assert "float64" in str(ei.value.__cause__)


def test_checkpoint_sequence_as_dict_with_alien_keys(tmp_path, monkeypatch):
    """A tuple field saved as a dict with keys other than "0", "1" (JAX's
    Orbax form of a sequence) is not that sequence: the overlay keeps the
    template's and, the field being non-scalar, refuses the unsafe fill;
    the "0", "1" form is read as the sequence."""
    monkeypatch.setattr(cp, "_load", lambda path: {"x": torch.arange(3.0),
                                                    "seq": {"a": 1.0, "b": 2.0}})
    template = {"x": torch.zeros(3), "seq": (torch.zeros(2), torch.zeros(2))}
    with pytest.raises(ValueError, match="seq"):
        cp.restore_checkpoint(tmp_path / "c", template)
    with pytest.warns(UserWarning, match="seq"):
        out = cp.restore_checkpoint(tmp_path / "c", template, allow_partial=True)
    np.testing.assert_allclose(out["x"].numpy(), np.arange(3.0))
    assert isinstance(out["seq"], tuple) and len(out["seq"]) == 2
    monkeypatch.setattr(cp, "_load", lambda path: {"x": torch.arange(3.0), "extra": 1,
                                                    "seq": {"0": torch.ones(2),
                                                            "1": torch.ones(2) * 2}})
    out = cp.restore_checkpoint(tmp_path / "c", template)
    assert torch.equal(out["seq"][1], torch.ones(2) * 2)


# -- kill and resume ----------------------------------------------------------

class _Killed(Exception):
    """Ends a run from its callback, as a kill would."""


def _save_and_kill(path, counter, at):
    """A callback that saves the state at the first callback whose
    ``counter(state) >= at``, keeps a template of it and ends the run."""
    kept = {}

    def cb(state, _elapsed):
        if counter(state) >= at:
            cp.save_checkpoint(path, state)
            kept["template"] = _zeros_like(state)
            kept["at"] = counter(state)
            raise _Killed

    return cb, kept


def _killed_then_restored(run, path, counter, at):
    cb, kept = _save_and_kill(path, counter, at)
    with pytest.raises(_Killed):
        run(cb)
    return cp.restore_checkpoint(path, kept["template"]), kept["at"]


def _jax_resumed(problem, x0, aux, opts, chunk, at, tmp_path):
    """JAX's kill-and-resume, as tests/test_harness_checkpoint.py runs it."""
    saved = {}

    def cb(state, _elapsed):
        if int(state.k) == at and not saved:
            jcp.save_checkpoint(tmp_path / "jmid", state)
            saved["t"] = jax.tree_util.tree_map(jnp.zeros_like, state)

    j_lbfgs_chunked(problem, x0, aux=aux, opts=opts, chunk=chunk, callback=cb)
    restored = jcp.restore_checkpoint(tmp_path / "jmid", saved["t"])
    return j_lbfgs_chunked(problem, None, aux=aux, opts=opts, chunk=chunk,
                           resume_state=restored)[0]


def _same(a, b):
    for f in ("x", "loss_history", "gnorm_history"):
        u, v = getattr(a, f), getattr(b, f)
        assert torch.equal(torch.nan_to_num(u, nan=7.0), torch.nan_to_num(v, nan=7.0)), f
    assert (a.n_iters, a.n_fevals, a.n_gevals) == (b.n_iters, b.n_fevals, b.n_gevals)


def _held_to_jax(res, jres):
    assert res.n_iters == int(jres.n_iters)
    n = res.n_iters
    np.testing.assert_allclose(res.loss_history[:n].numpy(), np.asarray(jres.loss_history[:n]),
                               rtol=1e-9)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("pair_dtype", [None, "bfloat16"])
def test_lbfgs_chunked_kill_and_resume(tmp_path, pair_dtype):
    """Rosenbrock n=4, m=8, 60 iterations in chunks of 10 (the Wolfe search,
    as JAX's test), saved at the first callback with k >= 20: the resumed
    run equals the uninterrupted one bitwise (no derived field), its time
    column is NaN before the resume, and it is held to JAX's resumed run.
    The two packages' f64 trajectories on this function part where rounding
    is amplified (f64 pairs: 4e-8 apart by iteration 35; the bf16 ring: a
    rounding flip at iteration 21, ROADMAP "Differences that are not
    faults"), so the losses are held to rtol 1e-9 over the resumed run's
    first iterations before that (20-29 with f64 pairs, 20 with the bf16
    ring) and the solution to 1e-8 at the end."""
    x0 = np.asarray(ja.rosenbrock_start(4))
    tp = ta.rosenbrock_problem()
    opts = tl.LBFGSOptions(max_iters=60, tol=1e-12, m=8, pair_dtype=pair_dtype)
    tx0 = torch.tensor(x0, dtype=torch.float64)
    full, _ = tl.lbfgs_chunked(tp, tx0, (), opts, chunk=10)
    restored, at = _killed_then_restored(
        lambda cb: tl.lbfgs_chunked(tp, tx0, (), opts, chunk=10, callback=cb),
        tmp_path / "mid", lambda s: int(s.k), 20)
    assert at == int(restored.k) == 20
    assert restored.hist.S.dtype == (torch.bfloat16 if pair_dtype else torch.float64)
    resumed, time_ms = tl.lbfgs_chunked(tp, None, (), opts, chunk=10, resume_state=restored)
    _same(resumed, full)
    assert np.isnan(time_ms[:20]).all() and np.isfinite(time_ms[20:resumed.n_iters]).all()
    jopts = JOptions(max_iters=60, tol=1e-12, m=8, pair_dtype=pair_dtype)
    jres = _jax_resumed(ja.rosenbrock_problem(), jnp.asarray(x0), (), jopts, 10, 20, tmp_path)
    held = slice(20, 30 if pair_dtype is None else 21)
    np.testing.assert_allclose(resumed.loss_history[held].numpy(),
                               np.asarray(jres.loss_history[held]), rtol=1e-9)
    np.testing.assert_allclose(resumed.x.numpy(), np.asarray(jres.x), rtol=1e-8)


def _mlp_case():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(24, 6))
    y = np.eye(3)[np.arange(24) % 3]
    w0 = rng.normal(size=tmlp.mlp_spec([6, 8, 3], ["relu", "linear"]).n_params) * 0.4
    return x, y, w0


@pytest.mark.parametrize("variant", ["carried", "stale", "grad_input"])
def test_lbfgs_chunked_resume_with_line_prefix(tmp_path, variant):
    """The MLP 6-8-3 with its carried prefix (24 samples, f64, chunks of 5,
    saved at k >= 10): the prefix round-trips ((24, 8)) and the resumed run
    recomputes it from the iterate, so it is held to JAX's resumed run at
    the rtols above ("carried"); a zeroed prefix (a template-filled
    migration) is healed the same way ("stale"); with the grad-input bf16
    copy the resumed run matches the uninterrupted one to JAX's own
    tolerance ("grad_input", f32)."""
    x, y, w0 = _mlp_case()
    spec_dims, acts = [6, 8, 3], ["relu", "linear"]
    dtype = torch.float32 if variant == "grad_input" else torch.float64
    kw = {"grad_input_dtype": "bfloat16"} if variant == "grad_input" else {}
    tp = tmlp.mlp_problem(tmlp.mlp_spec(spec_dims, acts), **kw)
    aux = (torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=dtype))
    tw0 = torch.tensor(w0, dtype=dtype)
    opts = tl.LBFGSOptions(max_iters=30, tol=1e-12, m=4, line_search="armijo")
    restored, at = _killed_then_restored(
        lambda cb: tl.lbfgs_chunked(tp, tw0, aux, opts, chunk=5, callback=cb),
        tmp_path / "mid", lambda s: int(s.k), 10)
    assert at == 10 and restored.prefix.shape == (24, 8)
    if variant == "stale":
        restored = restored._replace(prefix=torch.zeros_like(restored.prefix))
    resumed, _ = tl.lbfgs_chunked(tp, None, aux, opts, chunk=5, resume_state=restored)
    if variant == "grad_input":
        full, _ = tl.lbfgs_chunked(tp, tw0, aux, opts, chunk=5)
        assert resumed.n_iters == full.n_iters
        np.testing.assert_allclose(resumed.x.numpy(), full.x.numpy(), rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(float(resumed.final_loss), float(full.final_loss), rtol=1e-4)
        return
    jp = jmlp.mlp_problem(jmlp.mlp_spec(spec_dims, acts))
    jres = _jax_resumed(jp, jnp.asarray(w0), (jnp.asarray(x), jnp.asarray(y)),
                        JOptions(max_iters=30, tol=1e-12, m=4, line_search="armijo"), 5, 10,
                        tmp_path)
    _held_to_jax(resumed, jres)


def _batch_case():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(96, 12)))
    y = torch.tensor(np.eye(4)[np.arange(96) % 4])
    spec = tmlp.mlp_spec([12, 8, 4], ["relu", "linear"])
    w0 = torch.tensor(rng.normal(size=spec.n_params) * 0.3)
    return spec, w0, x, y


def test_slbfgs_chunked_kill_and_resume(tmp_path):
    """S-LBFGS with the SVRG anchor, the curvature ring, the last average
    and the sampler's seed: 6 epochs, chunk 1, saved after epoch 2; the
    resumed run equals the uninterrupted one bitwise."""
    spec, w0, x, y = _batch_case()
    bp = tmlp.mlp_batch_problem(spec, lam=1e-4)
    opts = tsl.SLBFGSOptions(epochs=6, tol=1e-12, history=4, L=3, batch_size=16,
                             step_size=0.05, seed=7)
    full, _ = tsl.slbfgs_chunked(bp, w0, x, y, opts, chunk=1)
    restored, at = _killed_then_restored(
        lambda cb: tsl.slbfgs_chunked(bp, w0, x, y, opts, chunk=1, callback=cb),
        tmp_path / "mid", lambda s: int(s.epoch), 2)
    assert at == 2 and int(restored.hist.count) > 0 and bool(restored.has_u)
    assert int(restored.seed) == 7
    resumed, time_ms = tsl.slbfgs_chunked(bp, None, x, y, opts, chunk=1, resume_state=restored)
    assert torch.equal(resumed.x, full.x) and resumed.n_iters == full.n_iters == 6
    assert torch.equal(resumed.loss_history, full.loss_history)
    assert torch.equal(resumed.gnorm_history, full.gnorm_history)
    assert np.isnan(time_ms[:2]).all() and np.isfinite(time_ms[2:]).all()


def test_gd_chunked_kill_and_resume(tmp_path):
    """GD with momentum (its velocity in the state), 40 iterations in
    chunks of 7, saved at k >= 14: bitwise equal to the uninterrupted run."""
    tp = ta.rosenbrock_problem()
    x0 = torch.tensor(np.asarray(ja.rosenbrock_start(4)), dtype=torch.float64)
    opts = tgd.GDOptions(max_iters=40, tol=1e-12, step_size=1e-3, momentum=0.9,
                         use_line_search=False)
    full, _ = tgd.gd_chunked(tp, x0, (), opts, chunk=7)
    restored, at = _killed_then_restored(
        lambda cb: tgd.gd_chunked(tp, x0, (), opts, chunk=7, callback=cb),
        tmp_path / "mid", lambda s: int(s.k), 14)
    assert at == 14
    resumed, _ = tgd.gd_chunked(tp, None, (), opts, chunk=7, resume_state=restored)
    _same(resumed, full)


@pytest.mark.parametrize("sampling", ["random", "sequential"])
def test_sgd_chunked_kill_and_resume(tmp_path, sampling):
    """SGD (momentum, a decaying step, the seed), 6 epochs in chunks of 1,
    saved after epoch 3: bitwise equal to the uninterrupted run."""
    spec, w0, x, y = _batch_case()
    bp = tmlp.mlp_batch_problem(spec)
    opts = tsgd.SGDOptions(epochs=6, batch_size=20, step_size=0.05, momentum=0.5,
                           lr_decay=0.9, lr_decay_step=2, sampling=sampling, seed=5)
    full, _ = tsgd.sgd_chunked(bp, w0, x, y, opts, chunk=1)
    restored, at = _killed_then_restored(
        lambda cb: tsgd.sgd_chunked(bp, w0, x, y, opts, chunk=1, callback=cb),
        tmp_path / "mid", lambda s: int(s.epoch), 3)
    assert at == 3
    resumed, _ = tsgd.sgd_chunked(bp, None, x, y, opts, chunk=1, resume_state=restored)
    assert torch.equal(resumed.x, full.x) and resumed.n_iters == full.n_iters
    assert torch.equal(resumed.loss_history, full.loss_history)
