"""The port's PINN objectives against the JAX package's, on the CPU:

* the Burgers residual, both formulations, at width 8 on a few points (f64,
  rtol 1e-10), and against finite differences of the network;
* losses and gradients of ``burgers_problem`` and ``oscillator_problem`` on
  coarse grids (f64 rtol 1e-10, f32 rtol 1e-5), and ``Problem.hvp``;
* ``burgers_points`` bit for bit, at the reference's counts; ``pinn_init``
  within its Xavier bounds;
* full FP32 matmuls inside the objectives whatever the caller's TF32 flag
  (every matmul the dispatcher sees, the autodiff ones included);
* the oscillator learning sin(x) to the 0.05 gate at the JAX test's size;
* the two runners as smoke runs, and the port's FD oracle and gate against
  ``scripts/burgers_fd.py``.

JAX's weights cross over as numpy (``params_from_numpy``); the two
packages' random streams differ.
"""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.objectives import pinn as jp
from lbfgs_ffnn_torch.objectives import pinn as tp
from lbfgs_ffnn_torch.objectives.mlp import mlp_apply, mlp_apply_single, params_from_numpy

COARSE = dict(dx=0.1, dt=0.2, int_dx=0.25, int_dt=0.5)  # 21 IC, 12 BC, 27 collocation points
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10), "f32": (jnp.float32, torch.float32, 1e-5)}


def _w(jspec, tspec, seed, jdtype=jnp.float64, tdtype=torch.float64):
    w = np.asarray(jp.pinn_init(jspec, jax.random.PRNGKey(seed), dtype=jdtype))
    return jnp.asarray(w), params_from_numpy(tspec, w, dtype=tdtype)


@pytest.mark.parametrize("formulation", ["vmap", "batched"])
def test_burgers_residual_matches_jax(formulation):
    js, ts = jp.default_burgers_spec(8), tp.default_burgers_spec(8)
    jw, tw = _w(js, ts, 5)
    xt = np.random.default_rng(1).uniform(-1, 1, (9, 2))
    rj = jp.burgers_residual(js, jw, jnp.asarray(xt), formulation=formulation)
    rt = tp.burgers_residual(ts, tw, torch.tensor(xt), formulation=formulation)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-10, atol=1e-13)


def test_burgers_residual_derivatives_vs_fd():
    """jvp-composed u_t, u_x, u_xx agree with finite differences of the
    network (JAX tests/test_pinn.py's check, on the port)."""
    spec = tp.default_burgers_spec(width=8)
    _, w = _w(jp.default_burgers_spec(8), spec, 1)
    xt = torch.tensor([[0.3, 0.4], [-0.5, 0.9]], dtype=torch.float64)
    r = tp.burgers_residual(spec, w, xt)

    def u(pt):
        return float(mlp_apply(spec, w, torch.tensor(pt).reshape(1, 2))[0, 0])

    eps = 1e-6
    for k in range(xt.shape[0]):
        p = xt[k].numpy()
        ex, et = np.array([eps, 0.0]), np.array([0.0, eps])
        ux = (u(p + ex) - u(p - ex)) / (2 * eps)
        ut = (u(p + et) - u(p - et)) / (2 * eps)
        uxx = (u(p + ex) - 2 * u(p) + u(p - ex)) / eps ** 2
        expected = ut + u(p) * ux - tp.BURGERS_NU * uxx
        np.testing.assert_allclose(float(r[k]), expected, rtol=1e-4, atol=1e-6)


def test_mlp_apply_single_is_one_row_of_mlp_apply():
    spec = tp.default_burgers_spec(8)
    _, w = _w(jp.default_burgers_spec(8), spec, 2)
    x = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (5, 2)))
    rows = torch.stack([mlp_apply_single(spec, w, xi) for xi in x])
    np.testing.assert_allclose(rows.numpy(), mlp_apply(spec, w, x).numpy(), rtol=1e-14)
    batched = torch.func.vmap(lambda xi: mlp_apply_single(spec, w, xi))(x)
    np.testing.assert_allclose(batched.numpy(), rows.numpy(), rtol=1e-14)


def _problems(name, jdtype, tdtype):
    """(JAX problem, its w and aux), (port problem, its w and aux); "burgers"
    in the residual's default formulation, "burgers-batched" in the port's
    other (JAX's problem takes the default)."""
    if name.startswith("burgers"):
        js, ts = jp.default_burgers_spec(8), tp.default_burgers_spec(8)
        jw, tw = _w(js, ts, 3, jdtype, tdtype)
        form = "batched" if name.endswith("batched") else "vmap"
        return ((jp.burgers_problem(js), jw, jp.burgers_points(**COARSE, dtype=jdtype)),
                (tp.burgers_problem(ts, formulation=form), tw,
                 tp.burgers_points(**COARSE, dtype=tdtype)))
    js, ts = jp.default_oscillator_spec(8), tp.default_oscillator_spec(8)
    jw, tw = _w(js, ts, 4, jdtype, tdtype)
    xs = np.linspace(0.0, math.pi, 12).reshape(-1, 1)
    return ((jp.oscillator_problem(js, w_ode=12.0), jw, jnp.asarray(xs, dtype=jdtype)),
            (tp.oscillator_problem(ts, w_ode=12.0), tw, torch.tensor(xs, dtype=tdtype)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["burgers", "burgers-batched", "oscillator"])
def test_loss_and_gradient_match_jax(name, dtype):
    jdtype, tdtype, rtol = DTYPES[dtype]
    (jprob, jw, jaux), (tprob, tw, taux) = _problems(name, jdtype, tdtype)
    fj, gj = jprob.value_and_grad(jw, jaux)
    ft, gt = tprob.value_and_grad(tw, taux)
    assert ft.dtype == gt.dtype == tdtype
    np.testing.assert_allclose(float(ft), float(fj), rtol=rtol)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=rtol,
                               atol=rtol * float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(float(tprob.fun(tw, taux)), float(fj), rtol=rtol)


@pytest.mark.parametrize("name", ["burgers", "oscillator"])
def test_hvp_matches_jax(name):
    (jprob, jw, jaux), (tprob, tw, taux) = _problems(name, jnp.float64, torch.float64)
    v = np.random.default_rng(6).normal(size=tw.shape[0])
    hj = np.asarray(jprob.hvp(jw, jnp.asarray(v), jaux))
    ht = tprob.hvp(tw, torch.tensor(v), taux).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-10, atol=1e-10 * np.abs(hj).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_burgers_points_match_jax_bitwise(dtype):
    jdtype, tdtype, _ = DTYPES[dtype]
    jpts, tpts = jp.burgers_points(dtype=jdtype), tp.burgers_points(dtype=tdtype)
    assert tpts.ic_xt.shape == (2001, 2) and tpts.bc_xt.shape == (402, 2)
    assert tpts.col_xt.shape == (201 * 51, 2) and tpts.ic_target.shape == (2001,)
    for j, t in zip(jpts, tpts):
        assert t.dtype == tdtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pinn_init_xavier_bounds():
    spec = tp.default_burgers_spec()
    w = tp.pinn_init(spec, torch.Generator().manual_seed(0), torch.float64)
    assert w.shape == (spec.n_params,) and w.dtype == torch.float64
    for w_off, b_off, d_in, d_out in spec.layer_slices():
        layer = w[w_off:b_off + d_out]
        limit = math.sqrt(6.0 / (d_in + d_out))
        assert float(layer.abs().max()) <= limit
        assert float(layer.abs().max()) > 0.5 * limit  # fills the range
    again = tp.pinn_init(spec, torch.Generator().manual_seed(0), torch.float64)
    assert torch.equal(w, again)


class _MatmulSpy(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the TF32 flag at every matrix product the dispatcher runs,
    forward and autodiff alike."""

    OPS = ("mm", "bmm", "addmm", "matmul", "mv", "dot", "baddbmm", "addmv")

    def __init__(self):
        super().__init__()
        self.flags = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            self.flags.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["burgers", "oscillator"])
def test_pinn_objectives_run_full_fp32_matmuls(name):
    """With the caller's TF32 on, every matmul of the loss, its gradient,
    a jvp trial through it and its Hessian-vector product runs with TF32
    off, and the caller's setting is back afterwards."""
    _, (prob, w, aux) = _problems(name, jnp.float32, torch.float32)
    p = torch.ones_like(w)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        spy = _MatmulSpy()
        with spy:
            prob.fun(w, aux)
            prob.value_and_grad(w, aux)
            prob.grad(w, aux)
            torch.func.jvp(lambda u: prob.fun(u, aux), (w,), (p,))
            prob.hvp(w, p, aux)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert len(spy.flags) > 20 and not any(spy.flags)


def test_unported_and_refused_options_raise():
    with pytest.raises(NotImplementedError, match="item 11"):
        tp.burgers_problem(mesh=object())
    with pytest.raises(ValueError, match="highest"):
        tp.burgers_problem(precision="high")
    with pytest.raises(ValueError, match="highest"):
        tp.oscillator_problem(precision="default")
    with pytest.raises(ValueError, match="formulation"):
        tp.burgers_residual(tp.default_burgers_spec(4), torch.zeros(tp.default_burgers_spec(
            4).n_params), torch.zeros((3, 2)), formulation="loop")


def test_oscillator_learns_sin():
    """u'' + u = 0, u(0) = 0, u'(0) = 1 trained to the 0.05 sin gate at the
    JAX test's size (width 12, 48 points, 400 iterations, m = 30), with
    JAX's init, on the port's early-exit loop."""
    from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs

    js, ts = jp.default_oscillator_spec(12), tp.default_oscillator_spec(12)
    _, w0 = _w(js, ts, 3)
    xs = tp.oscillator_points(48, x_max=math.pi, dtype=torch.float64)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jp.oscillator_points(
        48, x_max=math.pi, dtype=jnp.float64)), rtol=1e-15)
    res = lbfgs(tp.oscillator_problem(ts), w0, xs, LBFGSOptions(max_iters=400, tol=1e-12, m=30))
    err = float((mlp_apply(ts, res.x, xs)[:, 0] - torch.sin(xs[:, 0])).abs().max())
    assert err < 0.05, f"max |u - sin| = {err}"


def test_run_burgers_smoke(tmp_path):
    from lbfgs_ffnn_torch.experiments import burgers_validate, run_burgers

    out = tmp_path / "b.csv"
    run = run_burgers.main(["--device", "cpu", "--coarse", "--iters", "5", "--out", str(out)])
    res = run["result"]
    assert res.n_iters == 5 and run["warmup"] is None
    assert float(res.final_loss) < float(res.loss_history[0])
    rows = np.genfromtxt(out, delimiter=",", names=True)
    assert rows.dtype.names == ("x", "t", "u", "type") and rows.shape == (4 * 101,)
    assert set(rows["t"]) == {0.0, 0.5, 1.0, 1.5} and set(rows["type"]) == {0.0, 2.0}
    errs = burgers_validate.errors(str(out))
    assert sorted(errs) == [0.0, 0.5, 1.0] and all(e.shape == (101,) for e in errs.values())
    warm = run_burgers.main(["--device", "cpu", "--coarse", "--iters", "5", "--warm-alpha",
                             "--out", str(out)])
    assert warm["result"].n_iters == 5 and run_burgers.options(5, False, warm_alpha=True) \
        == run_burgers.options(5, False)._replace(ls_alpha_init="warm")
    assert float(warm["result"].final_loss) < float(warm["result"].loss_history[0])


def test_run_oscillator_smoke(capsys):
    from lbfgs_ffnn_torch.experiments import run_oscillator

    out = run_oscillator.main(["--device", "cpu", "--iters", "20", "--reps", "1"])
    assert out["result"].n_iters == 20 and out["iters_run"] == 22  # 2 warm-up iterations
    assert np.isfinite(out["max_err"]) and out["passed"] == (out["max_err"] <= 0.05)
    assert "Max Error" in capsys.readouterr().out


def test_fd_oracle_matches_the_scripts_copy(tmp_path):
    """The port's FD oracle is the JAX package's script, value for value;
    the gate passes on the oracle's own snapshots and fails on zeros."""
    from lbfgs_ffnn_torch.experiments import burgers_fd, burgers_validate

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    try:
        import burgers_fd as script_fd
    finally:
        sys.path.pop(0)
    x_s, snaps_s = script_fd.solve_burgers_fd(nx=201, snapshot_times=(0.0, 0.5, 1.0))
    x_p, snaps_p = burgers_fd.solve_burgers_fd(nx=201, snapshot_times=(0.0, 0.5, 1.0))
    np.testing.assert_array_equal(x_p, x_s)
    assert sorted(snaps_p) == sorted(snaps_s)
    for t in snaps_s:
        np.testing.assert_array_equal(snaps_p[t], snaps_s[t])
    x, snaps = burgers_fd.solve_burgers_fd(snapshot_times=burgers_validate.SNAPSHOTS)
    xs = np.arange(-1.0, 1.01, 0.02)
    for name, u_of in (("oracle", lambda t: np.interp(xs, x, snaps[t])),
                       ("zeros", lambda t: np.zeros_like(xs))):
        csv = tmp_path / f"{name}.csv"
        with open(csv, "w") as f:
            f.write("x,t,u,type\n")
            for t in burgers_validate.SNAPSHOTS:
                f.writelines(f"{xi},{t},{ui},0\n" for xi, ui in zip(xs, u_of(t)))
        assert burgers_validate.validate(str(csv)) == (name == "oracle")
