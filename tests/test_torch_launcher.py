"""The port's launcher, recorder and runner against the JAX package's: the
same data and weights (carried across with ``params_from_numpy``,
``reset_params=False``) through ``Launcher.train``, compared on the CSV's
Loss and GradNorm columns (f64: rtol 1e-9; TimeMs is a wall time and is not
compared), for GD (whole and in measured chunks), Armijo L-BFGS (the cuda
style), Wolfe L-BFGS (the cpu style) and the cuda style's sequential SGD
with its TrainAcc and TestAcc columns. S-LBFGS and the cpu style's random
SGD draw their batches from the port's own stream, so their Launchers are
held to the JAX Launcher's options and runs. The runner's variant flags run
at a tiny size on the CPU, from IDX label files written here; its default
rows, filters and styles are in ``tests/test_torch_launcher_runner.py``."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgs_ffnn_tpu.data.datasets import Dataset as JDataset
from lbfgs_ffnn_tpu.launcher import Launcher as JLauncher, UnifiedConfig as JConfig
from lbfgs_ffnn_tpu.recorder import History as JHistory, read_history_csv as j_read
from lbfgs_ffnn_tpu.recorder import write_history_csv as j_write
from lbfgs_ffnn_torch.data.datasets import Dataset
from lbfgs_ffnn_torch.data.idx import write_idx_u8
from lbfgs_ffnn_torch.experiments import run_mnist
from lbfgs_ffnn_torch.launcher import Launcher, UnifiedConfig
from lbfgs_ffnn_torch.objectives.mlp import params_from_numpy
from lbfgs_ffnn_torch.recorder import History, read_history_csv, write_history_csv

DIMS, ACTS = [20, 16, 12, 8, 4], ["relu", "relu", "relu", "linear"]


def _data(seed=0, n=200, n_test=40):
    rng = np.random.default_rng(seed)
    x = rng.random((n + n_test, DIMS[0]))
    y = np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], n + n_test)]
    return x[:n], y[:n], x[n:], y[n:]


def _build(launcher, ds):
    for d_in, d_out, act in zip(DIMS[:-1], DIMS[1:], ACTS):
        launcher.add_layer(d_in, d_out, act)
    return launcher.build_network().set_data(ds)


def _both(style="cuda"):
    parts = _data()
    w0 = np.random.default_rng(1).normal(size=sum(
        a * b + b for a, b in zip(DIMS[:-1], DIMS[1:]))) * 0.4
    jl = _build(JLauncher(style, dtype=jnp.float64), JDataset(*parts))
    tl = _build(Launcher(style, dtype=torch.float64, device="cpu"), Dataset(*parts))
    jl.weights = jnp.asarray(w0)
    tl.weights = params_from_numpy(tl.spec, w0, dtype=torch.float64)
    return jl, tl


@pytest.mark.parametrize("solver,extra", [
    ("gd", dict(learning_rate=0.02, momentum=0.9)),
    ("lbfgs", dict(m_param=5)),
    ("lbfgs", dict(m_param=5, pair_dtype="bfloat16")),
])
def test_train_matches_jax_launcher(solver, extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # both write <name>_history.csv into the cwd
    jl, tl = _both()
    kw = dict(max_iters=25, tolerance=1e-12, log_interval=1, reset_params=False, **extra)
    rj = jl.train(solver, JConfig(name="J", **kw), verbose=False)
    rt = tl.train(solver, UnifiedConfig(name="T", **kw), verbose=False)
    hj, ht = j_read(rj.csv_path), read_history_csv(rt.csv_path)
    assert ht.n == hj.n == 25 and rt.csv_path.endswith("T_history.csv")
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-9)
    np.testing.assert_allclose(ht.gnorm, hj.gnorm, rtol=1e-9)
    assert ht.time_ms[-1] == pytest.approx(rt.wall_time_s * 1e3)
    np.testing.assert_allclose(tl.weights.numpy(), np.asarray(jl.weights), rtol=1e-8, atol=1e-10)
    assert rt.train_eval["correct"] == rj.train_eval["correct"]
    assert tl.test(verbose=False)["correct"] == jl.test(verbose=False)["correct"]
    assert rt.warmup_iters == 2


def test_reset_params_rebinds_seeded_weights(tmp_path):
    _, tl = _both()
    tl.out_dir = tmp_path
    cfg = UnifiedConfig(name="R", max_iters=3, m_param=5)
    r1 = tl.train("lbfgs", cfg, verbose=False)
    r2 = tl.train("lbfgs", cfg, verbose=False)
    assert torch.equal(r1.result.x, r2.result.x)
    r3 = tl.train("lbfgs", UnifiedConfig(name="R", max_iters=3, m_param=5, reset_params=False),
                  verbose=False)
    assert not torch.equal(r3.result.x, r2.result.x)  # went on from r2's weights


def test_styles_bind_biases():
    """The cuda style binds zero biases, the cpu style random ones."""
    parts = _data()
    for style, zero in (("cuda", True), ("cpu", False)):
        tl = _build(Launcher(style, device="cpu"), Dataset(*parts))
        b0 = tl.weights[DIMS[0] * DIMS[1]: DIMS[0] * DIMS[1] + DIMS[1]]
        assert bool((b0 == 0).all()) == zero


def test_launcher_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        assert Launcher("cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            Launcher("cuda")
    assert Launcher("cuda", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("solver,kw", [
    ("sgd", {"fun_input_dtype": "uint8", "compute_dtype": "bfloat16"}),
    ("slbfgs", {"compute_dtype": "bfloat16"}),
    ("gd", {"compute_dtype": "bfloat16"}), ("lbfgs", {"compute_dtype": "bfloat16"}),
    ("lbfgs", {"prefix_dtype": "bfloat16", "line_search": "armijo_batched"}),
    ("lbfgs", {"grad_input_dtype": "bfloat16", "compute_dtype": "bfloat16"}),
    ("lbfgs", {"line_input_dtype": "uint8", "pair_dtype": "float16"}),
    ("gd", {"fun_input_dtype": "uint8", "compute_dtype": "float16"}),
    ("lbfgs", {"ls_alpha_init": "warm", "pair_dtype": "float16"}),
    ("lbfgs", {"pair_dtype": "float16", "timed_chunks": 5}),
    ("lbfgs", {"line_search": "armijo_batched"}), ("lbfgs", {"pair_dtype": "float16"}),
])
def test_unported_options_raise(solver, kw, tmp_path):
    _, tl = _both()
    tl.out_dir = tmp_path
    with pytest.raises(NotImplementedError):
        tl.train(solver, UnifiedConfig(max_iters=2, **kw), verbose=False)


def test_cpu_style_lbfgs_needs_wolfe(tmp_path):
    """The cpu style's L-BFGS is the Wolfe search with the reference CPU's
    50 trials; the cuda style's Armijo has 20."""
    _, tl = _both("cpu")
    tl.out_dir = tmp_path
    opts = tl._lbfgs_opts(UnifiedConfig(max_iters=2))
    assert (opts.line_search, opts.ls_max_iters) == ("wolfe", 50)
    assert tl.train("lbfgs", UnifiedConfig(max_iters=2), verbose=False).result.n_iters == 2
    assert tl.train("gd", UnifiedConfig(max_iters=2, write_csv=False), verbose=False).csv_path is None
    _, tc = _both("cuda")
    opts = tc._lbfgs_opts(UnifiedConfig(max_iters=2))
    assert (opts.line_search, opts.ls_max_iters) == ("armijo", 20)


def test_cpu_style_wolfe_matches_jax_launcher(tmp_path, monkeypatch):
    """Launcher().train("lbfgs", UnifiedConfig()) runs the Wolfe search: its
    history equals the JAX Launcher's cpu style."""
    monkeypatch.chdir(tmp_path)
    jl, tl = _both("cpu")
    kw = dict(max_iters=25, tolerance=1e-12, log_interval=1, reset_params=False, m_param=5)
    rj = jl.train("lbfgs", JConfig(name="J", **kw), verbose=False)
    rt = tl.train("lbfgs", UnifiedConfig(name="T", **kw), verbose=False)
    hj, ht = j_read(rj.csv_path), read_history_csv(rt.csv_path)
    assert ht.n == hj.n == 25
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-9)
    np.testing.assert_allclose(ht.gnorm, hj.gnorm, rtol=1e-9)
    np.testing.assert_allclose(tl.weights.numpy(), np.asarray(jl.weights), rtol=1e-8, atol=1e-10)
    assert Launcher(device="cpu").backend_style == "cpu"


@pytest.mark.parametrize("kw", [{}, {"batch_size": 32, "L_param": 3, "b_H_param": 12,
                                     "lam": 1e-3, "m_param": 4, "pair_dtype": "bfloat16"}])
def test_slbfgs_options_match_jax_launcher(kw):
    """The Launcher maps a config to S-LBFGS options as the JAX Launcher's
    _slbfgs_opts does (lam 1e-4 when 0, m_inner = N // batch_size, b_H =
    batch_size // 2 when 0), on the same defaults."""
    jl, tl = _both("cpu")
    jo = jl._slbfgs_opts(JConfig(max_iters=7, **kw), N=200)
    to = tl._slbfgs_opts(UnifiedConfig(max_iters=7, **kw))
    for field in to._fields:
        if field != "two_loop_impl":  # "cuda" here, "xla" there: each package's default
            assert getattr(to, field) == getattr(jo, field), field
    lam = kw.get("lam", 1e-4)
    w = torch.tensor(np.linspace(-1, 1, tl.spec.n_params))
    assert float(tl._batch_problem(UnifiedConfig(**kw)).reg(w)) == pytest.approx(
        0.5 * lam * float(w @ w), rel=1e-12)
    for name in ("batch_size", "L_param", "b_H_param", "lam"):
        assert getattr(UnifiedConfig(), name) == getattr(JConfig(), name)


@pytest.mark.parametrize("timed_chunks", [0, 4])
def test_launcher_trains_slbfgs(tmp_path, timed_chunks):
    """Launcher().train("slbfgs", ...) on the CPU: one CSV row per epoch,
    the loss falls, the same solve chunked or not."""
    _, tl = _both("cpu")
    tl.out_dir = tmp_path
    cfg = UnifiedConfig(name=f"S{timed_chunks}", max_iters=6, batch_size=40, log_interval=1,
                        learning_rate=0.02, tolerance=1e-12, reset_params=False,
                        timed_chunks=timed_chunks)
    w0 = tl.weights.clone()
    rep = tl.train("slbfgs", cfg, verbose=False)
    h = read_history_csv(rep.csv_path)
    assert rep.result.n_iters == 6 and h.n == 6 and np.all(np.isfinite(h.loss))
    assert h.loss[-1] < float(tl._batch_problem(cfg).fun(w0, tl._x, tl._y))
    if timed_chunks:
        assert len(np.unique(h.time_ms)) == 2 and np.all(np.diff(h.time_ms) >= 0)
    assert rep.warmup_iters == (0 if timed_chunks else 2)
    tl.weights = w0
    other = tl.train("slbfgs", dataclasses.replace(cfg, timed_chunks=4 - timed_chunks),
                     verbose=False)
    assert torch.equal(other.result.x, rep.result.x)


@pytest.mark.parametrize("log_interval", [1, 3])
def test_history_csv_matches_jax_writer(tmp_path, log_interval):
    """The same History gives the same text from both writers."""
    rng = np.random.default_rng(3)
    loss, gnorm = rng.random(7), rng.random(7)
    tms = np.linspace(0.5, 3.5, 7)
    write_history_csv(tmp_path / "t.csv", History(loss, gnorm, tms), log_interval)
    j_write(str(tmp_path / "j.csv"), JHistory(loss, gnorm, tms), log_interval)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    back = read_history_csv(tmp_path / "t.csv")
    np.testing.assert_array_equal(back.loss, loss[::log_interval])
    write_history_csv(tmp_path / "none.csv", History(loss, gnorm, tms), 0)
    assert not (tmp_path / "none.csv").exists()
    extra = {"TrainAcc": rng.random(7) * 100, "TestAcc": rng.random(7) * 100}
    write_history_csv(tmp_path / "te.csv", History(loss, gnorm, tms), log_interval, extra)
    j_write(str(tmp_path / "je.csv"), JHistory(loss, gnorm, tms), log_interval, extra)
    assert (tmp_path / "te.csv").read_text() == (tmp_path / "je.csv").read_text()


@pytest.fixture
def fashion_root(tmp_path):
    rng = np.random.default_rng(4)
    write_idx_u8(tmp_path / "train-labels-idx1-ubyte", rng.integers(0, 10, 96, dtype=np.uint8))
    write_idx_u8(tmp_path / "t10k-labels-idx1-ubyte", rng.integers(0, 10, 24, dtype=np.uint8))
    return tmp_path


def test_sgd_cuda_style_matches_jax_launcher(tmp_path, monkeypatch):
    """The cuda style's SGD (sequential batches with a ragged tail, momentum,
    the decay and the tol stop) with the accuracy columns: the CSV equals
    the JAX Launcher's, TrainAcc and TestAcc included."""
    monkeypatch.chdir(tmp_path)
    jl, tl = _both("cuda")
    kw = dict(max_iters=9, tolerance=1e-3, learning_rate=0.05, momentum=0.9, batch_size=32,
              lr_decay=0.8, lr_decay_rate=4, log_interval=2, reset_params=False,
              record_accuracy=True)
    rj = jl.train("sgd", JConfig(name="J", **kw), verbose=False)
    rt = tl.train("sgd", UnifiedConfig(name="T", **kw), verbose=False)
    assert rt.result.n_iters == int(rj.result.n_iters)
    tj = np.genfromtxt(rj.csv_path, delimiter=",", names=True)
    tt = np.genfromtxt(rt.csv_path, delimiter=",", names=True)
    assert tt.dtype.names == tj.dtype.names == ("Iteration", "Loss", "GradNorm", "TimeMs",
                                                "TrainAcc", "TestAcc")
    for col in ("Iteration", "Loss", "GradNorm", "TrainAcc", "TestAcc"):
        np.testing.assert_allclose(tt[col], tj[col], rtol=1e-9, err_msg=col)
    np.testing.assert_allclose(tl.weights.numpy(), np.asarray(jl.weights), rtol=1e-8, atol=1e-10)
    assert rt.warmup_iters == 2
    o_j, o_t = jl._sgd_opts(JConfig(**kw)), tl._sgd_opts(UnifiedConfig(**kw))
    for field in o_t._fields:
        if field != "metric_fn":
            assert getattr(o_t, field) == getattr(o_j, field), field


@pytest.mark.parametrize("timed_chunks", [0, 3])
def test_sgd_cpu_style_runs_with_accuracy(tmp_path, timed_chunks):
    """The cpu style's SGD (random batches, plain steps, no stop) maps its
    options as the JAX Launcher does and writes TrainAcc alone without a
    held-out split; chunked or not, the same solve."""
    parts = _data()
    tl = _build(Launcher("cpu", dtype=torch.float64, device="cpu", out_dir=tmp_path),
                Dataset(parts[0], parts[1], parts[2][:0], parts[3][:0]))
    jl, _ = _both("cpu")
    kw = dict(max_iters=5, learning_rate=0.03, batch_size=32, log_interval=1,
              record_accuracy=True, timed_chunks=timed_chunks)
    o_j, o_t = jl._sgd_opts(JConfig(**kw)), tl._sgd_opts(UnifiedConfig(**kw))
    for field in o_t._fields:
        if field != "metric_fn":
            assert getattr(o_t, field) == getattr(o_j, field), field
    assert (o_t.sampling, o_t.momentum, o_t.tol) == ("random", 0.0, 0.0)
    rep = tl.train("sgd", UnifiedConfig(name="S", **kw), verbose=False)
    tab = np.genfromtxt(rep.csv_path, delimiter=",", names=True)
    assert tab.dtype.names[-1] == "TrainAcc" and len(tab) == 5
    assert np.all((tab["TrainAcc"] >= 0) & (tab["TrainAcc"] <= 100))
    ref = tl.train("sgd", UnifiedConfig(name="R", **dict(kw, timed_chunks=3 - timed_chunks)),
                   verbose=False)
    assert torch.equal(ref.result.x, rep.result.x)


def test_gd_timed_chunks_matches_jax_launcher(tmp_path, monkeypatch):
    """GD in measured chunks (gd_chunked): JAX's history, a time per chunk."""
    monkeypatch.chdir(tmp_path)
    jl, tl = _both()
    kw = dict(max_iters=11, tolerance=1e-12, learning_rate=0.02, momentum=0.9,
              log_interval=1, reset_params=False, timed_chunks=4)
    rj = jl.train("gd", JConfig(name="J", **kw), verbose=False)
    rt = tl.train("gd", UnifiedConfig(name="T", **kw), verbose=False)
    hj, ht = j_read(rj.csv_path), read_history_csv(rt.csv_path)
    assert ht.n == hj.n == 11 and rt.warmup_iters == 0
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-9)
    np.testing.assert_allclose(ht.gnorm, hj.gnorm, rtol=1e-9)
    assert len(np.unique(ht.time_ms)) == 3 and np.all(np.diff(ht.time_ms) >= 0)


@pytest.mark.parametrize("style", ["cuda", "cpu"])
@pytest.mark.parametrize("solver", ["gd", "lbfgs", "sgd", "slbfgs"])
def test_warm_up_is_the_timed_solves_start(solver, style):
    """Each solver's warm-up (the Launcher's one table lookup) runs
    WARMUP_ITERS iterations (epochs) of the solve the Launcher then times,
    from the same start: its losses, gradient norms and metric rows are
    that solve's first ones."""
    from lbfgs_ffnn_torch import launcher

    _, tl = _both(style)
    c = UnifiedConfig(name="T", max_iters=6, tolerance=1e-12, learning_rate=0.02,
                      batch_size=32, m_param=5, record_accuracy=solver in ("sgd", "slbfgs"))
    n = launcher.WARMUP_ITERS
    warm = tl._warm_up(solver, c)
    whole = tl._solve(solver, c, c.max_iters)
    assert int(warm.n_iters) == n < int(whole.n_iters)
    for field in ("loss_history", "gnorm_history", "metric_history"):
        a, b = getattr(warm, field), getattr(whole, field)
        assert (a is None) == (b is None) == (field == "metric_history"
                                              and solver not in ("sgd", "slbfgs"))
        if a is not None:
            np.testing.assert_allclose(a[:n].numpy(), b[:n].numpy(), rtol=1e-10)


_U8 = dict(grad_input_dtype="uint8", line_input_dtype="uint8", fun_input_dtype="uint8")


@pytest.mark.parametrize("style,solver,extra", [
    ("cuda", "lbfgs", dict(m_param=5, pair_dtype="bfloat16", prefix_dtype="bfloat16",
                           ls_alpha_init="warm", **_U8)),
    ("cuda", "lbfgs", dict(m_param=5, grad_input_dtype="bfloat16",
                           line_input_dtype="bfloat16", prefix_dtype="bfloat16")),
    ("cpu", "lbfgs", dict(m_param=5, ls_alpha_init="warm", ls_alpha_growth=4.0)),
    ("cuda", "gd", dict(learning_rate=0.02, momentum=0.9, fun_input_dtype="uint8")),
    ("cuda", "sgd", dict(learning_rate=0.05, momentum=0.9, batch_size=32, lr_decay=0.8,
                         lr_decay_rate=4, fun_input_dtype="uint8")),
])
def test_traffic_fields_match_jax_launcher(style, solver, extra, tmp_path, monkeypatch):
    """The traffic fields (the input copies, the bf16 prefix, warm alpha;
    GD's and the cuda style's SGD's uint8 x) through both Launchers: the
    same CSV, the same final weights, and the same options."""
    monkeypatch.chdir(tmp_path)
    jl, tl = _both(style)
    kw = dict(max_iters=9 if solver == "sgd" else 20, tolerance=1e-12, log_interval=1,
              reset_params=False, **extra)
    rj = jl.train(solver, JConfig(name="J", **kw), verbose=False)
    rt = tl.train(solver, UnifiedConfig(name="T", **kw), verbose=False)
    hj, ht = j_read(rj.csv_path), read_history_csv(rt.csv_path)
    assert ht.n == hj.n == int(rj.result.n_iters) > 0
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-9)
    np.testing.assert_allclose(ht.gnorm, hj.gnorm, rtol=1e-9)
    np.testing.assert_allclose(tl.weights.numpy(), np.asarray(jl.weights), rtol=1e-8, atol=1e-10)
    if solver == "lbfgs":
        to, jo = tl._lbfgs_opts(UnifiedConfig(**kw)), jl._lbfgs_opts(JConfig(**kw))
        assert all(getattr(to, f) == getattr(jo, f) for f in LBFGS_FIELDS)
    if solver == "sgd":  # one quantized copy, reused
        assert tl._stochastic_x(UnifiedConfig(**kw)) is tl._stochastic_x(UnifiedConfig(**kw))
        assert tl._stochastic_x(UnifiedConfig(**kw)).dtype == torch.uint8


LBFGS_FIELDS = ("max_iters", "tol", "m", "line_search", "ls_max_iters", "pair_dtype",
                "prefix_dtype", "ls_alpha_init", "ls_alpha_growth")


def test_traffic_problems_are_cached_and_slbfgs_refuses_fun_input(tmp_path):
    """One problem per combination of input dtypes (the captured step keys on
    it), and S-LBFGS refuses fun_input_dtype with the JAX Launcher's
    ValueError; the defaults of the new fields are JAX's."""
    jl, tl = _both("cpu")
    tl.out_dir = tmp_path
    c = UnifiedConfig(max_iters=2, **_U8)
    assert tl._problem(c) is tl._problem(UnifiedConfig(**_U8))
    assert tl._problem(c) is not tl._problem(UnifiedConfig())
    for launcher, config in ((jl, JConfig), (tl, UnifiedConfig)):
        with pytest.raises(ValueError, match="fun_input_dtype"):
            launcher.train("slbfgs", config(max_iters=2, fun_input_dtype="uint8"), verbose=False)
        with pytest.raises(ValueError):
            launcher.train("sgd", config(max_iters=2, fun_input_dtype="bfloat16"), verbose=False)
    for name in ("prefix_dtype", "grad_input_dtype", "line_input_dtype", "fun_input_dtype",
                 "ls_alpha_init", "ls_alpha_growth"):
        assert getattr(UnifiedConfig(), name) == getattr(JConfig(), name), name


def test_runner_variant_flags(fashion_root, capsys):
    """The JAX runner's variant flags: L-BFGS m=10 and m=100 rows with its
    suffixes and options, the u8input GD and SGD rows; --bf16-compute and
    --batched-ls print one line and exit non-zero."""
    base = ["--dataset", "fashion", "--iters", "2", "--train-size", "32", "--data-root",
            str(fashion_root), "--out-dir", str(fashion_root / "out"), "--device", "cpu"]
    flags = ["--bf16-grad-input", "--bf16-prefix", "--bf16-line-input", "--bf16-all",
             "--u8-input", "--u8-all", "--warm-alpha"]
    runs = run_mnist.run_list(run_mnist.build_parser().parse_args(base + flags))
    names = [c.name for _, c in runs]
    suffixes = ["bf16gradin", "bf16prefix", "bf16lineinput", "bf16all", "u8input", "u8all",
                "warmalpha", "u8warm"]
    assert names == (["FASHION_GD", "FASHION_SGD", "FASHION_LBFGS_m10", "FASHION_LBFGS_m100"]
                     + [f"FASHION_LBFGS_m{m}_{s}" for s in suffixes for m in (10, 100)]
                     + ["FASHION_GD_u8input", "FASHION_SGD_u8input"])
    by = {c.name: c for _, c in runs}
    u8warm = by["FASHION_LBFGS_m10_u8warm"]
    assert (u8warm.grad_input_dtype, u8warm.line_input_dtype, u8warm.fun_input_dtype,
            u8warm.pair_dtype, u8warm.prefix_dtype, u8warm.ls_alpha_init) == (
        "uint8", "uint8", "uint8", "bfloat16", "bfloat16", "warm")
    assert by["FASHION_SGD_u8input"].fun_input_dtype == "uint8"
    cpu = run_mnist.run_list(run_mnist.build_parser().parse_args(base + ["--style", "cpu",
                                                                          "--u8-input"]))
    assert [c.name for _, c in cpu][-1] == "FASHION_GD_u8input"  # no SGD row in the cpu style
    done = run_mnist.main(base + ["--u8-all", "--warm-alpha", "--only", "u8"])
    assert [c.name for _, c, _ in done] == [
        "FASHION_LBFGS_m10_u8all", "FASHION_LBFGS_m100_u8all", "FASHION_LBFGS_m10_u8warm",
        "FASHION_LBFGS_m100_u8warm", "FASHION_GD_u8input", "FASHION_SGD_u8input"]
    for _, cfg, rep in done:
        assert rep.result.n_iters >= 1 and bool(torch.isfinite(rep.result.final_loss))
    capsys.readouterr()
    for flag in ("--bf16-compute", "--batched-ls"):
        with pytest.raises(SystemExit) as exc:
            run_mnist.main(base + [flag])
        assert exc.value.code != 0
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1 and "not ported" in out[0]
