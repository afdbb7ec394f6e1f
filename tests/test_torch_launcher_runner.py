"""The MNIST runner's ``main(argv)`` on the CPU at a tiny size, from IDX
label files written here: the deep cuda-style run list, the row filter and
both styles with measured chunks, and the default rows in either style with
``--record-accuracy`` and ``--seeds 2``. Apart from
``tests/test_torch_launcher.py`` (the Launcher against the JAX package's)
so that ``--dist loadfile`` can give these slow runs a worker of their
own."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.data.idx import write_idx_u8
from lbfgs_ffnn_torch.experiments import run_mnist


@pytest.fixture
def fashion_root(tmp_path):
    rng = np.random.default_rng(4)
    write_idx_u8(tmp_path / "train-labels-idx1-ubyte", rng.integers(0, 10, 96, dtype=np.uint8))
    write_idx_u8(tmp_path / "t10k-labels-idx1-ubyte", rng.integers(0, 10, 24, dtype=np.uint8))
    return tmp_path


def test_runner_main_deep_on_cpu(fashion_root, capsys):
    """The cuda-style run list on the deep net at a tiny size: GD, SGD,
    L-BFGS m=10 and m=100, and both bf16-ring variants run."""
    out = fashion_root / "out"
    done = run_mnist.main(["--dataset", "fashion", "--deep", "--iters", "4", "--bf16-ring",
                           "--data-root", str(fashion_root), "--out-dir", str(out),
                           "--device", "cpu"])
    names = [cfg.name for _, cfg, _ in done]
    assert names == ["FASHION_GD", "FASHION_SGD", "FASHION_LBFGS_m10", "FASHION_LBFGS_m100",
                     "FASHION_LBFGS_m10_bf16ring", "FASHION_LBFGS_m100_bf16ring"]
    assert "not run" not in capsys.readouterr().out
    for solver, cfg, rep in done:
        assert rep.result.n_iters == 4 and bool(torch.isfinite(rep.result.final_loss))
        assert (out / f"{cfg.name}_history.csv").read_text().startswith(
            "Iteration,Loss,GradNorm,TimeMs\n")
        assert rep.result.x.shape == (242762,) and rep.result.x.device.type == "cpu"
    assert [cfg.pair_dtype for _, cfg, _ in done][-2:] == ["bfloat16", "bfloat16"]


def test_runner_filters_and_styles(fashion_root, capsys):
    base = ["--dataset", "fashion", "--iters", "2", "--data-root", str(fashion_root),
            "--out-dir", str(fashion_root / "out"), "--device", "cpu", "--train-size", "32"]
    done = run_mnist.main(base + ["--only", "LBFGS_m10", "--plain-two-loop"])  # a substring
    assert [(s, c.name, c.two_loop_impl) for s, c, _ in done] == [
        ("lbfgs", "FASHION_LBFGS_m10", "plain"), ("lbfgs", "FASHION_LBFGS_m100", "plain")]
    done = run_mnist.main(base + ["--style", "cpu", "--timed-chunks", "1"])
    assert [c.name for _, c, _ in done] == ["FASHION_Unified_GD", "FASHION_SGD",
                                            "FASHION_SLBFGS", "FASHION_LBFGS"]
    assert "not run" not in capsys.readouterr().out
    sl = done[2][1]
    assert (sl.batch_size, sl.m_param, sl.L_param, sl.b_H_param, sl.learning_rate,
            sl.timed_chunks) == (256, 10, 10, 128, 0.02, 1)
    assert done[2][2].result.n_iters == 2 and done[3][1].timed_chunks == 1  # Wolfe L-BFGS too
    assert all(c.timed_chunks == 1 for _, c, _ in done)  # GD and SGD too
    with pytest.raises(SystemExit):
        run_mnist.main(base + ["--only", "nothing-matches"])
    with pytest.raises(SystemExit):  # --data-root is required
        run_mnist.main(["--dataset", "fashion", "--device", "cpu"])


@pytest.mark.parametrize("style", ["cuda", "cpu"])
def test_runner_default_rows_with_seeds(fashion_root, style):
    """The runner's four default rows in either style, --record-accuracy
    and --seeds 2: the stochastic rows' CSVs carry TrainAcc and TestAcc,
    multiseed_summary.json holds each row's two seeds and run_meta.json
    each row; --timed-chunks -1 is JAX's rule."""
    import json

    out = fashion_root / f"out_{style}"
    done = run_mnist.main(["--dataset", "fashion", "--style", style, "--iters", "3",
                           "--train-size", "64", "--data-root", str(fashion_root),
                           "--out-dir", str(out), "--device", "cpu", "--record-accuracy",
                           "--seeds", "2", "--timed-chunks", "-1"])
    solvers = [s for s, _, _ in done]
    assert solvers == (["gd", "sgd", "lbfgs", "lbfgs"] if style == "cuda"
                       else ["gd", "sgd", "slbfgs", "lbfgs"])
    summary = json.loads((out / "multiseed_summary.json").read_text())
    meta = json.loads((out / "run_meta.json").read_text())
    assert [r["name"] for r in meta["runs"]] == [c.name for _, c, _ in done]
    for solver, cfg, rep in done:
        header = (out / f"{cfg.name}_history.csv").read_text().splitlines()[0]
        stochastic = solver in ("sgd", "slbfgs")
        assert header.endswith(",TrainAcc,TestAcc") == stochastic, header
        row = summary[cfg.name]
        assert row["seeds"] == [123, 124] and len(row["final_loss"]) == 2
        assert row["ms_per_iter_min"] <= row["ms_per_iter_median"] <= row["ms_per_iter_max"]
        assert cfg.timed_chunks == (3 if solver == "sgd" else 50)
        assert cfg.seed == 123 and rep.result.n_iters >= 1
    sgd_cfg = done[1][1]
    assert (sgd_cfg.batch_size, sgd_cfg.learning_rate, sgd_cfg.log_interval) == (
        (256, 0.01, 5) if style == "cuda" else (256, 0.03, 5))
    if style == "cuda":
        assert (sgd_cfg.lr_decay, sgd_cfg.lr_decay_rate, sgd_cfg.tolerance) == (0.8, 40, 1e-3)
