"""The port's IDX readers and dataset assembly against the JAX package's,
on fixtures written here (no external data files)."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lbfgs_ffnn_tpu.data import datasets as jds
from lbfgs_ffnn_tpu.data import idx as jidx
from lbfgs_ffnn_torch.data import datasets as tds
from lbfgs_ffnn_torch.data import idx as tidx

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def idx_files(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(37, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=37, dtype=np.uint8)
    jidx.write_idx_u8(tmp_path / "images.idx3-ubyte", images)
    jidx.write_idx_u8(tmp_path / "labels.idx1-ubyte", labels)
    return tmp_path, images, labels


@pytest.mark.parametrize("max_items", [0, 11])
def test_idx_readers_match_jax(idx_files, max_items):
    root, images, labels = idx_files
    n = max_items or len(labels)
    x_t = tidx.read_idx_images(root / "images.idx3-ubyte", max_items)
    x_j = jidx.read_idx_images(root / "images.idx3-ubyte", max_items)
    assert x_t.shape == x_j.shape == (n, 784) and x_t.dtype == np.float32
    # The JAX native loader multiplies by float32(1/255) where numpy
    # divides by 255: the two may differ by one float32 ulp.
    np.testing.assert_allclose(x_t, x_j, rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(x_t, images[:n].reshape(n, -1) / np.float32(255.0))
    np.testing.assert_array_equal(
        tidx.read_idx_labels_u8(root / "labels.idx1-ubyte", max_items),
        jidx.read_idx_labels_u8(root / "labels.idx1-ubyte", max_items))
    np.testing.assert_array_equal(
        tidx.read_idx_labels_onehot(root / "labels.idx1-ubyte", max_items),
        jidx.read_idx_labels_onehot(root / "labels.idx1-ubyte", max_items))


def test_write_idx_u8_same_bytes(tmp_path):
    data = np.arange(2 * 3 * 5, dtype=np.uint8).reshape(2, 3, 5)
    tidx.write_idx_u8(tmp_path / "t.idx", data)
    jidx.write_idx_u8(tmp_path / "j.idx", data)
    assert (tmp_path / "t.idx").read_bytes() == (tmp_path / "j.idx").read_bytes()


def test_reader_rejects_non_idx(tmp_path):
    (tmp_path / "bad").write_bytes(b"\x89PNG....")
    with pytest.raises(ValueError):
        tidx.read_idx_images(tmp_path / "bad")


def test_synthetic_images_bitwise_equal():
    labels = np.random.default_rng(123).integers(0, 10, 50)
    for kw in ({}, {"seed": 7, "noise_seed": 3}):
        np.testing.assert_array_equal(
            tds.synthetic_images_for_labels(labels, **kw),
            jds.synthetic_images_for_labels(labels, **kw))


def test_load_mnist_matches_jax_with_labels_only(tmp_path):
    """With only the label files present both loaders synthesize the same
    images from the same label stream."""
    rng = np.random.default_rng(1)
    jidx.write_idx_u8(tmp_path / "train-labels.idx1-ubyte", rng.integers(0, 10, 30, dtype=np.uint8))
    jidx.write_idx_u8(tmp_path / "t10k-labels.idx1-ubyte", rng.integers(0, 10, 12, dtype=np.uint8))
    t = tds.load_mnist(train_size=20, test_size=0, root=tmp_path)
    j = jds.load_mnist(train_size=20, test_size=0, root=tmp_path)
    assert t.synthetic_images and j.synthetic_images and t.n_train == 20
    for name in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_load_mnist_raises_without_labels(tmp_path):
    with pytest.raises(OSError):
        tds.load_mnist(train_size=5, test_size=5, root=tmp_path)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['lbfgs_ffnn_tpu'] = None\n"
        "import lbfgs_ffnn_torch, lbfgs_ffnn_torch.data, lbfgs_ffnn_torch.objectives\n"
        "import lbfgs_ffnn_torch.ops, lbfgs_ffnn_torch.ops.cuda_two_loop, lbfgs_ffnn_torch.solvers\n"
        "import lbfgs_ffnn_torch._build, lbfgs_ffnn_torch.launcher, lbfgs_ffnn_torch.recorder\n"
        "import lbfgs_ffnn_torch.solvers.gd, lbfgs_ffnn_torch.experiments.run_mnist\n"
        "import lbfgs_ffnn_torch.harness, lbfgs_ffnn_torch.objectives.analytic\n"
        "import lbfgs_ffnn_torch.experiments.diag_two_loop_large, chip_smoke\n"
        "import lbfgs_ffnn_torch.experiments.blocked_stage_study\n"
        "import lbfgs_ffnn_torch.experiments.resident_phase_study\n"
        "import lbfgs_ffnn_torch.ops.control, lbfgs_ffnn_torch.experiments.bench\n"
        "import lbfgs_ffnn_torch.solvers.slbfgs, lbfgs_ffnn_torch.ops.sampling\n"
        "import lbfgs_ffnn_torch.objectives.pinn, lbfgs_ffnn_torch.experiments.run_burgers\n"
        "import lbfgs_ffnn_torch.experiments.run_oscillator\n"
        "import lbfgs_ffnn_torch.experiments.burgers_validate\n"
        "import lbfgs_ffnn_torch.solvers.sgd, lbfgs_ffnn_torch.runtime.streamer\n"
        "assert not any(k.startswith(('jax', 'lbfgs_ffnn_tpu')) and sys.modules[k] is not None\n"
        "               for k in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
