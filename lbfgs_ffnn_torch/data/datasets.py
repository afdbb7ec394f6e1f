"""Dataset assembly: MNIST / Fashion-MNIST with a synthetic-image fallback.

Counterpart of :mod:`lbfgs_ffnn_tpu.data.datasets`. When the image blob is
absent the images are synthesized conditioned on the real label stream
(:func:`synthetic_images_for_labels`, the same numpy code bit for bit, so
both packages build identical inputs from one label stream). The label file
itself is required: like the JAX loader, :func:`load_mnist` raises when it
is missing.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from lbfgs_ffnn_torch.data.idx import (
    read_idx_images,
    read_idx_labels_onehot,
    read_idx_labels_u8,
)


@dataclasses.dataclass
class Dataset:
    """Train/test split, batch-major float32 numpy arrays."""

    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    synthetic_images: bool = False

    @property
    def n_train(self) -> int:
        return self.train_x.shape[0]


def synthetic_images_for_labels(
    labels: np.ndarray,
    *,
    side: int = 28,
    num_classes: int = 10,
    seed: int = 123,
    noise_seed: int = 0,
    noise: float = 0.35,
) -> np.ndarray:
    """Deterministic MNIST-shaped images for a given label stream.

    Each class gets a smooth random prototype in [0,1]^(side*side); each
    sample is prototype + N(0, noise) clipped to [0,1], quantized to uint8
    like real MNIST pixels, then scaled back to [0,1] float32.

    ``seed`` fixes the class prototypes (must match between train and test
    splits of one dataset); ``noise_seed`` varies the per-sample noise.
    """
    rng = np.random.default_rng(seed)
    noise_rng = np.random.default_rng((seed, noise_seed))
    d = side * side
    # Smooth prototypes: low-frequency random fields.
    freqs = rng.normal(size=(num_classes, 8, 8))
    protos = np.zeros((num_classes, side, side), dtype=np.float64)
    yy, xx = np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, side), indexing="ij")
    for c in range(num_classes):
        field = np.zeros((side, side))
        for i in range(8):
            for j in range(8):
                field += freqs[c, i, j] * np.cos(np.pi * (i * yy + j * xx))
        field = (field - field.min()) / (field.max() - field.min() + 1e-12)
        protos[c] = field
    protos = protos.reshape(num_classes, d)

    labels = np.asarray(labels, dtype=np.int64)
    imgs = protos[labels] + noise * noise_rng.standard_normal((labels.shape[0], d))
    imgs = np.clip(imgs, 0.0, 1.0)
    imgs_u8 = np.round(imgs * 255.0).astype(np.uint8)
    return imgs_u8.astype(np.float32) / 255.0


def _load_split(
    images_path: Path,
    labels_path: Path,
    max_items: int,
    seed: int,
    noise_seed: int,
) -> tuple[np.ndarray, np.ndarray, bool]:
    y = read_idx_labels_onehot(labels_path, max_items)
    if images_path.exists() and images_path.stat().st_size > 1024:
        x = read_idx_images(images_path, max_items)
        return x, y, False
    labels = read_idx_labels_u8(labels_path, max_items)
    x = synthetic_images_for_labels(labels, seed=seed, noise_seed=noise_seed)
    return x, y, True


def _load(root: Path | str, sep: str, train_size: int, test_size: int, seed: int) -> Dataset:
    """Both splits from ``<split>-{images,labels}<sep>idx{3,1}-ubyte``."""
    root = Path(root)
    train_x, train_y, syn1 = _load_split(
        root / f"train-images{sep}idx3-ubyte", root / f"train-labels{sep}idx1-ubyte",
        train_size, seed, 0,
    )
    test_x, test_y, syn2 = _load_split(
        root / f"t10k-images{sep}idx3-ubyte", root / f"t10k-labels{sep}idx1-ubyte",
        test_size, seed, 1,
    )
    return Dataset(train_x, train_y, test_x, test_y, synthetic_images=syn1 or syn2)


def load_mnist(
    root: Path | str,
    train_size: int = 60000,
    test_size: int = 10000,
    seed: int = 123,
) -> Dataset:
    """MNIST from the IDX files in ``root`` (``train-labels.idx1-ubyte``
    etc.); no default root is assumed."""
    return _load(root, ".", train_size, test_size, seed)


def load_fashion_mnist(
    root: Path | str,
    train_size: int = 60000,
    test_size: int = 10000,
    seed: int = 456,
) -> Dataset:
    """Fashion-MNIST from the IDX files in ``root``, under their dashed
    names (``train-labels-idx1-ubyte`` etc.); no default root is assumed.
    Its own prototype seed keeps synthetic Fashion images apart from
    synthetic MNIST ones."""
    return _load(root, "-", train_size, test_size, seed)
