"""IDX (MNIST-family) file IO, numpy only.

Counterpart of :mod:`lbfgs_ffnn_tpu.data.idx` without its native fast path:
that path is reached through the JAX package's ``__init__``, so the port
parses the big-endian IDX layout with numpy alone.

Images come back batch-major ``(n, rows*cols)`` float32 scaled to [0, 1];
labels one-hot ``(n, num_classes)`` float32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _read_header(f) -> tuple[int, np.ndarray]:
    hdr = f.read(4)
    if len(hdr) != 4 or hdr[0] != 0 or hdr[1] != 0:
        raise ValueError(f"{f.name}: not an IDX file")
    if hdr[2] != 0x08:
        raise ValueError(f"{f.name}: unsupported IDX dtype {hdr[2]:#x}")
    ndim = hdr[3]
    dims = np.frombuffer(f.read(4 * ndim), dtype=">u4").astype(np.int64)
    return ndim, dims


def read_idx_images(path: str | Path, max_items: int = 0) -> np.ndarray:
    """Load images as (n, elems) float32 in [0, 1]."""
    with open(path, "rb") as f:
        ndim, dims = _read_header(f)
        n = min(max_items, dims[0]) if max_items > 0 else dims[0]
        elems = int(np.prod(dims[1:])) if ndim > 1 else 1
        raw = np.frombuffer(f.read(int(n) * elems), dtype=np.uint8)
    return raw.reshape(int(n), elems).astype(np.float32) / 255.0


def read_idx_labels_u8(path: str | Path, max_items: int = 0) -> np.ndarray:
    with open(path, "rb") as f:
        _, dims = _read_header(f)
        n = min(max_items, dims[0]) if max_items > 0 else dims[0]
        return np.frombuffer(f.read(int(n)), dtype=np.uint8).copy()


def read_idx_labels_onehot(
    path: str | Path, max_items: int = 0, num_classes: int = 10
) -> np.ndarray:
    """Load labels one-hot encoded as (n, num_classes) float32."""
    labels = read_idx_labels_u8(path, max_items)
    out = np.zeros((labels.shape[0], num_classes), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def write_idx_u8(path: str | Path, data: np.ndarray) -> None:
    """Write a uint8 array as an IDX file (for synthetic fixtures)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, data.ndim]))
        f.write(np.asarray(data.shape, dtype=">u4").tobytes())
        f.write(data.tobytes())
