"""IDX (MNIST-family) file IO.

Counterpart of :mod:`lbfgs_ffnn_tpu.data.idx` on its default path: the
native runtime (``lbfgs_ffnn_torch/runtime/runtime.cpp``) parses,
normalizes (times float32(1/255)) and one-hot encodes in one pass, and
writes IDX files; its errors are JAX's (``OSError`` naming the function and
its code: -1 open, -2 magic or dtype, -3 read, -4 arguments). The port also
reads uint8 labels through the library, where JAX reads them with numpy:
the same bytes, and an ``OSError`` on a file that is not IDX.

The ``*_plain`` functions are the numpy versions that the tests hold the
library against; the port never switches to them on its own. Their images
divide by 255, so they may differ from the library's by one float32 ulp.

Images come back batch-major ``(n, rows*cols)`` float32 scaled to [0, 1];
labels one-hot ``(n, num_classes)`` float32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from lbfgs_ffnn_torch.runtime.native import get_lib


def _query(lib, path: str) -> tuple[int, int]:
    n_items, elems = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.idx_query(path.encode(), ctypes.byref(n_items), ctypes.byref(elems))
    if rc != 0:
        raise IOError(f"idx_query({path}) failed: {rc}")
    return n_items.value, elems.value


def _load(path, max_items: int, fn: str, cols, dtype, *args) -> np.ndarray:
    """``fn(path, n, *args, out, &n_loaded)`` into an ``(n, cols)`` array
    (``cols`` None: the file's item size; 0: a vector)."""
    path = str(path)
    lib = get_lib()
    n_items, elems = _query(lib, path)
    n = min(max_items, n_items) if max_items > 0 else n_items
    cols = elems if cols is None else cols
    out = np.empty((n, cols) if cols else (n,), dtype=dtype)
    n_loaded = ctypes.c_int64()
    ctype = np.ctypeslib.as_ctypes_type(dtype)
    rc = getattr(lib, fn)(path.encode(), n, *args, out.ctypes.data_as(ctypes.POINTER(ctype)),
                          ctypes.byref(n_loaded))
    if rc != 0:
        raise IOError(f"{fn}({path}) failed: {rc}")
    return out[: n_loaded.value]


def read_idx_images(path: str | Path, max_items: int = 0) -> np.ndarray:
    """Load images as (n, elems) float32 in [0, 1]."""
    return _load(path, max_items, "idx_load_images_f32", None, np.float32)


def read_idx_labels_u8(path: str | Path, max_items: int = 0) -> np.ndarray:
    """Load labels as (n,) uint8."""
    return _load(path, max_items, "idx_load_labels_u8", 0, np.uint8)


def read_idx_labels_onehot(
    path: str | Path, max_items: int = 0, num_classes: int = 10
) -> np.ndarray:
    """Load labels one-hot encoded as (n, num_classes) float32 (a label
    >= num_classes gives a zero row, as JAX's native loader does)."""
    return _load(path, max_items, "idx_load_labels_onehot_f32", num_classes, np.float32,
                 num_classes)


def write_idx_u8(path: str | Path, data: np.ndarray) -> None:
    """Write a uint8 array as an IDX file (for synthetic fixtures)."""
    path = str(path)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    dims = (ctypes.c_int64 * data.ndim)(*data.shape)
    rc = get_lib().idx_write_u8(path.encode(),
                                data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                dims, data.ndim)
    if rc != 0:
        raise IOError(f"idx_write_u8({path}) failed: {rc}")


# ---------------------------------------------------------------------------
# Plain numpy versions
# ---------------------------------------------------------------------------


def _read_header(f) -> tuple[int, np.ndarray]:
    hdr = f.read(4)
    if len(hdr) != 4 or hdr[0] != 0 or hdr[1] != 0:
        raise ValueError(f"{f.name}: not an IDX file")
    if hdr[2] != 0x08:
        raise ValueError(f"{f.name}: unsupported IDX dtype {hdr[2]:#x}")
    ndim = hdr[3]
    dims = np.frombuffer(f.read(4 * ndim), dtype=">u4").astype(np.int64)
    return ndim, dims


def read_idx_images_plain(path: str | Path, max_items: int = 0) -> np.ndarray:
    with open(path, "rb") as f:
        ndim, dims = _read_header(f)
        n = min(max_items, dims[0]) if max_items > 0 else dims[0]
        elems = int(np.prod(dims[1:])) if ndim > 1 else 1
        raw = np.frombuffer(f.read(int(n) * elems), dtype=np.uint8)
    return raw.reshape(int(n), elems).astype(np.float32) / 255.0


def read_idx_labels_u8_plain(path: str | Path, max_items: int = 0) -> np.ndarray:
    with open(path, "rb") as f:
        _, dims = _read_header(f)
        n = min(max_items, dims[0]) if max_items > 0 else dims[0]
        return np.frombuffer(f.read(int(n)), dtype=np.uint8).copy()


def read_idx_labels_onehot_plain(
    path: str | Path, max_items: int = 0, num_classes: int = 10
) -> np.ndarray:
    labels = read_idx_labels_u8_plain(path, max_items)
    out = np.zeros((labels.shape[0], num_classes), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def write_idx_u8_plain(path: str | Path, data: np.ndarray) -> None:
    data = np.ascontiguousarray(data, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, data.ndim]))
        f.write(np.asarray(data.shape, dtype=">u4").tobytes())
        f.write(data.tobytes())
