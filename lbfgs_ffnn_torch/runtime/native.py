"""The native host runtime (``runtime.cpp``) through ctypes.

:func:`get_lib` builds ``runtime.cpp`` with g++ at first use
(:func:`lbfgs_ffnn_torch._build.build_host`, into ``build/``), loads it
with :class:`ctypes.CDLL`, whose calls release the interpreter lock, and
declares every function's ``argtypes`` and ``restype``. A build that fails
raises with the compiler's stderr: the callers have plain numpy versions
(the tests hold the library against them), but they never switch to them
on their own, since the numpy stream of :class:`BatchStreamer` is a
different result.

Counterpart of :func:`lbfgs_ffnn_tpu.runtime.get_lib`, which returns None
where it cannot build and lets its callers fall back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

from lbfgs_ffnn_torch import _build
from lbfgs_ffnn_torch.utils import profiling

SRC = Path(__file__).resolve().parent / "runtime.cpp"
ERR_PRODUCER = -5  # streamer_next: the producer thread failed (runtime.cpp)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def get_lib() -> ctypes.CDLL:
    """The loaded runtime, built first if the cached build is not current."""
    global _lib
    with _lock:
        if _lib is None:
            with profiling.span("native.load", SRC.stem):
                _lib = _declare(ctypes.CDLL(str(_build.build_host(SRC).path)))
        return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, c_int, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    p_i64 = ctypes.POINTER(i64)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_vp = ctypes.POINTER(vp)
    sigs = {
        "idx_query": ([ctypes.c_char_p, p_i64, p_i64], c_int),
        "idx_load_images_f32": ([ctypes.c_char_p, i64, p_f32, p_i64], c_int),
        "idx_load_labels_onehot_f32": ([ctypes.c_char_p, i64, c_int, p_f32, p_i64], c_int),
        "idx_load_labels_u8": ([ctypes.c_char_p, i64, p_u8, p_i64], c_int),
        "idx_write_u8": ([ctypes.c_char_p, p_u8, p_i64, c_int], c_int),
        "csv_write_history": ([ctypes.c_char_p, p_f64, p_f64, p_f64, i64, c_int], c_int),
        "streamer_create": ([vp, vp, i64, i64, i64, i64, ctypes.c_uint64, c_int, c_int,
                             p_vp, p_vp], i64),
        "streamer_next": ([i64, i64, p_i64, p_i64, p_i64], c_int),
        "streamer_destroy": ([i64], c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
