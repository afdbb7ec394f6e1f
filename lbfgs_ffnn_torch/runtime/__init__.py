"""Host-side runtime: the native library and the prefetching minibatch
streamer.

Counterpart of :mod:`lbfgs_ffnn_tpu.runtime`. ``runtime.cpp`` (IDX
parsing, one-hot encoding, CSV writing, the streamer's producer thread) is
built with g++ at first use and loaded with ctypes (:func:`get_lib`);
:class:`BatchStreamer` draws JAX's default (native) batch stream from it,
or JAX's numpy stream with ``force_fallback=True``."""

from lbfgs_ffnn_torch.runtime.native import get_lib
from lbfgs_ffnn_torch.runtime.streamer import BatchStreamer

__all__ = ["BatchStreamer", "get_lib"]
