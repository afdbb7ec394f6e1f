"""Host-side runtime: the prefetching minibatch streamer.

Counterpart of :mod:`lbfgs_ffnn_tpu.runtime`, whose native C++ library
(IDX parsing, CSV writing, the streamer's producer) has no counterpart: the
port's loader and CSV writer are plain Python, and its streamer's producer
is a Python thread."""

from lbfgs_ffnn_torch.runtime.streamer import BatchStreamer

__all__ = ["BatchStreamer"]
