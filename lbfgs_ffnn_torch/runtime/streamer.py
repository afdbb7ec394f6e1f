"""Prefetching minibatch streamer.

Counterpart of :class:`lbfgs_ffnn_tpu.runtime.streamer.BatchStreamer`,
with its interface and both its streams. By default the producer is the
native runtime's (``runtime.cpp``, a C++ thread): epoch e is a Fisher-Yates
shuffle drawn from ``std::mt19937_64(seed ^ 0x9e3779b97f4a7c15 * (e + 1))``
through ``std::uniform_int_distribution<int64_t>``, the JAX package's
default stream bit for bit (on one C++ standard library: the distribution
is the library's). With ``force_fallback=True`` it is JAX's pure-Python
stream instead: epoch e is ``np.random.default_rng((seed, e)).permutation(n)``,
gathered by a Python thread. Either way the permutation is cut into batches
of ``batch_size`` rows, a trailing short batch zero-padded past its
``count`` (or dropped with ``drop_last``).

The producer gathers each batch into one of a ring of ``depth`` host
staging buffers (torch tensors, pinned when the consumer's device is CUDA,
so that the copy to the card can be ``non_blocking``) while the consumer
works on the ones before it. The native producer gathers into those
buffers directly and holds no interpreter lock, and :meth:`next` is one
ctypes call, which releases the lock while it waits; the Python producer's
numpy gather holds the lock for part of its work. Use it to feed a
host-driven loop (:func:`lbfgs_ffnn_torch.solvers.sgd.sgd_streaming`) when
the data should not live on the device whole.
"""

from __future__ import annotations

import ctypes
import queue
import threading

import numpy as np
import torch

from lbfgs_ffnn_torch.runtime.native import ERR_PRODUCER, get_lib


class BatchStreamer:
    """Endless stream of shuffled ``(x_batch, y_batch, count, epoch)``.

    ``x``/``y`` are ``(n, xdim)``/``(n, ydim)`` arrays, read as float32 (a
    copy only where they are not float32 and contiguous already), but a
    uint8 ``x`` (pixel-quantized, ``objectives.mlp.quantize_pixels``) stays
    uint8: a quarter of the bytes to gather and copy. They must stay alive
    while the streamer is open: the native producer reads them in place.
    ``device`` is the consumer's: CUDA pins the staging buffers. The
    batches are CPU tensors (x's dtype, y float32) of ``batch_size`` rows,
    the rows past ``count`` zero; they are staging buffers, valid until the
    following :meth:`next` (or :meth:`close`), which hands the buffer back
    to the producer. ``native`` says which producer runs: the native one
    unless ``force_fallback``; a native runtime that cannot be built raises
    (no quiet fallback: the two streams differ).
    """

    def __init__(self, x, y, batch_size: int, seed: int = 123, depth: int = 4,
                 drop_last: bool = False, force_fallback: bool = False,
                 device: str | torch.device = "cpu"):
        x = np.asarray(x)
        self._x = np.ascontiguousarray(x, dtype=np.uint8 if x.dtype == np.uint8 else np.float32)
        self._y = np.ascontiguousarray(y, dtype=np.float32)
        if self._x.ndim != 2 or self._y.ndim != 2 or len(self._x) != len(self._y):
            raise ValueError("x, y must be 2-D with matching leading dim")
        if len(self._x) == 0 or batch_size < 1 or depth < 1:
            raise ValueError(f"need n >= 1, batch_size >= 1 and depth >= 1, got n="
                             f"{len(self._x)}, batch_size={batch_size}, depth={depth}")
        self.n = self._x.shape[0]
        self.batch_size = min(batch_size, self.n)
        self.seed = seed
        self.depth = depth
        self.drop_last = drop_last
        self.native = not force_fallback
        self.pinned = torch.device(device).type == "cuda"
        self._buffers = [
            tuple(torch.zeros((self.batch_size, a.shape[1]), dtype=torch.from_numpy(a[:0]).dtype,
                              pin_memory=self.pinned) for a in (self._x, self._y))
            for _ in range(depth)]
        self._held = None  # the slot the consumer holds
        self._handle = self._thread = None
        if self.native:
            self._lib = get_lib()
            slots = [(ctypes.c_void_p * depth)(*(b[i].data_ptr() for b in self._buffers))
                     for i in (0, 1)]
            handle = self._lib.streamer_create(
                self._x.ctypes.data, self._y.ctypes.data, self.n, self._x.strides[0],
                self._y.strides[0], self.batch_size, seed, depth, int(drop_last), *slots)
            if handle <= 0:
                raise RuntimeError(f"streamer_create failed: {handle}")
            self._handle = handle
            return
        self._free: queue.Queue = queue.Queue()
        for slot in range(depth):
            self._free.put(slot)
        self._ready: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._produce, name="BatchStreamer",
                                        daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        """The fallback's producer: JAX's numpy stream."""
        try:
            epoch = 0
            while True:
                perm = np.random.default_rng((self.seed, epoch)).permutation(self.n)
                for off in range(0, self.n, self.batch_size):
                    idx = perm[off:off + self.batch_size]
                    count = len(idx)
                    if count < self.batch_size and self.drop_last:
                        break
                    slot = self._free.get()
                    if slot is None:  # closed
                        return
                    for src, buf in zip((self._x, self._y), self._buffers[slot]):
                        out = buf.numpy()
                        np.take(src, idx, axis=0, out=out[:count], mode="clip")
                        out[count:] = 0.0
                    self._ready.put((slot, count, epoch))
                epoch += 1
        except Exception as exc:  # the thread's boundary: next() raises it
            self._ready.put(exc)

    def next(self) -> tuple[torch.Tensor, torch.Tensor, int, int]:
        """Blocking pop of the next prefetched batch; hands the previous
        one's buffer back to the producer."""
        if self._handle is not None:
            slot, count, epoch = (ctypes.c_int64() for _ in range(3))
            release = -1 if self._held is None else self._held
            self._held = None
            rc = self._lib.streamer_next(self._handle, release, ctypes.byref(slot),
                                         ctypes.byref(count), ctypes.byref(epoch))
            if rc == ERR_PRODUCER:
                raise RuntimeError("the streamer's producer failed")
            if rc != 0:
                raise RuntimeError(f"streamer_next failed: {rc}")
            item = slot.value, count.value, epoch.value
        else:
            if self._thread is None:
                raise RuntimeError("the streamer is closed")
            if self._held is not None:
                self._free.put(self._held)
                self._held = None
            item = self._ready.get()
            if isinstance(item, Exception):
                raise RuntimeError("the streamer's producer failed") from item
        slot, count, epoch = item
        self._held = slot
        xb, yb = self._buffers[slot]
        return xb, yb, count, epoch

    def close(self) -> None:
        """Stop the producer and wait for it (the Python one: at most
        ``depth`` more batches of its work)."""
        if self._handle is not None:
            self._lib.streamer_destroy(self._handle)  # joins the producer
            self._handle = None
            return
        if self._thread is None:
            return
        self._free.put(None)
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise RuntimeError("the streamer's producer did not stop")
        self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort; close() is the supported path
        try:
            self.close()
        except Exception:
            pass
