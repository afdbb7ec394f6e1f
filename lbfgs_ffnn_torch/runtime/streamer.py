"""Prefetching minibatch streamer.

Counterpart of :class:`lbfgs_ffnn_tpu.runtime.streamer.BatchStreamer`,
with its interface and its pure-Python stream: epoch e is the permutation
``np.random.default_rng((seed, e)).permutation(n)`` cut into batches of
``batch_size`` rows, a trailing short batch zero-padded past its ``count``
(or dropped with ``drop_last``). The JAX package's native producer, whose
permutation stream differs, has no counterpart here.

A producer thread gathers each batch into one of a ring of ``depth`` host
staging buffers while the consumer works on the ones before it; the
buffers are pinned when the consumer's device is CUDA, so that the copy to
the card can be ``non_blocking``. The gather is numpy's, which holds the
interpreter lock for part of its work, so the thread overlaps the
consumer's waits on the device more than its Python. Use it to feed a
host-driven loop (:func:`lbfgs_ffnn_torch.solvers.sgd.sgd_streaming`) when
the data should not live on the device whole.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class BatchStreamer:
    """Endless stream of shuffled ``(x_batch, y_batch, count, epoch)``.

    ``x``/``y`` are ``(n, xdim)``/``(n, ydim)`` arrays, read as float32 (a
    copy only where they are not float32 and contiguous already), but a
    uint8 ``x`` (pixel-quantized, ``objectives.mlp.quantize_pixels``) stays
    uint8: a quarter of the bytes to gather and copy. ``device`` is the
    consumer's: CUDA pins the staging buffers. The batches are CPU tensors
    (x's dtype, y float32) of ``batch_size`` rows, the rows past ``count``
    zero; they
    are staging buffers, valid until the following :meth:`next` (or
    :meth:`close`), which hands the buffer back to the producer.
    """

    def __init__(self, x, y, batch_size: int, seed: int = 123, depth: int = 4,
                 drop_last: bool = False, device: str | torch.device = "cpu"):
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
        self.pinned = torch.device(device).type == "cuda"
        self._buffers = [
            tuple(torch.zeros((self.batch_size, a.shape[1]), dtype=torch.from_numpy(a[:0]).dtype,
                              pin_memory=self.pinned) for a in (self._x, self._y))
            for _ in range(depth)]
        self._free: queue.Queue = queue.Queue()
        for slot in range(depth):
            self._free.put(slot)
        self._ready: queue.Queue = queue.Queue()
        self._held = None  # the slot the consumer holds
        self._thread = threading.Thread(target=self._produce, name="BatchStreamer",
                                        daemon=True)
        self._thread.start()

    def _produce(self) -> None:
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
        """Stop the producer and wait for it (at most ``depth`` more batches
        of its work)."""
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
