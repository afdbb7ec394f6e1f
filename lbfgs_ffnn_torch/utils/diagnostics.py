"""Run diagnostics and timing helpers.

Counterpart of :mod:`lbfgs_ffnn_tpu.utils.diagnostics`.
:func:`check_parallelism` is the port's form of the reference's
``checkParallelism()`` thread report (reference: src/common.hpp:45-64): the
backend, the devices and their names, the process topology and torch's
intra-op threads. :func:`sync_time` times a thunk on the wall clock,
waiting for the device of its result first: PyTorch returns before a CUDA
device has finished.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def check_parallelism(verbose: bool = True) -> dict:
    """The backend ("cuda" when a card is visible, else "cpu"), the device
    count and names, and the process topology under JAX's keys (process 0
    of 1 unless ``torch.distributed`` is initialised), plus ``n_threads``,
    torch's intra-op threads."""
    cuda = torch.cuda.is_available()
    if cuda:
        n = torch.cuda.device_count()
        devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(n)]
    else:
        n, devices = 1, ["cpu"]
    dist = torch.distributed.is_available() and torch.distributed.is_initialized()
    info = {
        "backend": "cuda" if cuda else "cpu",
        "n_devices": n,
        "n_local_devices": n,
        "process_index": torch.distributed.get_rank() if dist else 0,
        "process_count": torch.distributed.get_world_size() if dist else 1,
        "devices": devices,
        "n_threads": torch.get_num_threads(),
    }
    if verbose:
        print(f"backend={info['backend']} devices={info['n_devices']} "
              f"(local {info['n_local_devices']}), "
              f"process {info['process_index']}/{info['process_count']}, "
              f"{info['n_threads']} intra-op threads")
        for d in info["devices"]:
            print(f"  {d}")
    return info


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for item in tree:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def sync_time(thunk: Callable[[], object], reps: int = 1) -> tuple[float, object]:
    """Best-of-``reps`` wall time of ``thunk()`` in seconds, and its last
    result; each call waits for the device of the result's first tensor
    (a CUDA synchronize; nothing to wait for on the CPU)."""
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = thunk()
        first = _first_tensor(out)
        if first is not None and first.is_cuda:
            torch.cuda.synchronize(first.device)
        best = min(best, time.perf_counter() - t0)
    return best, out
