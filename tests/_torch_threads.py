"""Caps torch's intra-op threads in a process that runs the port's tests.

Under pytest-xdist every worker runs torch with a thread pool as wide as
the machine, beside JAX's own pools, so six workers on eight cores run
dozens of busy threads and the port's heaviest files take many times their
single-process time. Each ``tests/test_torch_*.py`` imports this module
first; it sets ``torch.set_num_threads`` to the cores this process may use
divided by ``PYTEST_XDIST_WORKER_COUNT`` (1 without xdist), at least 1,
before any torch operation."""

import os

import torch


def thread_cap() -> int:
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (cores or 1) // max(workers, 1))


torch.set_num_threads(thread_cap())
