"""Device timings for the per-layer metrics, on the card only.

``cold_us``: CUDA events around each call with the L2 flushed before it,
as a solve leaves it (each iteration streams the input through the L2),
and a spin kernel queued after the flush so that the call's host-side
Python is not in its time. ``slope_us``: a call chained K times in one
CUDA graph, replayed; the time per call is the slope between two chain
lengths, which cancels the fixed costs. ``profile``: a torch.profiler trace
of one call, reduced to the device's busy time (the union of its kernels'
intervals), the operations that took most of it and the longest gaps, each
named by what the host was doing then.
"""

from __future__ import annotations

import time

import torch

HEAD_START_CYCLES = 2_000_000  # ~1 ms of spin at the H100's clock


def cold_us(fn, reps: int = 50, l2_bytes: int = 50 * 2 ** 20) -> float:
    flush = torch.empty(2 * l2_bytes // 4, dtype=torch.float32, device="cuda")  # twice the L2
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps * 1e3


def slope_us(fn, k1: int, k2: int, reps: int = 3) -> float:
    """Microseconds per call of ``fn`` (which returns tensors): the best of
    ``reps`` replays of graphs holding ``k1`` and ``k2`` calls."""
    def chain_ms(k):
        fn()  # outside the capture: cuBLAS handles, the allocator
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(k):
                fn()
        best = float("inf")
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        del graph
        return best

    t1, t2 = chain_ms(k1), chain_ms(k2)
    return (t2 - t1) / (k2 - k1) * 1e3


def wall_s(fn):
    """``(seconds, result)`` of ``fn()`` by the host clock, the device
    idle at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _merge(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def profile(fn, top: int = 10) -> dict:
    """Trace ``fn()``: ``{"busy_s", "window_s", "device_ops", "idle_gaps",
    "result"}``; ``device_ops`` the ``top`` device operations by total
    time, ``idle_gaps`` the ``top`` longest gaps between device work, each
    named by the innermost host operation running when it began."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window, result = wall_s(fn)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    merged = _merge([(e.time_range.start, e.time_range.end) for e in device])
    busy_us = sum(hi - lo for lo, hi in merged)
    totals: dict[str, float] = {}
    for e in device:
        totals[e.name] = totals.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for lo, hi in gaps:
        covering = [e for e in host if e.time_range.start <= lo < e.time_range.end]
        name = min(covering, key=lambda e: e.time_range.end - e.time_range.start).name \
            if covering else "host idle"
        named.append([name, (hi - lo) / 1e6])
    return {"busy_s": busy_us / 1e6, "window_s": window, "result": result,
            "device_ops": [[name, us / 1e6] for name, us in device_ops],
            "idle_gaps": named}
