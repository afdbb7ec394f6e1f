"""Where a call of the resident two-loop kernel (K1) spends its time.

K1 is built twice from ``csrc/two_loop.cu``: the launched kernel and a
timestamped build of the same template (``two_loop_resident_kernel<T,
true>``), in which block 0 records ``%globaltimer`` and ``clock64`` after a
block barrier at each phase boundary. The study launches the timestamped
build on full wrapped m=10 rings at the MNIST width (n = 101,770), f32 and
bf16 pairs, with the L2 flushed before each call (as the solve leaves it),
and prints the mean time of each phase of block 0 (:data:`PHASES`): the
TMA copies of the pairs issued and v loaded, sweep 1 (which waits for each
group of four pairs to land before its tiles), reduction 1, the backward
recurrence, sweep 2, reduction 2, the forward recurrence and sweep 3;
then the same split with the L2 warm (no flush: the ring, and the
kernel's code, already in L2). The barriers the stamps add cost a little;
the launched kernel's time per call is printed beside the timestamped
build's.

It also measures the launch gap of K1 on the same rings: CUDA events around
each call (the wrapper's checks, allocations and the cooperative launch)
against the profiler's device time of the kernel and of all the kernels of
the call; the same events with a head start for the host (a spin kernel of
about 100 us queued before the start event, so that the host has queued the
call before the card reaches it: what is left is the card's own gap around
the launch); and last, on the f32 ring, the same call replayed from a
captured ``torch.cuda.CUDAGraph``, with and without the head start (or the
error that capture raises; nothing runs on the card after it).

Runs only on an NVIDIA GPU with nvcc. Usage:
  python -m lbfgs_ffnn_torch.experiments.resident_phase_study [--reps N]
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, N_STAMPS, launch
from lbfgs_ffnn_torch.ops.two_loop import empty_history_state, ring_push

# Block 0's phases, between consecutive stamps of the timestamped build.
PHASES = ("copies issued, v loaded", "sweep 1 as the pairs land", "reduction 1",
          "backward recurrence", "sweep 2", "reduction 2", "forward recurrence", "sweep 3")
M = 10
N = 101_770  # the MNIST 784-128-10 net


def phase_split(stamps: np.ndarray) -> dict[str, tuple[float, float]]:
    """Per phase, the mean over calls of (us by %globaltimer, cycles by
    clock64), from stamps of shape (calls, N_STAMPS, 2): boundary k of a
    call as (ns, cycles)."""
    if stamps.shape[1:] != (N_STAMPS, 2) or len(PHASES) != N_STAMPS - 1:
        raise ValueError(f"stamps of shape {stamps.shape}, expected (calls, {N_STAMPS}, 2)")
    d = np.diff(stamps.astype(np.float64), axis=1).mean(axis=0)
    return {label: (d[k, 0] * 1e-3, d[k, 1]) for k, label in enumerate(PHASES)}


def wrapped_ring(pair_dtype, dev, m: int = M, n: int = N, seed: int = 3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = empty_history_state(m, n, torch.float32, pair_dtype, device=dev)
    for _ in range(m + 3):
        s = torch.randn(n, generator=gen, device=dev)
        y = torch.randn(n, generator=gen, device=dev) + 0.5 * s
        hist = ring_push(hist, s, y, 1.0 / torch.dot(y, s), torch.dot(y, s) > 1e-3)
    return hist, torch.randn(n, generator=gen, device=dev)


HEAD_START_CYCLES = 200_000  # the spin kernel: ~100 us at the H100's ~2 GHz


def events_us(fn, flush, reps: int, head_start: bool = False) -> float:
    """Mean time of ``fn()`` by CUDA events around each call, the L2
    flushed before it; with ``head_start`` a spin kernel runs between the
    flush and the start event while the host queues the call."""
    pairs = []
    for _ in range(reps):
        flush.zero_()
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps * 1e3


def device_us(fn, flush, reps: int) -> tuple[float, float]:
    """(K1's device time, all the call's kernels' device time) per call
    from torch.profiler, the L2 flushed before each call (the flush's own
    fill kernel left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and "Fill" not in e.key]
    k1 = sum(e.self_device_time_total for e in rows if "two_loop_resident_kernel" in e.key)
    return k1 / reps, sum(e.self_device_time_total for e in rows) / reps


def graph_replay_us(fn, flush, reps: int) -> tuple[tuple[float, float] | None, str]:
    """Events per replay of ``fn`` captured in a CUDA graph, without and
    with the head start, and a note: whether the replay's result equals an
    eager call's bitwise, or the error that capture raised."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except Exception as exc:  # noqa: BLE001 -- the reading is the error itself
        return None, f"capture raised {type(exc).__name__}: {exc}"
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, eager)
    times = tuple(events_us(graph.replay, flush, reps, hs) for hs in (False, True))
    return times, f"replay bitwise equal to an eager call: {same}"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resident_phase_study needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, device=dev)  # 256 MB > the 50 MB L2
    results = {}
    for pd, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        hist, v = wrapped_ring(pd, dev)
        stamps = torch.zeros(args.reps, 2 * N_STAMPS, dtype=torch.int64, device=dev)
        plain = lambda: launch(COOPERATIVE, v, hist)  # noqa: E731
        stamped = lambda i=0: launch(COOPERATIVE, v, hist, stamps=stamps[i])  # noqa: E731
        plain(), stamped()  # warm-up
        splits = {}
        for how in ("L2 flushed before each", "L2 warm"):
            for i in range(args.reps):
                if how != "L2 warm":
                    flush.zero_()
                stamped(i)
            torch.cuda.synchronize()
            splits[how] = split = phase_split(stamps.view(args.reps, N_STAMPS, 2).cpu().numpy())
            print(f"m={M} n={N} {name}, wrapped ring, {args.reps} calls, {how}; block 0 by "
                  "%globaltimer (clock64 cycles): "
                  + ", ".join(f"{k} {us:.2f} us ({cyc:.0f})" for k, (us, cyc) in split.items())
                  + f"; sum {sum(us for us, _ in split.values()):.2f} us", flush=True)
        split = splits["L2 flushed before each"]
        t_plain, t_stamped = (events_us(f, flush, args.reps) for f in (plain, stamped))
        print(f"m={M} n={N} {name}: events per call, L2 flushed: kernel {t_plain:.2f} us, "
              f"timestamped build {t_stamped:.2f} us", flush=True)
        k1_dev, call_dev = device_us(plain, flush, 20)
        t_head = events_us(plain, flush, args.reps, head_start=True)
        print(f"m={M} n={N} {name}: launch gap: events {t_plain:.2f} us per call, "
              f"{t_head:.2f} us with the host's head start; profiler device time K1 "
              f"{k1_dev:.2f} us, all the call's kernels {call_dev:.2f} us; events - K1 device "
              f"{t_plain - k1_dev:.2f} us, with the head start {t_head - k1_dev:.2f} us",
              flush=True)
        results[name] = {"phases_us": {k: us for k, (us, _) in split.items()},
                         "warm_phases_us": {k: us for k, (us, _) in splits["L2 warm"].items()},
                         "events_us": t_plain, "head_start_events_us": t_head,
                         "stamped_events_us": t_stamped,
                         "k1_device_us": k1_dev, "call_device_us": call_dev}
        if name == "f32":
            ring = (hist, v)
        else:
            del hist, v
    hist, v = ring
    g_us, g_note = graph_replay_us(lambda: launch(COOPERATIVE, v, hist), flush, args.reps)
    graph = (f"{g_us[0]:.2f} us per replay, {g_us[1]:.2f} us with the head start ({g_note})"
             if g_us is not None else g_note)
    print(f"m={M} n={N} f32: the call replayed from a CUDA graph, L2 flushed before each "
          f"replay: {graph}; eager events {results['f32']['events_us']:.2f} us", flush=True)
    results["graph"] = {"replay_us": g_us, "note": g_note}
    return results


if __name__ == "__main__":
    main()
