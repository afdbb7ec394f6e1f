"""Where a cell's set-up goes and why its device sits idle, by the
program's own spans (:mod:`lbfgs_ffnn_torch.utils.profiling`), on the card:

    python3 -m benchmark.span_study --workload <cell> --seed <n> [--solves 3] [--json PATH]

in a process of its own, from the checkout's root. It runs the set-up of
``benchmark.run`` step by step (the port's import, the CUDA context, the
cell's data and problem, the first steps that capture the window's step,
one whole warm-up solve; before the first steps, one call of the
objective, where the card's first kernels load) and splits the time from
the process's start to the window's into those steps and the program's
spans (``native_s`` and ``capture_s`` by their readers, ``prepare``).
Then it times whole solves in turns, unrecorded and recorded
(``profiling.recording()``), each recorded one's gaps over its ``solve``
span and their host spans; last one solve under the profiler, as
``--trace 1`` traces it: its busy share, and its idle time split into
what the program's gaps hold and what they miss. The result is one JSON
line on standard output."""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402


def _overlap(a, b) -> float:
    """The length two lists of disjoint sorted intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _profiled(solve) -> dict:
    """One solve under the profiler, as ``--trace 1`` traces it, its
    window split (% of the window): the device's busy time, the program's
    gaps where the profiler saw the device idle (``seen``) or busy
    (``gap_busy``), the idle inside the solve that no gap holds (between a
    replay's kernels: ``unseen``), and the idle outside the ``solve`` span
    (``outside``: the window's syncs, the solve's own start)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark import timing

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window_s, res = timing.wall_s(solve)
    events = prof.events()
    busy = timing._merge([(e.time_range.start, e.time_range.end) for e in events
                          if e.device_type == DeviceType.CUDA])
    t = res.trace
    host = next(e for e in events if e.device_type == DeviceType.CPU and e.name == "solve")
    lo, hi = host.time_range.start, host.time_range.end  # µs on the profiler's clock
    shift = t.span.start_ns / 1e3 - lo
    gaps = sorted([g.start_ns / 1e3 - shift, g.end_ns / 1e3 - shift] for g in t.gaps)
    window, busy_us = window_s * 1e6, sum(b - a for a, b in busy)
    busy_in = _overlap(busy, [[lo, hi]])
    gap_us = sum(b - a for a, b in gaps)
    gap_busy = _overlap(gaps, busy)
    seen = gap_us - gap_busy
    out = {"window_s": window_s, "busy_s": busy_us / 1e6,
           "driver_idle_pct": 100.0 * (1.0 - busy_us / window),
           "host_gap_pct": 100.0 * t.gap_ns() / (t.span.end_ns - t.span.start_ns),
           "seen_pct": 100.0 * seen / window, "gap_busy_pct": 100.0 * gap_busy / window,
           "unseen_pct": 100.0 * ((hi - lo) - busy_in - seen) / window,
           "outside_pct": 100.0 * (window - (hi - lo) - (busy_us - busy_in)) / window}
    out.update(_gaps(t))
    return out


def _gaps(trace) -> dict:
    span_ns = trace.span.end_ns - trace.span.start_ns
    by = {k: v / 1e6 for k, v in list(trace.by_cause().items())[:6]}
    longest = sorted(trace.gaps, key=lambda g: g.start_ns - g.end_ns)[:5]
    return {"host_gap_pct": 100.0 * trace.gap_ns() / span_ns, "solve_ms": span_ns / 1e6,
            "gaps": len(trace.gaps), "gap_ms_by_span": by,
            "longest_ms": [[g.cause, (g.end_ns - g.start_ns) / 1e6] for g in longest]}


def study(name: str, seed: int, solves: int, device: str = "cuda", cell=None) -> dict:
    """The study of ``name`` (or of ``cell``, a loaded cell); on the CPU
    (a rehearsal at a tiny size) without the CUDA context and the profiled
    solve."""
    from benchmark import catalog, data, run, timing

    root = catalog.root_of()
    run.cache_dirs(root)
    started = run.process_age_s() - (time.perf_counter() - _T0)
    t = time.perf_counter()
    import torch
    torch_s = time.perf_counter() - t
    t = time.perf_counter()
    import lbfgs_ffnn_torch  # noqa: F401
    from lbfgs_ffnn_torch.utils import profiling
    port_s = time.perf_counter() - t
    harness_s = time.perf_counter() - _T0 - torch_s - port_s
    cell = cell or catalog.load_cell(name, root)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t = time.perf_counter()
    card = f"{torch.cuda.get_device_name(0)} ({run.power_limit()})" if on_card else "cpu"
    torch.zeros(1, device=dev)
    sync()
    context_s = time.perf_counter() - t
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, model = cell.kind, cell.model
    obj = model.objective(cell.config, cell.traffic.get("lam", 0.0))
    k = int(cell.traffic["check_steps"])

    def start(i):
        return (model.start(obj, data.sub_seed(seed, 1, i), dev),
                data.sub_seed(seed, 2, i) % 2 ** 31)

    t = time.perf_counter()
    inputs = model.inputs(cell.config, seed, dev)
    program = kind.build(model, cell.config, cell.traffic, inputs, dev)
    w0, s0 = start(0)
    sync()
    data_s = time.perf_counter() - t
    t = time.perf_counter()
    call, _ = kind.batch_vag(program)  # the objective's first kernels on the card
    call()
    sync()
    first_call_s = time.perf_counter() - t
    t = time.perf_counter()
    kind.first_steps(program, w0, s0, 1)
    kind.first_steps(program, w0, s0, k)
    sync()
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    kind.solve(program, w0, s0)
    sync()
    warm_s = time.perf_counter() - t
    setup_s = run.process_age_s()
    native_s = catalog.reader("native_s", root)(None) or 0.0
    capture_s = catalog.reader("capture_s", root)(None) or 0.0
    prepare_s = sum(s.seconds for s in profiling.spans("prepare"))
    import_s = profiling.last("import").seconds
    first_rest = first_s - native_s - capture_s - prepare_s
    parts = {"interpreter": started, "harness_imports": harness_s, "torch_import": torch_s,
             "port_import": import_s, "port_import_rest": port_s - import_s,
             "cuda_context": context_s, "data_and_problem": data_s,
             "first_objective_call": first_call_s, "native_s": native_s,
             "capture_s": capture_s, "prepare": prepare_s, "first_steps_rest": first_rest,
             "warm_up_solve": warm_s}
    parts["rest"] = setup_s - sum(parts.values())
    capture_parts = {name: sum(s.seconds for s in profiling.spans(name))
                     for name in ("capture.eager", "capture.check", "capture.graph")}

    walls = {"off": [], "on": []}
    recorded = []
    for i in range(1, 2 * solves + 1):
        wi, si = start((i + 1) // 2)
        on = i % 2 == 0
        sync()
        t = time.perf_counter()
        if on:
            with profiling.recording():
                res = kind.solve(program, wi, si)
        else:
            res = kind.solve(program, wi, si)
        float(res.final_loss)
        sync()
        walls["on" if on else "off"].append((time.perf_counter() - t) * 1e3 / int(res.n_iters))
        if on and on_card:
            recorded.append(_gaps(res.trace))
    profiled = None
    if on_card:
        profiled = _profiled(lambda: kind.solve(program, w0, s0))
        bare = timing.wall_s(lambda: kind.solve(program, w0, s0))[0]
        profiled.update(idle_pct=100.0 * (1.0 - profiled["busy_s"] / bare), bare_s=bare)
    return {"cell": name, "seed": seed, "card": card, "setup_s": setup_s, "setup_split_s": parts,
            "capture_split_s": capture_parts,
            "counters": dict(profiling.PROCESS.counters),
            f"{kind.unit}_ms": {m: {"median": statistics.median(v), "runs": v}
                                for m, v in walls.items()},
            "recording_cost_pct": 100.0 * (statistics.median(walls["on"])
                                           / statistics.median(walls["off"]) - 1.0),
            "recorded": recorded, "profiled": profiled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--solves", type=int, default=3, help="solves each way, in turns")
    ap.add_argument("--json", default=None, help="also write the result to this file")
    args = ap.parse_args(argv)
    out = study(args.workload, args.seed, args.solves)
    line = json.dumps(out)
    if args.json:
        with open(args.json, "a") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
