"""Run one cell of the benchmark once, on the card this process sees.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. The cell's configuration names its model family
(``benchmark/models/<model>.py``) and its mix its solver kind
(``benchmark/kinds/<solver>.py``). Set-up makes the cell's data and the
checked start from ``--seed`` on the card, builds the program's problem,
runs its first steps through the step it captures and caches (the window
replays that same step; those steps are what the correctness check
reads), then one whole solve from the same start, so that every shape and
path of the window is warm. The window then runs whole solves back to
back, each from an initial point (and, stochastic, a sampler seed) drawn
from ``--seed``, the first from the checked start, until ``--seconds``
have passed; the rate is the window's wall time over the iterations
(epochs) it completed. After the window, where the solver keeps a
curvature history, one more whole solve leaves its history and the
solver's dispatch is applied to it; where it draws batches, its draws for
the checked epochs are taken. With ``--trace 1`` the same window runs, then
one solve under the profiler and the per-layer metrics' readers
(``benchmark/metrics/<name>.py``). Last, the program's state is freed and
the plain reference (``benchmark/reference``) follows the checked steps and
the history's two-loop; ``correct`` holds when each compared number is
within its limit (``benchmark/limits/<cell>.json``).

The last line of standard output is one JSON object; the compared numbers
and their limits are also the last lines of standard error. The run
exits 1 without a result when no card is visible or the cell asks for
more cards than there are, and 3 when ``jax``, ``jaxlib``, ``flax`` or
``lbfgs_ffnn_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import os
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lbfgs_ffnn_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start; the time since this module was loaded where that is unreadable."""
    try:
        with open(f"/proc/{os.getpid()}/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def cache_dirs(root: Path) -> None:
    """Fixed kernel-cache directories inside the checkout."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "1")  # one process, few threads


def loaded_forbidden() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


class Context:
    """What a per-layer metric's reader reads: the window's solves and
    their counters, the traced solve, the peaks, and probes timed on
    demand (each at most once)."""

    def __init__(self, solves, window_s, setup_s, trace, peaks, probes):
        self.solves, self.window_s, self.setup_s = solves, window_s, setup_s
        self.trace, self.peaks = trace, peaks
        self._probes, self._done = probes, {}

    def total(self, field: str) -> int:
        return sum(s[field] for s in self.solves)

    def probe(self, name: str):
        if name not in self._done:
            self._done[name] = self._probes[name]() if name in self._probes else None
        return self._done[name]

    def flops_share(self) -> float | None:
        """The window's required operations over its time at the f32 peak, %."""
        if self.peaks is None:
            return None
        return 100.0 * self.total("flops") / (self.window_s * self.peaks["f32_flops"])

    def idle_pct(self) -> float | None:
        """1 - the traced solve's device busy time over the same solve's
        faster unprofiled wall time, %."""
        if self.trace is None or self.trace["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["bare_s"])

    def roofline(self, probe: str) -> float | None:
        """A probe's least time at the peaks (its operations at the f32
        rate or its bytes at the HBM rate, whichever is longer) over its
        measured time, %."""
        p = self.probe(probe)
        if p is None or self.peaks is None:
            return None
        least_s = max(p["flops"] / self.peaks["f32_flops"], p["bytes"] / self.peaks["hbm_bytes"])
        return 100.0 * least_s * 1e6 / p["us"]


def _probes(kind, program, held, peaks):
    from benchmark import counts, drive, timing

    def two_loop():
        if held is None:
            return None
        ring, v = held["ring"], held["v"]
        us = timing.cold_us(lambda: drive.direction(v, ring, kind.clamp_gamma),
                            l2_bytes=peaks["l2_bytes"])
        pairs, n = int(ring.count), v.shape[0]
        return {"us": us, "pairs": pairs, "flops": counts.two_loop_flops(n, pairs),
                "bytes": counts.two_loop_bytes(n, pairs, ring.S.element_size())}

    def vag():
        call, rows = kind.batch_vag(program)
        k1, k2 = (2, 10) if rows > 10_000 else (20, 100)
        return {"us": timing.slope_us(call, k1, k2), "rows": rows,
                "flops": program.work.vag(rows), "bytes": program.work.vag_bytes(rows)}

    return {"two_loop": two_loop, "vag": vag}


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path | None = None, log=None, keep: dict | None = None) -> dict:
    """One run of ``cell`` (a :class:`benchmark.catalog.Cell`): the result
    object the command prints, without the device check. ``keep``, where
    given, receives the checked start and the program's history, its
    vector and its direction (what :mod:`benchmark.control` reads)."""
    import torch

    from benchmark import catalog, check, data, drive, peaks as peak_table, timing
    from benchmark.reference import lbfgs as ref_lbfgs
    from benchmark.reference.precision import precision

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations are f32 with TF32 off
    torch.backends.cudnn.allow_tf32 = False
    kind, model = cell.kind, cell.model
    obj = model.objective(cell.config, cell.traffic.get("lam", 0.0))
    k = int(cell.traffic["check_steps"])

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def start(i):
        """Solve i's initial point and sampler seed."""
        return (model.start(obj, data.sub_seed(seed, 1, i), dev),
                data.sub_seed(seed, 2, i) % 2 ** 31)

    inputs = model.inputs(cell.config, seed, dev)
    program = kind.build(model, cell.config, cell.traffic, inputs, dev)
    w0, s0 = start(0)
    first = kind.first_steps(program, w0, s0, 1)  # captures the step the window replays
    steps = kind.first_steps(program, w0, s0, k)
    w1, wk, gnorm0 = first.x.clone(), steps.x.clone(), kind.first_grad(first)
    loss_runs = [steps.loss_history[:k].tolist()]
    warm = kind.solve(program, w0, s0)  # a whole solve: the window's every shape and path
    loss_runs.append(warm.loss_history[:k].tolist())
    sync()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    solves, i = [], 0
    sync()
    t0 = time.perf_counter()
    while True:
        wi, si = (w0, s0) if i == 0 else start(i)
        ts = time.perf_counter()
        res = kind.solve(program, wi, si)
        final = float(res.final_loss)  # waits for the solve
        if i == 0:
            loss_runs.append(res.loss_history[:k].tolist())
        solves.append({"n_iters": int(res.n_iters), "n_fevals": res.n_fevals or 0,
                       "n_gevals": res.n_gevals or 0, "n_host_syncs": int(res.n_host_syncs or 0),
                       "wall_s": time.perf_counter() - ts, "final_loss": final})
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    for s in solves:  # counted after the window: nothing but the solves in it
        s["flops"] = kind.flops(program, types.SimpleNamespace(**s))
    steps_done = sum(s["n_iters"] for s in solves)
    expected = cell.traffic["solve"][kind.length]
    failed = sum(1 for s in solves
                 if not math.isfinite(s["final_loss"]) or s["n_iters"] != expected)
    kind_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    peak_mem = int(torch.cuda.max_memory_allocated()) if on_card else 0
    log(f"window {window_s:.3f} s: {len(solves)} solves, {steps_done} {kind.unit}s")

    # checks of the program that need it alive: its history after a whole
    # solve and the solver's dispatch on it; its draws
    held = None
    if kind.ring_after is not None:
        ring, v = kind.ring_after(program, w0, s0)
        held = {"ring": ring, "v": v, "z": drive.direction(v, ring, kind.clamp_gamma)}
    wrong_draws = kind.sampler_gap(program, s0, k) if kind.sampler_gap is not None else None

    metrics, breakdown, device_extra, traced = {}, None, {}, None
    peaks = peak_table.of(kind_name)
    if trace and on_card:
        bare = [solves[0]["wall_s"]]
        traced = timing.profile(lambda: kind.solve(program, w0, s0))
        bare.append(timing.wall_s(lambda: kind.solve(program, w0, s0))[0])
        traced["bare_s"] = min(bare)
        device_extra = {"busy_s": traced["busy_s"], "window_s": traced["window_s"]}
        breakdown = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    probes = _probes(kind, program, held, peaks) if trace and on_card and peaks else {}
    ctx = Context(solves, window_s, setup_s, traced, peaks, probes)
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = catalog.reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if keep is not None:
        keep.update(held or {}, w0=w0, s0=s0)

    del ctx, probes, program, first, steps, warm, res
    drive.release()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    with precision("float32"), torch.no_grad():
        ref = kind.reference(obj, w0, inputs, cell.traffic, s0, k)
        z_ref = None if held is None else ref_lbfgs.two_loop(
            held["v"], ref_lbfgs.with_rho(drive.ring_rows(held["ring"], obj.n_params)),
            clamp_gamma=kind.clamp_gamma)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    prog = {"loss_runs": loss_runs, "w1": w1, "wk": wk, "gnorm0": gnorm0}
    gaps = check.numbers(w0, prog, ref, obj.leaves())
    if held is not None:
        gaps["direction"] = check.direction_gap(held["z"], z_ref, obj.leaves())
    if wrong_draws is not None:
        gaps["sampler"] = wrong_draws
    ok, shown = check.verdict(gaps, cell.limits)
    # a solve that ends on a loss that is not finite, or short of its
    # length, is counted failed; correct is the comparison's verdict
    result = {"correct": bool(ok and steps_done > 0), "attempted": len(solves),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind_name,
                         "count": int(cell.workload.get("chips", 1)),
                         "memory_peak_bytes": peak_mem, **device_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["gaps"] = gaps  # every number read, compared or not
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import catalog
    root = catalog.root_of()
    cache_dirs(root)
    cell = catalog.load_cell(args.workload, root)
    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {cell.name} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    print(f"card: {torch.cuda.get_device_name(0)} ({power_limit()}); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", root)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
