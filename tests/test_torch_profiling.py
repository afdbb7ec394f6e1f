"""The port's tracer (:mod:`lbfgs_ffnn_torch.utils.profiling`) on the CPU.

Recording off, a solve keeps no hot span and its result no trace. Recorded,
an L-BFGS, an S-LBFGS and an SGD solve each give a ``solve`` span with
``chunk``, ``replay:<body>`` and ``chunk.read`` below it, every span of the
solve carrying its id, and counters that agree with the solve's own. The
cold counters count the caches' hits and misses; the cold spans hold the
package's import, the native runtime's load and build. Under
``torch.profiler`` each program span is a host event of the profiler's
own timeline, in the same order, enclosing the operators run inside it.
The device gaps and what they are put down to, on a stand-in event clock."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn_torch.solvers import common
from lbfgs_ffnn_torch.utils import profiling

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")
tsgd = importlib.import_module("lbfgs_ffnn_torch.solvers.sgd")

ROOT = Path(__file__).resolve().parents[1]
HOT = {"solve", "resident.load", "chunk", "chunk.read", "finalize"}
N, DIMS = 300, (20, 8, 3)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((N, DIMS[0])), dtype=torch.float32)
    y = torch.tensor(np.eye(DIMS[-1])[rng.integers(0, DIMS[-1], N)], dtype=torch.float32)
    spec = mlp_spec(list(DIMS), ["relu", "linear"])
    return spec, mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32), x, y


def _lbfgs(spec, w0, x, y, **kw):
    return tl.lbfgs_chunked(mlp_problem(spec, **kw), w0, (x, y),
                            tl.LBFGSOptions(line_search="armijo", max_iters=12), chunk=5)[0]


def _slbfgs(spec, w0, x, y):
    # 9 inner steps an epoch, L = 3: start, two segments, finish
    return tsl.slbfgs(mlp_batch_problem(spec), w0, x, y,
                      tsl.SLBFGSOptions(epochs=3, batch_size=32, history=3, L=3))


def _sgd(spec, w0, x, y):
    return tsgd.sgd(mlp_batch_problem(spec), w0, x, y, tsgd.SGDOptions(epochs=3, batch_size=64))


SOLVES = {"lbfgs": (_lbfgs, {"iteration"}),
          "slbfgs": (_slbfgs, {"start", "segment", "finish"}),
          "sgd": (_sgd, {"start", "segment", "finish"})}


def test_recording_off_keeps_no_hot_records():
    spec, w0, x, y = _data()
    before = profiling.spans()
    res = _lbfgs(spec, w0, x, y)
    assert res.trace is None and profiling.ACTIVE == 0 and not profiling.RECORDING
    new = [s for s in profiling.spans() if s not in before]
    assert not {s.name for s in new} & HOT
    assert not any(s.name.startswith("replay:") for s in new)


def test_recording_off_reaches_no_hot_site(monkeypatch):
    """Off, no hot span, hot counter or solve record is made: each raises
    here, and every solver kind still runs."""
    def refuse(*_a, **_k):
        raise AssertionError("a hot site ran with recording off")

    for name in ("hot", "hot_count", "SolveTrace", "_recorded_solve"):
        monkeypatch.setattr(profiling, name, refuse)
    spec, w0, x, y = _data()
    for run, _ in SOLVES.values():
        assert run(spec, w0, x, y).trace is None
    assert tl.lbfgs(mlp_problem(spec), w0, (x, y), tl.LBFGSOptions(max_iters=3)).trace is None


@pytest.mark.parametrize("solver", sorted(SOLVES))
def test_recorded_solve_nests_its_spans(solver):
    run, bodies = SOLVES[solver]
    spec, w0, x, y = _data()
    with profiling.recording():
        res = run(spec, w0, x, y)
    t = res.trace
    assert t is not None and profiling.ACTIVE == 0
    by_id = {s.id: s for s in t.spans}
    root = t.span
    assert root.name == "solve" and root.id == t.id and root.solve == t.id
    assert all(s.solve == t.id for s in t.spans)
    names = {s.name for s in t.spans}
    assert {"chunk", "chunk.read", "resident.load", "finalize"} <= names
    assert {n[len("replay:"):] for n in names if n.startswith("replay:")} == bodies
    for s in t.spans:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        if s is root:
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
        if s.name.startswith("replay:"):
            assert parent.name == "chunk"
        if s.name in ("chunk", "chunk.read", "resident.load", "finalize"):
            assert parent is root
    replays = [s.name for s in t.spans if s.name.startswith("replay:")]
    for body in bodies:
        assert t.counters["replays:" + body] == replays.count("replay:" + body) > 0
    reads = sum(1 for s in t.spans if s.name == "chunk.read")
    assert t.counters["host_syncs"] == res.n_host_syncs == reads
    assert t.device == [] and t.gaps == []  # no card: no device times


def test_every_entry_opens_a_solve_span():
    spec, w0, x, y = _data()
    with profiling.recording():
        loop = tl.lbfgs(mlp_problem(spec), w0, (x, y), tl.LBFGSOptions(max_iters=3))
        gd = importlib.import_module("lbfgs_ffnn_torch.solvers.gd").gradient_descent(
            mlp_problem(spec), w0, (x, y))
    assert [s.name for s in loop.trace.spans] == ["solve"]
    assert {"solve", "chunk", "replay:iteration"} <= {s.name for s in gd.trace.spans}
    assert loop.trace.id != gd.trace.id


def test_cache_counters_across_two_solves():
    """Two solves on the same data: the prepared copy misses, then hits
    (the recorded solve counts its own); the step cache misses, then hits."""
    spec, w0, x, y = _data(1)
    miss, hit = profiling.counter("prepared.miss"), profiling.counter("prepared.hit")
    prepares = len(profiling.spans("prepare"))
    problem = mlp_problem(spec, grad_input_dtype="bfloat16")  # a problem with a prepare
    opts = tl.LBFGSOptions(line_search="armijo", max_iters=3)
    with profiling.recording():
        a = tl.lbfgs_chunked(problem, w0, (x, y), opts)[0]
        b = tl.lbfgs_chunked(problem, w0, (x, y), opts)[0]
    def rest(counters):
        return {k: v for k, v in counters.items() if not k.startswith("prepared.")}

    assert rest(a.trace.counters) == rest(b.trace.counters)
    assert a.trace.counters["prepared.miss"] == 1 and "prepared.hit" not in a.trace.counters
    assert b.trace.counters["prepared.hit"] == 1 and "prepared.miss" not in b.trace.counters
    assert (profiling.counter("prepared.miss"), profiling.counter("prepared.hit")) == (
        miss + 1, hit + 1)
    assert len(profiling.spans("prepare")) == prepares + 1
    assert "prepare" in {s.name for s in a.trace.spans}
    assert "prepare" not in {s.name for s in b.trace.spans}
    assert torch.equal(a.x, b.x)

    gm, gh = profiling.counter("graph_cache.miss"), profiling.counter("graph_cache.hit")
    made = []
    key = ("test", object())
    for _ in range(2):
        common.cached_resident(key, lambda: made.append(1) or "step")
    assert made == [1]
    assert (profiling.counter("graph_cache.miss"), profiling.counter("graph_cache.hit")) == (
        gm + 1, gh + 1)
    common.clear_graph_cache()


def test_capture_record_replaces_the_class_attributes():
    assert not hasattr(common.Resident, "captures")
    assert not hasattr(common.Resident, "last_capture_s")
    n = profiling.counter("captures")
    profiling.count("captures")
    assert profiling.counter("captures") == n + 1
    with profiling.span("resident.capture"):
        with profiling.span("capture.eager"):
            pass
    outer, inner = profiling.last("resident.capture"), profiling.last("capture.eager")
    assert inner.parent == outer.id and outer.seconds >= inner.seconds >= 0
    assert outer.solve is None


def test_import_and_native_spans_in_a_fresh_process():
    """A fresh process records the package's import, and the native
    runtime's load with its build (here the hash check of the cached
    library, or g++) inside it."""
    code = ("import json\n"
            "import lbfgs_ffnn_torch\n"
            "from lbfgs_ffnn_torch.runtime import native\n"
            "from lbfgs_ffnn_torch.utils import profiling\n"
            "native.get_lib()\n"
            "print(json.dumps([[s.name, s.id, s.parent, s.detail, s.end_ns - s.start_ns]"
            " for s in profiling.spans()]))\n")
    path = os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    spans = json.loads(out.stdout.strip().splitlines()[-1])
    names = [s[0] for s in spans]
    assert names[0] == "import" and spans[0][4] > 0
    load = next(s for s in spans if s[0] == "native.load")
    build = next(s for s in spans if s[0] == "native.build")
    assert load[3] == build[3] == "runtime" and build[2] == load[1]


def _profiled_solve():
    from torch.profiler import ProfilerActivity, profile

    spec, w0, x, y = _data()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _lbfgs(spec, w0, x, y)
    return res, prof


def test_spans_are_the_profilers_host_events():
    """A solve under ``torch.profiler`` is recorded without a recording
    block; each of its spans is a host event of the profiler, in the same
    order, and each replay's event encloses the operators run inside it."""
    res, prof = _profiled_solve()
    t = res.trace
    assert t is not None and t.profiled
    names = {s.name for s in t.spans}
    events = [e for e in prof.events() if e.name in names]
    ours = sorted(t.spans, key=lambda s: (s.start_ns, -s.end_ns))
    theirs = sorted(events, key=lambda e: (e.time_range.start, -e.time_range.end))
    assert [e.name for e in theirs] == [s.name for s in ours]
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    replays = [e for e in theirs if e.name == "replay:iteration"]
    assert len(replays) == t.counters["replays:iteration"] > 0
    for r in replays:
        inside = [o for o in ops if r.time_range.start <= o.time_range.start < r.time_range.end]
        assert inside, "a replay with no operator"
        assert all(o.time_range.end <= r.time_range.end for o in inside)
    solve = next(e for e in theirs if e.name == "solve")
    assert all(solve.time_range.start <= e.time_range.start
               and e.time_range.end <= solve.time_range.end for e in theirs)


def test_trace_writes_program_spans_beside_the_operators(tmp_path):
    spec, w0, x, y = _data()
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        assert profiling.RECORDING
        res = _lbfgs(spec, w0, x, y)
    assert not profiling.RECORDING and res.trace is not None
    events = json.loads(next(Path(logdir).glob("trace-*.json")).read_text())["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    assert {"solve", "chunk", "chunk.read", "replay:iteration"} <= names
    assert any(n.startswith("aten::") for n in names)


class _StandIn:
    """A timing event on the host clock: complete when recorded."""

    def __init__(self, enable_timing=False):
        self.ns = None

    def record(self, stream=None):
        self.ns = time.perf_counter_ns()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


@pytest.mark.parametrize("graph", [True, False], ids=["graph", "eager"])
def test_device_gaps_on_a_stand_in_clock(monkeypatch, graph):
    """With events that complete when recorded (a device that is never
    busy), every host interval between two launches is a gap, a graph's
    launch included (it holds the device until it returns; an eager body's
    kernels run as it does): the gaps and the replays tile the solve from
    the calibration to its exit, and each gap goes to the span that held
    the host longest within it."""
    monkeypatch.setattr(torch.cuda, "Event", _StandIn)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)

    def hold(ms):
        end = time.perf_counter_ns() + int(ms * 1e6)
        while time.perf_counter_ns() < end:
            pass

    with profiling.recording(), profiling.solve("cuda") as t:
        with profiling.hot("resident.load"):
            hold(4)
        with profiling.hot("chunk"):
            for _ in range(3):
                with t.open("replay:iteration"):
                    t.launch()
                    hold(1)
                    t.landed("replay:iteration", graph)
        with profiling.hot("chunk.read"):
            hold(8)
        with profiling.hot("finalize"):
            hold(2)
    assert [label for label, _ in t.device] == ["replay:iteration"] * 3
    ends = [ns for _, ns in t.device]
    assert ends == sorted(ends)
    assert len(t.gaps) == 4 and t.gaps[0].cause == "resident.load"
    assert t.gaps[-1].cause == "chunk.read"
    # between two replays of a chunk: the launch (a graph's), or the
    # replay's own exit and entry and the chunk's Python between them
    assert {g.cause for g in t.gaps[1:3]} <= ({"replay:iteration"} if graph
                                              else {"replay:iteration", "chunk"})
    assert all(g.end_ns > g.start_ns and sum(g.by.values()) == g.end_ns - g.start_ns
               for g in t.gaps)
    busy = sum(e - s.end_ns for s, (_, e) in zip(t.gaps[:3], t.device))
    assert t.gap_ns() + busy == t.gaps[-1].end_ns - t.gaps[0].start_ns
    assert t.gaps[-1].end_ns <= t.span.end_ns
    # the spans outside the replays lie whole in the gaps, each to its own name
    by = t.by_cause()
    for name in ("resident.load", "chunk.read", "finalize"):
        (held,) = [sp for sp in t.spans if sp.name == name]
        assert by[name] == held.end_ns - held.start_ns
    assert by["chunk.read"] >= 8e6
    if graph:  # a graph's launch holds the device: its 1 ms each is a gap
        assert by["replay:iteration"] >= 3e6
