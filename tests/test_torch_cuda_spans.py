"""The tracer on the card: recording adds no work to a captured step (one
replay runs the same kernels whether the step was captured with recording
on or off); a recorded solve's device times rise on the host clock; a
recorded, unprofiled resident L-BFGS solve on the MNIST shapes (784-128-10,
60,000 rows, m = 10) leaves the device idle under 10% of its ``solve``
span; under ``torch.profiler`` the ``replay:*`` spans are among the
profiler's host events.

Imports neither JAX nor the JAX package: ``python -m pytest --noconftest
tests/test_torch_cuda_spans.py``. Skips itself where
``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib

import pytest
import torch

from lbfgs_ffnn_torch.objectives.mlp import mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn_torch.solvers import common
from lbfgs_ffnn_torch.utils import profiling

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(dev, n, dims=(784, 128, 10), seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, dims[0]), generator=g, device=dev)
    y = torch.nn.functional.one_hot(torch.randint(0, dims[-1], (n,), generator=g, device=dev),
                                    dims[-1]).to(torch.float32)
    spec = mlp_spec(list(dims), ["relu"] * (len(dims) - 2) + ["linear"])
    w0 = mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32, device=dev)
    return mlp_problem(spec), w0, (x, y)


def _kernels_of_one_replay(record: bool, dev) -> list:
    from torch.autograd import DeviceType

    problem, w0, aux = _case(dev, 2000)
    opts = tl.LBFGSOptions(line_search="armijo", max_iters=50, m=10)
    common.clear_graph_cache()
    if record:
        with profiling.recording():
            tl.lbfgs_warm_up(problem, w0, aux, opts, iters=2)
    else:
        tl.lbfgs_warm_up(problem, w0, aux, opts, iters=2)
    (r,) = common._GRAPHS.values()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        r.graphs[0].replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    common.clear_graph_cache()
    return names


@pytest.mark.cuda
def test_recording_adds_no_work_to_a_captured_step(cuda):
    off, on = _kernels_of_one_replay(False, cuda), _kernels_of_one_replay(True, cuda)
    assert off and sorted(on) == sorted(off)


@pytest.mark.cuda
def test_device_times_rise_on_the_host_clock(cuda):
    problem, w0, aux = _case(cuda, 2000)
    opts = tl.LBFGSOptions(line_search="armijo", max_iters=60, m=10)
    tl.lbfgs_warm_up(problem, w0, aux, opts, iters=2)
    with profiling.recording():
        res = tl.lbfgs(problem, w0, aux, opts)
    t = res.trace
    ends = [ns for _, ns in t.device]
    assert len(ends) == t.counters["replays:iteration"] > 0
    assert all(a <= b for a, b in zip(ends, ends[1:]))
    assert t.span.start_ns <= ends[0] and ends[-1] <= t.span.end_ns + 5_000_000
    for g in t.gaps:
        assert g.end_ns > g.start_ns and sum(g.by.values()) == g.end_ns - g.start_ns
    common.clear_graph_cache()


@pytest.mark.cuda
def test_resident_mnist_solve_keeps_the_device_busy(cuda):
    problem, w0, aux = _case(cuda, 60_000)
    opts = tl.LBFGSOptions(line_search="armijo", max_iters=300, m=10, tol=1e-12)
    tl.lbfgs_warm_up(problem, w0, aux, opts, iters=2)
    tl.lbfgs(problem, w0, aux, opts)  # every path warm
    torch.cuda.synchronize()
    with profiling.recording():
        res = tl.lbfgs(problem, w0, aux, opts)
    t = res.trace
    pct = 100.0 * t.gap_ns() / (t.span.end_ns - t.span.start_ns)
    assert res.n_iters == 300 and not t.profiled
    assert pct < 10.0, (pct, t.by_cause())
    common.clear_graph_cache()


@pytest.mark.cuda
def test_replay_spans_are_profiler_host_events(cuda):
    from torch.autograd import DeviceType

    problem, w0, aux = _case(cuda, 2000)
    opts = tl.LBFGSOptions(line_search="armijo", max_iters=30, m=10)
    tl.lbfgs_warm_up(problem, w0, aux, opts, iters=2)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = tl.lbfgs(problem, w0, aux, opts)
        torch.cuda.synchronize()
    t = res.trace
    assert t is not None and t.profiled
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    replays = [e for e in host if e.name == "replay:iteration"]
    assert len(replays) == t.counters["replays:iteration"] > 0
    assert {"solve", "chunk", "chunk.read"} <= {e.name for e in host}
    common.clear_graph_cache()
