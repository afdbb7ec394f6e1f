"""The utilities and the ``models`` alias against the JAX package's: the
alias exports JAX's ``__all__`` letter for letter and names the port's
objectives; ``check_parallelism`` reports JAX's keys on the CPU;
``sync_time`` times a thunk and returns its result; ``trace`` writes a
Chrome trace file. And the test processes' thread cap
(``tests/_torch_threads.py``): the cores divided by xdist's worker count,
at least 1, in this process and in a fresh one under a given count."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import lbfgs_ffnn_tpu.models as jmodels
import lbfgs_ffnn_torch.models as tmodels
from lbfgs_ffnn_torch.objectives import mlp as tmlp
from lbfgs_ffnn_torch.objectives import pinn as tpinn
from lbfgs_ffnn_torch.utils import check_parallelism, sync_time, trace


def test_models_alias_exports_jax_names_and_the_ports_objects():
    assert tmodels.__all__ == jmodels.__all__
    for name in tmodels.__all__:
        obj = getattr(tmodels, name)
        assert obj is getattr(tmlp, name, None) or obj is getattr(tpinn, name, None), name
        assert obj.__module__.startswith("lbfgs_ffnn_torch."), name


def test_check_parallelism_on_the_cpu(capsys):
    from lbfgs_ffnn_tpu.utils.diagnostics import check_parallelism as j_check

    info = check_parallelism(verbose=True)
    jinfo = j_check(verbose=False)
    assert set(jinfo) <= set(info)
    if not torch.cuda.is_available():
        assert info["backend"] == "cpu" and info["devices"] == ["cpu"]
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert info["n_devices"] == info["n_local_devices"] == len(info["devices"]) >= 1
    assert info["n_threads"] == torch.get_num_threads()
    assert capsys.readouterr().out.startswith(f"backend={info['backend']} ")


def test_sync_time_returns_the_best_time_and_the_result():
    calls = []

    def thunk():
        calls.append(1)
        return {"a": (torch.ones(3) * len(calls), 2)}

    best, out = sync_time(thunk, reps=3)
    assert len(calls) == 3 and 0.0 <= best < 10.0
    assert torch.equal(out["a"][0], torch.full((3,), 3.0))
    assert sync_time(lambda: None)[1] is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as logdir:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(Path(logdir).glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def _cores() -> int:
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()


def test_thread_cap_under_xdist():
    """The cap in this process follows xdist's worker count, and a fresh
    process started under 4 workers sets it on import."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == max(1, _cores() // workers)
    env = dict(os.environ, PYTEST_XDIST_WORKER_COUNT="4",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).resolve().parent),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", "import _torch_threads, torch; "
                          "print(torch.get_num_threads())"],
                         capture_output=True, text=True, env=env, check=True).stdout.split()
    assert out == [str(max(1, _cores() // 4))]


@pytest.mark.parametrize("workers,cap", [("", 1), ("0", 1), ("2", 2), ("many", None)])
def test_thread_cap_of_a_worker_count(workers, cap, monkeypatch):
    """Cores over the count, at least 1; no count (or 0) is one worker."""
    import _torch_threads as tt

    if workers == "many":
        workers = str(_cores() + 3)
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
    assert tt.thread_cap() == max(1, _cores() // (cap or int(workers)))
