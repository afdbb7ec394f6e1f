"""The multi-device path on the card, at world 1 on NCCL: a process group of
one rank whose collectives are captured into the resident graphs (IF nodes
for the Armijo slots and the guards, a WHILE node for the Wolfe trials).

* the data-parallel L-BFGS (Armijo and Wolfe) and the parameter-sharded
  L-BFGS (the loop and the Gram forms) captured equal their bodies run
  eagerly on the card bitwise, and a second solve replays the captured
  step without capturing again;
* ``slbfgs(mesh=)`` (both samplings) and the data-parallel Burgers solve
  captured equal their eager bodies bitwise;
* the gloo world-2 mechanism check (two processes on the one card,
  ``lbfgs_ffnn_torch.experiments.mesh_check``): the data-parallel value and
  gradient and both sharded two-loops against the world-1 values;
* on two cards or more, NCCL at world 2 (two processes, this file run as a
  script by :func:`test_nccl_world2_captured_mesh_solves`): an all-reduce
  captured in an IF and in a WHILE node, the data-parallel L-BFGS (Armijo
  and Wolfe) and the parameter-sharded Gram form captured, replayed and
  equal to their eager bodies bitwise on both ranks, and the group
  destroyed after the captured steps are freed. Skips on one card.

Imports neither JAX nor the JAX package: ``python -m pytest --noconftest
tests/test_torch_cuda_parallel.py``. Skips itself where
``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import gc
import importlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn_torch.solvers.common import clear_graph_cache
from lbfgs_ffnn_torch.utils import profiling

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")


@pytest.fixture(scope="module")
def meshes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from lbfgs_ffnn_torch.parallel import make_mesh

    yield make_mesh(axis_name="data"), make_mesh(axis_name="model")
    torch.distributed.destroy_process_group()


def _case(n=3000, dims=(784, 32, 10), seed=0):
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((n, dims[0])), dtype=torch.float32, device=dev)
    y = torch.tensor(np.eye(dims[-1])[rng.integers(0, dims[-1], n)], dtype=torch.float32,
                     device=dev)
    spec = mlp_spec(list(dims), ["relu"] * (len(dims) - 2) + ["linear"])
    w0 = mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32, device=dev)
    return spec, w0, x, y


def _same(a, b, fields=("x", "loss_history", "gnorm_history")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.n_iters, a.n_fevals, a.n_gevals) == (b.n_iters, b.n_fevals, b.n_gevals)


@pytest.mark.cuda
@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_captured_data_parallel_lbfgs_equals_eager_body(meshes, line_search):
    from lbfgs_ffnn_torch.parallel import data_parallel_problem, shard_batch

    mesh = meshes[0]
    spec, w0, x, y = _case()
    dp = data_parallel_problem(mlp_problem(spec), mesh)
    aux = shard_batch(mesh, x, y)
    opts = tl.LBFGSOptions(max_iters=30, tol=1e-12, m=10, line_search=line_search)
    clear_graph_cache()
    captured = tl.lbfgs(dp, w0, aux, opts)
    caps = profiling.counter("captures")
    again = tl.lbfgs(dp, w0, aux, opts)
    assert profiling.counter("captures") == caps  # replayed, not captured again
    _same(captured, again)
    _same(captured, tl._lbfgs_resident_eager(dp, w0, aux, opts))
    assert captured.n_host_syncs <= -(-captured.n_iters // tl.RESIDENT_CHUNK) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["xla", "compact"])
def test_captured_sharded_lbfgs_equals_eager_body(meshes, impl):
    mmesh = meshes[1]
    spec, w0, x, y = _case()
    prob = mlp_problem(spec)
    opts = tl.LBFGSOptions(max_iters=30, tol=1e-12, m=10, line_search="armijo",
                           two_loop_impl=impl)
    clear_graph_cache()
    captured = tl.lbfgs(prob, w0, (x, y), opts, mesh=mmesh)
    caps = profiling.counter("captures")
    _same(captured, tl.lbfgs(prob, w0, (x, y), opts, mesh=mmesh))
    assert profiling.counter("captures") == caps
    eager = tl._solve_sharded(prob, w0, (x, y), opts, mmesh, "model", chunk=10, capture=False,
                              pipeline=False)[0]
    _same(captured, eager)
    single = tl.lbfgs(prob, w0, (x, y), opts._replace(two_loop_impl="plain"))
    np.testing.assert_allclose(captured.loss_history[:5].cpu().numpy(),
                               single.loss_history[:5].cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["local", "global"])
def test_captured_slbfgs_mesh_equals_eager_body(meshes, sampling):
    from lbfgs_ffnn_torch.parallel import shard_batch

    mesh = meshes[0]
    spec, w0, x, y = _case()
    bp = mlp_batch_problem(spec, lam=1e-4)
    xs, ys = shard_batch(mesh, x, y)
    opts = tsl.SLBFGSOptions(epochs=3, tol=1e-12, history=10, L=5, batch_size=128,
                             step_size=0.02, sampling=sampling)
    clear_graph_cache()
    captured = tsl.slbfgs(bp, w0, xs, ys, opts, mesh=mesh)
    eager = tsl._solve(bp, w0, xs, ys, opts, chunk=10, capture=False, mesh=mesh)[0]
    _same(captured, eager, ("x", "loss_history", "gnorm_history"))
    if sampling == "global":  # the single-process batches
        single = tsl.slbfgs(bp, w0, x, y, opts)
        np.testing.assert_allclose(captured.loss_history.cpu().numpy(),
                                   single.loss_history.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_captured_burgers_mesh_equals_eager_body(meshes):
    from lbfgs_ffnn_torch.experiments import run_burgers
    from lbfgs_ffnn_torch.objectives import pinn

    mesh = meshes[0]
    dev = torch.device("cuda")
    spec = pinn.default_burgers_spec()
    pts = pinn.burgers_points(dx=0.01, dt=0.02, int_dx=0.05, int_dt=0.1, device=dev)
    mpts = pinn.shard_burgers_points(mesh, pinn.pad_burgers_points(pts, 1))
    w0 = pinn.pinn_init(spec, torch.Generator().manual_seed(3), torch.float32, device=dev)
    prob = pinn.burgers_problem(spec, mesh=mesh)
    opts = run_burgers.options(20, False)  # Wolfe, lean trials: jvps through the all-reduce
    clear_graph_cache()
    captured = tl.lbfgs(prob, w0, mpts, opts)
    _same(captured, tl._lbfgs_resident_eager(prob, w0, mpts, opts))


@pytest.mark.cuda
def test_gloo_world2_mechanism_on_one_card(meshes):
    from lbfgs_ffnn_torch.experiments import mesh_check

    res = mesh_check.launch(2, "cuda", 6000, timeout=120.0)
    assert res["ok"], res


def _nccl_world2_rank(rank: int, port: int, out: Path) -> None:
    """One rank of :func:`test_nccl_world2_captured_mesh_solves`; writes
    ``r{rank}.npz`` before it destroys the group."""
    from lbfgs_ffnn_torch.ops import control
    from lbfgs_ffnn_torch.parallel import (
        data_parallel_problem, distributed_init, make_mesh, shard_batch,
    )
    from lbfgs_ffnn_torch.parallel.collectives import psum

    distributed_init(f"localhost:{port}", 2, rank)
    mesh, mmesh = make_mesh(2), make_mesh(2, axis_name="model")
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {}
    v = torch.full((4,), float(rank + 1), device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    got_if, got_while = torch.zeros(4, device=dev), torch.zeros(4, device=dev)
    passes = torch.zeros((), dtype=torch.int32, device=dev)
    g_if, g_while = control.Graph(), control.Graph()
    with control.capture(g_if):
        with control.guard(flag):
            got_if.copy_(psum(v, mesh, "data"))

    def body():
        got_while.copy_(psum(got_while, mesh, "data"))
        passes.add_(1)

    with control.capture(g_while):
        passes.zero_()
        got_while.copy_(v)
        control.loop(lambda: passes < 3, body)
    g_if.replay()
    g_while.replay()
    res.update(got_if=got_if.cpu().numpy(), got_while=got_while.cpu().numpy(),
               passes=int(passes))

    spec, w0, x, y = _case()
    prob = mlp_problem(spec)
    dp = data_parallel_problem(prob, mesh)
    aux = shard_batch(mesh, x, y)
    for ls in ("armijo", "wolfe"):
        opts = tl.LBFGSOptions(max_iters=20, tol=1e-12, m=10, line_search=ls)
        clear_graph_cache()
        captured = tl.lbfgs(dp, w0, aux, opts)
        caps = profiling.counter("captures")
        again = tl.lbfgs(dp, w0, aux, opts)
        res[f"{ls}_recaptured"] = profiling.counter("captures") - caps
        eager = tl._lbfgs_resident_eager(dp, w0, aux, opts)
        single = tl.lbfgs(prob, w0, (x, y), opts)
        for name, r in (("captured", captured), ("again", again), ("eager", eager),
                        ("single", single)):
            res[f"{ls}_{name}_x"] = r.x.cpu().numpy()
            res[f"{ls}_{name}_loss"] = r.loss_history.cpu().numpy()
            res[f"{ls}_{name}_counts"] = np.array([r.n_iters, r.n_fevals, r.n_gevals])
    opts = tl.LBFGSOptions(max_iters=20, tol=1e-12, m=10, line_search="armijo",
                           two_loop_impl="compact")
    captured = tl.lbfgs(prob, w0, (x, y), opts, mesh=mmesh)
    eager = tl._solve_sharded(prob, w0, (x, y), opts, mmesh, "model", chunk=10, capture=False,
                              pipeline=False)[0]
    res.update(gram_captured_x=captured.x.cpu().numpy(), gram_eager_x=eager.x.cpu().numpy())
    np.savez(out / f"r{rank}.npz", **res)
    del g_if, g_while
    clear_graph_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_nccl_world2_captured_mesh_solves(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (NCCL refuses two ranks on one card)")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(root), env.get("PYTHONPATH")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{o[-3000:]}"
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    for r in (r0, r1):
        np.testing.assert_array_equal(r["got_if"], np.full(4, 3.0))
        np.testing.assert_array_equal(r["got_while"], np.full(4, 12.0))
        assert int(r["passes"]) == 3
        for ls in ("armijo", "wolfe"):
            assert int(r[f"{ls}_recaptured"]) == 0  # replayed, not captured again
            for other in ("again", "eager"):
                for f in ("x", "loss", "counts"):
                    np.testing.assert_array_equal(r[f"{ls}_captured_{f}"],
                                                  r[f"{ls}_{other}_{f}"])
            np.testing.assert_allclose(r[f"{ls}_captured_loss"][:5], r[f"{ls}_single_loss"][:5],
                                       rtol=1e-5)
        np.testing.assert_array_equal(r["gram_captured_x"], r["gram_eager_x"])
    for k in r0.files:  # every decision came out of a collective: the ranks agree
        if "single" not in k:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


if __name__ == "__main__":
    _nccl_world2_rank(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
