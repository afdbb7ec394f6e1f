"""The out-of-core path and checkpoint/resume on the card: the gather kernel
(``csrc/gather.cu``) bitwise against its plain route (f32, uint8 and f64
rows, repeats, the ragged last chunk, an index out of range giving zeros),
one launch per call counted on the device; a captured chunk sweep (its
copies memcpy nodes inside an IF node) equal to the eager sweep; the
captured out-of-core L-BFGS and S-LBFGS equal to their bodies run eagerly;
and a kill-and-resume across processes
(``lbfgs_ffnn_torch.experiments.kill_resume``) at a small size.

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda_outofcore.py``.
Skips itself where ``torch.cuda.is_available()`` is false."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lbfgs_ffnn_torch.data.outofcore import (
    ChunkStore, accumulate_chunks, outofcore_mlp_problem, outofcore_problem,
)
from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
from lbfgs_ffnn_torch.ops.control import Graph, capture, guard
from lbfgs_ffnn_torch.ops.cuda_gather import gather_rows, gather_rows_plain
from lbfgs_ffnn_torch.solvers.common import clear_graph_cache

tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(dev, n=3000, dims=(784, 32, 10), rows=1024, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 256, (n, dims[0])) / 255.0).astype(np.float32)
    y = np.eye(dims[-1], dtype=np.float32)[rng.integers(0, dims[-1], n)]
    spec = mlp_spec(list(dims), ["relu", "linear"])
    w0 = mlp_init(spec, torch.Generator().manual_seed(seed), torch.float32, device=dev)
    return spec, w0, ChunkStore(x, y, rows, device=dev), x, y


def _same(a, b, fields=("x", "loss_history", "gnorm_history")):
    for f in fields:
        u, v = getattr(a, f), getattr(b, f)
        assert torch.equal(torch.nan_to_num(u, nan=7.0), torch.nan_to_num(v, nan=7.0)), f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 784), (torch.uint8, 784),
                                     (torch.float64, 7), (torch.float32, 1)])
def test_gather_kernel_equals_plain_route(cuda, dtype, d):
    n, rows = 1000, 384
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.integers(0, 200, (n, d))).to(dtype)
    y = torch.tensor(rng.normal(size=(n, 10)), dtype=torch.float32)
    st = ChunkStore(x, y, rows, device=cuda)
    for b in (256, 128, 3):
        idx = rng.integers(0, n, b)
        idx[:2] = idx[2]
        idx[-1] = n - 1  # the ragged last chunk
        it = torch.tensor(idx, device=cuda)
        gather_rows.LAUNCHES.reset()
        xb, yb = st.fetch_rows(it)
        assert int(gather_rows.LAUNCHES) == 1
        xp, yp = gather_rows_plain(st.x, st.y, it)
        assert xb.dtype == dtype and torch.equal(xb, xp) and torch.equal(yb, yp)
    xb, yb = gather_rows(st.x, st.y, torch.tensor([n, -1, 0], device=cuda))
    assert not xb[:2].any() and not yb[:2].any() and torch.equal(xb[2], st.x[0].to(cuda))


@pytest.mark.cuda
def test_gather_refuses_what_it_does_not_take(cuda):
    x, y = torch.zeros(8, 4), torch.zeros(8, 2)
    with pytest.raises(ValueError, match="pinned"):
        gather_rows(x, y, torch.zeros(2, dtype=torch.int64, device=cuda))
    st = ChunkStore(x, y, 4, device=cuda)
    with pytest.raises(ValueError, match="int64"):
        gather_rows(st.x, st.y, torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="indices on cpu"):
        st.fetch_rows(torch.zeros(2, dtype=torch.int64))


@pytest.mark.cuda
def test_captured_chunk_sweep_equals_eager_sweep(cuda):
    spec, w0, st, _, _ = _case(cuda)
    bp = mlp_batch_problem(spec, lam=1e-3)
    prob = outofcore_problem(bp, st)
    f, g = prob.value_and_grad(w0, ())
    flag = torch.ones((), dtype=torch.bool, device=cuda)
    out = torch.zeros(w0.numel() + 1, device=cuda)

    def body():
        fc, gc = prob.value_and_grad(w0, ())
        out.copy_(torch.cat([fc.view(1), gc]))

    body()
    eager = out.clone()
    out.zero_()
    graph = Graph()
    with capture(graph):
        with guard(flag):
            body()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager) and torch.equal(eager[0], f) and torch.equal(eager[1:], g)
    # a sweep summing the raw chunks: every row once, the padding zero
    total = accumulate_chunks(st, lambda xb, yb, m: xb.sum(0), torch.zeros(784, device=cuda))
    torch.testing.assert_close(total, st.x.sum(0).to(cuda), rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_captured_outofcore_lbfgs_equals_eager_body(cuda):
    spec, w0, st, x, y = _case(cuda)
    prob = outofcore_mlp_problem(spec, st)
    opts = tl.LBFGSOptions(max_iters=15, tol=1e-12, m=10, line_search="armijo", ls_max_iters=20)
    clear_graph_cache()
    cap = tl.lbfgs(prob, w0, (), opts)
    eager = tl._lbfgs_resident_eager(prob, w0, (), opts)
    _same(cap, eager)
    assert (cap.n_fevals, cap.n_gevals) == (eager.n_fevals, eager.n_gevals)
    assert cap.n_host_syncs <= -(-15 // tl.RESIDENT_CHUNK) + 2


@pytest.mark.cuda
def test_captured_outofcore_slbfgs_equals_eager_body(cuda):
    spec, w0, st, _, _ = _case(cuda)
    bp = mlp_batch_problem(spec, lam=1e-4)
    opts = tsl.SLBFGSOptions(epochs=2, tol=1e-12, history=5, L=5, batch_size=128,
                             step_size=0.02)
    clear_graph_cache()
    gather_rows.LAUNCHES.reset()
    cap = tsl.slbfgs(bp, w0, None, None, opts, store=st)
    eager = tsl._slbfgs_resident_eager(bp, w0, None, None, opts, store=st)
    _same(cap, eager)
    assert int(gather_rows.LAUNCHES) > 0


@pytest.mark.cuda
def test_kill_and_resume_across_processes(cuda, tmp_path):
    """The save process is killed (os._exit) after its last case's save;
    the resume process finishes each case; the in-memory cases equal their
    uninterrupted runs bitwise, the out-of-core one to rounding."""
    args = ["--dir", str(tmp_path), "--n-train", "3000", "--chunk-rows", "1024",
            "--rosenbrock-n", "5000", "--iters", "30", "--epochs", "3", "--batch-size", "128"]
    for leg in ("save", "resume"):
        proc = subprocess.run([sys.executable, "-m", "lbfgs_ffnn_torch.experiments.kill_resume",
                               "--leg", leg, *args], cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    from lbfgs_ffnn_torch.experiments import kill_resume

    ka = kill_resume.build_parser().parse_args(["--leg", "save", *args])
    cases = {c: kill_resume.Case(c, ka, cuda) for c in kill_resume.CASES}
    for name, case in cases.items():
        full, _ = case.run(case.x0)
        r = torch.load(tmp_path / f"{name}.resumed.pt", weights_only=True)
        at = r["resumed_at"]
        assert 0 < at < r["n_iters"] == full.n_iters
        if name == "outofcore":
            np.testing.assert_allclose(r["loss_history"].numpy(), full.loss_history.cpu().numpy(),
                                       rtol=1e-4)
            continue
        for k in ("x", "loss_history", "gnorm_history"):
            assert torch.equal(torch.nan_to_num(r[k], nan=7.0),
                               torch.nan_to_num(getattr(full, k).cpu(), nan=7.0)), (name, k)
