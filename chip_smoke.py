"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile    # also trace 10 solver iterations
    python3 chip_smoke.py --mnist-root DIR   # MNIST IDX files instead of seeded data

Phases, each printing one line (any failure raises and exits non-zero):
  1. device   - refuses to run without CUDA; torch, CUDA, nvcc and card
  2. build    - compiles lbfgs_ffnn_torch/csrc/two_loop.cu for sm_90a
  3. kernel   - the two-loop kernel against its plain torch version on the
                m=10, n=101,770 f32 ring: empty, partial, full and wrapped
                rings, clamp on and off; error bounds, bitwise repeatability,
                and time per call of both
  4. solve    - 100 iterations of L-BFGS (m=10, Armijo, ls_max_iters=20) on
                the 784-128-10 MLP at N=60,000, f32, through the kernel,
                then through the plain two-loop; the loss must fall, the
                kernel must run once per direction, and the two solves agree
  5. result   - one JSON line with the kernel's numbers, then the last line
                {"ok": true, "device": {...}}

Imports nothing of JAX. Full f32 throughout: TF32 is switched off.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_TRAIN = 60_000
DIMS, ACTS = [784, 128, 10], ["relu", "linear"]
M = 10
ITERS = 100
SEED = 123
KERNEL_REL_TOL = 1e-4  # max|kernel - plain| / max|plain|, f32 reduction order
ERR_RATIO = 2.0        # kernel's f64-referenced error vs the plain f32 one's


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU and prints no result without one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lbfgs_ffnn_torch import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    say("device", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}; {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; TF32 off")
    print(smi, flush=True)
    return smi


def build_phase():
    from lbfgs_ffnn_torch import _build
    from lbfgs_ffnn_torch.ops.cuda_two_loop import _lib

    built = _build.build("two_loop")
    _lib()
    ptxas = "; ".join(line.split("ptxas info    : ")[-1] for line in built.log.splitlines()
                      if "Used" in line or "spill" in line)
    say("build", f"{built.path.name} from csrc/two_loop.cu with {' '.join(_build.NVCC_FLAGS)} "
        f"in {built.seconds:.2f} s (compiled={built.compiled}); ptxas: {ptxas}")


def _ring(torch, ttl, n, k, seed, dev):
    """Ring of capacity M after k pushes of seeded f32 pairs."""
    rng = np.random.default_rng(seed)
    hist = ttl.empty_history_state(M, n, torch.float32, device=dev)
    pushed = 0
    while pushed < k:
        s = rng.normal(size=n)
        y = rng.normal(size=n) + 0.5 * s
        if s @ y > 1e-3:
            s_t = torch.tensor(s, dtype=torch.float32, device=dev)
            y_t = torch.tensor(y, dtype=torch.float32, device=dev)
            hist = ttl.ring_push(hist, s_t, y_t, 1.0 / torch.dot(y_t, s_t),
                                 torch.tensor(True, device=dev))
            pushed += 1
    return hist


def _time_ms(torch, fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, n, dev):
    import lbfgs_ffnn_torch.ops.two_loop  # noqa: F401  (the module, not the function)
    from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda

    ttl = sys.modules["lbfgs_ffnn_torch.ops.two_loop"]
    v = torch.tensor(np.random.default_rng(1).normal(size=n), dtype=torch.float32, device=dev)
    worst = 0.0
    rings = {}
    for k in (0, 4, 10, 13):  # empty, partial, full, wrapped
        rings[k] = hist = _ring(torch, ttl, n, k, seed=k, dev=dev)
        h64 = hist._replace(S=hist.S.double(), Y=hist.Y.double(), rho=hist.rho.double())
        for clamp in (False, True):
            r_k = two_loop_cuda(v, hist, clamp_gamma=clamp)
            r_k2 = two_loop_cuda(v, hist, clamp_gamma=clamp)
            torch.cuda.synchronize()
            r_p = ttl.two_loop(v, hist, clamp_gamma=clamp)
            r_64 = ttl.two_loop(v.double(), h64, clamp_gamma=clamp)
            check(bool(torch.isfinite(r_k).all()), f"k={k} clamp={clamp}: non-finite output")
            diff = float((r_k - r_p).abs().max())
            rel = diff / float(r_p.abs().max())
            err_k = float((r_k.double() - r_64).abs().max())
            err_p = float((r_p.double() - r_64).abs().max())
            check(rel <= KERNEL_REL_TOL, f"k={k} clamp={clamp}: |kernel-plain|/|plain| = {rel:.3e}")
            check(err_k <= ERR_RATIO * err_p,
                  f"k={k} clamp={clamp}: f64-referenced error kernel {err_k:.3e} > "
                  f"{ERR_RATIO} x plain {err_p:.3e}")
            check(torch.equal(r_k, r_k2), f"k={k} clamp={clamp}: two calls differ")
            worst = max(worst, diff)
            say("kernel", f"m={M} n={n} count={min(k, M)} wrapped={k > M} clamp={clamp}: "
                f"max|kernel-plain|={diff:.3e} (rel {rel:.3e} <= {KERNEL_REL_TOL}); vs f64: "
                f"kernel {err_k:.3e}, plain f32 {err_p:.3e} (<= {ERR_RATIO}x); bitwise repeat ok")

    full = rings[10]

    def kernel():
        two_loop_cuda(v, full)

    def plain():
        ttl.two_loop(v, full)

    for fn in (kernel, plain):
        _time_ms(torch, fn, 10)  # warm-up
    times = {"plain": [], "kernel": []}
    for name, fn in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)):
        times[name].append(_time_ms(torch, fn, 200))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    say("kernel", f"time per call at m={M}, n={n}, count={M} (CUDA events, 200 calls, "
        f"min of 2): kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us "
        f"(runs: kernel {[round(t * 1e3, 1) for t in times['kernel']]}, "
        f"plain {[round(t * 1e3, 1) for t in times['plain']]})")
    return worst, ms, plain_ms


def _data(torch, dev, mnist_root):
    from lbfgs_ffnn_torch.data import datasets as tds

    if mnist_root is not None:
        ds = tds.load_mnist(mnist_root, train_size=N_TRAIN, test_size=0)
        x, y = ds.train_x, ds.train_y
        source = (f"MNIST IDX files in {mnist_root} "
                  f"({'synthetic' if ds.synthetic_images else 'real'} images)")
    else:
        labels = np.random.default_rng(SEED).integers(0, 10, N_TRAIN)
        x = tds.synthetic_images_for_labels(labels)
        y = np.eye(10, dtype=np.float32)[labels]
        source = "seeded labels (default_rng(123)) + synthetic_images_for_labels"
    return (torch.tensor(x, device=dev), torch.tensor(y, device=dev)), source


def solve_phase(torch, dev, profile: bool, mnist_root):
    from lbfgs_ffnn_torch.objectives.mlp import evaluate, mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda
    from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs

    aux, source = _data(torch, dev, mnist_root)
    spec = mlp_spec(DIMS, ACTS)
    problem = mlp_problem(spec)
    w0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
    f0 = float(problem.fun(w0, aux))
    say("solve", f"data: {source}; x {tuple(aux[0].shape)}, n_params {spec.n_params}, "
        f"initial loss {f0:.6g}")
    opts = {impl: LBFGSOptions(max_iters=ITERS, tol=1e-12, m=M, line_search="armijo",
                               ls_max_iters=20, two_loop_impl=impl)
            for impl in ("cuda", "plain")}
    for impl in opts:  # warm-up: cuBLAS handles, allocator, functorch
        lbfgs(problem, w0, aux, opts[impl]._replace(max_iters=3))
    torch.cuda.synchronize()

    # cuda (the counted run), plain, plain, cuda: one card, taken in turns
    results, times, launches, repeat = {}, {"cuda": [], "plain": []}, None, {}
    for impl in ("cuda", "plain", "plain", "cuda"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        two_loop_cuda.LAUNCHES = 0
        start.record()
        res = lbfgs(problem, w0, aux, opts[impl])
        end.record()
        torch.cuda.synchronize()
        if launches is None:
            launches = two_loop_cuda.LAUNCHES
        times[impl].append(start.elapsed_time(end) / res.n_iters)
        if impl in results:
            repeat[impl] = torch.equal(res.x, results[impl].x)
            continue
        results[impl] = res
        lh = res.loss_history[:res.n_iters]
        check(res.x.shape == (spec.n_params,) and bool(torch.isfinite(res.x).all()),
              f"{impl}: iterate has the wrong shape or non-finite values")
        check(bool(torch.isfinite(lh).all()), f"{impl}: non-finite loss")
        check(float(res.final_loss) < f0, f"{impl}: loss did not fall")
    ms_iter = {impl: min(t) for impl, t in times.items()}
    for impl, res in results.items():
        acc = evaluate(spec, res.x, *aux)["accuracy"]
        say("solve", f"two_loop_impl={impl}: {res.n_iters} iters, loss {f0:.6g} -> "
            f"{float(res.final_loss):.6g}, train acc {acc:.2f}%, {ms_iter[impl]:.3f} ms/iter "
            f"(CUDA events, min of {[round(t, 3) for t in times[impl]]}), n_fevals "
            f"{res.n_fevals}, n_gevals {res.n_gevals}, host syncs {res.n_host_syncs} "
            f"({res.n_host_syncs / res.n_iters:.2f}/iter); repeat bitwise equal: {repeat[impl]}")
    rc, rp = results["cuda"], results["plain"]
    check(launches == rc.n_iters,
          f"kernel launches {launches} != directions computed {rc.n_iters}")
    first_c, first_p = rc.loss_history[:5].cpu().numpy(), rp.loss_history[:5].cpu().numpy()
    check(np.allclose(first_c, first_p, rtol=1e-4, atol=0),
          f"first 5 losses differ: {first_c} vs {first_p}")
    lc, lp = float(rc.final_loss), float(rp.final_loss)
    check(abs(lc - lp) <= 0.02 * lp, f"final losses differ by more than 2%: {lc} vs {lp}")
    say("solve", f"kernel launches in the counted solve: {launches} = directions computed; "
        f"first 5 losses agree to rtol 1e-4; final {lc:.6g} vs plain {lp:.6g} "
        f"({abs(lc - lp) / lp * 100:.3f}% apart, limit 2%)")
    if profile:
        _profile(torch, problem, w0, aux, opts["cuda"]._replace(max_iters=10))
    return launches, ms_iter


def _profile(torch, problem, w0, aux, opts):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lbfgs_ffnn_torch.solvers.lbfgs import lbfgs

    def wall_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6, res

    # the same solve unprofiled, before and after the traced one
    bare = [wall_us(lambda: lbfgs(problem, w0, aux, opts))[0]]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_us, res = wall_us(lambda: lbfgs(problem, w0, aux, opts))
    bare.append(wall_us(lambda: lbfgs(problem, w0, aux, opts))[0])
    # device-side rows only (kernels, copies); the op rows repeat their time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events)
    k = res.n_iters
    say("profile", f"{k} iters: device busy {busy / k:.1f} us/iter (traced); wall "
        f"{traced_us / k:.1f} us/iter traced, {[round(b / k, 1) for b in bare]} us/iter "
        f"unprofiled (same solve, this run); device idle {100 - busy / min(bare) * 100:.1f}% "
        f"of the faster unprofiled wall, {100 - busy / traced_us * 100:.1f}% of the traced wall")
    for e in events[:12]:
        say("profile", f"  {e.self_device_time_total / res.n_iters:9.1f} us/iter "
            f"{e.count / res.n_iters:6.1f} calls/iter  {e.key[:90]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace 10 solver iterations with torch.profiler")
    parser.add_argument("--mnist-root", default=None,
                        help="directory of the MNIST IDX files; without it the data are "
                             "seeded labels with synthetic images")
    args = parser.parse_args()
    import torch

    smi = device_phase(torch)
    build_phase()
    from lbfgs_ffnn_torch.objectives.mlp import mlp_spec

    n = mlp_spec(DIMS, ACTS).n_params
    dev = torch.device("cuda")
    worst, ms, plain_ms = kernel_phase(torch, n, dev)
    launches, ms_iter = solve_phase(torch, dev, args.profile, args.mnist_root)
    kernels = [{
        "name": "two_loop_cooperative",
        "route": "cuda",
        "source": "lbfgs_ffnn_torch/csrc/two_loop.cu",
        "replaces": "lbfgs_ffnn_tpu/ops/pallas_two_loop.py:173",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]
    say("result", f"{smi}; solve ms/iter: cuda {ms_iter['cuda']:.4f}, plain {ms_iter['plain']:.4f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
