"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile    # also trace the kernels and two solves
    python3 chip_smoke.py --mnist-root DIR   # MNIST IDX files instead of seeded data

Phases, each printing its lines (any failure raises and exits non-zero):
  1. device   - refuses to run without CUDA; torch, CUDA, nvcc and card
  2. build    - compiles lbfgs_ffnn_torch/csrc/two_loop.cu,
                csrc/conditional.cu (CUDA graph IF nodes), csrc/lstsq.cu
                (GMRES's least squares) and csrc/gather.cu (the out-of-core
                row gather) for sm_90a, the four nvcc runs together, and
                prints ptxas's report for every kernel (K1 and its
                timestamped build, K2 at each group size k, K3, both pair
                types; the least-squares kernel in f32 and f64; the gather)
  3. kernel   - the cooperative kernel (K1, the compact form) against its
                plain torch version on the m=10, n=101,770 f32 and bf16
                rings: empty, partial, full and wrapped, clamp on and off;
                error bounds, bitwise repeatability; also against the
                compact form in plain torch (two_loop_compact)
  4. stream   - the streaming kernel (K2) the same way on the m=100,
                n=242,762 (deep net) f32 and bf16 rings (counts 0, 37, 100
                and wrapped), at every group size k the ring takes (1, 2, 4
                and, for bf16, 8), each also against the grouped algebra in
                plain torch (two_loop_grouped) at its k
  5. blocked  - the blocked kernel (K3, its L2 prefetch at the distance
                prefetch_rows gives) the same way on m=50 rings at
                n = 2,000,000 and 4,000,000, f32 and bf16, with its distance
                and us per stage on the wrapped ring; then the diag entry
                (lbfgs_ffnn_torch.experiments.diag_two_loop_large) at
                n=4,000,000, m=50
  6. table    - the dispatch table: every kernel whose slices fit (K2 in a
                column per group size k, the one group_size picks marked;
                K3 on the m=50 rows in a column per prefetch distance d in
                {1, 2, 4, prefetch_rows's d, twice that}, its d marked) and
                the plain version, timed at m in {10, 100} x n in
                {101,770, 242,762} and m=50 x n in {1M, 2M, 4M}, x {f32, bf16},
                each beside its bounds (history read once, and twice where
                the ring outgrows the L2) and K3's us per stage; then K1's
                phase split and launch gap on the m=10 MNIST rings
                (lbfgs_ffnn_torch.experiments.resident_phase_study, in a
                process of its own)
  7. solve    - 100 iterations of L-BFGS (m=10, Armijo, ls_max_iters=20) on
                the 784-128-10 MLP at N=60,000, f32, through the kernel, then
                through the plain two-loop (both on the resident driver);
                the loss must fall, K1 must run once per direction, and the
                two solves agree
  8. resident - the main path on the resident driver: lbfgs() on CUDA
                tensors (each iteration a replayed CUDA graph, its Armijo
                trials decided on the card by IF nodes) against the resident
                body run eagerly (loss histories to rtol 1e-6, counters
                equal) and the early-exit loop (first 5 losses to rtol 1e-4,
                n_fevals equal over 20 iterations, final loss within 2%);
                host syncs <= ceil(iters / chunk) + 2; K1 launched once per
                direction, counted on the device; ms/iter of each run and
                the device time of a trial slot that does not fire
  9. deep     - the runner (lbfgs_ffnn_torch.experiments.run_mnist) on the
                deep 784-256-128-64-10 Fashion net at N=60,000 from seeded
                label files: GD, L-BFGS m=100 through K2 (k = 4 for the f32
                ring, 8 for bf16) in f32 and bf16 ring, and through the
                plain two-loop in f32 and bf16 ring, 120 iterations each; K2
                must run once per direction, the f32 kernel and plain final
                losses within 2%; the four L-BFGS solves again at init seeds
                124-130 through the runner's Launcher, where K2 must run once
                per direction and each ring's kernel solve agrees with the
                plain one on that ring (first 5 losses to rtol 1e-4) at
                every seed; prints the final losses per seed and the bf16
                ring's parity with f32 (the bench's 2% rule, a reading)
 10. large    - L-BFGS (m=50, f32) on the extended Rosenbrock at
                n=2,000,000 through the harness (lbfgs_ffnn_torch.harness),
                120 iterations under Armijo (ls_max_iters=20) and under
                Wolfe (both on the resident driver), each through K3,
                through the plain two-loop, and with the bf16 ring through
                the kernel the dispatch picks (K3); the kernels must run
                once per direction, the kernel and plain solves agree, and
                each search's resident solve agrees with the early-exit
                loop's (first 5 losses to rtol 1e-3; its ms/iter and host
                syncs printed beside)
 11. bench    - python -m lbfgs_ffnn_torch.experiments.bench in a process of
                its own (the 1000-iteration headline chosen among its five
                rows, its supplementary rows on stderr); its one stdout
                line must be the contract JSON, and its stderr must name
                one of the five rows on a "headline config:" line
 12. stochastic - S-LBFGS at the bench row's configuration (the first 5,000
                samples, b=256, b_H=128, M=10, L=10, lam 1e-4, step 0.02)
                on the 784-128-10 net: the captured solve (each epoch
                replayed from its CUDA graphs: start, segment, finish)
                equals the epoch's bodies run eagerly on the card bitwise after 5 epochs (anchor, ring, u_prev,
                has_u, loss history) and over 30; K1 (gamma clamp) runs
                30 epochs x 19 inner steps times, counted on the device;
                the first 3 epochs' losses equal the plain two-loop's to
                rtol 1e-4 and the final loss is within 2%; host syncs <=
                ceil(30 / 10) + 2; ms/epoch captured and eager, the capture
                time and peak memory; the bf16 ring's final loss against
                f32 (a reading); then the Launcher's S-LBFGS on all 60,000
                samples at its defaults (b=128, 468 inner steps), 3
                epochs, with the time of its capture. --profile adds the
                device idle share and K1's device us per call on this path
 13. pinn     - the PINN path: K2 on the Burgers ring (m=100, n=921, one
                block, k = 8) and K1 on the oscillator's (m=16, n=481)
                against the plain version and timed beside it; (a) Burgers
                at full width (2-20-20-20-1, the full 2001/402/10,251-point
                grid, f32, m=100, Wolfe with 100 lean trials, relative
                curvature gate 1e-6) through K2: the captured solve (its
                trials a CUDA graph WHILE node) equals the eager body
                bitwise over 10 iterations, K2 once per iteration, the
                first 5 losses equal the plain two-loop's and the early-exit
                loop's to rtol 1e-4, host syncs <= ceil(10 / 10) + 2; ms/iter
                captured and early-exit, trials/iter, capture time, peak
                memory; (b) the Burgers runner
                (lbfgs_ffnn_torch.experiments.run_burgers) at its defaults,
                5000 iterations, its CSV held to the FD gate (mean |u - u_FD|
                <= 0.02 at t = 0, 0.5, 1.0), K2 launches counted; (c) the
                oscillator runner (run_oscillator --reps 1, 1-20-20-1,
                m=16, Wolfe with 50 fused trials, 2000 iterations) through
                K1: max |u - sin| <= 0.05, K1 launches counted; the phase's
                time
 14. first_order - the first-order solvers and the runner's last rows: (a)
                the runner (run_mnist --iters 100 --timed-chunks 10
                --record-accuracy) at its four default rows in the cuda
                style (GD, sequential SGD, L-BFGS m=10 through K1 and m=100
                through K2; 784-128-10, N=60,000) and in the cpu style (GD,
                random SGD, S-LBFGS through K1, Wolfe L-BFGS m=20 through
                K2; N=5,000) from seeded label files: no row "not run",
                every loss finite and falling, the CSV columns (TrainAcc and
                TestAcc on the stochastic rows), host syncs <= ceil(steps /
                10) + 2, the kernels' launches = directions; (b) GD momentum
                and Wolfe (50 iterations, N=60,000), captured = eager body
                bitwise, ms/iter captured and on the host loop; (c) SGD
                sequential (234 batches of 256 and a 96-row tail) and
                random, captured = eager body bitwise over 3 epochs,
                ms/epoch over 10, capture time, host syncs; (d)
                sgd_streaming from the port's BatchStreamer (pinned), 2
                epochs, its ms/epoch beside the resident SGD's; the phase's
                time
 15. traffic  - the bench's traffic variants at MNIST width (784-128-10,
                N=60,000, m=10, Armijo): f32, bf16-traffic, u8-traffic,
                u8-warm and u8-warm-nr, 100 iterations each on the
                resident driver, captured: the first 10 iterations equal
                the eager body's bitwise, the first loss f32's (bitwise;
                rtol 1e-5 where fun_input_dtype is uint8), the refresh
                fired 100 // 16 = 6 times (0 for u8-warm-nr and f32; the
                state's device counter), K1 ran iterations + 1 capture,
                and the same solve again captured nothing on the same
                prepared copy; ms/iter, trials/iter, capture time and peak
                memory per row; the first-layer GEMM pair's µs at N=60,000
                for x in f32, uint8 and bf16 (upcast); the deep u8 traffic
                stack, 20 iterations through K2 (21 launches); the
                runner's --u8-input GD and SGD rows, 10 iterations/epochs
 16. suite    - BFGS and Newton on the resident driver: the deterministic
                suite runner (lbfgs_ffnn_torch.experiments.
                run_deterministic_suite: BFGS, L-BFGS m=16, BFGS+GMRES and
                Newton on Rosenbrock n=4, Ackley n=3 and Rastrigin n=500,
                5000 iterations, tol 1e-12) in f64, held to JAX's gates
                (tests/test_solvers_analytic.py:69-101), and in f32 with
                its BFGS+GMRES rows cut to 10 iterations (at tol 1e-12
                f32 GMRES runs 10,000 cycles per BFGS iteration; every
                other row 5000 iterations, Rastrigin n=500), its
                L-BFGS row through K1 (launches = iterations + 1 capture per
                row, counted on the device) and its BFGS+GMRES rows through
                the least-squares kernel (csrc/lstsq.cu), held against its
                plain version on full-rank and rank-deficient 21 x 20
                Hessenberg matrices and timed beside it; Newton-CG
                (cg_max_iters=50) and factor-form BFGS (CG, 200 iterations)
                at MNIST width (784-128-10, N=60,000, f32), 10 iterations
                each: ms/iter, HVPs or matvecs/iter, trials/iter, host syncs,
                capture time, peak memory, captured = eager body bitwise;
                dense BFGS (direct) and dense Newton (autodiff Hessian) on
                the extended Rosenbrock at n = 8192, f64, 10 iterations,
                and n = 8193 refused; every BFGS and Newton mode captured =
                eager body bitwise on Rosenbrock n=4 (30 iterations), a
                second solve capturing nothing
 17. outofcore - the out-of-core path on the bench's data held in a
                ChunkStore (pinned host memory, chunk_rows = 8192: 8 chunks,
                the last 2,656 rows): the gather kernel (csrc/gather.cu)
                bitwise against its plain route on 10 index sets (repeats,
                rows of the ragged chunk), timed at b = 256 and 128 beside
                the plain route, its bound and a 256 MB pinned copy's rate;
                outofcore_problem against the in-memory batch problem at w0
                (rtol 1e-5); Armijo L-BFGS (m=10, 100 iterations) on
                outofcore_mlp_problem, captured (chunk copies as memcpy
                nodes), against the in-memory resident solve (first 5
                losses to rtol 1e-4, final within 2%), the captured solve
                = the eager body bitwise over 10 iterations, host syncs <=
                ceil(100 / 10) + 2, K1 once per direction, ms/iter, bytes
                copied per iteration and both peak memories (the
                out-of-core peak below the in-memory one by half of x's
                188 MB at least); kill-and-resume across processes
                (lbfgs_ffnn_torch.experiments.kill_resume: one process
                saves and is killed, another restores and finishes) for the
                out-of-core L-BFGS (first 5 losses after the resume to rtol
                1e-4, final within 2%), S-LBFGS in memory (3 epochs) and
                L-BFGS on the extended Rosenbrock at n = 100,000 (both
                bitwise equal to their uninterrupted runs); S-LBFGS with
                store= (N=60,000, b=256, b_H=128, L=10, 3 epochs) against the
                in-memory solve with the same seed (per-epoch losses to rtol
                1e-4, final within 2%), its captured epoch = the eager body
                bitwise, host syncs, ms/epoch and the gather kernel's
                launches; the phase's time
 18. result   - one JSON line with the kernels' numbers (K1's launches
                summed over its seven paths, K2's over its four, each also
                by path, with the PINN ring's numbers; K2's with its group
                size, K3's with its prefetch distance and its time at each
                distance; the least-squares kernel's; the gather kernel's),
                then the last line {"ok": true, "device": {...}}

The L-BFGS solves of phases 7-10, 13, 14 and 17 (Armijo and Wolfe), the
S-LBFGS solves of phases 12, 14 and 17 and the GD and SGD solves of phase 14
run on the resident driver; their host syncs are held to ceil(iters /
chunk) + 2, and every launch count is read from the kernels' counters on
the device.

--profile adds torch.profiler readings: each kernel's device time per call
in the dispatch table, and the device time by kernel of 10 MNIST iterations,
of the 100-iteration resident MNIST solve,
of the whole deep L-BFGS m=100 f32 solve, of the whole large Rosenbrock
Armijo solve through K3 and of the Burgers (200 iterations captured, 10
early-exit) and oscillator (200 iterations) solves, each beside the wall
time of the same solve unprofiled, with the two-loop kernel's device time
per iteration; the 100-iteration captured Burgers solve in both of the
residual's formulations ("vmap", the default, and "batched"); and the
captured GD momentum solve and the SGD solves of phase 14 (the device idle
share per iteration or epoch).

Imports nothing of JAX. Full f32 throughout: TF32 is switched off.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_TRAIN = 60_000
DIMS, ACTS = [784, 128, 10], ["relu", "linear"]
DEEP_DIMS = [784, 256, 128, 64, 10]
DEEP_ACTS = ["relu", "relu", "relu", "linear"]
M = 10
M_DEEP = 100
M_RUNNER_K2 = (20, 100)  # the runner's L-BFGS rows that K2 takes at MNIST width
M_LARGE = 50
N_LARGE = 2_000_000
N_LARGE_RINGS = (2_000_000, 4_000_000)
N_MID = 1_048_576  # the JAX package's diag_two_loop_large.py at 1M: K2 and K3 both take it
ITERS = 100
DEEP_ITERS = 120
DEEP_SEEDS = 8  # init seeds of the deep L-BFGS solves: the runner's 123, then 124-130
LARGE_ITERS = 120
SEED = 123
SL_N, SL_B, SL_BH, SL_L = 5_000, 256, 128, 10  # the port bench's S-LBFGS row
SL_EPOCHS = 30
FO_ITERS = 100       # the runner's default rows: iterations (epochs) each
FO_GD_ITERS = 50     # GD held captured = eager body bitwise, and timed
FO_SGD_CHECK = 3     # SGD epochs held captured = eager body bitwise
FO_SGD_EPOCHS = 10   # SGD epochs timed
LAUNCHER_EPOCHS = 3  # the Launcher's S-LBFGS on all N_TRAIN samples
TRAFFIC_ITERS = 100      # each traffic variant's captured solve
TRAFFIC_CHECK = 10       # iterations held captured = eager body bitwise
TRAFFIC_DEEP_ITERS = 20  # the deep u8 row through K2
TRAFFIC_FO = 10          # the runner's u8input GD iterations and SGD epochs
PINN_CHECK_ITERS = 10  # Burgers iterations held captured = eager body bitwise
BURGERS_ITERS = 5000   # the Burgers runner's default depth
KERNEL_REL_TOL = 1e-4  # max|kernel - plain| / max|plain|, f32 reduction order
ERR_RATIO = 2.0        # kernel's f64-referenced error vs the plain f32 one's
LOSS_GATE = 0.02       # final losses within 2% (the bench's quality gate)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
F64_FLOPS = 67e12          # H100 SXM f64 peak: the tensor cores' IEEE f64 (NVIDIA's data sheet;
                           # 34e12 outside them)
SUITE_MF_ITERS = 10        # the MNIST-width Newton-CG and factor-BFGS solves
SUITE_F32_GMRES_ITERS = 10  # the f32 suite's BFGS+GMRES rows (10,000 GMRES cycles an iteration)
SUITE_DENSE_ITERS = 10     # the dense solves at n = DENSE_HESSIAN_LIMIT
SUITE_CHECK_ITERS = 30     # Rosenbrock n = 4 solves held captured = eager body bitwise
LSTSQ_REPS = 200           # timed calls of the least-squares kernel
TIMED_CALLS = 200
TIMED_CALLS_LARGE = 20  # per timing in the n = 1M, 2M and 4M rows
L2_BYTES = 50e6            # H100 L2
HEAD_START_CYCLES = 200_000  # a ~100 us spin kernel queued before each timed call
K3_STAGE_US_BEFORE = 8.5   # K3's us per stage at m=50, n=2M f32 before its L2 prefetch (PERF.md)


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
    from lbfgs_ffnn_torch.ops.control import conditional_nodes_supported

    driver = ctypes.c_int()
    check(ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(driver)) == 0,
          "cuDriverGetVersion failed")
    cond_ok, cond_why = conditional_nodes_supported()
    check(cond_ok, cond_why)
    say("device", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}; driver CUDA {driver.value // 1000}."
        f"{driver.value % 1000 // 10}; {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; TF32 off; CUDA graph IF nodes through "
        "csrc/conditional.cu (torch's CUDAGraph has none), CUDA 12.4+ needed")
    check(driver.value >= 12040, f"the driver's CUDA {driver.value} is older than 12.4, which "
          "conditional nodes need")
    print(smi, flush=True)
    return smi


# The kernels' entry functions in csrc/two_loop.cu.
KERNEL_NAMES = ("two_loop_resident_kernel", "two_loop_grouped_kernel", "two_loop_blocked_kernel")


def _kernel_label(name):
    """What ptxas's mangled entry name is: two_loop_resident_kernel<T,
    false> is K1 (true: its timestamped build), two_loop_grouped_kernel<T, K>
    K2 at k = K, two_loop_blocked_kernel<T> K3."""
    if "two_loop_grouped_kernel" in name:
        kind = "streaming k=" + re.search(r"Li(\d+)E", name).group(1)
    elif "two_loop_resident_kernel" in name:
        kind = "cooperative" + (" timestamped" if "Lb1E" in name else "")
    elif "two_loop_blocked_kernel" in name:
        kind = "blocked"
    else:
        raise RuntimeError(f"unknown entry function {name}")
    return f"{kind}, {'bf16' if 'bfloat16' in name else 'f32'} pairs"


def build_phase():
    from lbfgs_ffnn_torch import _build
    from lbfgs_ffnn_torch.ops import control
    from lbfgs_ffnn_torch.ops.cuda_two_loop import _lib

    t0 = time.perf_counter()
    from lbfgs_ffnn_torch.ops.cuda_lstsq import _lib as lstsq_lib

    from lbfgs_ffnn_torch.ops.cuda_gather import _lib as gather_lib

    # one nvcc each, together
    builds = _build.build_all(["two_loop", "conditional", "lstsq", "gather"])
    _lib()
    control._lib()
    lstsq_lib()
    gather_lib()
    for name, b in builds.items():
        say("build", f"{b.path.name} from csrc/{name}.cu with {' '.join(_build.NVCC_FLAGS)} "
            f"in {b.seconds:.2f} s (compiled={b.compiled})")
    say("build", f"all four built in {time.perf_counter() - t0:.2f} s of wall time")
    for name, what in (("lstsq", "least squares"), ("gather", "row gather")):
        for line in builds[name].log.splitlines():
            if "Used" in line or "spill" in line:
                say("build", f"ptxas {what}: {line.split('ptxas info    : ')[-1].strip()}")
    built = builds["two_loop"]
    kind = None
    for line in built.log.splitlines():
        if "Compiling entry function" in line:
            kind = _kernel_label(line.split("'")[1])
        elif kind and ("Used" in line or "spill" in line):
            say("build", f"ptxas {kind}: {line.split('ptxas info    : ')[-1].strip()}")


def _rings(torch, ttl, m, n, ks, pair_dtype, dev, seed):
    """Snapshots of one ring of capacity m after each count in ks (rising)
    of seeded pushes; the pairs come from a CUDA generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = ttl.empty_history_state(m, n, torch.float32, pair_dtype, device=dev)
    out, pushed = {}, 0
    for k in ks:
        while pushed < k:
            s = torch.randn(n, generator=gen, device=dev)
            y = torch.randn(n, generator=gen, device=dev) + 0.5 * s
            hist = ttl.ring_push(hist, s, y, 1.0 / torch.dot(y, s), torch.dot(y, s) > 1e-3)
            pushed += 1
        out[k] = hist._replace(S=hist.S.clone(), Y=hist.Y.clone(), rho=hist.rho.clone())
    return out


def _agreement(torch, ttl, kernels, phase, v, rings, m, n, pair_name):
    """Each ring, clamp off and on: every kernel of ``kernels`` ({label:
    (fn, algebra)}; fn is two_loop_cuda, the dispatch's pick, or one
    kernel's launch) against the plain f32 version on the same ring and the
    plain f64 one; where algebra is not None, (its name, its function), also
    against the algebra the kernel computes in plain f32 torch (K1's compact
    form, K2's grouped form at its k). Returns each label's largest
    max|kernel - plain|."""
    worst = dict.fromkeys(kernels, 0.0)
    for pushes, hist in rings.items():
        h64 = hist._replace(S=hist.S.double(), Y=hist.Y.double(), rho=hist.rho.double())
        for clamp in (False, True):
            r_p = ttl.two_loop(v, hist, clamp_gamma=clamp)
            r_64 = ttl.two_loop(v.double(), h64, clamp_gamma=clamp)
            err_p = float((r_p.double() - r_64).abs().max())
            for label, (kernel, algebra) in kernels.items():
                r_k = kernel(v, hist, clamp_gamma=clamp)
                r_k2 = kernel(v, hist, clamp_gamma=clamp)
                torch.cuda.synchronize()
                what = f"m={m} n={n} {pair_name}{label} pushes={pushes} clamp={clamp}"
                check(bool(torch.isfinite(r_k).all()), f"{what}: non-finite output")
                diff = float((r_k - r_p).abs().max())
                rel = diff / float(r_p.abs().max())
                err_k = float((r_k.double() - r_64).abs().max())
                check(rel <= KERNEL_REL_TOL, f"{what}: |kernel-plain|/|plain| = {rel:.3e}")
                check(err_k <= ERR_RATIO * err_p,
                      f"{what}: f64-referenced error kernel {err_k:.3e} > {ERR_RATIO} x plain "
                      f"{err_p:.3e}")
                check(torch.equal(r_k, r_k2), f"{what}: two calls differ")
                grouped = ""
                if algebra is not None:
                    name, fn = algebra
                    r_g = fn(v, hist, clamp_gamma=clamp)
                    rel_g = float((r_k - r_g).abs().max()) / float(r_g.abs().max())
                    check(rel_g <= KERNEL_REL_TOL,
                          f"{what}: |kernel-{name}|/|{name}| = {rel_g:.3e}")
                    grouped = (f"; vs {name}: rel {rel_g:.3e} "
                               f"(f64-referenced {float((r_g.double() - r_64).abs().max()):.3e})")
                worst[label] = max(worst[label], diff)
                say(phase, f"{what} (count={min(pushes, m)}, wrapped={pushes > m}): "
                    f"max|kernel-plain|={diff:.3e} (rel {rel:.3e} <= {KERNEL_REL_TOL}); vs f64: "
                    f"kernel {err_k:.3e}, plain f32 {err_p:.3e} (<= {ERR_RATIO}x){grouped}; "
                    "bitwise repeat ok")
    return worst


def kernel_phase(torch, n, dev):
    import lbfgs_ffnn_torch.ops.two_loop  # noqa: F401  (the module, not the function)
    from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, kernel_dispatch, two_loop_cuda

    ttl = sys.modules["lbfgs_ffnn_torch.ops.two_loop"]
    v = torch.tensor(np.random.default_rng(1).normal(size=n), dtype=torch.float32, device=dev)
    worst = 0.0
    for pd, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        rings = _rings(torch, ttl, M, n, (0, 4, 10, 13), pd, dev, seed=1)
        impl = kernel_dispatch(rings[0].S.shape[1], M, torch.float32, pd)[0]
        check(impl == COOPERATIVE, f"m={M} n={n} {name}: dispatch picks {impl}, not K1")
        compact = ("compact form", ttl.two_loop_compact)
        worst = max(worst, _agreement(torch, ttl, {"": (two_loop_cuda, compact)}, "kernel", v,
                                      rings, M, n, name)[""])
    return worst


def bound(n, m, pair_bytes):
    """(ms, "bytes" or "operations"): the least time for one call on a full
    ring of m pairs: 2 m n_pad pair bytes of history read once, v read and
    out written once (f32), at the HBM rate; against 4 flops per element of
    each of the 2m stages, plus the newest pair's two extra dots, at the f32
    rate."""
    n_pad = -(-n // 128) * 128
    nbytes = 2 * m * n_pad * pair_bytes + 2 * n * 4 + m * 4
    flops = 4 * n_pad * (2 * m + 1)
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def two_pass_ms(n, m, pair_bytes):
    """The floor of a streaming recursion on a ring larger than the L2: the
    forward pass needs every pair again, so the history is read twice, plus
    v and out; a ring that fits the L2 can be read once (then the bound
    above)."""
    n_pad = -(-n // 128) * 128
    ring = 2 * m * n_pad * pair_bytes
    if ring <= L2_BYTES:
        return bound(n, m, pair_bytes)[0]
    return (2 * ring + 2 * n * 4 + m * 4) / HBM_BYTES_PER_S * 1e3


def _time_cold_ms(torch, fn, flush, reps=TIMED_CALLS):
    """Mean device time of ``fn()`` over ``reps`` calls, CUDA events around
    each call, with the L2 flushed before it (as the solve leaves it: each
    iteration streams the 188 MB input through the 50 MB L2) and a spin
    kernel queued after the flush, so that the host has queued the call
    before the card reaches the start event: a call's host-side Python is
    not in its time, even where it outlasts the flush."""
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
    return sum(s.elapsed_time(e) for s, e in events) / reps


def _kernel_device_us(torch, fn, flush, reps=20):
    """Device time per call of the two-loop kernels that ``fn()`` launches,
    from torch.profiler, with the L2 flushed before each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(k in e.key for k in KERNEL_NAMES)) / reps


def _groups(n_pad, m, pair_bytes):
    """The group sizes K2 takes on a ring, smallest first."""
    from lbfgs_ffnn_torch.ops.cuda_two_loop import GROUP_SIZES, group_fits

    return sorted(k for k in GROUP_SIZES if group_fits(n_pad, m, pair_bytes, k))


def stream_phase(torch, dev):
    """K2 at every group size the deep rings take, then at the group size
    the dispatch gives the runner's MNIST rings (L-BFGS m = 100 in the cuda
    style, Wolfe m = 20 in the cpu style). Returns the largest
    max|kernel - plain| at the group size the dispatch runs, f32 rings."""
    import functools

    import lbfgs_ffnn_torch.ops.two_loop  # noqa: F401
    from lbfgs_ffnn_torch.ops.cuda_two_loop import STREAMING, group_size, kernel_dispatch, launch

    ttl = sys.modules["lbfgs_ffnn_torch.ops.two_loop"]
    n_deep = _n_params(DEEP_DIMS)
    v = torch.tensor(np.random.default_rng(2).normal(size=n_deep), dtype=torch.float32,
                     device=dev)
    worst = {}
    for pd, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        rings = _rings(torch, ttl, M_DEEP, n_deep, (0, 37, 100, 130), pd, dev, seed=2)
        n_pad = rings[0].S.shape[1]
        impl = kernel_dispatch(n_pad, M_DEEP, torch.float32, pd)[0]
        check(impl == STREAMING, f"m={M_DEEP} n={n_deep} {name}: dispatch picks {impl}, not K2")
        ks = _groups(n_pad, M_DEEP, pd.itemsize)
        picked = group_size(n_pad, M_DEEP, pd.itemsize)
        say("stream", f"m={M_DEEP} n={n_deep} {name}: K2 takes k in {ks}; group_size picks "
            f"{picked}")
        kernels = {f" K2 k={k}": (functools.partial(launch, STREAMING, group=k),
                                  (f"grouped algebra at k={k}",
                                   functools.partial(ttl.two_loop_grouped, k=k)))
                   for k in ks}
        errs = _agreement(torch, ttl, kernels, "stream", v, rings, M_DEEP, n_deep, name)
        worst[name] = errs[f" K2 k={picked}"]
        del rings
    n_mnist = _n_params(DIMS)
    v = torch.tensor(np.random.default_rng(9).normal(size=n_mnist), dtype=torch.float32,
                     device=dev)
    for m in M_RUNNER_K2:
        for pd, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            rings = _rings(torch, ttl, m, n_mnist, (0, m // 3, m, m + 3), pd, dev, seed=9)
            n_pad = rings[0].S.shape[1]
            impl = kernel_dispatch(n_pad, m, torch.float32, pd)[0]
            check(impl == STREAMING, f"m={m} n={n_mnist} {name}: dispatch picks {impl}, not K2")
            k = group_size(n_pad, m, pd.itemsize)
            say("stream", f"runner ring m={m} n={n_mnist} {name}: group_size picks {k}")
            label = f" K2 k={k}"
            errs = _agreement(torch, ttl, {label: (
                functools.partial(launch, STREAMING, group=k),
                (f"grouped algebra at k={k}", functools.partial(ttl.two_loop_grouped, k=k)))},
                "stream", v, rings, m, n_mnist, name)
            worst[name] = max(worst[name], errs[label])
            del rings
    return worst["f32"]


def blocked_phase(torch, dev, ns=N_LARGE_RINGS, m=M_LARGE, diag_n=4_000_000):
    """K3 forced onto the large rings at its prefetch distance (launched by
    name, whichever kernel the dispatch gives a ring), then the diag
    entry."""
    import functools

    import lbfgs_ffnn_torch.ops.two_loop  # noqa: F401
    from lbfgs_ffnn_torch.experiments import diag_two_loop_large
    from lbfgs_ffnn_torch.ops.cuda_two_loop import BLOCKED, launch, prefetch_rows

    ttl = sys.modules["lbfgs_ffnn_torch.ops.two_loop"]
    k3 = functools.partial(launch, BLOCKED)
    flush = torch.empty(64 * 1024 * 1024, device=dev)  # 256 MB > the 50 MB L2
    worst = 0.0
    for n in ns:
        v = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        for pd, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            rings = _rings(torch, ttl, m, n, (0, 20, m, m + 3), pd, dev, seed=6)
            worst = max(worst, _agreement(torch, ttl, {" K3": (k3, None)}, "blocked", v, rings,
                                          m, n, name)[" K3"])
            us = _time_cold_ms(torch, lambda: k3(v, rings[m + 3]), flush, reps=5) * 1e3
            say("blocked", f"m={m} n={n} {name}: K3 prefetches "
                f"{prefetch_rows(rings[0].S.shape[1], pd.itemsize)} rows ahead; wrapped ring "
                f"{us:.1f} us per call, {us / (2 * m):.2f} us per stage (time / 2 count; "
                f"{K3_STAGE_US_BEFORE} at n=2M f32 before the prefetch), 5 calls, L2 flushed "
                "before each")
            del rings
    del flush
    say("blocked", f"diag entry: python -m lbfgs_ffnn_torch.experiments.diag_two_loop_large "
        f"--n {diag_n} --m {m}")
    diag = diag_two_loop_large.main(["--n", str(diag_n), "--m", str(m)])
    return worst, diag


def table_phase(torch, dev, profile: bool):
    """The dispatch table: every kernel that takes the ring (K2 at each group
    size k it takes, as "cuda-streaming k=K"), and the plain version, on a
    full wrapped ring; timed in turns, min of two."""
    import lbfgs_ffnn_torch.ops.two_loop  # noqa: F401
    from lbfgs_ffnn_torch.ops.cuda_two_loop import (
        BLOCKED, COOPERATIVE, STREAMING, fits, group_size, kernel_dispatch, launch,
        prefetch_rows,
    )

    ttl = sys.modules["lbfgs_ffnn_torch.ops.two_loop"]
    n_mnist, n_deep = _n_params(DIMS), _n_params(DEEP_DIMS)
    flush = torch.empty(64 * 1024 * 1024, device=dev)  # 256 MB > the 50 MB L2
    say("table", f"dispatch table (CUDA events around each call, L2 flushed before it, "
        f"{TIMED_CALLS} calls, {TIMED_CALLS_LARGE} at n >= 1M; min of 2 in turns); the "
        "dispatch takes the first of cooperative, streaming, blocked whose slices fit, "
        "streaming at the largest k that fits (group_size, marked *), blocked at "
        "prefetch_rows's distance d (marked *)")
    rows = [(m, n) for m in (10, 100) for n in (n_mnist, n_deep)]
    rows += [(M_LARGE, n) for n in (N_MID,) + N_LARGE_RINGS]
    table = {}
    for m, n in rows:
        reps = TIMED_CALLS_LARGE if n >= N_MID else TIMED_CALLS
        for pd, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            hist = _rings(torch, ttl, m, n, (m + 3,), pd, dev, seed=3)[m + 3]
            vv = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
            n_pad = hist.S.shape[1]
            fns = {"plain": lambda: ttl.two_loop(vv, hist)}
            k_pick = group_size(n_pad, m, pd.itemsize)
            d_pick = prefetch_rows(n_pad, pd.itemsize)
            # K3's distance study on the large rings; elsewhere its own d
            ds = sorted({1, 2, 4, d_pick, 2 * d_pick}) if m == M_LARGE else [d_pick]
            for impl in (COOPERATIVE, STREAMING, BLOCKED):
                if impl == STREAMING:
                    for k in _groups(n_pad, m, pd.itemsize):
                        fns[f"{impl} k={k}{'*' if k == k_pick else ''}"] = (
                            lambda k=k: launch(STREAMING, vv, hist, group=k))
                elif impl == BLOCKED:
                    for d in ds:
                        fns[f"{impl} d={d}{'*' if d == d_pick else ''}"] = (
                            lambda d=d: launch(BLOCKED, vv, hist, prefetch=d))
                elif fits(impl, n_pad, m, pd.itemsize):
                    fns[impl] = lambda impl=impl: launch(impl, vv, hist)
            for fn in fns.values():
                _time_cold_ms(torch, fn, flush, reps=5)  # warm-up
            order = list(fns) + list(fns)[::-1]
            times = {k: [] for k in fns}
            for k in order:
                times[k].append(_time_cold_ms(torch, fns[k], flush, reps))
            ms = {k: min(t) for k, t in times.items()}
            device = ("; device time (profiler, 20 calls): " + ", ".join(
                f"{k} {_kernel_device_us(torch, fn, flush):.1f} us"
                for k, fn in fns.items() if k != "plain")) if profile else ""
            b_ms, b_by = bound(n, m, pd.itemsize)
            b2_ms = two_pass_ms(n, m, pd.itemsize)
            picked = kernel_dispatch(n_pad, m, torch.float32, pd)[0]
            fastest = min((k for k in ms if k != "plain"), key=ms.get)
            table[m, n, name] = (ms, b_ms, b_by, picked, k_pick, d_pick)
            per_stage = ", ".join(f"{k.split()[-1]} {t * 1e3 / (2 * m):.2f}"
                                  for k, t in ms.items() if k.startswith(BLOCKED))
            say("table", f"  m={m:3d} n={n} {name}: "
                + ", ".join(f"{k} {t * 1e3:.1f} us" for k, t in ms.items())
                + f"; bound {b_ms * 1e3:.1f} us ({b_by}, history read once), "
                f"{b2_ms * 1e3:.1f} us read twice where the ring outgrows the L2; "
                f"K3 us per stage (time / 2 count) {per_stage} ({K3_STAGE_US_BEFORE} at n=2M "
                "f32 before the prefetch); "
                f"dispatch picks {picked}, fastest kernel {fastest}; {reps} calls per timing, "
                "runs " + ", ".join(f"{k} {[round(t * 1e3, 1) for t in ts]}"
                                    for k, ts in times.items()) + device)
            del hist
    del flush
    say("table", "K1's phase split and launch gap: python -m "
        "lbfgs_ffnn_torch.experiments.resident_phase_study")
    subprocess.run([sys.executable, "-m", "lbfgs_ffnn_torch.experiments.resident_phase_study"],
                   check=True, timeout=600)
    return table


def _n_params(dims):
    return sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))


def _data(torch, dev, mnist_root):
    x, y, source = _data_np(mnist_root)
    return (torch.tensor(x, device=dev), torch.tensor(y, device=dev)), source


def _data_np(mnist_root):
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
    return x, y, source


def _reset(launches):
    for k in launches:
        launches[k] = 0


def solve_phase(torch, dev, profile: bool, mnist_root):
    from lbfgs_ffnn_torch.objectives.mlp import evaluate, mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, STREAMING, two_loop_cuda
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
    for impl in opts:  # warm-up: cuBLAS handles, allocator, and the captured iteration
        lbfgs(problem, w0, aux, opts[impl])
    torch.cuda.synchronize()

    # cuda (the counted run), plain, plain, cuda: one card, taken in turns
    results, times, launches, repeat = {}, {"cuda": [], "plain": []}, None, {}
    for impl in ("cuda", "plain", "plain", "cuda"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _reset(two_loop_cuda.LAUNCHES)
        start.record()
        res = lbfgs(problem, w0, aux, opts[impl])
        end.record()
        torch.cuda.synchronize()
        if launches is None:
            launches = dict(two_loop_cuda.LAUNCHES)
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
    check(launches[COOPERATIVE] == rc.n_iters and launches[STREAMING] == 0,
          f"kernel launches {launches} != {rc.n_iters} directions through K1")
    first_c, first_p = rc.loss_history[:5].cpu().numpy(), rp.loss_history[:5].cpu().numpy()
    check(np.allclose(first_c, first_p, rtol=1e-4, atol=0),
          f"first 5 losses differ: {first_c} vs {first_p}")
    lc, lp = float(rc.final_loss), float(rp.final_loss)
    check(abs(lc - lp) <= LOSS_GATE * lp, f"final losses differ by more than 2%: {lc} vs {lp}")
    say("solve", f"kernel launches in the counted solve: {launches} = {rc.n_iters} directions; "
        f"first 5 losses agree to rtol 1e-4; final {lc:.6g} vs plain {lp:.6g} "
        f"({abs(lc - lp) / lp * 100:.3f}% apart, limit 2%)")
    if profile:
        o10 = opts["cuda"]._replace(max_iters=10)
        _profile(torch, lambda: lbfgs(problem, w0, aux, o10))
    return launches[COOPERATIVE], ms_iter


def _skipped_slot_us(torch, dev, slots=20, reps=500):
    """Device µs per trial slot that does not fire: a captured graph of one
    small op and ``slots`` guarded slots, each with the Armijo slot's
    predicate ``~ok & (i < slots)`` on an accepted search, against the same
    graph without the slots, ``reps`` replays each, CUDA events."""
    from lbfgs_ffnn_torch.ops.control import Graph, assign, capture, guard

    ok = torch.ones((), dtype=torch.bool, device=dev)
    i = torch.zeros((), dtype=torch.int32, device=dev)
    x = torch.zeros((), device=dev)

    def body(n):
        x.mul_(1.0)
        for _ in range(n):
            live = ~ok & (i < slots)
            with guard(live):
                assign(live, x, x + 1.0)

    ms = {}
    for n in (0, slots):
        body(n)
        graph = Graph()
        with capture(graph):
            body(n)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms[n] = start.elapsed_time(end) / reps
        del graph
    check(float(x) == 0.0, "a slot that should not fire wrote its result")
    return (ms[slots] - ms[0]) * 1e3 / slots, ms


def resident_phase(torch, dev, profile: bool, mnist_root):
    """The MNIST main path on the resident driver: lbfgs() on CUDA tensors,
    each iteration a replayed CUDA graph whose Armijo trials are decided on
    the card, against the resident body run eagerly (masked writes, nothing
    captured) and against the early-exit loop."""
    import importlib

    from lbfgs_ffnn_torch.objectives.mlp import evaluate, mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, two_loop_cuda

    sl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")  # the module, not lbfgs()

    aux, source = _data(torch, dev, mnist_root)
    spec = mlp_spec(DIMS, ACTS)
    problem = mlp_problem(spec)
    w0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
    f0 = float(problem.fun(w0, aux))
    opts = sl.LBFGSOptions(max_iters=ITERS, tol=1e-12, m=M, line_search="armijo",
                           ls_max_iters=20)
    runs = {"captured": lambda o: sl.lbfgs(problem, w0, aux, o),
            "eager": lambda o: sl._lbfgs_resident_eager(problem, w0, aux, o),
            "loop": lambda o: sl._lbfgs_loop(problem, w0, aux, o)}
    sl.clear_graph_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs["captured"](opts)  # captures the iteration (warm-up included), then solves
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    say("resident", f"data: {source}; first captured solve (eager warm-up + capture + "
        f"{ITERS} iterations) {first_s:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("eager", "loop"):
        runs[name](opts._replace(max_iters=3))  # warm-up

    results, times, launches = {}, {k: [] for k in runs}, None
    for name in ("captured", "eager", "loop", "loop", "eager", "captured"):
        _reset(two_loop_cuda.LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = runs[name](opts)
        end.record()
        torch.cuda.synchronize()
        if name == "captured" and launches is None:
            launches = dict(two_loop_cuda.LAUNCHES)
        times[name].append(start.elapsed_time(end) / res.n_iters)
        if name in results:
            check(torch.equal(res.x, results[name].x), f"{name}: two runs differ")
            continue
        results[name] = res
        lh = res.loss_history[:res.n_iters]
        check(res.n_iters == ITERS and bool(torch.isfinite(lh).all())
              and bool(torch.isfinite(res.x).all()), f"{name}: non-finite or short solve")
        check(float(res.final_loss) < f0, f"{name}: loss did not fall")
    rc, re_, rl = results["captured"], results["eager"], results["loop"]
    bound = -(-rc.n_iters // sl.RESIDENT_CHUNK) + 2
    check(rc.n_host_syncs <= bound, f"captured: {rc.n_host_syncs} host syncs > {bound}")
    check(launches[COOPERATIVE] == rc.n_iters and sum(launches.values()) == rc.n_iters,
          f"captured: launches {launches} != {rc.n_iters} directions through K1 (device count)")
    check((rc.n_iters, rc.n_fevals, rc.n_gevals) == (re_.n_iters, re_.n_fevals, re_.n_gevals),
          f"captured vs eager body: counters {(rc.n_iters, rc.n_fevals, rc.n_gevals)} vs "
          f"{(re_.n_iters, re_.n_fevals, re_.n_gevals)}")
    lc, le = rc.loss_history.cpu().numpy(), re_.loss_history.cpu().numpy()
    check(np.allclose(lc, le, rtol=1e-6, atol=0), "captured vs eager body: loss histories "
          f"differ beyond rtol 1e-6 (max rel {np.max(np.abs(lc - le) / np.abs(le)):.3e})")
    bitwise = {k: torch.equal(getattr(rc, k), getattr(re_, k))
               for k in ("x", "loss_history", "gnorm_history")}
    first_c, first_l = lc[:5], rl.loss_history[:5].cpu().numpy()
    check(np.allclose(first_c, first_l, rtol=1e-4, atol=0),
          f"captured vs loop: first 5 losses differ: {first_c} vs {first_l}")
    short = {name: runs[name](opts._replace(max_iters=20)) for name in ("captured", "loop")}
    check(short["captured"].n_fevals == short["loop"].n_fevals,
          f"n_fevals over 20 iterations: captured {short['captured'].n_fevals}, loop "
          f"{short['loop'].n_fevals}")
    fc, fl = float(rc.final_loss), float(rl.final_loss)
    check(abs(fc - fl) <= LOSS_GATE * fl, f"final loss captured {fc} vs loop {fl}: > 2%")
    ms_iter = {k: min(t) for k, t in times.items()}
    for name, res in results.items():
        trials = (res.n_fevals - 1) / res.n_iters - 1
        say("resident", f"{name}: {res.n_iters} iters, loss {f0:.6g} -> "
            f"{float(res.final_loss):.6g}, train acc {evaluate(spec, res.x, *aux)['accuracy']:.2f}%,"
            f" {ms_iter[name]:.4f} ms/iter (CUDA events, min of "
            f"{[round(t, 4) for t in times[name]]}), n_fevals {res.n_fevals} ({trials:.3f} "
            f"trials/iter), n_gevals {res.n_gevals}, host syncs {res.n_host_syncs} "
            f"({res.n_host_syncs / res.n_iters:.3f}/iter)")
    slot_us, slot_ms = _skipped_slot_us(torch, dev)
    say("resident", f"captured = eager body: counters equal, loss histories to rtol 1e-6, "
        f"bitwise {bitwise}; captured vs loop: first 5 losses to rtol 1e-4, n_fevals over 20 "
        f"iterations {short['captured'].n_fevals} = {short['loop'].n_fevals}, final "
        f"{fc:.6g} vs {fl:.6g} ({abs(fc - fl) / fl * 100:.3f}% apart, limit 2%); host syncs "
        f"{rc.n_host_syncs} <= {bound}; K1 launches (device count) {launches} = {rc.n_iters} "
        f"directions; a trial slot that does not fire costs {slot_us:.3f} us of device time "
        f"(graph replay {slot_ms[0] * 1e3:.2f} us bare, {slot_ms[20] * 1e3:.2f} us with 20 "
        "such slots)")
    if profile:
        _profile(torch, lambda: sl.lbfgs(problem, w0, aux, opts))
    sl.clear_graph_cache()
    return launches[COOPERATIVE], ms_iter, rc


def deep_phase(torch, profile: bool):
    """The runner's entry point on the deep Fashion net at full width, then
    its four L-BFGS m=100 solves at DEEP_SEEDS - 1 further init seeds
    through the runner's Launcher."""
    import dataclasses

    from lbfgs_ffnn_torch.data.datasets import load_fashion_mnist
    from lbfgs_ffnn_torch.data.idx import write_idx_u8
    from lbfgs_ffnn_torch.experiments import run_mnist
    from lbfgs_ffnn_torch.launcher import Launcher
    from lbfgs_ffnn_torch.ops.cuda_two_loop import (
        COOPERATIVE, STREAMING, group_size, two_loop_cuda,
    )
    from lbfgs_ffnn_torch.solvers.common import Resident
    from lbfgs_ffnn_torch.solvers.lbfgs import RESIDENT_CHUNK, clear_graph_cache

    n_pad = -(-_n_params(DEEP_DIMS) // 128) * 128
    groups = {name: group_size(n_pad, M_DEEP, pb) for name, pb in (("f32", 4), ("bf16", 2))}
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "fashion", Path(tmp) / "out"
        root.mkdir()
        rng = np.random.default_rng(SEED)
        write_idx_u8(root / "train-labels-idx1-ubyte", rng.integers(0, 10, N_TRAIN, dtype=np.uint8))
        write_idx_u8(root / "t10k-labels-idx1-ubyte", rng.integers(0, 10, 10_000, dtype=np.uint8))
        say("deep", f"data: seeded label files (default_rng({SEED})) in a temporary --data-root, "
            f"images synthesized by the loader; 784-256-128-64-10, N={N_TRAIN:,}")
        base = ["--dataset", "fashion", "--deep", "--iters", str(DEEP_ITERS),
                "--data-root", str(root), "--out-dir", str(out)]
        runs = {}
        for _, cfg, report in run_mnist.main(base + ["--only", "FASHION_GD"]):
            runs["gd"] = (cfg, report)
        _reset(two_loop_cuda.LAUNCHES)
        captures = Resident.captures
        kernel_runs = run_mnist.main(base + ["--bf16-ring", "--only", "m100"])
        launches = dict(two_loop_cuda.LAUNCHES)
        # each capture runs the body once eagerly first: one direction more
        captures = Resident.captures - captures
        for _, cfg, report in kernel_runs:
            runs["bf16" if cfg.pair_dtype else "f32"] = (cfg, report)
        for _, cfg, report in run_mnist.main(
                base + ["--plain-two-loop", "--bf16-ring", "--only", "m100"]):
            runs["plain-bf16" if cfg.pair_dtype else "plain"] = (cfg, report)
        check(sorted(runs) == ["bf16", "f32", "gd", "plain", "plain-bf16"], f"runs: {sorted(runs)}")

        for key, (cfg, rep) in runs.items():
            res = rep.result
            lh = res.loss_history[:res.n_iters].cpu().numpy()
            check(res.n_iters > 0 and bool(np.isfinite(lh).all()), f"{cfg.name}: non-finite loss")
            check(lh[-1] < lh[0], f"{cfg.name}: loss did not fall ({lh[0]} -> {lh[-1]})")
            header = Path(rep.csv_path).read_text().splitlines()[0]
            check(header == "Iteration,Loss,GradNorm,TimeMs", f"{rep.csv_path}: header {header!r}")
            say("deep", f"{cfg.name} ({key}): {res.n_iters} iters (+{rep.warmup_iters} warm-up), "
                f"loss {lh[0]:.6g} -> {lh[-1]:.6g}, train acc {rep.train_eval['accuracy']:.2f}%, "
                f"{rep.ms_per_iter:.3f} ms/iter (CUDA events), host syncs {res.n_host_syncs} "
                f"({res.n_host_syncs / res.n_iters:.2f}/iter); {Path(rep.csv_path).name} ok")
        for key in ("f32", "bf16", "plain", "plain-bf16"):
            res = runs[key][1].result
            bound = -(-res.n_iters // RESIDENT_CHUNK) + 2
            check(res.n_host_syncs <= bound,
                  f"deep {key}: {res.n_host_syncs} host syncs > {bound} (resident driver)")
        directions = captures + sum(runs[k][1].result.n_iters + runs[k][1].warmup_iters
                                    for k in ("f32", "bf16"))
        check(launches[STREAMING] == directions and launches[COOPERATIVE] == 0,
              f"kernel launches {launches} != {directions} directions through K2")
        lk, lp, lb, lpb = (float(runs[k][1].result.final_loss)
                           for k in ("f32", "plain", "bf16", "plain-bf16"))
        check(abs(lk - lp) <= LOSS_GATE * lp, f"final losses kernel {lk} vs plain {lp}: > 2%")

        # The four L-BFGS solves again at DEEP_SEEDS - 1 further init seeds,
        # through the runner's Launcher: f32 rounding alone moves one
        # 120-iteration trajectory by several % (PERF.md §6), so one seed's
        # final losses are a draw.
        launcher = Launcher("cuda", device="cuda", out_dir=out)
        for d_in, d_out, act in zip(DEEP_DIMS, DEEP_DIMS[1:], DEEP_ACTS):
            launcher.add_layer(d_in, d_out, act)
        launcher.build_network().set_data(load_fashion_mnist(root, train_size=N_TRAIN,
                                                             test_size=0))
        solves = {key: [runs[key][1].result] for key in ("f32", "bf16", "plain", "plain-bf16")}
        _reset(two_loop_cuda.LAUNCHES)
        seed_directions = 0
        for s in range(1, DEEP_SEEDS):
            for key, results in solves.items():
                cfg = dataclasses.replace(runs[key][0], seed=runs[key][0].seed + s,
                                          write_csv=False)
                c0 = Resident.captures  # this Launcher's problem captures anew
                rep = launcher.train("lbfgs", cfg, verbose=False)
                results.append(rep.result)
                if not key.startswith("plain"):
                    seed_directions += (rep.result.n_iters + rep.warmup_iters
                                        + Resident.captures - c0)
        seed_launches = dict(two_loop_cuda.LAUNCHES)
        check(seed_launches[STREAMING] == seed_directions and seed_launches[COOPERATIVE] == 0,
              f"seed runs: launches {seed_launches} != {seed_directions} directions through K2")
        seeds = [runs["f32"][0].seed + s for s in range(DEEP_SEEDS)]
        # each ring's kernel solve against the plain loop's on the same ring
        for ring, plain in (("f32", "plain"), ("bf16", "plain-bf16")):
            for seed, rk, rp in zip(seeds, solves[ring], solves[plain]):
                lh = rk.loss_history[:rk.n_iters].cpu().numpy()
                check(bool(np.isfinite(lh).all()) and lh[-1] < lh[0],
                      f"{ring} ring, seed {seed}: non-finite loss or no fall")
                first_k = rk.loss_history[:5].cpu().numpy()
                first_p = rp.loss_history[:5].cpu().numpy()
                check(np.allclose(first_k, first_p, rtol=1e-4, atol=0),
                      f"{ring} ring, seed {seed}: first 5 losses differ: {first_k} vs {first_p}")
        final = {key: [float(r.final_loss) for r in rs] for key, rs in solves.items()}

        def apart(a, b):
            """Per seed (a - b) / b, and its median over the seeds."""
            gaps = [(x - y) / y for x, y in zip(final[a], final[b])]
            return ", ".join(f"{g * 100:+.2f}%" for g in gaps), float(np.median(gaps))

        say("deep", f"K2 launches in the kernel runs (k={groups['f32']} f32 ring, "
            f"k={groups['bf16']} bf16): {launches} = {directions} directions (timed + warm-up "
            f"solves + {captures} captures' eager run of the body), at seeds {seeds[1:]} {seed_launches} = {seed_directions}; first 5 losses "
            f"agree with the plain loop's to rtol 1e-4 on both rings at every seed; seed "
            f"{seeds[0]}: final kernel {lk:.6g} vs plain {lp:.6g} "
            f"({abs(lk - lp) / lp * 100:.3f}% apart, limit 2%), bf16 ring {lb:.6g} vs plain "
            f"bf16 ring {lpb:.6g}")
        for key in solves:
            say("deep", f"final loss per seed {seeds}, {key}: "
                + ", ".join(f"{x:.6g}" for x in final[key]))
        for a, b in (("f32", "plain"), ("bf16", "plain-bf16"), ("bf16", "f32"),
                     ("plain-bf16", "plain")):
            per_seed, med = apart(a, b)
            say("deep", f"final loss {a} vs {b}: {per_seed}; median {med * 100:+.3f}%")
        # The bench's parity rule for a bf16 ring (final loss within 2% of
        # f32) is printed, not checked: the plain loop's own rings miss it
        # at most seeds (PERF.md §6), so it judges the bf16 ring, not K2.
        parity = {path: apart(*pair)[1] for path, pair in
                  (("kernel", ("bf16", "f32")), ("plain loop", ("plain-bf16", "plain")))}
        say("deep", "bf16 ring parity (bench rule: final loss within 2% of f32), median over "
            "seeds: " + ", ".join(f"{path} {g * 100:+.3f}% "
                                  f"{'PASSED' if g <= LOSS_GATE else 'FAILED'}"
                                  for path, g in parity.items()))
        ms_iter = {k: rep.ms_per_iter for k, (cfg, rep) in runs.items()}
        if profile:
            _profile_deep(torch, root, runs["f32"][0])
    clear_graph_cache()
    return launches[STREAMING], ms_iter


def _profile_deep(torch, root, cfg):
    """The deep f32 L-BFGS solve of the runner, rebuilt from its parts."""
    from lbfgs_ffnn_torch.data.datasets import load_fashion_mnist
    from lbfgs_ffnn_torch.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs

    ds = load_fashion_mnist(root, train_size=N_TRAIN, test_size=0)
    dev = torch.device("cuda")
    aux = (torch.tensor(ds.train_x, device=dev), torch.tensor(ds.train_y, device=dev))
    spec = mlp_spec(DEEP_DIMS, ["relu", "relu", "relu", "linear"])
    w0 = mlp_init(spec, torch.Generator().manual_seed(cfg.seed), torch.float32,
                  bias_init="zeros", device=dev)
    opts = LBFGSOptions(max_iters=cfg.max_iters, tol=cfg.tolerance, m=cfg.m_param,
                        line_search="armijo", ls_max_iters=20)
    problem = mlp_problem(spec)
    _profile(torch, lambda: lbfgs(problem, w0, aux, opts))


def _profile(torch, solve, unit="iter"):
    """Trace ``solve()`` (a whole solve returning a SolveResult) with
    torch.profiler beside two unprofiled runs of it; prints the device busy
    time, the two-loop kernel's share and the device idle share per
    ``unit``. Returns (busy us, two-loop us, steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def wall_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6, res

    # the same solve unprofiled, before and after the traced one
    bare = [wall_us(solve)[0]]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_us, res = wall_us(solve)
    bare.append(wall_us(solve)[0])
    # device-side rows only (kernels, copies); the op rows repeat their time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events)
    two_loop_us = sum(e.self_device_time_total for e in events
                      if any(name in e.key for name in KERNEL_NAMES))
    k = res.n_iters
    # The busy total holds for a solve replayed from a CUDA graph, but the
    # profiler has given replayed kernels other kernels' names (PERF.md §7).
    say("profile", f"{k} {unit}s: device busy {busy / k:.1f} us/{unit} (traced), the two-loop "
        f"kernel {two_loop_us / k:.1f} us/{unit} of it ({two_loop_us / busy * 100:.1f}%; kernel "
        f"names under graph replay are not reliable); wall "
        f"{traced_us / k:.1f} us/{unit} traced, {[round(b / k, 1) for b in bare]} us/{unit} "
        f"unprofiled (same solve, this run); device idle {100 - busy / min(bare) * 100:.1f}% "
        f"of the faster unprofiled wall, {100 - busy / traced_us * 100:.1f}% of the traced wall")
    for e in events[:12]:
        say("profile", f"  {e.self_device_time_total / k:9.1f} us/{unit} "
            f"{e.count / k:6.1f} calls/{unit}  {e.key[:90]}")
    return busy, two_loop_us, k


def large_phase(torch, dev, profile: bool, n=N_LARGE, iters=LARGE_ITERS, m=M_LARGE):
    """L-BFGS on the extended Rosenbrock at n = 2M through the harness: per
    line search the kernel (f32 ring), the plain two-loop and the bf16 ring.
    Each run's launches are counted from 0 just before it and read just
    after it."""
    from lbfgs_ffnn_torch.harness import TestCase, TestSuite
    from lbfgs_ffnn_torch.objectives.analytic import rosenbrock_problem, rosenbrock_start
    from lbfgs_ffnn_torch.ops.cuda_two_loop import (
        BLOCKED, STREAMING, group_size, kernel_dispatch, two_loop_cuda,
    )
    from lbfgs_ffnn_torch.solvers.lbfgs import (
        RESIDENT_CHUNK, LBFGSOptions, _lbfgs_loop, clear_graph_cache, lbfgs, lbfgs_warm_up,
    )

    problem = rosenbrock_problem()
    x0 = rosenbrock_start(n, torch.float32, dev)
    f0 = float(problem.fun(x0))
    n_pad = -(-n // 128) * 128
    bf16_pick = kernel_dispatch(n_pad, m, torch.float32, torch.bfloat16)[0]
    bf16_k = group_size(n_pad, m, 2) if bf16_pick == STREAMING else None
    if n == N_LARGE:  # K2 fits it only at k = 1, where K3 was the faster (PERF.md)
        check(bf16_pick == BLOCKED, f"n={n} bf16 ring goes to {bf16_pick}, not K3")
    say("large", f"extended Rosenbrock, n={n:,}, start (-1.2, 1, ...) in f32, initial loss "
        f"{f0:.6g}; m={m}, {iters} iterations; the dispatch gives the f32 ring to "
        f"{kernel_dispatch(n_pad, m, torch.float32)[0]} and the bf16 ring to {bf16_pick}"
        + (f" at k={bf16_k}" if bf16_k else ""))
    searches = {"armijo": {"line_search": "armijo", "ls_max_iters": 20},
                "wolfe": {"line_search": "wolfe"}}
    variants = {"cuda": {}, "plain": {"two_loop_impl": "plain"}, "bf16": {"pair_dtype": "bfloat16"}}
    opts = {f"{ls}-{v}": LBFGSOptions(max_iters=iters, tol=1e-12, m=m, **kw, **extra)
            for ls, kw in searches.items() for v, extra in variants.items()}
    for o in opts.values():  # warm-up: cuBLAS, allocator, kernel configs, and each
        # solve's captured iteration
        lbfgs_warm_up(problem, x0, (), o)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    results, launches = {}, {}

    def solver(name):
        def solve(problem, x):
            _reset(two_loop_cuda.LAUNCHES)
            res = lbfgs(problem, x, (), opts[name])
            launches[name] = dict(two_loop_cuda.LAUNCHES)
            results[name] = res
            return res
        return solve

    suite = TestSuite()
    for name in opts:
        suite.add_implementation(name, solver(name))
    suite.add_test(TestCase(f"rosenbrock-{n}", problem, x0, np.ones(n)))
    records = {r.implementation: r for r in suite.run(verbose=False)}

    ms_iter = {}
    for name, rec in records.items():
        res = results[name]
        lh = res.loss_history[:res.n_iters]
        check(res.x.shape == (n,) and bool(torch.isfinite(res.x).all()),
              f"{name}: iterate has the wrong shape or non-finite values")
        check(res.n_iters > 0 and bool(torch.isfinite(lh).all()), f"{name}: non-finite loss")
        check(float(res.final_loss) < f0, f"{name}: loss did not fall")
        ms_iter[name] = rec.elapsed_s * 1e3 / rec.n_iters
        say("large", f"{name}: {rec.n_iters} iters, loss {f0:.6g} -> {rec.final_loss:.9g}, "
            f"|g| {rec.final_gnorm:.3g} ({rec.status}), {ms_iter[name]:.3f} ms/iter (CUDA "
            f"events, harness), n_fevals {res.n_fevals}, n_gevals {res.n_gevals}, host syncs "
            f"{res.n_host_syncs} ({res.n_host_syncs / res.n_iters:.2f}/iter), launches "
            f"{launches[name]} on {rec.device}")
    for name, res in results.items():  # every solve on the resident driver
        bound = -(-res.n_iters // RESIDENT_CHUNK) + 2
        check(res.n_host_syncs <= bound, f"{name}: {res.n_host_syncs} host syncs > {bound}")
    f64 = {}  # the f64 plain solve's final loss, per search, where it judges
    for ls in searches:
        rk, rp, rb = (results[f"{ls}-{v}"] for v in variants)
        want = {k: (rk.n_iters if k == BLOCKED else 0) for k in two_loop_cuda.LAUNCHES}
        check(launches[f"{ls}-cuda"] == want,
              f"{ls}: launches {launches[f'{ls}-cuda']} != {rk.n_iters} directions through K3")
        want = {k: (rb.n_iters if k == bf16_pick else 0) for k in two_loop_cuda.LAUNCHES}
        check(launches[f"{ls}-bf16"] == want,
              f"{ls} bf16 ring: launches {launches[f'{ls}-bf16']} != {rb.n_iters} through "
              f"{bf16_pick}")
        check(not any(launches[f"{ls}-plain"].values()), f"{ls} plain: a kernel ran")
        first_k, first_p = rk.loss_history[:5].cpu().numpy(), rp.loss_history[:5].cpu().numpy()
        check(np.allclose(first_k, first_p, rtol=1e-3, atol=0),
              f"{ls}: first 5 losses differ: {first_k} vs {first_p}")
        lk, lp, lb = (float(r.final_loss) for r in (rk, rp, rb))
        how = f"{abs(lk - lp) / lp * 100:.3e}% apart, limit 2%"
        if abs(lk - lp) > LOSS_GATE * lp:
            # f32 summation order alone can move this trajectory: judge both
            # f32 solves by their distance from the f64 plain solve
            f64[ls] = float(lbfgs(problem, x0.double(), (), opts[f"{ls}-plain"]).final_loss)
            d_k, d_p = abs(lk - f64[ls]), abs(lp - f64[ls])
            check(d_k <= 2.0 * d_p, f"{ls}: final loss kernel {lk} vs plain {lp} (> 2% apart) and "
                  f"|kernel - f64| {d_k:.4g} > 2 x |plain - f64| {d_p:.4g}")
            how += (f" exceeded: f32 order moves the trajectory, so the f64 plain solve on the "
                    f"card ({f64[ls]:.6g}) judges: |kernel - f64| {d_k:.4g} <= 2 x "
                    f"|plain f32 - f64| {d_p:.4g}")
        # the early-exit loop, the resident driver's reference
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rl = _lbfgs_loop(problem, x0, (), opts[f"{ls}-cuda"])
        end.record()
        torch.cuda.synchronize()
        first_l = rl.loss_history[:5].cpu().numpy()
        check(np.allclose(first_k, first_l, rtol=1e-3, atol=0),
              f"{ls}: first 5 losses resident {first_k} vs early-exit loop {first_l}")
        ll = float(rl.final_loss)
        say("large", f"{ls}: K3 launches {launches[f'{ls}-cuda'][BLOCKED]} = {rk.n_iters} "
            f"directions; first 5 losses agree to rtol 1e-3; final kernel {lk:.9g} vs plain "
            f"{lp:.9g} ({how}); bf16 ring through {bf16_pick} {lb:.9g} "
            f"({abs(lb - lk) / lk * 100:.3e}% from f32); the early-exit loop (same options): "
            f"first 5 losses = the resident solve's to rtol 1e-3, final {ll:.9g}, "
            f"{start.elapsed_time(end) / rl.n_iters:.3f} ms/iter (CUDA events), "
            f"{rl.n_host_syncs / rl.n_iters:.2f} host syncs/iter against the resident "
            f"{rk.n_host_syncs / rk.n_iters:.2f}")
    if profile:
        _profile(torch, lambda: lbfgs(problem, x0, (), opts["armijo-cuda"]))
    clear_graph_cache()
    return sum(launches[f"{ls}-cuda"][BLOCKED] for ls in searches), ms_iter


def _capture_steps(sl, m_inner, L=SL_L):
    """Inner steps a capture of an S-LBFGS epoch runs eagerly: its start
    (the prologue), one segment (where the epoch has one) and its finish
    (the tail), each once."""
    nb, p_end, tail = sl._plan(m_inner, L)
    return p_end + 1 + (L if nb >= 2 else 0) + tail


def _graphs_note(sl, m_inner, L=SL_L):
    nb, p_end, tail = sl._plan(m_inner, L)
    seg = f", a segment of {L} steps replayed {nb - 1} times" if nb >= 2 else ""
    return (f"the {m_inner}-step epoch as the start graph ({p_end + 1} steps){seg} and the "
            f"finish graph ({tail} steps)")


def stochastic_phase(torch, dev, profile: bool, mnist_root):
    """S-LBFGS at the port bench's row on the MNIST net at full width (the
    first SL_N samples): the resident solve (each epoch replayed from its
    CUDA graphs, K1 with the gamma clamp once per inner step) against the
    epoch's bodies run eagerly on the card and against the plain two-loop; the bf16
    ring; then the Launcher's S-LBFGS on all N_TRAIN samples at its
    defaults. K1's launches are counted from 0 just before the counted
    solve and read just after it."""
    import importlib

    from lbfgs_ffnn_torch.data.datasets import Dataset
    from lbfgs_ffnn_torch.launcher import Launcher, UnifiedConfig
    from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
    from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, kernel_dispatch, two_loop_cuda
    from lbfgs_ffnn_torch.solvers.common import Resident, clear_graph_cache, clone

    sl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")  # the module, not slbfgs()

    (x_all, y_all), source = _data(torch, dev, mnist_root)
    x, y = x_all[:SL_N], y_all[:SL_N]
    spec = mlp_spec(DIMS, ACTS)
    problem = mlp_batch_problem(spec, lam=1e-4)
    w0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
    f0 = float(problem.fun(w0, x, y))
    opts = sl.SLBFGSOptions(epochs=SL_EPOCHS, tol=1e-12, history=M, L=SL_L, batch_size=SL_B,
                            hvp_batch_size=SL_BH, step_size=0.02)
    m_inner = SL_N // SL_B
    n_pad = -(-spec.n_params // 128) * 128
    impls = {t: kernel_dispatch(n_pad, M, torch.float32, t)[0] for t in (None, torch.bfloat16)}
    check(all(i == COOPERATIVE for i in impls.values()), f"the dispatch gives S-LBFGS's rings "
          f"to {impls}, not K1")
    say("stochastic", f"data: the first {SL_N:,} of {source}; 784-128-10 (n={spec.n_params:,}), "
        f"lam 1e-4, initial loss {f0:.6g}; b={SL_B}, b_H={SL_BH}, M={M}, L={SL_L}, step 0.02, "
        f"m_inner={m_inner}, {SL_EPOCHS} epochs; f32 and bf16 rings go to K1 with the gamma "
        "clamp")

    # captured = eager on the card, bitwise, after 5 epochs: anchor, ring, histories
    five = opts._replace(epochs=5)
    states = {}
    for capture in (False, True):
        kept = []
        sl._solve(problem, w0, x, y, five, chunk=5, capture=capture,
                  callback=lambda st, _e: kept.append(clone(st)))
        torch.cuda.synchronize()
        states[capture] = kept[-1]
    ea, ca = states[False], states[True]
    check(int(ea.epoch) == int(ca.epoch) == 5, f"5-epoch solves ran {int(ea.epoch)} and "
          f"{int(ca.epoch)} epochs")
    for name, a, b in [(f"ring {f}", getattr(ea.hist, f), getattr(ca.hist, f))
                       for f in ea.hist._fields] + [
            (f, getattr(ea, f), getattr(ca, f)) for f in ("w", "u_prev", "has_u", "loss_h")]:
        check(torch.equal(a, b), f"captured vs eager body after 5 epochs: {name} differs")
    say("stochastic", f"captured = eager body after 5 epochs, bitwise: the anchor, the ring (S, "
        f"Y, rho, head={int(ca.hist.head)}, count={int(ca.hist.count)}), u_prev, has_u and the "
        "loss history (so the draws on the card agree too)")

    runs = {"captured": lambda o: sl.slbfgs(problem, w0, x, y, o),
            "eager": lambda o: sl._slbfgs_resident_eager(problem, w0, x, y, o)}
    clear_graph_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs["captured"](opts)  # captures the epoch (warm-up included), then solves
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    capture_s = Resident.last_capture_s
    peak = torch.cuda.max_memory_allocated() / 2**30
    runs["eager"](opts._replace(epochs=2))  # warm-up

    results, times, launches = {}, {k: [] for k in runs}, None
    for name in ("captured", "eager", "eager", "captured"):
        _reset(two_loop_cuda.LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = runs[name](opts)
        end.record()
        torch.cuda.synchronize()
        if name == "captured" and launches is None:
            launches = dict(two_loop_cuda.LAUNCHES)
        times[name].append(start.elapsed_time(end) / res.n_iters)
        if name in results:
            check(torch.equal(res.x, results[name].x), f"{name}: two runs differ")
            continue
        results[name] = res
    rc, re_ = results["captured"], results["eager"]
    for name, res in results.items():
        lh = res.loss_history.cpu().numpy()
        check(res.n_iters == SL_EPOCHS and bool(np.isfinite(lh).all())
              and bool(torch.isfinite(res.x).all()), f"{name}: non-finite or short solve")
        check(lh[-1] < f0, f"{name}: loss did not fall ({f0} -> {lh[-1]})")
    check(torch.equal(rc.x, re_.x) and torch.equal(rc.loss_history, re_.loss_history),
          "captured vs eager body: 30-epoch solves differ")
    bound = -(-SL_EPOCHS // sl.RESIDENT_CHUNK) + 2
    check(rc.n_host_syncs <= bound, f"captured: {rc.n_host_syncs} host syncs > {bound}")
    want = SL_EPOCHS * m_inner
    check(launches[COOPERATIVE] == want and sum(launches.values()) == want,
          f"captured: launches {launches} != {SL_EPOCHS} epochs x {m_inner} steps through K1")

    plain = sl.slbfgs(problem, w0, x, y, opts._replace(two_loop_impl="plain"))
    lk, lp = rc.loss_history.cpu().numpy(), plain.loss_history.cpu().numpy()
    check(np.allclose(lk[:3], lp[:3], rtol=1e-4, atol=0),
          f"kernel vs plain: first 3 epochs' losses differ: {lk[:3]} vs {lp[:3]}")
    check(abs(lk[-1] - lp[-1]) <= LOSS_GATE * lp[-1],
          f"kernel vs plain: final losses {lk[-1]} vs {lp[-1]} more than 2% apart")
    _reset(two_loop_cuda.LAUNCHES)
    bf16 = sl.slbfgs(problem, w0, x, y, opts._replace(pair_dtype="bfloat16"))
    bf16_launches = dict(two_loop_cuda.LAUNCHES)
    lb = bf16.loss_history.cpu().numpy()
    check(bool(np.isfinite(lb).all()) and lb[-1] < f0, "bf16 ring: non-finite loss or no fall")
    # the capture's eager run of each of the epoch's bodies, then the solve
    per_capture = _capture_steps(sl, m_inner)
    check(bf16_launches[COOPERATIVE] == SL_EPOCHS * m_inner + per_capture,
          f"bf16 ring: launches {bf16_launches} != {SL_EPOCHS} x {m_inner} + {per_capture} "
          "(the capture's eager runs) through K1")
    ms_epoch = {k: min(t) for k, t in times.items()}
    say("stochastic", f"first captured solve (each of the epoch's graphs run once eagerly, "
        f"flat-captured and captured, then {SL_EPOCHS} epochs) {first_s:.2f} s, of which the "
        f"capture {capture_s:.3f} s; peak device memory {peak:.3f} GiB; "
        + _graphs_note(sl, m_inner))
    for name, res in results.items():
        say("stochastic", f"{name}: {res.n_iters} epochs, loss {f0:.6g} -> "
            f"{float(res.final_loss):.6g}, {ms_epoch[name]:.4f} ms/epoch (CUDA events, min of "
            f"{[round(t, 4) for t in times[name]]}), host syncs {res.n_host_syncs}")
    say("stochastic", f"captured = eager body over {SL_EPOCHS} epochs, bitwise; K1 launches "
        f"(device count) {launches} = {SL_EPOCHS} epochs x {m_inner} steps; host syncs "
        f"{rc.n_host_syncs} <= {bound}; kernel vs plain: first 3 epochs' losses to rtol 1e-4, "
        f"final {lk[-1]:.6g} vs {lp[-1]:.6g} ({abs(lk[-1] - lp[-1]) / lp[-1] * 100:.3f}% apart, "
        f"limit 2%); bf16 ring through K1 ({bf16_launches[COOPERATIVE]} launches = "
        f"{SL_EPOCHS} x {m_inner} + {per_capture}): final {lb[-1]:.6g} vs f32 {lk[-1]:.6g} "
        f"({(lb[-1] - lk[-1]) / lk[-1] * 100:+.3f}%, a reading, not a gate)")
    k1_us = None
    if profile:
        busy, two_loop_us, k = _profile(torch, lambda: sl.slbfgs(problem, w0, x, y, opts),
                                        unit="epoch")
        if two_loop_us > 0:
            k1_us = two_loop_us / (k * m_inner)
            say("profile", f"S-LBFGS: K1 {k1_us:.2f} us of device time per call ({m_inner} "
                "calls per epoch; kernel names under graph replay are not reliable, "
                "PERF.md §7)")
        else:
            say("profile", "S-LBFGS: K1's device time per call not measured: the trace gave "
                "the replayed kernels other names (PERF.md §7)")
    clear_graph_cache()

    # The Launcher's S-LBFGS on all N_TRAIN samples at its defaults (b=128,
    # m_inner = N // b, b_H = 64, L = 10, M = 10, lam 1e-4)
    launcher = Launcher("cpu", device="cuda")
    launcher.add_layer(DIMS[0], DIMS[1], ACTS[0]).add_layer(DIMS[1], DIMS[2], ACTS[1])
    x_np, y_np = x_all.cpu().numpy(), y_all.cpu().numpy()
    launcher.build_network().set_data(Dataset(x_np, y_np, x_np[:0], y_np[:0]))
    cfg = UnifiedConfig(name="SLBFGS_60k", max_iters=LAUNCHER_EPOCHS, write_csv=False)
    _reset(two_loop_cuda.LAUNCHES)
    c0 = Resident.captures
    t0 = time.perf_counter()
    rep = launcher.train("slbfgs", cfg, verbose=False)
    train_s = time.perf_counter() - t0
    big_launches = dict(two_loop_cuda.LAUNCHES)
    big_inner = N_TRAIN // cfg.batch_size
    lh = rep.result.loss_history.cpu().numpy()
    check(rep.result.n_iters == LAUNCHER_EPOCHS and bool(np.isfinite(lh).all()),
          f"Launcher S-LBFGS: {rep.result.n_iters} epochs, losses {lh}")
    captures = Resident.captures - c0
    big_capture = captures * _capture_steps(sl, big_inner)
    want_big = (LAUNCHER_EPOCHS + rep.warmup_iters) * big_inner + big_capture
    check(big_launches[COOPERATIVE] == want_big,
          f"Launcher S-LBFGS: launches {big_launches} != ({LAUNCHER_EPOCHS} + "
          f"{rep.warmup_iters} warm-up) x {big_inner} + {big_capture} (the capture)")
    say("stochastic", f"Launcher S-LBFGS, N={N_TRAIN:,}, b={cfg.batch_size} (m_inner="
        f"{big_inner}): capture {Resident.last_capture_s:.2f} s ({_graphs_note(sl, big_inner)});"
        f" train() {train_s:.2f} s; {rep.ms_per_iter:.2f} ms/epoch (CUDA events, "
        f"{LAUNCHER_EPOCHS} epochs), losses {[round(float(v), 6) for v in lh]}; K1 launches "
        f"{big_launches[COOPERATIVE]} = ({LAUNCHER_EPOCHS} + {rep.warmup_iters} warm-up) x "
        f"{big_inner} + {big_capture} (the capture's eager runs)")
    clear_graph_cache()
    return launches[COOPERATIVE], ms_epoch, k1_us


def _pinn_ring(torch, ttl, dev, m, n, impl, label):
    """One PINN ring shape on its kernel: the dispatch's pick checked, the
    kernel against the plain version (empty, partial, full, wrapped rings,
    clamp off and on), then timed as the table phase times a ring (CUDA
    events, L2 flushed, min of 2 in turns with the plain loop) with its
    profiler device time and bound. Returns its kernel-JSON numbers."""
    import functools

    from lbfgs_ffnn_torch.ops.cuda_two_loop import STREAMING, group_size, kernel_dispatch, launch

    rings = _rings(torch, ttl, m, n, (0, m // 3, m, m + 3), torch.float32, dev, seed=7)
    n_pad = rings[0].S.shape[1]
    picked = kernel_dispatch(n_pad, m, torch.float32)[0]
    check(picked == impl, f"{label} ring m={m} n={n}: dispatch picks {picked}, not {impl}")
    k = group_size(n_pad, m, 4) if impl == STREAMING else None
    v = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    worst = _agreement(torch, ttl, {f" {label}": (functools.partial(launch, impl), None)},
                       "pinn", v, rings, m, n, "f32")[f" {label}"]
    hist = rings[m + 3]
    flush = torch.empty(64 * 1024 * 1024, device=dev)
    fns = {"kernel": lambda: launch(impl, v, hist), "plain": lambda: ttl.two_loop(v, hist)}
    for fn in fns.values():
        _time_cold_ms(torch, fn, flush, reps=5)
    times = {key: [] for key in fns}
    for key in list(fns) + list(fns)[::-1]:
        times[key].append(_time_cold_ms(torch, fns[key], flush))
    ms = {key: min(t) for key, t in times.items()}
    device_us = _kernel_device_us(torch, fns["kernel"], flush)
    b_ms, b_by = bound(n, m, 4)
    del flush
    reductions = (f", {2 * -(-m // k)} grid reductions per call at k={k}" if k else
                  ", 2 grid reductions per call")
    say("pinn", f"{label} ring m={m} n={n} (n_pad {n_pad}, one block){reductions}: "
        f"{impl} {ms['kernel'] * 1e3:.1f} us ({device_us:.1f} device, profiler), plain "
        f"{ms['plain'] * 1e3:.1f} us, bound {b_ms * 1e3:.3f} us ({b_by}, history read once; "
        f"the ring fits the L2); runs {[round(t * 1e3, 1) for t in times['kernel']]}, "
        f"{TIMED_CALLS} calls each, L2 flushed before each")
    return {"m": m, "n": n, "group": k, "max_abs_err": worst, "ms": ms["kernel"],
            "device_ms": device_us / 1e3, "plain_ms": ms["plain"], "bound_ms": b_ms,
            "bound_by": b_by}


def pinn_phase(torch, dev, profile: bool, burgers_iters=BURGERS_ITERS):
    """The PINN path at full width: (a) Burgers (2-20-20-20-1, the full
    grid, f32, m = 100, Wolfe with 100 lean trials) through K2, the
    captured solve against the eager body, the plain two-loop and the
    early-exit loop; (b) the runner's own solve and the FD gate; (c) the
    oscillator runner through K1. Each counted run's launches are counted
    from 0 just before it and read just after it."""
    import importlib

    import lbfgs_ffnn_torch.ops.two_loop  # noqa: F401
    from lbfgs_ffnn_torch.experiments import burgers_validate, run_burgers, run_oscillator
    from lbfgs_ffnn_torch.objectives.mlp import mlp_spec
    from lbfgs_ffnn_torch.objectives.pinn import (
        burgers_points, burgers_problem, default_burgers_spec, oscillator_problem, pinn_init,
    )
    from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, STREAMING, two_loop_cuda
    from lbfgs_ffnn_torch.solvers.common import Resident

    sl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
    ttl = sys.modules["lbfgs_ffnn_torch.ops.two_loop"]
    t_phase = time.perf_counter()
    rings = {"K2": _pinn_ring(torch, ttl, dev, 100, 921, STREAMING, "K2 Burgers"),
             "K1": _pinn_ring(torch, ttl, dev, 16, 481, COOPERATIVE, "K1 oscillator")}

    # (a) Burgers at full width through K2
    spec = default_burgers_spec()
    problem = burgers_problem(spec)
    pts = burgers_points(device=dev)
    w0 = pinn_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
    f0 = float(problem.fun(w0, pts))
    opts = run_burgers.options(PINN_CHECK_ITERS, False)
    say("pinn", f"Burgers: 2-20-20-20-1 tanh (n = {spec.n_params}), IC {pts.ic_xt.shape[0]}, "
        f"BC {pts.bc_xt.shape[0]}, collocation {pts.col_xt.shape[0]} points, f32, m = 100, "
        f"Wolfe with {opts.ls_max_iters} lean trials, rel curvature gate "
        f"{opts.curvature_rel_eps}; initial loss {f0:.6g}")
    sl.clear_graph_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eager = sl._lbfgs_resident_eager(problem, w0, pts, opts)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    captures = Resident.captures
    sl.lbfgs(problem, w0, pts, opts)  # captures the iteration
    capture_s = Resident.last_capture_s
    check(Resident.captures == captures + 1, "the first captured Burgers solve did not capture")
    _reset(two_loop_cuda.LAUNCHES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = sl.lbfgs(problem, w0, pts, opts)
    end.record()
    torch.cuda.synchronize()
    launches = dict(two_loop_cuda.LAUNCHES)
    captured_ms = start.elapsed_time(end) / res.n_iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    plain = sl.lbfgs(problem, w0, pts, opts._replace(two_loop_impl="plain", max_iters=5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = sl._lbfgs_loop(problem, w0, pts, opts)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / loop.n_iters
    check(res.n_iters == eager.n_iters == PINN_CHECK_ITERS, f"Burgers: {res.n_iters} iterations "
          f"captured, {eager.n_iters} eager, not {PINN_CHECK_ITERS}")
    check(all(bool(torch.isfinite(t).all()) for t in (res.x, res.loss_history)),
          "Burgers: non-finite iterate or loss")
    check(float(res.final_loss) < f0, "Burgers: the loss did not fall")
    bitwise = {k: torch.equal(getattr(res, k), getattr(eager, k))
               for k in ("x", "loss_history", "gnorm_history")}
    check(all(bitwise.values()) and (res.n_fevals, res.n_gevals) == (eager.n_fevals,
                                                                        eager.n_gevals),
          f"Burgers: captured != eager body (bitwise {bitwise}, counters "
          f"{(res.n_fevals, res.n_gevals)} vs {(eager.n_fevals, eager.n_gevals)})")
    check(launches == {k: res.n_iters * (k == STREAMING) for k in launches},
          f"Burgers: launches {launches} != {res.n_iters} directions through K2 (device count)")
    sync_bound = -(-res.n_iters // sl.RESIDENT_CHUNK) + 2
    check(res.n_host_syncs <= sync_bound, f"Burgers: {res.n_host_syncs} host syncs > {sync_bound}")
    first_c, first_p = res.loss_history[:5].cpu().numpy(), plain.loss_history[:5].cpu().numpy()
    check(np.allclose(first_c, first_p, rtol=1e-4, atol=0),
          f"Burgers: first 5 losses kernel {first_c} vs plain {first_p}")
    first_l = loop.loss_history[:5].cpu().numpy()
    check(np.allclose(first_c, first_l, rtol=1e-4, atol=0),
          f"Burgers: first 5 losses captured {first_c} vs early-exit loop {first_l}")

    def trials(r):  # lean: each later iteration adds its trials + 1 fevals
        return (r.n_fevals - 2) / max(r.n_iters - 1, 1) - 1

    say("pinn", f"Burgers (a), {res.n_iters} iterations: captured = eager body bitwise "
        f"{bitwise}, counters equal (n_fevals {res.n_fevals}, n_gevals {res.n_gevals}); K2 "
        f"launches (device count) {launches} = {res.n_iters} directions; first 5 losses = "
        f"plain two-loop's and the early-exit loop's to rtol 1e-4; host syncs "
        f"{res.n_host_syncs} <= {sync_bound}; loss {f0:.6g} -> {float(res.final_loss):.6g}; "
        f"{captured_ms:.3f} ms/iter captured (CUDA events), early-exit loop {loop_ms:.3f} ms/iter "
        f"(host clock, {loop.n_host_syncs / loop.n_iters:.2f} host syncs/iter), eager body "
        f"{eager_s * 1e3 / eager.n_iters:.1f} ms/iter; {trials(res):.2f} trials/iter; capture "
        f"{capture_s:.2f} s (eager warm-up, flat check and capture); peak device memory "
        f"{peak:.3f} GiB")
    if profile:
        # 200 captured iterations (their own graph), 10 of the early-exit
        # loop, and the same 100-iteration captured solve per formulation
        _profile(torch, lambda: sl.lbfgs(problem, w0, pts, opts._replace(max_iters=200)))
        _profile(torch, lambda: sl._lbfgs_loop(problem, w0, pts, opts))
        o100 = opts._replace(max_iters=100)
        for form in ("vmap", "batched"):
            fprob = burgers_problem(spec, formulation=form)
            sl.lbfgs(fprob, w0, pts, o100)  # captures
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            r = sl.lbfgs(fprob, w0, pts, o100)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / r.n_iters
            evals = (r.n_fevals + r.n_gevals) / r.n_iters
            say("pinn", f"Burgers formulation={form!r}: {r.n_iters} captured iterations "
                f"{ms:.4f} ms/iter, {trials(r):.2f} trials/iter, {ms / evals:.4f} ms per "
                f"evaluation (jvp trial or value-and-gradient), final loss "
                f"{float(r.final_loss):.6g}")
    sl.clear_graph_cache()

    # (b) the runner's own solve at its defaults, and the FD gate
    with tempfile.TemporaryDirectory() as tmp:
        csv = str(Path(tmp) / "burgers_test_extrapolation.csv")
        argv = ["--out", csv] + ([] if burgers_iters == 5000 else ["--iters", str(burgers_iters)])
        say("pinn", f"Burgers (b): python -m lbfgs_ffnn_torch.experiments.run_burgers "
            f"{' '.join(argv)}")
        _reset(two_loop_cuda.LAUNCHES)
        captures = Resident.captures
        t0 = time.perf_counter()
        run = run_burgers.main(argv)
        runner_s = time.perf_counter() - t0
        launches_b = dict(two_loop_cuda.LAUNCHES)
        rb, warm = run["result"], run["warmup"]
        captures = Resident.captures - captures
        want = warm.n_iters + rb.n_iters + captures
        check(launches_b == {k: want * (k == STREAMING) for k in launches_b},
              f"Burgers runner: launches {launches_b} != {want} directions through K2 "
              f"({warm.n_iters} warm-up, {rb.n_iters} timed, {captures} capture)")
        sync_bound = -(-rb.n_iters // sl.RESIDENT_CHUNK) + 2
        check(rb.n_host_syncs <= sync_bound,
              f"Burgers runner: {rb.n_host_syncs} host syncs > {sync_bound}")
        check(bool(torch.isfinite(rb.x).all()), "Burgers runner: non-finite iterate")
        gate = burgers_validate.errors(csv)
        means = {t: float(e.mean()) for t, e in gate.items()}
        say("pinn", "Burgers (b) FD gate: " + ", ".join(
            f"t={t}: mean {m:.4f} max {float(gate[t].max()):.4f}" for t, m in means.items())
            + f" (limit mean <= {burgers_validate.MEAN_TOL})")
        check(all(m <= burgers_validate.MEAN_TOL for m in means.values()),
              f"Burgers runner: the FD gate failed: {means}")
    say("pinn", f"Burgers (b): {rb.n_iters} iterations, loss {float(rb.final_loss):.6g}, "
        f"{run['ms_iter']:.4f} ms/iter (CUDA events), {trials(rb):.2f} trials/iter, host syncs "
        f"{rb.n_host_syncs}, capture {run['capture_s']:.2f} s; K2 launches {launches_b}; "
        f"runner wall {runner_s:.1f} s")

    # (c) the oscillator runner through K1, one timed solve: its default three
    # fresh-seed reps take ~40 s each on an H100 (~30 fused trials/iter)
    say("pinn", "oscillator (c): python -m lbfgs_ffnn_torch.experiments.run_oscillator "
        "--reps 1 (the runner's defaults otherwise: 1-20-20-1, m=16, 2000 iterations, tol "
        "1e-6; one timed solve instead of three)")
    _reset(two_loop_cuda.LAUNCHES)
    captures = Resident.captures
    osc = run_oscillator.main(["--reps", "1"])
    launches_c = dict(two_loop_cuda.LAUNCHES)
    captures = Resident.captures - captures
    want = osc["iters_run"] + captures
    check(launches_c == {k: want * (k == COOPERATIVE) for k in launches_c},
          f"oscillator: launches {launches_c} != {want} directions through K1")
    check(osc["passed"], f"oscillator: max |u - sin| = {osc['max_err']:.4g} > "
          f"{run_oscillator.MAX_ERR}")
    ro = osc["result"]
    say("pinn", f"oscillator (c): {ro.n_iters} iterations, loss {float(ro.final_loss):.6g}, "
        f"max |u - sin| {osc['max_err']:.4g} <= {run_oscillator.MAX_ERR}, "
        f"{osc['ms_iter']:.4f} ms/iter (CUDA events), "
        f"{(ro.n_fevals - 2) / max(ro.n_iters - 1, 1):.2f} fused trials/iter, host syncs "
        f"{ro.n_host_syncs}; K1 launches {launches_c} = {osc['iters_run']} iterations + "
        f"{captures} capture")
    if profile:
        xs = torch.arange(0.0, 6.28, 0.1, device=dev).reshape(-1, 1)
        ospec = mlp_spec([1, 20, 20, 1], ["tanh", "tanh", "linear"])
        oprob = oscillator_problem(ospec, w_ode=float(xs.shape[0]))
        ow0 = pinn_init(ospec, torch.Generator().manual_seed(SEED), device=dev)
        oopts = sl.LBFGSOptions(max_iters=200, tol=1e-6, m=16)
        _profile(torch, lambda: sl.lbfgs(oprob, ow0, xs, oopts))
    sl.clear_graph_cache()
    say("pinn", f"phase time {time.perf_counter() - t_phase:.1f} s")
    return {"K2": (launches_b[STREAMING], rings["K2"]), "K1": (launches_c[COOPERATIVE], rings["K1"]),
            "burgers_ms": run["ms_iter"], "oscillator_ms": osc["ms_iter"]}


def _runner_rows(torch, style, root, out):
    """run_mnist's default rows in ``style`` (FO_ITERS iterations or epochs,
    chunks of 10, the accuracy columns) from the label files in ``root``:
    their stdout, the rows, the kernels' launches (counted from 0 just
    before the runner and read just after it) and the captures it made."""
    import contextlib
    import io

    from lbfgs_ffnn_torch.experiments import run_mnist
    from lbfgs_ffnn_torch.ops.cuda_two_loop import two_loop_cuda
    from lbfgs_ffnn_torch.solvers.common import Resident

    argv = ["--style", style, "--iters", str(FO_ITERS), "--timed-chunks", "10",
            "--record-accuracy", "--data-root", str(root), "--out-dir", str(out)]
    _reset(two_loop_cuda.LAUNCHES)
    c0 = Resident.captures
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        done = run_mnist.main(argv)
    return (text.getvalue(), done, dict(two_loop_cuda.LAUNCHES), Resident.captures - c0,
            time.perf_counter() - t0, argv)


def first_order_phase(torch, dev, profile: bool, mnist_root):
    """The first-order solvers on the resident driver and the runner's last
    default rows: (a) run_mnist's four default rows in the cuda style at
    full width (784-128-10, N = 60,000) and in the cpu style (N = 5,000),
    K1's and K2's launches by their L-BFGS and S-LBFGS rows counted; (b) GD
    momentum and Wolfe, captured, against the eager body and the host loop;
    (c) SGD sequential (with its tail) and random, captured, against the
    eager body; (d) sgd_streaming from pinned buffers."""
    import collections
    import importlib

    from lbfgs_ffnn_torch.data.idx import write_idx_u8
    from lbfgs_ffnn_torch.objectives.mlp import (
        mlp_batch_problem, mlp_init, mlp_problem, mlp_spec, take_batch,
    )
    from lbfgs_ffnn_torch.ops.cuda_two_loop import kernel_dispatch
    from lbfgs_ffnn_torch.runtime import BatchStreamer
    from lbfgs_ffnn_torch.solvers.common import Resident, clear_graph_cache

    gd = importlib.import_module("lbfgs_ffnn_torch.solvers.gd")
    sgd = importlib.import_module("lbfgs_ffnn_torch.solvers.sgd")
    sl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")
    t_phase = time.perf_counter()
    spec = mlp_spec(DIMS, ACTS)
    n_pad = -(-spec.n_params // 128) * 128

    # (a) the runner's default rows, both styles
    runner_launches = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "mnist"
        root.mkdir()
        rng = np.random.default_rng(SEED)
        write_idx_u8(root / "train-labels.idx1-ubyte", rng.integers(0, 10, N_TRAIN, dtype=np.uint8))
        write_idx_u8(root / "t10k-labels.idx1-ubyte", rng.integers(0, 10, 10_000, dtype=np.uint8))
        for style, solvers in (("cuda", ["gd", "sgd", "lbfgs", "lbfgs"]),
                               ("cpu", ["gd", "sgd", "slbfgs", "lbfgs"])):
            out = Path(tmp) / f"out_{style}"
            text, done, launches, captures, wall, argv = _runner_rows(torch, style, root, out)
            say("first_order", f"python -m lbfgs_ffnn_torch.experiments.run_mnist {' '.join(argv)}"
                f" (seeded label files in a temporary --data-root, images synthesized): "
                f"{wall:.1f} s")
            for line in text.splitlines():
                if line.startswith("[") or "not run" in line:
                    say("first_order", f"  {line}")
            check("not run" not in text, f"{style} style: a row was not run")
            check([s for s, _, _ in done] == solvers, f"{style} style ran {done}")
            want = collections.Counter()
            for solver, cfg, rep in done:
                res = rep.result
                lh = res.loss_history[:res.n_iters].cpu().numpy()
                check(res.n_iters > 0 and bool(np.isfinite(lh).all()) and lh[-1] < lh[0],
                      f"{cfg.name}: non-finite loss or no fall ({lh[:1]} -> {lh[-1:]})")
                header = Path(rep.csv_path).read_text().splitlines()[0]
                cols = "Iteration,Loss,GradNorm,TimeMs" + (
                    ",TrainAcc,TestAcc" if solver in ("sgd", "slbfgs") else "")
                check(header == cols, f"{cfg.name}: CSV header {header!r}, not {cols!r}")
                bound = -(-res.n_iters // 10) + 2
                check(res.n_host_syncs <= bound,
                      f"{cfg.name}: {res.n_host_syncs} host syncs > {bound}")
                # each row captured once; the capture runs its bodies once eagerly
                if solver == "lbfgs":
                    want[kernel_dispatch(n_pad, cfg.m_param, torch.float32)[0]] += res.n_iters + 1
                elif solver == "slbfgs":
                    m_inner = max(rep.train_eval["n"] // cfg.batch_size, 1)
                    impl = kernel_dispatch(n_pad, cfg.m_param, torch.float32)[0]
                    want[impl] += res.n_iters * m_inner + _capture_steps(sl, m_inner, cfg.L_param)
            check(captures == len(solvers), f"{style} style: {captures} captures, not one a row")
            got = {k: v for k, v in launches.items() if v}
            check(got == dict(want), f"{style} style: launches {got} != {dict(want)} (each "
                  "L-BFGS row's iterations + 1 capture, S-LBFGS's epochs x steps + its capture)")
            runner_launches.update(got)
            say("first_order", f"{style} style: rows {[c.name for _, c, _ in done]} all run; CSV "
                f"columns checked (TrainAcc, TestAcc on SGD and S-LBFGS); host syncs <= "
                f"ceil(steps / 10) + 2 per row; kernel launches (device count) {got} = "
                f"{dict(want)}")
    clear_graph_cache()

    # (b) GD momentum and Wolfe: captured against the eager body and the host loop
    (x, y), source = _data(torch, dev, mnist_root)
    problem = mlp_problem(spec)
    w0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, bias_init="zeros",
                  device=dev)
    gd_ms = {}
    for name, kw in (("momentum", dict(momentum=0.9, step_size=0.02)), ("Wolfe", dict())):
        opts = gd.GDOptions(max_iters=FO_GD_ITERS, tol=1e-12, **kw)
        eager = gd._gd_resident_eager(problem, w0, (x, y), opts)
        c0 = Resident.captures
        gd.gradient_descent(problem, w0, (x, y), opts)  # captures
        check(Resident.captures == c0 + 1, f"GD {name}: the first solve did not capture")
        capture_s = Resident.last_capture_s
        times = {"captured": [], "loop": []}
        for run in ("captured", "loop", "loop", "captured"):
            fn = gd.gradient_descent if run == "captured" else gd._gd_loop
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(problem, w0, (x, y), opts)
            end.record()
            torch.cuda.synchronize()
            times[run].append(start.elapsed_time(end) / res.n_iters)
            if run == "captured":
                cap = res
            else:
                loop = res
        same = {k: torch.equal(getattr(cap, k), getattr(eager, k))
                for k in ("x", "loss_history", "gnorm_history")}
        check(all(same.values()) and (cap.n_fevals, cap.n_gevals) == (eager.n_fevals,
                                                                        eager.n_gevals),
              f"GD {name}: captured != eager body (bitwise {same})")
        bound = -(-cap.n_iters // gd.RESIDENT_CHUNK) + 2
        check(cap.n_host_syncs <= bound, f"GD {name}: {cap.n_host_syncs} host syncs > {bound}")
        lh = cap.loss_history.cpu().numpy()
        check(bool(np.isfinite(lh).all()) and lh[-1] < lh[0], f"GD {name}: loss did not fall")
        check(np.allclose(lh[:5], loop.loss_history[:5].cpu().numpy(), rtol=1e-4, atol=0),
              f"GD {name}: first 5 losses differ from the host loop's")
        gd_ms[name] = min(times["captured"])
        say("first_order", f"GD {name} ({FO_GD_ITERS} iterations, data: {source}): captured = "
            f"eager body bitwise {same}, n_fevals {cap.n_fevals}; host syncs "
            f"{cap.n_host_syncs} <= {bound} (host loop {loop.n_host_syncs}); "
            f"{gd_ms[name]:.4f} ms/iter captured, {min(times['loop']):.4f} host loop (CUDA "
            f"events, min of 2 each, in turns); capture {capture_s:.3f} s; loss {lh[0]:.6g} -> "
            f"{lh[-1]:.6g}")
        if profile and name == "momentum":
            _profile(torch, lambda: gd.gradient_descent(problem, w0, (x, y), opts))
    clear_graph_cache()

    # (c) SGD sequential (234 batches of 256 and the 96-row tail) and random
    bp = mlp_batch_problem(spec)
    sgd_ms = {}
    for sampling in ("sequential", "random"):
        opts = sgd.SGDOptions(epochs=FO_SGD_EPOCHS, batch_size=256, step_size=0.01,
                              momentum=0.9 if sampling == "sequential" else 0.0,
                              sampling=sampling, lr_decay=0.8, lr_decay_step=2)
        # the timed solve's first FO_SGD_CHECK epochs, its graphs captured
        # here (the timed solves replay them), against the same epochs eager
        eager = sgd._solve(bp, w0, x, y, opts, chunk=FO_SGD_CHECK, capture=False,
                           epochs=FO_SGD_CHECK)[0]
        c0 = Resident.captures
        cap = sgd.sgd_warm_up(bp, w0, x, y, opts, epochs=FO_SGD_CHECK)
        check(Resident.captures == c0 + 1, f"SGD {sampling}: the warm-up did not capture")
        capture_s = Resident.last_capture_s
        same = {k: torch.equal(getattr(cap, k)[:FO_SGD_CHECK], getattr(eager, k)[:FO_SGD_CHECK])
                for k in ("loss_history", "gnorm_history")}
        same["x"] = torch.equal(cap.x, eager.x)
        check(all(same.values()) and cap.n_iters == eager.n_iters == FO_SGD_CHECK,
              f"SGD {sampling}: captured != eager body (bitwise {same}; epochs {cap.n_iters}, "
              f"{eager.n_iters})")
        times = []
        for _ in range(2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = sgd.sgd(bp, w0, x, y, opts)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / res.n_iters)
        check(Resident.captures == c0 + 1, f"SGD {sampling}: the timed solves captured again")
        lh = res.loss_history[:res.n_iters].cpu().numpy()
        check(res.n_iters == FO_SGD_EPOCHS and bool(np.isfinite(lh).all()) and lh[-1] < lh[0],
              f"SGD {sampling}: {res.n_iters} epochs, losses {lh}")
        bound = -(-res.n_iters // sgd.RESIDENT_CHUNK) + 2
        check(res.n_host_syncs <= bound, f"SGD {sampling}: {res.n_host_syncs} host syncs > {bound}")
        sgd_ms[sampling] = min(times)
        b, m, rem = sgd._sizes(opts, N_TRAIN)
        say("first_order", f"SGD {sampling} (N={N_TRAIN:,}, b={b}: {m} batches"
            f"{f' and a {rem}-row tail' if rem else ''} per epoch as {m // sgd.SEGMENT} replays "
            f"of a {sgd.SEGMENT}-step segment graph and {m % sgd.SEGMENT} steps in the finish; "
            f"the full-data record): captured = eager body bitwise over the timed solve's "
            f"first {FO_SGD_CHECK} epochs {same}, its graphs the timed ones; "
            f"{sgd_ms[sampling]:.4f} ms/epoch captured over {res.n_iters} epochs (CUDA events, "
            f"min of {[round(t, 4) for t in times]}); capture {capture_s:.3f} s; host "
            f"syncs {res.n_host_syncs} per solve (<= {bound}); loss {lh[0]:.6g} -> {lh[-1]:.6g}")
        if profile:
            _profile(torch, lambda: sgd.sgd(bp, w0, x, y, opts), unit="epoch")
    clear_graph_cache()
    # a step's batch is a gather of b rows of x and y (the device step makes
    # it one where JAX slices): its device time, 100 gathers in a CUDA graph
    idx = torch.arange(256, device=dev) + 256 * 100
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        take_batch(x, y, idx)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(100):
            take_batch(x, y, idx)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    gather_us = start.elapsed_time(end) * 10.0
    del graph
    say("first_order", f"a step's batch gather (index_select of 256 rows of x and y): "
        f"{gather_us:.2f} us of device time (100 in a CUDA graph), {gather_us * 234 / 1e3:.3f} "
        f"ms of an epoch's 234 steps ({gather_us * 234 / 1e3 / sgd_ms['sequential'] * 100:.1f}% "
        "of the sequential epoch)")

    # (d) sgd_streaming from the port's streamer, pinned buffers
    opts = sgd.SGDOptions(epochs=2, batch_size=256, step_size=0.01, momentum=0.9)

    def full_eval(w):
        f, g = bp.value_and_grad(w, x, y)
        return f, torch.linalg.norm(g)

    f0 = float(bp.fun(w0, x, y))
    x_h, y_h = x.cpu().numpy(), y.cpu().numpy()
    with BatchStreamer(x_h, y_h, 256, seed=SEED, device=dev) as st:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = sgd.sgd_streaming(bp, w0, st, opts, full_eval_fn=full_eval)
        torch.cuda.synchronize()
        stream_ms = (time.perf_counter() - t0) * 1e3 / opts.epochs
        pinned = st.pinned
    lh = rs.loss_history.cpu().numpy()
    check(pinned and bool(np.isfinite(lh).all()) and lh[1] < lh[0] < f0,
          f"sgd_streaming: losses {f0} -> {lh} not finite and falling (pinned {pinned})")
    say("first_order", f"sgd_streaming (BatchStreamer, pinned buffers, depth 4, b=256, N="
        f"{N_TRAIN:,}, momentum 0.9, the full-data record): {stream_ms:.4f} ms/epoch (host "
        f"clock, 2 epochs) against the resident SGD's {sgd_ms['random']:.4f} (random batches); "
        f"full loss {f0:.6g} -> {lh[0]:.6g} -> {lh[1]:.6g}")
    split = _stream_split(torch, dev, bp, w0, x_h, y_h, x, y)
    steps = split.pop("steps")
    rest = stream_ms / steps - sum(split.values())
    say("first_order", f"a streamed step's host time, each part alone over one epoch's {steps} "
        f"batches (host clock): {stream_ms / steps:.4f} ms per step streamed = "
        + " + ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f" + {rest:.4f} not in the parts (the producer thread beside the update, the epoch "
        "records)")
    say("first_order", f"phase time {time.perf_counter() - t_phase:.1f} s")
    return {"runner": dict(runner_launches), "gd_ms": gd_ms, "sgd_ms": sgd_ms,
            "stream_ms": stream_ms}


def _upcast_gemm_pair_us(torch, dev, x, reps=(5, 25)):
    """µs per first-layer GEMM pair at the MNIST main path's shape (the
    direction's B = x @ W1_p and the accept point's dW1 = x^T dz1, (N, 784)
    by 784 x 128), f32 with TF32 off, for x in f32, uint8 and bf16 (each
    narrow x upcast to f32 first, the uint8 products rescaled by 1/255, as
    the objective computes them): the slope between two counts of pairs in
    a row (CUDA events), which cancels the fixed costs."""
    from lbfgs_ffnn_torch.objectives.mlp import quantize_pixels
    from lbfgs_ffnn_torch.solvers.common import full_f32

    g = torch.Generator(device=dev).manual_seed(SEED)
    W = torch.randn((x.shape[1], 128), generator=g, device=dev)
    dz = torch.randn((x.shape[0], 128), generator=g, device=dev)
    copies = {"f32": x, "u8": quantize_pixels(x), "bf16": x.to(torch.bfloat16)}

    def pair(xc):
        scale = 1.0 / 255.0 if xc.dtype == torch.uint8 else None
        b = xc.to(torch.float32) @ W
        gw = xc.to(torch.float32).t() @ dz
        if scale is not None:
            b, gw = b * scale, gw * scale
        return b, gw

    out = {}
    with full_f32(), torch.no_grad():
        for name, xc in copies.items():
            pair(xc)
            t = {}
            for k in reps:
                best = float("inf")
                for _ in range(2):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(k):
                        pair(xc)
                    end.record()
                    torch.cuda.synchronize()
                    best = min(best, start.elapsed_time(end))
                t[k] = best
            out[name] = (t[reps[1]] - t[reps[0]]) / (reps[1] - reps[0]) * 1e3
    return out


def traffic_phase(torch, dev, profile: bool, mnist_root):
    """The bench's traffic variants on the resident driver at MNIST width
    (784-128-10, N = 60,000, m = 10, Armijo with 20 trials): f32,
    bf16-traffic, u8-traffic, u8-warm and u8-warm-nr, TRAFFIC_ITERS
    iterations each, captured, as the bench builds them; then the deep u8
    row through K2, the runner's u8input GD and SGD rows, and the first-layer
    GEMM pair's cost per input dtype."""
    import contextlib
    import importlib
    import io

    from lbfgs_ffnn_torch.data.idx import write_idx_u8
    from lbfgs_ffnn_torch.experiments import bench, run_mnist
    from lbfgs_ffnn_torch.objectives.mlp import evaluate, mlp_init, mlp_spec
    from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, STREAMING, two_loop_cuda
    from lbfgs_ffnn_torch.solvers.common import Resident, prepared

    sl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
    t_phase = time.perf_counter()
    aux, source = _data(torch, dev, mnist_root)
    spec = mlp_spec(DIMS, ACTS)
    w0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
    base = sl.LBFGSOptions(max_iters=TRAFFIC_ITERS, tol=1e-12, m=M, line_search="armijo",
                           ls_max_iters=20)
    rows = bench.variants(spec, base)
    say("traffic", f"data: {source}; the bench's rows at N={N_TRAIN:,}, {TRAFFIC_ITERS} "
        f"iterations each on the resident driver (lbfgs_chunked, chunks of "
        f"{sl.RESIDENT_CHUNK}, as lbfgs() runs them), then lbfgs() again on the same data")
    sl.clear_graph_cache()
    f0_f32, k1_launches, ms_iter = None, 0, {}
    for tag, (problem, opts) in rows.items():
        # the eager body's first TRAFFIC_CHECK iterations of this very solve
        eager = sl._solve_resident(problem, w0, aux, opts, chunk=TRAFFIC_CHECK, capture=False,
                                   pipeline=False, iters=TRAFFIC_CHECK)[0]
        with torch.no_grad():
            f0 = float(problem.value_and_grad(w0, prepared(problem, aux))[0])
        if f0_f32 is None:
            f0_f32 = f0
        state = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(two_loop_cuda.LAUNCHES)
        c0 = Resident.captures
        res, _ = sl.lbfgs_chunked(problem, w0, aux, opts, chunk=sl.RESIDENT_CHUNK,
                                  callback=lambda s, t: state.update(s=s))
        torch.cuda.synchronize()
        launches = dict(two_loop_cuda.LAUNCHES)
        captures, capture_s = Resident.captures - c0, Resident.last_capture_s
        peak = torch.cuda.max_memory_allocated() / 2**30
        refreshes = int(state["s"].n_refresh)
        narrow = prepared(problem, aux)
        # the same solve again: the cached graph on the same prepared copy
        _reset(two_loop_cuda.LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        again = sl.lbfgs(problem, w0, aux, opts)
        end.record()
        torch.cuda.synchronize()
        ms_iter[tag] = start.elapsed_time(end) / again.n_iters
        launches_again = dict(two_loop_cuda.LAUNCHES)
        check(captures == 1, f"{tag}: the first solve made {captures} captures, not 1")
        check(Resident.captures == c0 + 1 and prepared(problem, aux) is narrow,
              f"{tag}: the second solve captured again or got a new prepared copy")
        check(res.n_iters == again.n_iters == TRAFFIC_ITERS and torch.equal(res.x, again.x),
              f"{tag}: the second solve differs from the first")
        lh = res.loss_history.cpu().numpy()
        check(bool(np.isfinite(lh).all()) and bool(torch.isfinite(res.x).all())
              and lh[-1] < lh[0] < f0, f"{tag}: non-finite or no fall ({f0} -> {lh[[0, -1]]})")
        same = {k: torch.equal(getattr(res, k)[:TRAFFIC_CHECK], getattr(eager, k)[:TRAFFIC_CHECK])
                for k in ("loss_history", "gnorm_history")}
        check(all(same.values()), f"{tag}: the captured solve's first {TRAFFIC_CHECK} "
              f"iterations != the eager body's (bitwise {same})")
        # f0 reads raw x unless fun_input_dtype is set (the u8 rows: exact
        # operands on grid data, another summation)
        ok_f0 = abs(f0 - f0_f32) <= 1e-5 * abs(f0_f32) if tag.startswith("u8") else f0 == f0_f32
        check(ok_f0, f"{tag}: first loss {f0!r} vs f32's {f0_f32!r}")
        want_refresh = (TRAFFIC_ITERS // 16 if opts.prefix_dtype is not None
                        and opts.prefix_refresh is None else 0)
        check(refreshes == want_refresh, f"{tag}: the refresh fired {refreshes} times, not "
              f"{want_refresh} (device counter)")
        check(launches == {k: (TRAFFIC_ITERS + 1) * (k == COOPERATIVE) for k in launches}
              and launches_again[COOPERATIVE] == TRAFFIC_ITERS,
              f"{tag}: K1 launches {launches} (then {launches_again}) != {TRAFFIC_ITERS} "
              "iterations + 1 capture (then no capture)")
        k1_launches += launches[COOPERATIVE]
        trials = (res.n_fevals - 1) / res.n_iters - 1
        acc = evaluate(spec, again.x, *aux)["accuracy"]
        say("traffic", f"[{tag}] {ms_iter[tag]:.4f} ms/iter (CUDA events, the second solve), "
            f"{trials:.3f} trials/iter, capture {capture_s:.3f} s, peak memory {peak:.2f} GiB, "
            f"refreshes {refreshes} (device counter), K1 launches {launches[COOPERATIVE]} "
            f"(then {launches_again[COOPERATIVE]}); first loss {f0:.9g}, final "
            f"{float(res.final_loss):.6g}, train acc {acc:.2f}%; first {TRAFFIC_CHECK} "
            f"iterations = eager body bitwise; the second solve captured nothing and read the "
            f"same prepared copy")
        if profile and tag in ("f32", "u8-warm"):
            _profile(torch, lambda: sl.lbfgs(problem, w0, aux, opts))
    sl.clear_graph_cache()

    pair = _upcast_gemm_pair_us(torch, dev, aux[0])
    say("traffic", "first-layer GEMM pair (B = x @ W1_p and dW1 = x^T dz1, N=60,000, "
        "784 x 128, f32 arithmetic, TF32 off; slope over 5 and 25 pairs): "
        + ", ".join(f"x {k} {v:.1f} us" for k, v in pair.items())
        + " (narrow x upcast to f32 first, as the objective reads it)")
    del aux

    # the deep u8 row through K2
    xd_np, yd_np = bench._fashion(N_TRAIN)
    daux = (torch.tensor(xd_np, device=dev), torch.tensor(yd_np, device=dev))
    dspec = mlp_spec(DEEP_DIMS, DEEP_ACTS)
    dproblem, dopts = bench.deep_variants(dspec, base._replace(m=M_DEEP))["u8 traffic stack"]
    dopts = dopts._replace(max_iters=TRAFFIC_DEEP_ITERS)
    dw0 = mlp_init(dspec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
    _reset(two_loop_cuda.LAUNCHES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    dres = sl.lbfgs(dproblem, dw0, daux, dopts)
    end.record()
    torch.cuda.synchronize()
    k2_launches = dict(two_loop_cuda.LAUNCHES)
    dlh = dres.loss_history.cpu().numpy()
    check(dres.n_iters == TRAFFIC_DEEP_ITERS and bool(np.isfinite(dlh).all()) and dlh[-1] < dlh[0],
          f"deep u8: {dres.n_iters} iterations, losses {dlh[[0, -1]]}")
    check(k2_launches == {k: (TRAFFIC_DEEP_ITERS + 1) * (k == STREAMING) for k in k2_launches},
          f"deep u8: launches {k2_launches} != {TRAFFIC_DEEP_ITERS} iterations + 1 capture "
          "through K2")
    say("traffic", f"deep 784-256-128-64-10 m=100 [u8 traffic stack], seeded Fashion labels: "
        f"{TRAFFIC_DEEP_ITERS} iterations, first solve (capture included) "
        f"{start.elapsed_time(end) / 1e3:.2f} s, loss {dlh[0]:.6g} -> {dlh[-1]:.6g}; K2 launches "
        f"(device count) {k2_launches[STREAMING]} = {TRAFFIC_DEEP_ITERS} + 1 capture")
    del daux
    sl.clear_graph_cache()

    # the runner's u8input GD and SGD rows
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "mnist"
        root.mkdir()
        rng = np.random.default_rng(SEED)
        write_idx_u8(root / "train-labels.idx1-ubyte", rng.integers(0, 10, N_TRAIN, dtype=np.uint8))
        write_idx_u8(root / "t10k-labels.idx1-ubyte", rng.integers(0, 10, 10_000, dtype=np.uint8))
        argv = ["--u8-input", "--only", "GD_u8input", "--iters", str(TRAFFIC_FO),
                "--timed-chunks", str(TRAFFIC_FO), "--data-root", str(root), "--out-dir",
                str(Path(tmp) / "out")]
        text = io.StringIO()
        c0 = Resident.captures
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            done = run_mnist.main(argv)
        wall = time.perf_counter() - t0
    names = [c.name for _, c, _ in done]
    check(names == ["MNIST_GD_u8input", "MNIST_SGD_u8input"], f"runner u8 rows: {names}")
    check(Resident.captures - c0 == 2, f"runner u8 rows: {Resident.captures - c0} captures")
    for solver, cfg, rep in done:
        lh = rep.result.loss_history[:rep.result.n_iters].cpu().numpy()
        check(rep.result.n_iters > 0 and bool(np.isfinite(lh).all()) and lh[-1] < lh[0],
              f"{cfg.name}: losses {lh}")
    for line in text.getvalue().splitlines():
        if line.startswith("["):
            say("traffic", f"  {line}")
    say("traffic", f"python -m lbfgs_ffnn_torch.experiments.run_mnist {' '.join(argv)}: rows "
        f"{names}, {wall:.1f} s; phase time {time.perf_counter() - t_phase:.1f} s")
    sl.clear_graph_cache()
    return {"K1": k1_launches, "K2": k2_launches[STREAMING], "ms_iter": ms_iter, "pair": pair}



def _same_solve(torch, a, b) -> bool:
    """Two SolveResults bitwise equal: x, the histories (NaN where both are
    NaN) and every counter."""
    for f in ("x", "loss_history", "gnorm_history"):
        u, v = getattr(a, f), getattr(b, f)
        if bool(((u != v) & ~(torch.isnan(u) & torch.isnan(v))).any()):
            return False
    return all(getattr(a, c) == getattr(b, c)
               for c in ("n_iters", "n_fevals", "n_gevals", "n_hevals", "n_matvecs"))


def _events_ms(torch, fn, reps):
    """ms per call of ``fn()`` over ``reps`` calls, CUDA events, after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _jacobi_sweeps(H: np.ndarray) -> int:
    """The sweeps the kernel's one-sided Jacobi SVD makes on ``H`` (f64), the
    last one rotating nothing: its loop and threshold in numpy. Every sweep
    visits all n (n - 1) / 2 column pairs, each three warp reductions in a
    row, the kernel's chain of dependent steps."""
    A = H.astype(np.float64).copy()
    m, n = A.shape
    tol = np.finfo(np.float64).eps * np.sqrt(m)
    for sweep in range(60):  # kMaxSweeps
        rotated = False
        for p in range(n - 1):
            for q in range(p + 1, n):
                ap, aq = A[:, p].copy(), A[:, q].copy()
                alpha, beta, gamma = ap @ ap, aq @ aq, ap @ aq
                if gamma == 0 or abs(gamma) <= tol * np.sqrt(alpha) * np.sqrt(beta):
                    continue
                zeta = (beta - alpha) / (2 * gamma)
                t = np.copysign(1 / (abs(zeta) + np.sqrt(1 + zeta * zeta)), zeta)
                c = 1 / np.sqrt(1 + t * t)
                A[:, p], A[:, q] = c * ap - c * t * aq, c * t * ap + c * aq
                rotated = True
        if not rotated:
            return sweep + 1
    return 60


def _lstsq_kernel(torch, dev):
    """The GMRES least-squares kernel against its plain version (the SVD
    formula on the CPU in f64) on GMRES's 21 x 20 Hessenberg shape, full rank
    and after a happy breakdown (rank 7: zero columns), f64 and f32; its
    time beside the plain version's on the card, the QR library call's (the
    same function where H has full rank) and its bound. Not counted: the
    main path's launches are counted in the suite."""
    from lbfgs_ffnn_torch.ops.cuda_lstsq import lstsq_min_norm, lstsq_plain

    rng = np.random.default_rng(SEED)
    m, n = 21, 20
    cases = {}
    for rank in (n, 7):
        H = np.triu(rng.normal(size=(m, n)), -1)
        if rank < n:
            H[:, rank:] = 0.0
            H[rank + 1:, :] = 0.0
            H[rank, rank - 1] = 0.0
        beta = np.zeros(m)
        beta[0] = rng.normal()
        cases[rank] = (H, beta)
    worst = {}
    for dtype in (torch.float64, torch.float32):
        for rank, (H, beta) in cases.items():
            Hd = torch.tensor(H, dtype=dtype, device=dev)
            bd = torch.tensor(beta, dtype=dtype, device=dev)
            y = lstsq_min_norm(Hd, bd).cpu().double()
            ref = lstsq_plain(Hd.cpu().double(), bd.cpu().double())
            plain_own = lstsq_plain(Hd.cpu(), bd.cpu()).double()
            err = float((y - ref).abs().max())
            err_plain = float((plain_own - ref).abs().max())
            scale = float(ref.abs().max())
            eps = torch.finfo(dtype).eps
            ok = (err <= 1e-10 * scale if dtype == torch.float64
                  else err <= 4 * err_plain + 10 * eps * scale)
            check(ok and bool(torch.all(y[rank:] == 0)),
                  f"lstsq kernel {dtype} rank {rank}: max |kernel - plain f64| {err:.3g} "
                  f"(plain in {dtype}: {err_plain:.3g}), zero weights {y[rank:].tolist()}")
            worst[(str(dtype).split(".")[-1], rank)] = (err, err_plain)
    H, beta = cases[n]
    Hd, bd = torch.tensor(H, device=dev), torch.tensor(beta, device=dev)
    ms = _events_ms(torch, lambda: lstsq_min_norm(Hd, bd), LSTSQ_REPS)
    plain_ms = _events_ms(torch, lambda: lstsq_plain(Hd, bd), 50)
    library_ms = _events_ms(torch, lambda: torch.linalg.lstsq(Hd, bd[:, None]).solution, 50)
    nbytes = (m * n + m + n) * 8
    flops = 4 * m * n * n + 8 * n ** 3 + 2 * m * n + 2 * n * n  # R-SVD (Golub-Van Loan) + solve
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F64_FLOPS * 1e3
    bound_ms, bound_by = max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
    pairs = _jacobi_sweeps(H) * n * (n - 1) // 2
    say("suite", "least-squares kernel (lstsq_min_norm_kernel, csrc/lstsq.cu) against the SVD "
        "formula in f64: " + ", ".join(f"{d} rank {r}: {e:.3g} (plain in {d} {ep:.3g})"
                                       for (d, r), (e, ep) in worst.items())
        + f"; 21 x 20 f64: {ms * 1e3:.2f} us/call (CUDA events, {LSTSQ_REPS} calls), plain "
        f"(torch.linalg.svd on the card) {plain_ms * 1e3:.2f} us, torch.linalg.lstsq (QR, full "
        f"rank only) {library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.4f} us ({bound_by}, "
        f"f64 at {F64_FLOPS / 1e12:.0f} TFLOP/s); latency: {pairs} column pairs in a row "
        f"({pairs // (n * (n - 1) // 2)} sweeps), {ms * 1e6 / pairs:.1f} ns per pair")
    return {"name": "lstsq_min_norm", "route": "cuda", "source": "lbfgs_ffnn_torch/csrc/lstsq.cu",
            "replaces": "jnp.linalg.lstsq in lbfgs_ffnn_tpu/ops/iterative.py:113 "
                        "(no Pallas kernel; GMRES's least squares)",
            "max_abs_err": max(e for e, _ in worst.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def suite_phase(torch, dev, profile: bool, mnist_root):
    """BFGS and Newton on the resident driver: the deterministic suite runner
    in f64 (held to JAX's gates) and f32 (K1 on its L-BFGS row, counted); the
    matrix-free modes at MNIST width; the dense modes at the package's
    ceiling n = DENSE_HESSIAN_LIMIT and its refusal above; every mode
    captured = eager body bitwise; the least-squares kernel."""
    import contextlib
    import importlib
    import io

    from lbfgs_ffnn_torch.experiments import run_deterministic_suite as runner
    from lbfgs_ffnn_torch.objectives.analytic import rosenbrock_problem, rosenbrock_start
    from lbfgs_ffnn_torch.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn_torch.ops.cuda_lstsq import lstsq_min_norm
    from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, two_loop_cuda
    from lbfgs_ffnn_torch.solvers.common import Resident, clear_graph_cache
    from lbfgs_ffnn_torch.types import DENSE_HESSIAN_LIMIT

    tb = importlib.import_module("lbfgs_ffnn_torch.solvers.bfgs")
    tn = importlib.import_module("lbfgs_ffnn_torch.solvers.newton")
    t_phase = time.perf_counter()
    clear_graph_cache()
    lstsq = _lstsq_kernel(torch, dev)

    # (a) the suite runner, f64 then f32; the counts from 0 just before
    _reset(two_loop_cuda.LAUNCHES)
    lstsq_min_norm.LAUNCHES.reset()
    c0 = Resident.captures
    records, walls = {}, {}
    f32_argv = ["--f32", "--gmres-max-iters", str(SUITE_F32_GMRES_ITERS)]
    for prec, argv in (("f64", []), ("f32", f32_argv)):
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            records[prec] = runner.main(argv)
        walls[prec] = time.perf_counter() - t0
        for line in text.getvalue().splitlines():
            say("suite", f"  [{prec}] {line}")
    launches = dict(two_loop_cuda.LAUNCHES)
    lstsq_launches = int(lstsq_min_norm.LAUNCHES)
    captures = Resident.captures - c0
    by = {(r.test, r.implementation): r for r in records["f64"]}
    gates = []
    for impl in ("BFGS", "LBFGS", "BFGS+GMRES", "Newton"):
        r = by[("rosenbrock n=4", impl)]
        gates.append((f"rosenbrock {impl}", r.final_gnorm <= 1e-10
                      and r.distance_to_optimum <= 1e-8))
        gates.append((f"ackley {impl}", by[("ackley n=3", impl)].final_gnorm <= 1e-9))
    for impl in ("LBFGS", "Newton"):
        gates.append((f"rastrigin {impl}", by[("rastrigin n=500", impl)].final_gnorm <= 1e-8))
    failed = [g for g, ok in gates if not ok]
    check(not failed, f"f64 suite rows outside JAX's gates (tests/test_solvers_analytic.py:"
          f"69-101): {failed}")
    lbfgs32 = [r for r in records["f32"] if r.implementation == "LBFGS"]
    want_k1 = sum(r.n_iters for r in lbfgs32) + len(lbfgs32)  # + each row's capture
    check(launches == {k: want_k1 * (k == COOPERATIVE) for k in launches},
          f"suite: two-loop launches {launches} != the f32 L-BFGS rows' {want_k1} "
          "iterations + captures through K1")
    check(lstsq_launches > 0, "suite: the BFGS+GMRES rows never launched the lstsq kernel")
    say("suite", f"f64 suite ({walls['f64']:.1f} s) within JAX's gates: Rosenbrock |g| <= 1e-10 "
        f"and |x - 1| <= 1e-8, Ackley |g| <= 1e-9 (all four), Rastrigin n=500 |g| <= 1e-8 "
        f"(L-BFGS, Newton); f32 suite (BFGS+GMRES rows cut to {SUITE_F32_GMRES_ITERS} iterations) "
        f"{walls['f32']:.1f} s (not gated); K1 launches (device "
        f"count) {launches[COOPERATIVE]} = the f32 L-BFGS rows' iterations + 1 capture each; "
        f"lstsq kernel launches {lstsq_launches}; {captures} captures")
    clear_graph_cache()

    # (b) the matrix-free modes at MNIST width
    aux, source = _data(torch, dev, mnist_root)
    spec = mlp_spec(DIMS, ACTS)
    problem = mlp_problem(spec)
    w0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
    rows = {
        "Newton-CG": (tn.newton, tn._newton_resident_eager, tn.NewtonOptions(
            max_iters=SUITE_MF_ITERS, tol=1e-12, hess_mode="hvp_cg", cg_max_iters=50)),
        "factor BFGS": (tb.bfgs, tb._bfgs_resident_eager, tb.BFGSOptions(
            max_iters=SUITE_MF_ITERS, tol=1e-12, storage="factors", linear_solver="cg",
            solver_max_iters=200)),
    }
    ms = {}
    for tag, (solve, eager, opts) in rows.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = Resident.captures
        first = solve(problem, w0, aux, opts)
        torch.cuda.synchronize()
        capture_s, peak = Resident.last_capture_s, torch.cuda.max_memory_allocated() / 2**30
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = solve(problem, w0, aux, opts)
        end.record()
        end.synchronize()
        ms[tag] = start.elapsed_time(end) / res.n_iters
        check(Resident.captures == c0 + 1, f"{tag}: {Resident.captures - c0} captures, not 1")
        check(_same_solve(torch, res, first) and _same_solve(torch, res, eager(problem, w0, aux,
                                                                              opts)),
              f"{tag}: the captured solve differs from the eager body (or from itself)")
        bound = -(-res.n_iters // tn.RESIDENT_CHUNK) + 2
        lh = res.loss_history.cpu().numpy()
        check(res.n_iters == SUITE_MF_ITERS and bool(np.isfinite(lh).all()) and lh[-1] < lh[0]
              and res.n_host_syncs <= bound,
              f"{tag}: {res.n_iters} iterations, losses {lh[[0, -1]]}, host syncs "
              f"{res.n_host_syncs} (limit {bound})")
        work = (f"{res.n_hevals / res.n_iters:.1f} HVPs/iter" if res.n_hevals is not None
                else f"{res.n_matvecs / res.n_iters:.1f} matvecs/iter")
        trials = (res.n_fevals - 1 - res.n_iters) / res.n_iters  # lean: trials + 1 per iteration
        say("suite", f"[{tag}] 784-128-10, N={N_TRAIN:,}, f32, {SUITE_MF_ITERS} iterations: "
            f"{ms[tag]:.4f} ms/iter (CUDA events, the second solve), {work}, {trials:.2f} "
            f"Wolfe trials/iter, host syncs {res.n_host_syncs} (limit {bound}), capture "
            f"{capture_s:.3f} s, peak memory {peak:.2f} GiB; loss {lh[0]:.6g} -> {lh[-1]:.6g}; "
            f"captured = eager body bitwise, the second solve captured nothing")
        if profile and tag == "Newton-CG":
            _profile(torch, lambda: solve(problem, w0, aux, opts))
    del aux
    clear_graph_cache()

    # (c) the dense modes at the package's ceiling
    n = DENSE_HESSIAN_LIMIT
    x0 = rosenbrock_start(n, torch.float64, dev)
    dense = {"dense BFGS direct": (tb.bfgs, rosenbrock_problem(), tb.BFGSOptions(
                 max_iters=SUITE_DENSE_ITERS, tol=1e-12)),
             "dense Newton, autodiff Hessian": (tn.newton, rosenbrock_problem(analytic=False),
                                                tn.NewtonOptions(max_iters=SUITE_DENSE_ITERS,
                                                                 tol=1e-12))}
    for tag, (solve, prob, opts) in dense.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solve(prob, x0, opts=opts)
        capture_s = Resident.last_capture_s
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = solve(prob, x0, opts=opts)
        end.record()
        end.synchronize()
        ms[tag] = start.elapsed_time(end) / res.n_iters
        lh = res.loss_history.cpu().numpy()
        check(res.n_iters == SUITE_DENSE_ITERS and bool(np.isfinite(lh).all()) and lh[-1] < lh[0],
              f"{tag}: {res.n_iters} iterations, losses {lh[[0, -1]]}")
        say("suite", f"[{tag}] extended Rosenbrock n={n}, f64, {res.n_iters} iterations: "
            f"{ms[tag]:.4f} ms/iter (CUDA events, the second solve), capture {capture_s:.3f} s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss "
            f"{lh[0]:.6g} -> {lh[-1]:.6g}")
        clear_graph_cache()
    try:
        tn.newton(rosenbrock_problem(analytic=False), rosenbrock_start(n + 1, torch.float64, dev),
                  opts=tn.NewtonOptions(max_iters=2))
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "hvp_cg" in refused,
          f"n = {n + 1}: the default dense Hessian was not refused ({refused})")
    say("suite", f"n = {n + 1}: refused ({refused[:70]}...)")

    # (d) every mode captured = eager body, bitwise, on Rosenbrock n = 4
    modes = [("bfgs", k, dict(v)) for k, v in (
        ("dense-direct", {}), ("dense-cg", {"linear_solver": "cg"}),
        ("dense-gmres", {"linear_solver": "gmres"}),
        ("factors-cg", {"storage": "factors", "linear_solver": "cg"}),
        ("factors-gmres", {"storage": "factors", "linear_solver": "gmres"}))]
    modes += [("newton", "dense", {}), ("newton", "hvp_cg", {"hess_mode": "hvp_cg"})]
    x4 = rosenbrock_start(4, torch.float64, dev)
    held = []
    for kind, mode, kw in modes:
        mod = tb if kind == "bfgs" else tn
        solve = mod.bfgs if kind == "bfgs" else mod.newton
        eager = mod._bfgs_resident_eager if kind == "bfgs" else mod._newton_resident_eager
        Options = mod.BFGSOptions if kind == "bfgs" else mod.NewtonOptions
        opts = Options(max_iters=SUITE_CHECK_ITERS, tol=1e-14, **kw)
        prob = rosenbrock_problem()  # one problem: the graph cache keys on it
        c0 = Resident.captures
        cap = solve(prob, x4, opts=opts)
        again = solve(prob, x4, opts=opts)
        check(Resident.captures == c0 + 1, f"{kind} {mode}: the second solve captured again")
        check(_same_solve(torch, cap, eager(prob, x4, opts=opts))
              and _same_solve(torch, cap, again),
              f"{kind} {mode}: captured != eager body (bitwise)")
        held.append(f"{kind} {mode} ({cap.n_iters} it)")
    say("suite", f"captured = eager body bitwise (x, histories, counters), Rosenbrock n=4 f64, "
        f"{SUITE_CHECK_ITERS} iterations at most, one capture each: " + ", ".join(held))
    clear_graph_cache()
    say("suite", f"phase time {time.perf_counter() - t_phase:.1f} s")
    lstsq["launches"] = lstsq_launches
    return {"K1": launches[COOPERATIVE], "lstsq": lstsq, "ms_iter": ms}


def _stream_split(torch, dev, bp, w0, x_h, y_h, x, y) -> dict:
    """ms per step, host clock, over one epoch's batches, of each part of a
    ``sgd_streaming`` step alone: the stream's ``next()`` (its producer
    alone), the batch's copy from a pinned buffer on a copy stream with its
    event waited for, and the masked update (``grad_and_value`` of
    ``fun_masked`` and the momentum step, as ``sgd_streaming`` runs it) on
    a batch already on the card, the card synchronized at the end."""
    from lbfgs_ffnn_torch.runtime import BatchStreamer
    from lbfgs_ffnn_torch.solvers.common import full_f32

    out, calls = {}, 0
    with BatchStreamer(x_h, y_h, 256, seed=SEED, device=dev) as st:
        st.next()  # the producer has started
        t0 = time.perf_counter()
        while True:
            xb, yb, count, epoch = st.next()
            calls += 1
            if epoch:
                break
        out["next()"] = (time.perf_counter() - t0) * 1e3 / calls
        steps = calls  # the first call's batch, then the epoch's others
        copy_stream = torch.cuda.Stream(device=dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            with torch.cuda.stream(copy_stream):
                xd, yd = xb.to(dev, non_blocking=True), yb.to(dev, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(copy_stream)
            copied.synchronize()
        out["copy"] = (time.perf_counter() - t0) * 1e3 / steps
    vag = torch.func.grad_and_value(bp.fun_masked)
    xd, yd, cols = x[:256], y[:256], torch.arange(256, device=dev)
    with full_f32(), torch.no_grad():
        w, v = w0.clone(), torch.zeros_like(w0)
        lr = torch.full((), 0.01, dtype=w.dtype, device=dev)
        vag(w, xd, yd, (cols < 256).to(w.dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            g, _loss = vag(w, xd, yd, (cols < 256).to(w.dtype))
            v = 0.9 * v - lr * g
            w = w + v
        torch.cuda.synchronize()
        out["update"] = (time.perf_counter() - t0) * 1e3 / steps
    out["steps"] = steps
    return out


OOC_CHECK = 10         # out-of-core L-BFGS iterations held captured = eager body bitwise
GATHER_SETS = 10       # index sets the gather kernel is held to its plain route on
HOST_LINK_BYTES_PER_S = 64e9  # PCIe Gen5 x16, each way (published)


def _gather_kernel(torch, dev, store, sizes):
    """The gather kernel bitwise against its plain route on GATHER_SETS index
    sets of S-LBFGS's sizes (b = 256 and b_H = 128), each with repeated
    indices and rows of the ragged last chunk; timed at both sizes beside the
    plain route (indices read back to the host, index_select, a copy to the
    card: also the row's library figure, as no one PyTorch call gathers a
    pinned host tensor by device indices), the bound (the rows' bytes over
    the host link) and a 256 MB pinned copy's rate. Launches made here are
    not the main path's."""
    from lbfgs_ffnn_torch.ops.cuda_gather import gather_rows, gather_rows_plain

    rng = np.random.default_rng(SEED)
    tail = (store.num_chunks - 1) * store.chunk_rows
    sets = []
    for i in range(GATHER_SETS):
        idx = rng.integers(0, store.n, sizes[i % 2])
        idx[1:4] = idx[0]                                  # repeated rows
        idx[-8:] = rng.integers(tail, store.n, 8)          # the ragged last chunk
        sets.append(torch.tensor(idx, device=dev))
    for idx in sets:
        xb, yb = gather_rows(store.x, store.y, idx)
        xp, yp = gather_rows_plain(store.x, store.y, idx)
        check(torch.equal(xb, xp) and torch.equal(yb, yp),
              f"gather kernel vs plain route at b={idx.numel()}: not bitwise equal")
    row_bytes = (store.x[0].numel() + store.y[0].numel()) * store.x.element_size()
    times = {}
    for b, idx in zip(sizes, sets):
        # replayed from a CUDA graph, as the solves launch it (launched from
        # the host, each call costs more host time than device time)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gather_rows(store.x, store.y, idx)
        ms = _events_ms(torch, graph.replay, TIMED_CALLS)
        host_ms = _events_ms(torch, lambda: gather_rows(store.x, store.y, idx), TIMED_CALLS)
        plain_ms = _events_ms(torch, lambda: gather_rows_plain(store.x, store.y, idx), 50)
        times[b] = (ms, plain_ms, b * row_bytes / HOST_LINK_BYTES_PER_S * 1e3, host_ms)
        del graph
    big = torch.empty(64 << 20, dtype=torch.float32, pin_memory=True)
    dbig = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    h2d_ms = _events_ms(torch, lambda: dbig.copy_(big, non_blocking=True), 5)
    h2d = big.numel() * 4 / (h2d_ms * 1e-3)
    del big, dbig
    for b, (ms, plain_ms, bound_ms, host_ms) in times.items():
        say("outofcore", f"gather kernel (gather_rows_kernel, csrc/gather.cu) at b={b}: "
            f"{ms * 1e3:.2f} us/call (CUDA events over {TIMED_CALLS} replays of a captured call; "
            f"x and y, one launch; {host_ms * 1e3:.2f} us launched from the host), plain route "
            f"(index_select on the host, a host sync) {plain_ms * 1e3:.2f} us, "
            f"bound {bound_ms * 1e3:.2f} us ({b} x {row_bytes} B over the host link at "
            f"{HOST_LINK_BYTES_PER_S / 1e9:.0f} GB/s), "
            f"{b * row_bytes / (ms * 1e-3) / 1e9:.2f} GB/s")
    say("outofcore", f"gather kernel bitwise equal to its plain route on {GATHER_SETS} index "
        f"sets (repeats, rows of the ragged last chunk); a 256 MiB pinned host-to-device copy "
        f"runs at {h2d / 1e9:.2f} GB/s ({h2d_ms:.3f} ms)")
    ms, plain_ms, bound_ms, host_ms = times[sizes[0]]
    return {"name": "gather_rows", "route": "cuda", "source": "lbfgs_ffnn_torch/csrc/gather.cu",
            "replaces": "no TPU kernel: the host gather ChunkStore.fetch_rows (io_callback) in "
                        "lbfgs_ffnn_tpu/data/outofcore.py:98",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": plain_ms, f"ms_b{sizes[1]}": times[sizes[1]][0],
            "ms_host_launched": host_ms, "h2d_gb_per_s": h2d / 1e9}


def _peak_run(torch, solve):
    """``solve()`` with the peak device memory read around it (GiB), every
    captured graph dropped first."""
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache

    clear_graph_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = solve()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() / 2**30


def _timed(torch, solve, unit_of):
    """``solve()`` timed with CUDA events: (result, ms per unit_of(result))."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = solve()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end) / unit_of(res)


def outofcore_phase(torch, dev, child_args=()):
    """The out-of-core path at full width: the bench's seeded data in a
    ChunkStore in pinned host memory; the gather kernel; the out-of-core
    problem, Armijo L-BFGS and S-LBFGS against their in-memory runs;
    kill-and-resume across processes. The save process starts first and
    runs beside the checks that are not timed; the timed solves and the
    peak memories are read with no other process on the card. The sizes are
    lbfgs_ffnn_torch.experiments.kill_resume's defaults (``child_args``
    overrides them for both, as a rehearsal at a small size does)."""
    import importlib
    import os

    from lbfgs_ffnn_torch.data.outofcore import ChunkStore, outofcore_mlp_problem, outofcore_problem
    from lbfgs_ffnn_torch.experiments import kill_resume
    from lbfgs_ffnn_torch.objectives.analytic import rosenbrock_problem, rosenbrock_start
    from lbfgs_ffnn_torch.objectives.mlp import mlp_batch_problem, mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn_torch.ops.cuda_gather import gather_rows
    from lbfgs_ffnn_torch.ops.cuda_two_loop import COOPERATIVE, two_loop_cuda
    from lbfgs_ffnn_torch.solvers.common import clear_graph_cache, clone

    tl = importlib.import_module("lbfgs_ffnn_torch.solvers.lbfgs")
    tsl = importlib.import_module("lbfgs_ffnn_torch.solvers.slbfgs")
    t_phase = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    ka = kill_resume.build_parser().parse_args(["--leg", "save", "--dir", ckpt_dir,
                                                *child_args])
    b, b_h = ka.batch_size, ka.batch_size // 2

    def leg(name):
        return subprocess.Popen([sys.executable, "-m", "lbfgs_ffnn_torch.experiments.kill_resume",
                                 "--leg", name, "--dir", ckpt_dir, *child_args],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(proc, name):
        out, _ = proc.communicate(timeout=300)
        for line in out.strip().splitlines():
            say("outofcore", f"[{name} process] {line}")
        check(proc.returncode == 0, f"the {name} process exited with {proc.returncode}")

    saver = leg("save")
    x_np, y_np = kill_resume.mnist_like(ka.n_train)
    store = ChunkStore(x_np, y_np, ka.chunk_rows, device=dev)
    check(store.num_chunks == -(-ka.n_train // ka.chunk_rows) and store.x.is_pinned(),
          f"the store has {store.num_chunks} chunks, pinned={store.x.is_pinned()}")
    last = store.n - (store.num_chunks - 1) * ka.chunk_rows
    say("outofcore", f"data: seeded labels (default_rng(123)) + synthetic_images_for_labels, "
        f"{ka.n_train:,} x {x_np.shape[1]} f32 ({x_np.nbytes / 1e6:.1f} MB) in a ChunkStore in "
        f"pinned host memory, chunk_rows {ka.chunk_rows}: {store.num_chunks} chunks, the last "
        f"{last} rows")
    spec = mlp_spec(DIMS, ACTS)
    w0 = mlp_init(spec, torch.Generator().manual_seed(SEED), torch.float32, device=dev)
    x, y = torch.tensor(x_np, device=dev), torch.tensor(y_np, device=dev)

    # (not timed, beside the save process) the problem at w0
    bp = mlp_batch_problem(spec)
    with torch.no_grad():
        f, g = outofcore_problem(bp, store).value_and_grad(w0, ())
        fr, gr = bp.value_and_grad(w0, x, y)
    f_rel = abs(float(f - fr)) / abs(float(fr))
    g_rel = float(torch.linalg.norm(g - gr) / torch.linalg.norm(gr))
    check(f_rel <= 1e-5 and g_rel <= 1e-5, f"outofcore_problem vs in-memory at w0: loss rel "
          f"{f_rel:.3g}, gradient rel {g_rel:.3g} (limit 1e-5)")
    say("outofcore", f"outofcore_problem vs the in-memory mlp_batch_problem at w0: loss "
        f"{float(f):.8g} vs {float(fr):.8g} (rel {f_rel:.3g}), gradient rel {g_rel:.3g} (rtol "
        "1e-5, f32 chunked summation)")
    gather = _gather_kernel(torch, dev, store, (b, b_h))
    finish(saver, "save")
    resumer = leg("resume")

    # (not timed, beside the resume process) captured = eager body bitwise,
    # and the uninterrupted in-memory runs the resumed ones are held to
    lopts = tl.LBFGSOptions(max_iters=ka.iters, tol=1e-12, m=M, line_search="armijo",
                            ls_max_iters=20)
    oprob = outofcore_mlp_problem(spec, store)
    warm = tl.lbfgs_warm_up(oprob, w0, (), lopts, iters=OOC_CHECK)  # captured, cached
    eager = tl._solve_resident(oprob, w0, (), lopts, chunk=OOC_CHECK, capture=False,
                               pipeline=False, iters=OOC_CHECK)[0]
    check(_same_solve(torch, warm, eager), f"out-of-core L-BFGS: captured vs eager body over "
          f"{OOC_CHECK} iterations not bitwise equal")
    sbp = mlp_batch_problem(spec, lam=1e-4)
    sopts = tsl.SLBFGSOptions(epochs=ka.epochs, tol=1e-12, history=M, L=SL_L, batch_size=b,
                              hvp_batch_size=b_h, step_size=0.02)
    one = {cap: tsl._solve(sbp, w0, None, None, sopts, chunk=1, capture=cap, epochs=1,
                           store=store)[0] for cap in (True, False)}
    check(_same_solve(torch, one[True], one[False]), "out-of-core S-LBFGS: captured vs eager "
          "body over 1 epoch not bitwise equal")
    rosen = tl.lbfgs_chunked(rosenbrock_problem(), rosenbrock_start(
        ka.rosenbrock_n, torch.float32, dev), (), lopts, chunk=10)[0]
    sl_mem = tsl.slbfgs_chunked(sbp, w0, x, y, sopts, chunk=1)[0]
    finish(resumer, "resume")
    resumed = {c: torch.load(os.path.join(ckpt_dir, f"{c}.resumed.pt"), weights_only=True)
               for c in kill_resume.CASES}
    for case, full in (("rosenbrock", rosen), ("slbfgs", sl_mem)):
        r = resumed[case]
        same = (all(torch.equal(torch.nan_to_num(r[k], nan=7.0),
                                torch.nan_to_num(getattr(full, k).cpu(), nan=7.0))
                    for k in ("x", "loss_history", "gnorm_history"))
                and (r["n_iters"], r["n_fevals"], r["n_gevals"])
                == (full.n_iters, full.n_fevals, full.n_gevals))
        check(same, f"kill-and-resume {case}: the resumed run (from {r['resumed_at']}) is not "
              "bitwise equal to the uninterrupted one")
        check(bool(torch.isnan(r["time_ms"][:r["resumed_at"]]).all()),
              f"kill-and-resume {case}: time_ms before the resume is not NaN")
    say("outofcore", f"kill-and-resume across processes: Rosenbrock n="
        f"{rosen.x.numel():,} L-BFGS (resumed at k={resumed['rosenbrock']['resumed_at']}) and "
        f"in-memory S-LBFGS (resumed at epoch {resumed['slbfgs']['resumed_at']}) bitwise equal "
        "to their uninterrupted runs; captured = eager body bitwise: out-of-core L-BFGS over "
        f"{OOC_CHECK} iterations, out-of-core S-LBFGS over 1 epoch")

    # timed, alone on the card: the out-of-core and in-memory L-BFGS solves,
    # each peak read with nothing of the other alive
    x_bytes = x.numel() * x.element_size()
    del x, y, warm, eager, one, sl_mem
    ooc, ooc_peak = _peak_run(torch, lambda: tl.lbfgs(oprob, w0, (), lopts))
    _reset(two_loop_cuda.LAUNCHES)
    ooc, ooc_ms = _timed(torch, lambda: tl.lbfgs(oprob, w0, (), lopts), lambda r: r.n_iters)
    k1_lbfgs = dict(two_loop_cuda.LAUNCHES)
    clear_graph_cache()
    x, y = torch.tensor(x_np, device=dev), torch.tensor(y_np, device=dev)
    mprob = mlp_problem(spec)
    mem, mem_peak = _peak_run(torch, lambda: tl.lbfgs(mprob, w0, (x, y), lopts))
    mem, mem_ms = _timed(torch, lambda: tl.lbfgs(mprob, w0, (x, y), lopts), lambda r: r.n_iters)
    lo, lm = ooc.loss_history.cpu().numpy(), mem.loss_history.cpu().numpy()
    check(ooc.n_iters == ka.iters and bool(np.isfinite(lo).all()),
          f"out-of-core L-BFGS: {ooc.n_iters} iterations, finite={bool(np.isfinite(lo).all())}")
    check(np.allclose(lo[:5], lm[:5], rtol=1e-4, atol=0),
          f"out-of-core vs in-memory L-BFGS: first 5 losses {lo[:5]} vs {lm[:5]}")
    check(abs(lo[-1] - lm[-1]) <= LOSS_GATE * lm[-1],
          f"out-of-core vs in-memory L-BFGS: final losses {lo[-1]} vs {lm[-1]} beyond 2%")
    bound = -(-ka.iters // tl.RESIDENT_CHUNK) + 2
    check(ooc.n_host_syncs <= bound, f"out-of-core L-BFGS: {ooc.n_host_syncs} host syncs > {bound}")
    check(k1_lbfgs[COOPERATIVE] == ooc.n_iters and sum(k1_lbfgs.values()) == ooc.n_iters,
          f"out-of-core L-BFGS: K1 launches {k1_lbfgs} != {ooc.n_iters} directions")
    check(ooc_peak <= mem_peak - 0.5 * x_bytes / 2**30, f"out-of-core peak {ooc_peak:.3f} GiB "
          f"is not below the in-memory {mem_peak:.3f} GiB by half of x ({x_bytes / 2**30:.3f} GiB)")
    # two sweeps an iteration (the direction's B and the accepted point's
    # value and gradient), each every chunk's x and y
    sweep_bytes = store.num_chunks * store.chunk_rows * (x_np.shape[1] + y_np.shape[1]) * 4
    r = resumed["outofcore"]
    at = r["resumed_at"]
    lr = r["loss_history"].numpy()
    check(r["n_iters"] == ka.iters and np.allclose(lr[at:at + 5], lo[at:at + 5], rtol=1e-4, atol=0)
          and abs(lr[-1] - lo[-1]) <= LOSS_GATE * lo[-1],
          f"kill-and-resume out-of-core L-BFGS (resumed at {at}): losses after the resume "
          f"{lr[at:at + 5]} vs {lo[at:at + 5]}, final {lr[-1]} vs {lo[-1]}")
    say("outofcore", f"Armijo L-BFGS m={M}, {ka.iters} iterations on outofcore_mlp_problem, "
        f"captured: {ooc_ms:.4f} ms/iter (CUDA events) against the in-memory resident solve's "
        f"{mem_ms:.4f}; {2 * sweep_bytes / 1e6:.1f} MB copied host-to-device per iteration (2 "
        f"sweeps of {store.num_chunks} chunks), {2 * sweep_bytes / (ooc_ms * 1e-3) / 1e9:.2f} "
        f"GB/s; K1 launches (device count) {k1_lbfgs[COOPERATIVE]} = {ooc.n_iters} directions; "
        f"host syncs {ooc.n_host_syncs} <= {bound}; n_fevals {ooc.n_fevals} vs {mem.n_fevals}; "
        f"first 5 losses to rtol 1e-4, final {lo[-1]:.8g} vs {lm[-1]:.8g} "
        f"({abs(lo[-1] - lm[-1]) / lm[-1] * 100:.4f}% apart, limit 2%); peak device memory "
        f"{ooc_peak:.3f} GiB out-of-core, {mem_peak:.3f} GiB in memory (x alone "
        f"{x_bytes / 2**30:.3f} GiB); resumed at k={at} in another process: first 5 losses "
        f"after the resume to rtol 1e-4, final {lr[-1]:.8g} vs {lo[-1]:.8g}")

    # timed, alone: S-LBFGS with store= against the in-memory solve
    clear_graph_cache()
    tsl.slbfgs(sbp, w0, None, None, sopts, store=store)  # captures
    _reset(two_loop_cuda.LAUNCHES)
    gather_rows.LAUNCHES.reset()
    so, so_ms = _timed(torch, lambda: tsl.slbfgs(sbp, w0, None, None, sopts, store=store),
                       lambda r: r.n_iters)
    k1_sl, gathers = dict(two_loop_cuda.LAUNCHES), int(gather_rows.LAUNCHES)
    tsl.slbfgs(sbp, w0, x, y, sopts)  # captures
    sm, sm_ms = _timed(torch, lambda: tsl.slbfgs(sbp, w0, x, y, sopts), lambda r: r.n_iters)
    m_inner = ka.n_train // b
    nb = tsl._plan(m_inner, SL_L)[0]
    # Per epoch from a common start: the out-of-core states after each
    # epoch (uncounted, no chunk run ahead), then one in-memory epoch from
    # each. Over the uninterrupted runs f32 rounding compounds: the
    # in-memory solve alone, through the plain two-loop instead of K1, is
    # 1.1e-4 off its own third epoch (lbfgs_ffnn_torch/experiments/
    # outofcore_study.py), so the uninterrupted runs are held to the
    # bench's 2% on the final loss.
    states = [None]
    tsl._solve(sbp, w0, None, None, sopts, chunk=1, capture=True, store=store,
               epochs=ka.epochs, callback=lambda st, _e: states.append(clone(st)))
    per_epoch = []
    for e in range(ka.epochs):
        one = tsl._solve(sbp, w0 if e == 0 else None, x, y, sopts, chunk=1, capture=True,
                         resume_state=states[e], epochs=e + 1)[0]
        per_epoch.append(float(one.loss_history[e]))
    ls, lsm = so.loss_history.cpu().numpy(), sm.loss_history.cpu().numpy()
    rel_e = np.abs(ls - np.array(per_epoch)) / np.abs(per_epoch)
    rel_run = np.abs(ls - lsm) / np.abs(lsm)
    check(so.n_iters == ka.epochs and len(states) == ka.epochs + 1 and bool((rel_e <= 1e-4).all())
          and abs(ls[-1] - lsm[-1]) <= LOSS_GATE * lsm[-1],
          f"out-of-core vs in-memory S-LBFGS: per-epoch losses {ls} vs {per_epoch} from the same "
          f"start (rel {rel_e}), uninterrupted {lsm} (rel {rel_run})")
    bound = -(-ka.epochs // tsl.RESIDENT_CHUNK) + 2
    check(so.n_host_syncs <= bound, f"out-of-core S-LBFGS: {so.n_host_syncs} host syncs > {bound}")
    check(k1_sl[COOPERATIVE] == ka.epochs * m_inner and gathers == ka.epochs * (m_inner + nb),
          f"out-of-core S-LBFGS: K1 launches {k1_sl}, gathers {gathers}: not {ka.epochs} x "
          f"{m_inner} steps and {ka.epochs} x ({m_inner} + {nb} HVP batches)")
    say("outofcore", f"S-LBFGS with store= (N={ka.n_train:,}, b={b}, b_H={b_h}, L={SL_L}, "
        f"M={M}, lam 1e-4, {ka.epochs} epochs): {so_ms:.4f} ms/epoch (CUDA events) against the "
        f"in-memory solve's {sm_ms:.4f}; per-epoch losses {[float(v) for v in ls]} against "
        f"one in-memory epoch from each out-of-core state {per_epoch} (rel "
        f"{[float(v) for v in rel_e]}, limit 1e-4), against the uninterrupted in-memory solve "
        f"{[float(v) for v in lsm]} (rel {[float(v) for v in rel_run]}; final within 2%); "
        f"host syncs {so.n_host_syncs} "
        f"<= {bound}; gather kernel launches (device count) {gathers} = {ka.epochs} x "
        f"({m_inner} steps + {nb} HVP batches); K1 launches {k1_sl[COOPERATIVE]}")
    clear_graph_cache()
    say("outofcore", f"phase time {time.perf_counter() - t_phase:.1f} s")
    gather["launches"] = gathers
    return {"K1": k1_lbfgs[COOPERATIVE] + k1_sl[COOPERATIVE], "gather": gather,
            "ms": {"L-BFGS out-of-core ms/iter": ooc_ms, "L-BFGS in memory ms/iter": mem_ms,
                   "S-LBFGS out-of-core ms/epoch": so_ms, "S-LBFGS in memory ms/epoch": sm_ms}}


def bench_phase():
    """The port's bench (python -m lbfgs_ffnn_torch.experiments.bench) in a
    process of its own: its last stdout line must be the contract JSON with
    a finite value."""
    say("bench", "python -m lbfgs_ffnn_torch.experiments.bench (stderr follows)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lbfgs_ffnn_torch.experiments.bench"],
                          capture_output=True, text=True, timeout=600)
    for line in proc.stderr.splitlines():
        say("bench", line)
    check(proc.returncode == 0, f"the bench exited with {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"the bench printed {len(lines)} stdout lines, not one")
    out = json.loads(lines[-1])
    check(out.get("metric") == "MNIST 784-128-10 full-batch L-BFGS m=10 step time"
          and out.get("unit") == "ms/iter" and np.isfinite(out.get("value", np.nan))
          and out["value"] > 0 and abs(out["vs_baseline"] - 7.20 / out["value"]) < 2e-3,
          f"the bench's line is not the contract: {lines[-1]}")
    heads = [ln for ln in proc.stderr.splitlines() if ln.startswith("headline config: ")]
    check(len(heads) == 1 and re.match(r"headline config: ([\w-]+);", heads[0]) is not None
          and re.match(r"headline config: ([\w-]+);", heads[0]).group(1)
          in ("f32", "bf16-traffic", "u8-traffic", "u8-warm", "u8-warm-nr"),
          f"the bench's headline config line is missing or names no row: {heads}")
    say("bench", f"{lines[-1]} ({time.perf_counter() - t0:.1f} s)")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace the kernels and two solves with torch.profiler")
    parser.add_argument("--mnist-root", default=None,
                        help="directory of the MNIST IDX files; without it the data are "
                             "seeded labels with synthetic images")
    args = parser.parse_args()
    import torch

    t0 = time.perf_counter()
    smi = device_phase(torch)
    build_phase()
    from lbfgs_ffnn_torch.ops.cuda_two_loop import BLOCKED, COOPERATIVE, STREAMING

    dev = torch.device("cuda")
    n = _n_params(DIMS)
    worst1 = kernel_phase(torch, n, dev)
    worst2 = stream_phase(torch, dev)
    worst3, diag = blocked_phase(torch, dev)
    table = table_phase(torch, dev, args.profile)
    launches1, ms_iter = solve_phase(torch, dev, args.profile, args.mnist_root)
    launches1r, resident_ms, resident = resident_phase(torch, dev, args.profile,
                                                       args.mnist_root)
    launches2, deep_ms = deep_phase(torch, args.profile)
    launches3, large_ms = large_phase(torch, dev, args.profile)
    bench = bench_phase()
    launches_sl, sl_ms, sl_k1_us = stochastic_phase(torch, dev, args.profile, args.mnist_root)
    pinn = pinn_phase(torch, dev, args.profile)
    fo = first_order_phase(torch, dev, args.profile, args.mnist_root)
    traffic = traffic_phase(torch, dev, args.profile, args.mnist_root)
    suite = suite_phase(torch, dev, args.profile, args.mnist_root)
    ooc = outofcore_phase(torch, dev)
    runner1, runner2 = fo["runner"].get(COOPERATIVE, 0), fo["runner"].get(STREAMING, 0)

    def entry(name, impl, replaces, launches, worst, m, n):
        ms, b_ms, b_by, _, k_pick, d_pick = table[m, n, "f32"]
        # the dispatch's K2 group size and K3 prefetch distance
        key = {STREAMING: f"{impl} k={k_pick}*", BLOCKED: f"{impl} d={d_pick}*"}.get(impl, impl)
        out = {"name": name, "route": "cuda", "source": "lbfgs_ffnn_torch/csrc/two_loop.cu",
               "replaces": replaces, "launches": launches, "max_abs_err": worst,
               "ms": ms[key], "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        if impl == STREAMING:
            out["group"] = k_pick
        if impl == BLOCKED:
            out["prefetch"] = d_pick
            out["ms_by_prefetch"] = {k.split("=")[1].rstrip("*"): t for k, t in ms.items()
                                     if k.startswith(BLOCKED)}
        return out

    k1_pinn, k1_ring = pinn["K1"]
    k2_pinn, k2_ring = pinn["K2"]
    k1 = entry("two_loop_cooperative", COOPERATIVE, "lbfgs_ffnn_tpu/ops/pallas_two_loop.py:173",
               launches1r + launches_sl + k1_pinn + runner1 + traffic["K1"] + suite["K1"]
               + ooc["K1"], worst1, M, n)
    # K1 and K2 run on several main paths, each counted from 0 just before its
    # solve; their PINN ring shapes are timed in the pinn phase
    k1["launches_by_path"] = {"resident L-BFGS": launches1r, "stochastic S-LBFGS": launches_sl,
                              "PINN oscillator": k1_pinn, "runner MNIST": runner1,
                              "traffic variants": traffic["K1"],
                              "deterministic suite": suite["K1"], "out-of-core": ooc["K1"]}
    k1["pinn_ring"] = k1_ring
    k2 = entry("two_loop_streaming", STREAMING, "lbfgs_ffnn_tpu/ops/pallas_two_loop.py:81",
               launches2 + k2_pinn + runner2 + traffic["K2"], worst2, M_DEEP,
               _n_params(DEEP_DIMS))
    k2["launches_by_path"] = {"deep Fashion L-BFGS": launches2, "PINN Burgers": k2_pinn,
                              "runner MNIST": runner2, "deep u8 traffic": traffic["K2"]}
    k2["pinn_ring"] = k2_ring
    kernels = [
        k1,
        k2,
        entry("two_loop_blocked", BLOCKED, "lbfgs_ffnn_tpu/ops/pallas_two_loop.py:230",
              launches3, worst3, M_LARGE, N_LARGE),
        suite["lstsq"],
        ooc["gather"],
    ]
    say("result", f"{smi}; MNIST solve ms/iter: cuda {ms_iter['cuda']:.4f}, plain "
        f"{ms_iter['plain']:.4f}; resident MNIST ms/iter: "
        + ", ".join(f"{k} {v:.4f}" for k, v in resident_ms.items())
        + f" (host syncs {resident.n_host_syncs / resident.n_iters:.3f}/iter); bench "
        f"{bench['value']} ms/iter (vs_baseline {bench['vs_baseline']}); deep ms/iter: "
        + ", ".join(f"{k} {v:.4f}" for k, v in deep_ms.items())
        + "; large Rosenbrock ms/iter: " + ", ".join(f"{k} {v:.4f}" for k, v in large_ms.items())
        + "; diag n=4M m=50 ms/call: " + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in diag.items())
        + "; S-LBFGS N=5000 ms/epoch: " + ", ".join(f"{k} {v:.4f}" for k, v in sl_ms.items())
        + (f" (K1 {sl_k1_us:.2f} us device/call)" if sl_k1_us is not None else "")
        + f"; PINN ms/iter: Burgers {pinn['burgers_ms']:.4f}, oscillator "
        f"{pinn['oscillator_ms']:.4f}"
        + "; GD N=60000 ms/iter: " + ", ".join(f"{k} {v:.4f}" for k, v in fo["gd_ms"].items())
        + "; SGD N=60000 b=256 ms/epoch: " + ", ".join(f"{k} {v:.4f}"
                                                       for k, v in fo["sgd_ms"].items())
        + f", streamed {fo['stream_ms']:.4f}"
        + "; traffic variants ms/iter: " + ", ".join(f"{k} {v:.4f}"
                                                     for k, v in traffic["ms_iter"].items())
        + "; GEMM pair us: " + ", ".join(f"{k} {v:.1f}" for k, v in traffic["pair"].items())
        + "; BFGS/Newton ms/iter: " + ", ".join(f"{k} {v:.4f}" for k, v in suite["ms_iter"].items())
        + "; out-of-core: " + ", ".join(f"{k} {v:.4f}" for k, v in ooc["ms"].items())
        + f"; whole script {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
