"""Unified training API: config + launcher.

Counterpart of :mod:`lbfgs_ffnn_tpu.launcher` (reference:
src/unified_optimization.hpp:26-48, src/unified_launcher.hpp):
``add_layer -> build_network -> set_data -> train(solver, config) -> test()``.

Backend styles select solver policy as in the JAX package: ``"cuda"`` is
Armijo with interpolation for L-BFGS (20 trials), sequential batches with
momentum, decay and the relative-improvement stop for SGD, and zero biases
at init; ``"cpu"`` is Wolfe for L-BFGS (50 trials), random batches with
plain steps for SGD, and random biases. The launcher runs on ``device``,
which is ``"cuda"`` unless the caller passes ``"cpu"``; without a card it
raises and never moves to the CPU on its own.

Timing: a short warm-up (``WARMUP_ITERS`` iterations or epochs) first pays
the one-time costs of a process (the nvcc builds, cuBLAS set-up) and, on
the card, captures the timed solve's iteration (GD, L-BFGS) or epoch (SGD,
S-LBFGS) as CUDA graphs; then the timed solve runs, its wall time from CUDA
events around it on the card, capture excluded. With ``timed_chunks = K >
0`` the solve is ``gd_chunked``, ``lbfgs_chunked``, ``sgd_chunked`` or
``slbfgs_chunked`` in K-iteration (K-epoch) chunks and the CSV's
``TimeMs`` column is its measured cumulative time per chunk, as in the JAX
package; without it, the whole solve's time is spread over the iterations.

Every solver of the JAX Launcher is ported: ``"gd"``, ``"lbfgs"`` (Armijo
and Wolfe), ``"sgd"`` (its options mapped as the JAX launcher's
``_sgd_opts``) and ``"slbfgs"`` (as ``_slbfgs_opts``: lam 1e-4 when 0,
``m_inner = N // batch_size``, ``b_H = batch_size // 2`` unless set).
``record_accuracy`` records the stochastic solvers' per-epoch accuracy,
``[TrainAcc, TestAcc]`` with a held-out split (``TrainAcc`` alone without),
as extra CSV columns. The traffic options are JAX's: the
``*_input_dtype`` copies (one problem per combination of them, cached, so
the warm-up and the timed solve share the captured step), the SGD rows'
pixel-quantized x under ``fun_input_dtype="uint8"`` (one cached copy),
``prefix_dtype`` and ``ls_alpha_init``/``ls_alpha_growth`` for L-BFGS;
S-LBFGS refuses ``fun_input_dtype`` with JAX's ``ValueError``. Not ported,
and raising ``NotImplementedError``: ``compute_dtype`` (ROADMAP's
do-not-port list).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch

from lbfgs_ffnn_torch.data.datasets import Dataset
from lbfgs_ffnn_torch.objectives.mlp import (
    MLPSpec, evaluate, mlp_apply, mlp_batch_problem, mlp_init, mlp_problem, mlp_spec,
    quantize_pixels,
)
from lbfgs_ffnn_torch.recorder import History, history_from_result, write_history_csv
from lbfgs_ffnn_torch.solvers.gd import GDOptions, gd_chunked, gd_warm_up, gradient_descent
from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions, lbfgs, lbfgs_chunked, lbfgs_warm_up
from lbfgs_ffnn_torch.solvers.sgd import SGDOptions, sgd, sgd_chunked, sgd_warm_up
from lbfgs_ffnn_torch.solvers.slbfgs import (
    SLBFGSOptions, slbfgs, slbfgs_chunked, slbfgs_warm_up,
)
from lbfgs_ffnn_torch.types import SolveResult

WARMUP_ITERS = 2

# solver -> (its whole solve, its chunked driver, its options' length field,
# its warm-up: the first iterations or epochs of the whole solve, its step
# captured on the card)
_DRIVERS = {"gd": (gradient_descent, gd_chunked, "max_iters", gd_warm_up),
            "lbfgs": (lbfgs, lbfgs_chunked, "max_iters", lbfgs_warm_up),
            "sgd": (sgd, sgd_chunked, "epochs", sgd_warm_up),
            "slbfgs": (slbfgs, slbfgs_chunked, "epochs", slbfgs_warm_up)}
# L-BFGS trial budget per line search: the reference CPU's Wolfe
# (full_batch_minimizer.hpp), the reference CUDA backend's Armijo
# (minimizer_base.cuh)
_LS_BUDGETS = {"wolfe": 50, "armijo": 20}
# config field -> its value when unused; anything else raises
_UNPORTED_FIELDS = {"compute_dtype": None}


@dataclasses.dataclass
class UnifiedConfig:
    """The fields of the JAX package's UnifiedConfig that the ported solvers
    read, with its names and defaults except ``two_loop_impl`` ("cuda": the
    Hopper kernels on CUDA tensors and the plain loop on CPU ones; "plain":
    the plain loop everywhere; "compact": the plain compact form), plus
    ``compute_dtype``, which raises unless None."""

    name: str = "Experiment"
    max_iters: int = 100
    tolerance: float = 1e-4
    learning_rate: float = 0.01
    momentum: float = 0.0
    lr_decay: float = 0.0        # SGD: > 0 multiplies the lr every lr_decay_rate epochs
    lr_decay_rate: int = 1
    batch_size: int = 128        # SGD: b; S-LBFGS: b (m_inner = N // b)
    m_param: int = 10
    L_param: int = 10            # S-LBFGS: curvature update interval
    b_H_param: int = 0           # S-LBFGS: HVP batch; 0 -> batch_size // 2
    log_interval: int = 10
    reset_params: bool = True
    seed: int = 123
    lam: float = 0.0             # L2 of the S-LBFGS objective; 0 -> 1e-4 (the reference's)
    two_loop_impl: str = "cuda"
    write_csv: bool = True
    line_search: str = ""        # L-BFGS override: "" = backend style
    pair_dtype: Optional[str] = None  # "bfloat16": the curvature ring in bf16
    timed_chunks: int = 0  # K > 0: measured K-iteration (K-epoch) chunks
    record_accuracy: bool = False  # SGD, S-LBFGS: per-epoch TrainAcc (and TestAcc) columns
    compute_dtype: Optional[str] = None  # not ported: anything but None raises
    prefix_dtype: Optional[str] = None  # L-BFGS: the carried prefix's storage ("bfloat16")
    grad_input_dtype: Optional[str] = None  # the accept point's dW1 reads x narrow
    line_input_dtype: Optional[str] = None  # the prefix GEMMs read x narrow
    fun_input_dtype: Optional[str] = None  # the full objective (GD; SGD's x as uint8)
    ls_alpha_init: str = "fixed"  # L-BFGS: "fixed" | "warm"
    ls_alpha_growth: float = 8.0  # "warm": alpha0 = min(1, growth * alpha_prev)


@dataclasses.dataclass
class TrainReport:
    result: SolveResult
    history: History
    wall_time_s: float
    csv_path: Optional[str]
    train_eval: dict
    warmup_iters: int = 0  # iterations of the warm-up solve before the timed one

    @property
    def ms_per_iter(self) -> float:
        """Milliseconds per iteration of the timed solve: per epoch for the
        stochastic solvers (SGD, S-LBFGS), whose ``n_iters`` counts epochs."""
        n = max(int(self.result.n_iters), 1)
        return self.wall_time_s * 1e3 / n


def _check_ported(solver: str, c: UnifiedConfig) -> None:
    if solver not in _DRIVERS:
        raise ValueError(f"unknown solver {solver!r}")
    for name, unused in _UNPORTED_FIELDS.items():
        if getattr(c, name) != unused:
            raise NotImplementedError(f"UnifiedConfig({name}={getattr(c, name)!r}) is not "
                                      "ported (ROADMAP: not ported unless an H100 measurement "
                                      "asks)")


class Launcher:
    """MLP training launcher (reference: src/unified_launcher.hpp)."""

    def __init__(self, backend_style: str = "cpu", dtype=torch.float32,
                 device: str | torch.device = "cuda", out_dir: str | Path = "."):
        if backend_style not in ("cpu", "cuda"):
            raise ValueError(backend_style)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Launcher(device='cuda') needs an NVIDIA GPU and "
                               "torch.cuda.is_available() is false; pass device='cpu'")
        self.backend_style = backend_style
        self.dtype = dtype
        self.out_dir = Path(out_dir)
        self._dims: list[int] = []
        self._acts: list[str] = []
        self.spec: Optional[MLPSpec] = None
        self.weights: Optional[torch.Tensor] = None
        self._x = self._y = self._tx = self._ty = None

    # -- network assembly ---------------------------------------------------
    def add_layer(self, d_in: int, d_out: int, activation: str) -> "Launcher":
        if not self._dims:
            self._dims = [d_in]
        elif self._dims[-1] != d_in:
            raise ValueError(f"layer input {d_in} != previous output {self._dims[-1]}")
        self._dims.append(d_out)
        self._acts.append(activation)
        return self

    def build_network(self, seed: int = 123) -> "Launcher":
        self.spec = mlp_spec(self._dims, self._acts)
        self._problems = {}  # input dtypes -> one Problem: captured steps key on it
        self._batch_problems = {}  # lam -> one BatchProblem: captured epochs key on it
        self._xq = None  # the pixel-quantized x of the stochastic rows
        self._accuracy = None      # the metric: captured epochs key on it too
        self._bind_params(seed)
        return self

    def _bind_params(self, seed: int) -> None:
        bias = "random" if self.backend_style == "cpu" else "zeros"
        self.weights = mlp_init(self.spec, torch.Generator().manual_seed(seed),
                                dtype=self.dtype, bias_init=bias, device=self.device)

    def set_data(self, dataset: Dataset) -> "Launcher":
        def put(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        self._x, self._y = put(dataset.train_x), put(dataset.train_y)
        self._tx, self._ty = put(dataset.test_x), put(dataset.test_y)
        self._accuracy = None  # its columns depend on the held-out split
        self._xq = None
        return self

    # -- training -----------------------------------------------------------
    def train(self, solver: str, config: UnifiedConfig, verbose: bool = True) -> TrainReport:
        if self.spec is None or self._x is None:
            raise RuntimeError("build_network() and set_data() first")
        _check_ported(solver, config)
        if config.reset_params:
            # (reference: src/unified_launcher.hpp:49-53)
            self._bind_params(config.seed)

        measured_ms, warmup_iters = None, 0
        if config.timed_chunks > 0:
            # the chunked drivers capture their step before the first chunk
            # and measure the chunks alone
            problem, data, opts, kw = self._call(solver, config)
            t0 = time.perf_counter()
            result, measured_ms = _DRIVERS[solver][1](problem, self.weights, *data, opts,
                                                      chunk=config.timed_chunks, **kw)
            wall = time.perf_counter() - t0
        else:
            warmup_iters = self._warm_up(solver, config).n_iters
            result, wall = self._timed(lambda: self._solve(solver, config, config.max_iters))

        self.weights = result.x
        history = history_from_result(result, wall)
        if measured_ms is not None:
            history.time_ms[:] = measured_ms[:history.n]
        csv_path = None
        if config.write_csv:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            csv_path = str(self.out_dir / f"{config.name}_history.csv")
            extra = None
            if result.metric_history is not None:
                mh = result.metric_history[:history.n].detach().cpu().double().numpy()
                extra = ({"TrainAcc": mh[:, 0], "TestAcc": mh[:, 1]} if mh.ndim == 2
                         else {"TrainAcc": mh})
            write_history_csv(csv_path, history, config.log_interval, extra)

        train_eval = evaluate(self.spec, self.weights, self._x, self._y)
        if verbose:
            n_it = max(int(result.n_iters), 1)
            if measured_ms is not None:
                # the wall includes the capture; the measured column is the
                # per-iteration cost
                t_s = float(history.time_ms[n_it - 1]) / 1e3
                t_note = f"measured={t_s:.3f}s ({t_s * 1e3 / n_it:.3f} ms/iter)"
            else:
                t_note = f"time={wall:.3f}s ({wall * 1e3 / n_it:.3f} ms/iter)"
            print(
                f"[{config.name}] {solver}: iters={int(result.n_iters)} "
                f"loss={float(result.final_loss):.6g} "
                f"gnorm={float(result.final_gnorm):.4g} "
                f"{t_note} "
                f"train_acc={train_eval['accuracy']:.2f}%"
            )
        return TrainReport(result, history, wall, csv_path, train_eval, warmup_iters)

    def _warm_up(self, solver: str, c: UnifiedConfig) -> SolveResult:
        """``WARMUP_ITERS`` iterations (epochs) before the timed solve; on the
        card, of the timed solve's own captured iteration or epoch (captured
        here, so the timed solve replays it from the cache)."""
        problem, data, opts, kw = self._call(solver, c)
        return _DRIVERS[solver][3](problem, self.weights, *data, opts,
                                   min(c.max_iters, WARMUP_ITERS), **kw)

    def _timed(self, run) -> tuple[SolveResult, float]:
        """``run()`` and its wall time in seconds: CUDA events on a CUDA
        device, the host clock otherwise; both end with the solve done."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = run()
            end.record()
            end.synchronize()
            return result, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        result = run()
        return result, time.perf_counter() - t0

    def _call(self, solver: str, c: UnifiedConfig) -> tuple:
        """The solver's arguments but the start: ``(problem, data, options,
        keywords)``, ``data`` the aux tuple of the full-batch solvers and
        ``(x, y)`` of the stochastic ones."""
        if solver in ("gd", "lbfgs"):
            opts = self._gd_opts(c) if solver == "gd" else self._lbfgs_opts(c)
            return self._problem(c), ((self._x, self._y),), opts, {}
        opts = self._sgd_opts(c) if solver == "sgd" else self._slbfgs_opts(c)
        return (self._batch_problem(c, solver), (self._stochastic_x(c), self._y), opts,
                {"metric_args": self._metric_args(c)})

    def _problem(self, c: UnifiedConfig):
        """The full-batch objective for the config's input dtypes, one per
        combination (JAX's ``_get_problem``)."""
        key = (c.grad_input_dtype, c.line_input_dtype, c.fun_input_dtype)
        if key not in self._problems:
            self._problems[key] = mlp_problem(self.spec, grad_input_dtype=key[0],
                                              line_input_dtype=key[1], fun_input_dtype=key[2])
        return self._problems[key]

    def _stochastic_x(self, c: UnifiedConfig):
        """x as the stochastic solvers read it: under ``fun_input_dtype=
        "uint8"`` the pixel-quantized copy, made once per data (JAX's
        ``_stochastic_x``)."""
        if c.fun_input_dtype is None:
            return self._x
        if c.fun_input_dtype != "uint8":
            raise ValueError(f"stochastic solvers support fun_input_dtype=None or 'uint8', "
                             f"got {c.fun_input_dtype!r}")
        if self._xq is None:
            self._xq = quantize_pixels(self._x)
        return self._xq

    def _solve(self, solver: str, c: UnifiedConfig, max_iters: int) -> SolveResult:
        whole, _, length, _ = _DRIVERS[solver]
        problem, data, opts, kw = self._call(solver, c)
        return whole(problem, self.weights, *data, opts._replace(**{length: max_iters}), **kw)

    def _lbfgs_opts(self, c: UnifiedConfig) -> LBFGSOptions:
        ls = c.line_search or ("armijo" if self.backend_style == "cuda" else "wolfe")
        if ls == "armijo_batched":
            raise NotImplementedError("L-BFGS line_search=\"armijo_batched\" is not ported "
                                      "(ROADMAP queue 1: not ported unless a measurement asks)")
        if ls not in _LS_BUDGETS:
            raise ValueError(f"unknown line_search {ls!r}; expected one of {sorted(_LS_BUDGETS)}")
        return LBFGSOptions(
            max_iters=c.max_iters, tol=c.tolerance,
            m=c.m_param if c.m_param > 0 else 10,
            line_search=ls, ls_max_iters=_LS_BUDGETS[ls],
            two_loop_impl=c.two_loop_impl, pair_dtype=c.pair_dtype,
            prefix_dtype=c.prefix_dtype, ls_alpha_init=c.ls_alpha_init,
            ls_alpha_growth=c.ls_alpha_growth,
        )

    def _batch_problem(self, c: UnifiedConfig, solver: str = "slbfgs"):
        """The stochastic objective: S-LBFGS's L2 is lam, 1e-4 when the config
        leaves it 0 (the reference strategy's, unified_optimization.hpp:375,
        398); SGD's has none, as the JAX Launcher's."""
        lam = 0.0 if solver == "sgd" else (c.lam if c.lam > 0 else 1e-4)
        if lam not in self._batch_problems:
            self._batch_problems[lam] = mlp_batch_problem(self.spec, lam=lam)
        return self._batch_problems[lam]

    def _accuracy_metric(self):
        """The per-epoch accuracy metric: [TrainAcc, TestAcc] when a held-out
        split exists (the reference plot tooling's optional panels,
        scripts/plot_results.py:107-127), else TrainAcc alone. Returns
        ``(metric_fn, metric_args)``: the test split is an operand of the
        solve, as the train split is, never a constant of a captured graph."""
        margs = (self._tx, self._ty) if self._tx is not None and self._tx.shape[0] > 0 else ()
        if self._accuracy is None:
            spec = self.spec

            def acc1(w, x, y):
                pred = mlp_apply(spec, w, x).argmax(dim=1)
                return (pred == y.argmax(dim=1)).to(w.dtype).mean() * 100.0

            if margs:
                def acc(w, x, y, tx, ty):
                    return torch.stack([acc1(w, x, y), acc1(w, tx, ty)])
            else:
                acc = acc1
            self._accuracy = acc
        return self._accuracy, margs

    def _metric_args(self, c: UnifiedConfig) -> tuple:
        """The accuracy metric's operands (the held-out split), empty when
        accuracy recording is off."""
        return self._accuracy_metric()[1] if c.record_accuracy else ()

    def _sgd_opts(self, c: UnifiedConfig) -> SGDOptions:
        cuda = self.backend_style == "cuda"
        return SGDOptions(
            metric_fn=self._accuracy_metric()[0] if c.record_accuracy else None,
            epochs=c.max_iters, batch_size=c.batch_size, step_size=c.learning_rate,
            momentum=c.momentum if cuda else 0.0,
            sampling="sequential" if cuda else "random",
            lr_decay=c.lr_decay if c.lr_decay > 0 else 1.0,
            lr_decay_step=c.lr_decay_rate if c.lr_decay > 0 else 0,
            tol=c.tolerance if cuda else 0.0,
            seed=c.seed,
        )

    def _slbfgs_opts(self, c: UnifiedConfig) -> SLBFGSOptions:
        # The reference strategy's sizes: m_inner = N / batch, b_H = batch / 2
        # (unified_optimization.hpp:314-405).
        if c.fun_input_dtype is not None:
            raise ValueError("fun_input_dtype is not supported for slbfgs (only sgd/gd/lbfgs); "
                             f"got {c.fun_input_dtype!r}")
        return SLBFGSOptions(
            metric_fn=self._accuracy_metric()[0] if c.record_accuracy else None,
            epochs=c.max_iters, tol=c.tolerance,
            m_inner=max(int(self._x.shape[0]) // c.batch_size, 1),
            history=c.m_param, L=c.L_param, batch_size=c.batch_size,
            hvp_batch_size=c.b_H_param if c.b_H_param > 0 else c.batch_size // 2,
            step_size=c.learning_rate, seed=c.seed,
            two_loop_impl=c.two_loop_impl, pair_dtype=c.pair_dtype,
        )

    def _gd_opts(self, c: UnifiedConfig) -> GDOptions:
        # UnifiedGD_CPU disables line search (unified_optimization.hpp:177);
        # CudaGD adds momentum (cuda/gd.cuh:78-88).
        return GDOptions(
            max_iters=c.max_iters, tol=c.tolerance, step_size=c.learning_rate,
            momentum=c.momentum, use_line_search=False,
        )

    # -- evaluation ----------------------------------------------------------
    def test(self, verbose: bool = True) -> dict:
        """Evaluate on the held-out split (reference: Network::test /
        UnifiedLauncher::evaluate)."""
        out = evaluate(self.spec, self.weights, self._tx, self._ty)
        if verbose:
            print(
                f"=== Test Results ===\nSamples: {out['n']}\n"
                f"Accuracy: {out['accuracy']:.4g}% ({out['correct']}/{out['n']})\n"
                f"Total MSE: {out['total_mse']:.6g}\n===================="
            )
        return out
