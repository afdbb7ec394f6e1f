"""Solvers x objectives cross-product test/benchmark harness.

Counterpart of :mod:`lbfgs_ffnn_tpu.harness` (the reference's TestSuite,
tests/test.hpp:124-150): a registry of solver implementations and test
objectives, run as a cross-product with per-run timing and iteration
counts, plus the convergence classifier of printStatus (tests/test.hpp:
44-65). A run whose iterate lies on a CUDA device is timed with CUDA events
around the solve; a CPU run with the host clock. Each record names the
device it ran on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from lbfgs_ffnn_torch.types import Problem, SolveResult


@dataclasses.dataclass
class RunRecord:
    implementation: str
    test: str
    elapsed_s: float
    n_iters: int
    final_loss: float
    final_gnorm: float
    status: str
    distance_to_optimum: Optional[float] = None
    device: str = ""  # torch.cuda.get_device_name() on CUDA, else "cpu"


def classify(
    gnorm: float,
    x: np.ndarray,
    expected_min: Optional[np.ndarray],
    gtol: float = 1e-6,
    xtol: float = 1e-4,
) -> str:
    """Convergence classifier: global-min / stationary / not-converged."""
    if gnorm > gtol:
        return "not-converged"
    if expected_min is not None and np.linalg.norm(x - expected_min) <= xtol:
        return "global-min"
    return "stationary"


@dataclasses.dataclass
class TestCase:
    __test__ = False  # not a pytest collectable

    name: str
    problem: Problem
    x0: torch.Tensor
    expected_min: Optional[np.ndarray] = None
    gtol: float = 1e-6


def _timed(solve: Callable, problem: Problem, x0: torch.Tensor) -> tuple[SolveResult, float]:
    """``(result, seconds)``: CUDA events around the solve on a CUDA device
    (the end event waited for), else the host clock."""
    if x0.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = solve(problem, x0)
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    res = solve(problem, x0)
    return res, time.perf_counter() - t0


class TestSuite:
    """Register implementations (name -> solve callable) and test cases, then
    run the cross-product. A solve callable takes (problem, x0) and returns a
    SolveResult."""

    __test__ = False  # not a pytest collectable

    def __init__(self):
        self._impls: list[tuple[str, Callable[[Problem, torch.Tensor], SolveResult]]] = []
        self._tests: list[TestCase] = []
        self.records: list[RunRecord] = []

    def add_implementation(self, name: str, solve: Callable) -> "TestSuite":
        self._impls.append((name, solve))
        return self

    def add_test(self, case: TestCase) -> "TestSuite":
        self._tests.append(case)
        return self

    def run(self, verbose: bool = True) -> list[RunRecord]:
        self.records = []
        for case in self._tests:
            dev = case.x0.device
            device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
            for impl_name, solve in self._impls:
                res, elapsed = _timed(solve, case.problem, case.x0)
                x = res.x.detach().cpu().double().numpy()
                gnorm = float(res.final_gnorm)
                rec = RunRecord(
                    implementation=impl_name,
                    test=case.name,
                    elapsed_s=elapsed,
                    n_iters=int(res.n_iters),
                    final_loss=float(res.final_loss),
                    final_gnorm=gnorm,
                    status=classify(gnorm, x, case.expected_min, case.gtol),
                    distance_to_optimum=(
                        float(np.linalg.norm(x - case.expected_min))
                        if case.expected_min is not None else None
                    ),
                    device=device,
                )
                self.records.append(rec)
                if verbose:
                    print(
                        f"[{case.name} | {impl_name}] {rec.status}: "
                        f"iters={rec.n_iters} loss={rec.final_loss:.6g} "
                        f"||g||={rec.final_gnorm:.3g} time={elapsed * 1e6:.0f}us "
                        f"on {device}"
                    )
        return self.records
