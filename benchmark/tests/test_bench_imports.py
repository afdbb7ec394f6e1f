"""What the benchmark imports, by the top-level name of each module (the
part before the first dot), compared whole: ``lbfgs_ffnn_torch`` begins
with the JAX package's name and is not it."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "lbfgs_ffnn_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _top(names) -> set[str]:
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere_in_the_benchmark(path):
    assert not _top(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert "lbfgs_ffnn_torch" not in _top(names)
    # of the benchmark, only the reference itself: the harness imports the program
    assert all(n.startswith("benchmark.reference") for n in names if _top([n]) == {"benchmark"})


def test_the_whole_name_is_compared():
    assert _top(["lbfgs_ffnn_torch.solvers.lbfgs"]) == {"lbfgs_ffnn_torch"}
    assert not _top(["lbfgs_ffnn_torch.solvers"]) & FORBIDDEN
    assert _top(["jax.numpy", "lbfgs_ffnn_tpu.solvers"]) <= FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, in a fresh process: afterwards nothing
    of JAX or the JAX package is in sys.modules."""
    code = (
        "import json, sys\n"
        "from benchmark import catalog, run\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "r = run.run_cell(tiny_cell('mnist-lbfgs-m10'), 7, 0.0, False, 'cpu',\n"
        "                 log=lambda *a: None)\n"
        "print(json.dumps({'found': run.loaded_forbidden(), 'correct': r['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"found": [], "correct": True}
