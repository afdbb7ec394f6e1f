"""Every cell's files are found by name, and a cell is added by adding
files and entries alone."""

import json
import shutil

import pytest

from benchmark import catalog, check, run
from benchmark.tests.tiny import shrink

ROOT = catalog.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(name):
    cell = catalog.load_cell(name, ROOT)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.kind.unit in ("iter", "epoch")
    assert cell.traffic["solve"][cell.kind.length] > 0
    assert callable(cell.model.objective) and callable(cell.model.problem)
    assert cell.limits and set(cell.limits) <= set(check.NUMBERS)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(catalog.reader(m["name"], ROOT))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_their_sizes(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    dims = cfg["dims"]
    assert cfg["n_params"] == sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    assert config["file"].startswith("benchmark/configs/")


def test_metric_entries_name_their_cells():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_unknown_kind_is_named(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    mix = tmp_path / "benchmark/traffic/lbfgs-fullbatch-m10.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), solver="newton_cg")))
    with pytest.raises(KeyError, match="newton_cg"):
        catalog.load_cell("mnist-lbfgs-m10", tmp_path)


def test_a_cell_added_with_files_only(tmp_path):
    """A new configuration of a new model family, a mix of a new solver
    kind, limits and a metric in a copy of the tree, found and run without
    a change to any file that was there."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "benchmark/configs/mlp-784-128-10.json").read_text())
    cfg.update(name="mlp-784-64-10", dims=[784, 64, 10], n_params=784 * 64 + 64 + 64 * 10 + 10,
               model="mlp_twin")
    (tmp_path / "benchmark/configs/mlp-784-64-10.json").write_text(json.dumps(cfg))
    # a model family and a solver kind, each a file of its own
    (tmp_path / "benchmark/models/mlp_twin.py").write_text(
        (ROOT / "benchmark/models/mlp.py").read_text())
    (tmp_path / "benchmark/kinds/lbfgs_twin.py").write_text(
        (ROOT / "benchmark/kinds/lbfgs.py").read_text())
    mix = json.loads((ROOT / "benchmark/traffic/lbfgs-fullbatch-m10.json").read_text())
    mix["solve"]["m"] = 5
    mix["solver"] = "lbfgs_twin"
    (tmp_path / "benchmark/traffic/lbfgs-fullbatch-m5.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/limits/narrow-lbfgs-m5.json").write_text(
        (ROOT / "benchmark/limits/mnist-lbfgs-m10.json").read_text())
    (tmp_path / "benchmark/metrics/solves.py").write_text(
        '"""Solves the window completed."""\n\n\ndef read(ctx):\n    return len(ctx.solves)\n')
    bench["configs"].append({"name": "mlp-784-64-10", "source": "https://example.org/narrow",
                             "file": "benchmark/configs/mlp-784-64-10.json", "reduced": []})
    bench["workloads"].append({"name": "narrow-lbfgs-m5", "config": "mlp-784-64-10",
                               "traffic": "lbfgs-fullbatch-m5", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "iter_ms":
            m["workloads"].append("narrow-lbfgs-m5")
    bench["per_layer"].append({"name": "solves", "unit": "solves", "better": "higher",
                               "source": "program_counter", "layer": "resident driver",
                               "moves": "iter_ms", "workloads": ["narrow-lbfgs-m5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = shrink(catalog.load_cell("narrow-lbfgs-m5", tmp_path))
    assert cell.traffic["solve"]["m"] == 5
    assert cell.model.__file__ == str(tmp_path / "benchmark/models/mlp_twin.py")
    result = run.run_cell(cell, 3, 0.0, True, "cpu", root=tmp_path, log=lambda *a: None)
    assert result["metrics"]["solves"]["value"] == 1
    assert result["correct"], result["checks"]
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (tmp_path / path.relative_to(ROOT)).read_bytes() == path.read_bytes()
