"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; each lives in a file of its own:

- ``benchmark/configs/<config>.json``: the model's sizes, as run;
- ``benchmark/traffic/<traffic>.json``: the mix, the parameters that
  its solver kind turns into the program's calls;
- ``benchmark/kinds/<solver>.py``: a solver kind (the mix's ``solver``),
  a module defining ``KIND``, a :class:`benchmark.drive.Kind`;
- ``benchmark/models/<model>.py``: a model family (the configuration's
  ``model``): its data, starting points, the program's problems, the
  reference's objective and the work of its calls;
- ``benchmark/limits/<workload>.json``: the limit of each number that
  decides ``correct``;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(ctx)`` that returns the metric's value or None.

A cell, a mix, a configuration, a solver kind, a model family or a
metric is added by adding files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    kind: object       # the mix's solver kind, a benchmark.drive.Kind
    model: object      # the configuration's model family, a module


def root_of(start: Path | None = None) -> Path:
    """The checkout's root: the working directory when it holds
    ``BENCHMARK.json``, else the directory above this package."""
    cwd = Path.cwd() if start is None else Path(start)
    return cwd if (cwd / "BENCHMARK.json").is_file() else HERE.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: Path | None = None) -> Cell:
    root = root_of(root)
    bench = _json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; it has "
                       f"{sorted(by_name)}")
    w = by_name[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    base = root / "benchmark"

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    config = _json(root / cfg["file"])
    traffic = _json(base / "traffic" / f"{w['traffic']}.json")
    return Cell(name, w, config, traffic, _json(base / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)],
                _module(root, "kinds", traffic["solver"]).KIND,
                _module(root, "models", config["model"]))


def _module(root: Path, folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` under ``root``, loaded from its file."""
    path = root / "benchmark" / folder / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in path.parent.glob("*.py"))
        raise KeyError(f"no {path}; {folder} has {have}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path | None = None):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    return _module(root_of(root), "metrics", metric).read
