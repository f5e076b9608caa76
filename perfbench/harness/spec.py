"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells (``workloads``) and the metrics. Each piece lives in a file of
its own beside this package:

- a configuration: the ``file`` its entry names (``perfbench/configs/``);
- a cell's traffic: ``perfbench/traffic/<traffic>.json``;
- a cell's comparison limits: ``perfbench/limits/<cell>.json``;
- a metric: the reader ``perfbench/metrics/<metric name>.py``, whose
  ``read(run)`` returns the value or None where it finds nothing to read.

So a later change adds a configuration, a cell or a metric as new files
and new entries, and edits none of these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str

    def reader(self, root: Path) -> Callable:
        """The metric's ``read`` function, from its file under ``metrics/``."""
        return reader_of(self.name, root)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration, traffic, limits and
    metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path


def reader_of(name: str, root: Path = PACKAGE) -> Callable:
    """The ``read`` function of ``metrics/<name>.py`` under ``root``."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r}: no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace("-", "_").replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(checkout: Path, name: str, root: Path = PACKAGE) -> Cell:
    """The cell ``name`` of ``checkout``'s ``BENCHMARK.json``; its files are
    read from ``root`` (this package's directory). Raises ValueError for an
    unknown cell and FileNotFoundError for a missing file."""
    bench = load_json(checkout / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(checkout / configs[w["config"]]["file"])
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "limits" / f"{name}.json")

    def metrics(kind):
        return [Metric(m["name"], m["unit"])
                for m in bench[kind] if name in m.get("workloads", [name])]

    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits, end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"), root=root)
