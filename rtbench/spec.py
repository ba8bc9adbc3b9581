"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``) and comparison limits
(``limits/<cell>.json``), and the per-layer metric readers
(``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list   # the metric entries this cell reports
    per_layer: list


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files; raises
    KeyError for a cell it does not list."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        config=load_json(root / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        chips=int(entry["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, name)],
    )


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"rtbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
