"""The benchmark's files, found by the names ``BENCHMARK.json`` uses.

A cell (workload) names a configuration and a traffic mix; each is a file
of its own: ``configs/<config>.json``, ``traffic/<cell>.json`` (and the
cell's correctness limits, ``limits/<cell>.json``); each per-layer metric
is a reader ``metrics/<metric>.py`` with a ``read(ctx)`` function. A later
cell, configuration or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_benchmark(start: Path = BENCH_DIR) -> Path:
    """``BENCHMARK.json`` at the root of the checkout (the benchmark
    folder's parent)."""
    path = start.parent / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json beside {start}")
    return path


def load_cell(name: str, benchmark: dict, root: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``benchmark`` (BENCHMARK.json's content), with
    its files read from ``root``."""
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]

    def reported(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / "configs" / f"{w['config']}.json"),
        traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(root / "limits" / f"{name}.json"),
        end_to_end=[m for m in benchmark["end_to_end"] if reported(m)],
        per_layer=[m for m in benchmark["per_layer"] if reported(m)],
    )


def metric_reader(name: str, root: Path = BENCH_DIR) -> Callable:
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
