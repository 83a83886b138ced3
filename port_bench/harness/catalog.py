"""Everything the harness runs, found by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics. A
cell names a configuration, ``configs/<name>.json``, and a traffic mix,
``mixes/<name>.json``. A configuration names its ``algorithm``, whose plain
reference is ``reference/<algorithm>.py``; a mix names its ``entry``,
``entries/<entry>.py``. A cell's limits are ``limits/<cell>.json``, and a
per-layer metric's reader is ``metrics/<metric>.py``, whose ``read(record)``
returns a number or None. A later change adds a cell, a configuration, a
mix or a metric by adding such files and entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    for c in (bench or benchmark())["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return _json(BENCH / "mixes" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(BENCH / "limits" / f"{cell_name}.json")["limits"]


def reference(algorithm: str):
    return importlib.import_module(f"reference.{algorithm}")


def entry(name: str):
    return importlib.import_module(f"entries.{name}")


def metric_reader(name: str):
    """``read(record)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(cell_name: str, trace: bool, bench: dict | None = None
               ) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    each listing the cell under ``workloads``, or listing no cells."""
    bench = bench or benchmark()
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if cell_name in m.get("workloads", [cell_name])]
