"""Everything a cell is made of, found by name.

``BENCHMARK.json`` (at the checkout's root) names the cells and metrics.
A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a cell's correctness limits ``limits/<cell>.json``
and a per-layer metric ``metrics/<name>.py`` (a module with
``read(record) -> float | None``), all under ``lidar_bench/``. Adding one
of them is adding a file; no code names them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in bench['workloads']]}")


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "configs" / f"{name}.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "traffic" / f"{name}.json")


def limits(cell: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "limits" / f"{cell}.json")


def metrics_for(entries: list[dict], cell: str) -> list[dict]:
    """The metrics of `entries` that cell reports: those whose
    ``workloads`` list it, and those with no ``workloads`` key."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"lidar_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
