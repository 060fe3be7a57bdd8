"""Fixtures of the benchmark's own tests: a copy of its data files at a
size the CPU runs in seconds (32 rings x 1024 azimuth steps, the reduced
capacities of tests/test_pipeline.py, short drives)."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

from lidar_bench.harness import cell, spec

TINY_OVERRIDES = {
    "odometry.scan_edge_cap": 2048, "odometry.scan_sphere_cap": 256, "odometry.scan_planar_cap": 1024,
    "odometry.scan_ground_cap": 4096, "odometry.submap_edge_cap": 8192, "odometry.submap_ground_cap": 8192,
    "odometry.tls.max_per_cell": 8, "max_voxels": 16384, "max_clusters": 64, "frame_planar_cap": 2048,
    "frame_sphere_cap": 512,
}
TINY_SENSOR = {"rings": 32, "az_steps": 1024, "capacity": 32768, "rate_hz": 10}
SEED = 2**31 + 7  # above 32 signed bits, as the driver's seeds are


def make_tiny(dst: Path) -> Path:
    """A copy of lidar_bench's data files under dst, cut to the tiny size."""
    shutil.copytree(spec.BENCH_DIR, dst, ignore=shutil.ignore_patterns(
        ".scan_cache", "__pycache__", "reference", "harness", "tests", "*.md"))
    for f in (dst / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["sensor"] = TINY_SENSOR
        c["overrides"].update(TINY_OVERRIDES)
        f.write_text(json.dumps(c))
    for f in (dst / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        if t["kind"] == "stream":
            t["drive"]["frames"] = 14
        else:
            t["drive"]["frames"], t["problem_frames"], t["replicas"] = 8, [4, 7], 2
        f.write_text(json.dumps(t))
    return dst


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny") / "lidar_bench")


class StepClock:
    """A host clock that moves 0.25 s a reading, so that a window's frame
    or solve count does not hang on how busy the CPU is."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 0.25
        return self.now


@pytest.fixture
def cpu_run(tiny_bench, monkeypatch):
    """run(cell, seconds=..., program=...) -> a run's result on the CPU at the
    tiny size (deterministic algorithms: the CPU's accumulating index_put_
    adds in a thread-dependent order otherwise). The drivers' windows run on
    StepClock: a stream frame takes 0.5 s of it, a batch solve 0.25 s."""
    from lidar_bench.harness import batch, stream

    for mod in (batch, stream):
        monkeypatch.setattr(mod, "time", StepClock())

    def run(name: str, seconds: float = 0.5, **kw) -> dict:
        torch.use_deterministic_algorithms(True)
        try:
            return cell.run(name, SEED, seconds, False, "cpu", time.perf_counter(), processes=1,
                            bench_dir=tiny_bench, **kw)
        finally:
            torch.use_deterministic_algorithms(False)

    return run


def write_piece(bench_dir: Path, name: str, files: dict[str, str]) -> Path:
    """A reference piece, the package bench_dir/<name>/ with `files`
    ({file name: source}); a piece binds in its __init__.py what it takes
    unchanged from lidar_bench.reference."""
    pkg = bench_dir / name
    pkg.mkdir()
    for f, src in files.items():
        (pkg / f).write_text(src)
    return pkg


@pytest.fixture
def pieces(monkeypatch):
    """add(bench_dir): the pieces written under a copy of lidar_bench import
    as lidar_bench.<piece>, as they would from the checkout's lidar_bench/
    (the package's path is extended for the test, after its own folder)."""
    import lidar_bench

    added = []

    def add(bench_dir: Path) -> None:
        added.append(bench_dir)
        monkeypatch.setattr(lidar_bench, "__path__", [*lidar_bench.__path__, str(bench_dir)])

    yield add
    for name in [m for m in sys.modules if m.startswith("lidar_bench.")]:
        f = getattr(sys.modules[name], "__file__", None) or ""
        if any(f.startswith(str(d)) for d in added):
            del sys.modules[name]
            vars(lidar_bench).pop(name.split(".")[1], None)
