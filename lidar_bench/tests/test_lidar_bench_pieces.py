"""A configuration may name its own reference piece (a package under
lidar_bench/): the check and the control then drive that piece, and a name
that does not resolve fails at set-up, before any window."""
from __future__ import annotations

import json

import pytest

from lidar_bench.harness import cell, programs, spec
from lidar_bench.tests.conftest import SEED, write_piece

# a piece that takes the frozen reference whole and moves every pose it
# solves by 1 cm: a check against it must fail where one against the frozen
# reference passes
MOVED = {
    "__init__.py": "from lidar_bench.reference import cloud, config, frontend\nfrom . import registration\n",
    "registration.py": (
        "from lidar_bench.reference import registration as frozen\n\n\n"
        "def scan_matching(*args, **kw):\n"
        "    pose, diag = frozen.scan_matching(*args, **kw)\n"
        "    pose = pose.clone()\n"
        "    pose[..., 0, 3] += 0.01\n"
        "    return pose, diag\n"
    ),
}


def _cell_naming(bench_dir, piece: str, cell_name: str) -> dict:
    """BENCHMARK.json with one more cell: cell_plane.batch64-urban's
    configuration, traffic and limits, its configuration naming `piece`."""
    c = spec.config("kitti-hdl64.cell_plane", bench_dir)
    config = f"kitti-hdl64.{cell_name.split('.')[0]}"
    c.update(name=config, reference=piece)
    (bench_dir / "configs" / f"{config}.json").write_text(json.dumps(c))
    (bench_dir / "limits" / f"{cell_name}.json").write_text(
        json.dumps(spec.limits("cell_plane.batch64-urban", bench_dir)))
    bench = spec.benchmark()
    bench["workloads"].append({"name": cell_name, "config": config, "traffic": "batch64-urban", "chips": 1,
                               "why": "a test's cell"})
    return bench


def test_a_configuration_is_checked_against_the_piece_it_names(cpu_run, tiny_bench, pieces):
    write_piece(tiny_bench, "pose_moved_1cm", MOVED)
    pieces(tiny_bench)
    bench = _cell_naming(tiny_bench, "pose_moved_1cm", "moved.batch64-urban")
    moved = cpu_run("moved.batch64-urban", bench=bench)
    assert not moved["correct"] and moved["failed"] == moved["attempted"], moved["check"]
    assert moved["check"]["pose_gap_m"]["value"] == pytest.approx(0.01, abs=1e-4)
    sound = cpu_run("cell_plane.batch64-urban")  # the same configuration without the key
    assert sound["correct"], sound["check"]


@pytest.mark.parametrize("piece,files", [
    ("no_such_piece", None),
    ("piece_without_registration", {"__init__.py": "from lidar_bench.reference import cloud, config, frontend\n"}),
    ("piece_without_scan_matching", {"__init__.py": "from lidar_bench.reference import cloud, config, frontend\n",
                                     "registration.py": "def solve(*args):\n    pass\n"}),
    ("../harness", None),
])
def test_a_piece_that_does_not_resolve_fails_before_the_window(tmp_path, pieces, monkeypatch, piece, files):
    dst = tmp_path / "lidar_bench"
    (dst / "configs").mkdir(parents=True)
    (dst / "limits").mkdir()
    (dst / "traffic").mkdir()
    (dst / "traffic" / "batch64-urban.json").write_text(json.dumps(spec.traffic("batch64-urban")))
    (dst / "configs" / "kitti-hdl64.cell_plane.json").write_text(json.dumps(spec.config("kitti-hdl64.cell_plane")))
    (dst / "limits" / "cell_plane.batch64-urban.json").write_text("{}")
    if files:
        write_piece(dst, piece, files)
    pieces(dst)
    bench = _cell_naming(dst, piece, "named.batch64-urban")

    def no_further(*args, **kw):
        raise AssertionError("the run went on past its set-up's first step")

    monkeypatch.setattr(cell.scans_mod, "drive_scans", no_further)
    monkeypatch.setattr(programs, "port", no_further)
    with pytest.raises(ValueError, match=f"reference piece {piece!r}"):
        cell.run("named.batch64-urban", SEED, 1.0, False, "cpu", 0.0, processes=1, bench=bench, bench_dir=dst)

