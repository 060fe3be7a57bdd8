"""The readers of the solver's spans and the program's sync counters, on
hand-built records of the stream's traced run."""
from __future__ import annotations

import pytest

from lidar_bench.harness import spec

# what STAGES.collect() returns over a window of 4 frames: device ms by span,
# host ms ("host:"), counts ("count:")
STAGE_MS = {
    "solve": 800.0, "solve.grids": 100.0, "solve.correspond": 300.0, "solve.gn": 280.0, "solve.gnc": 100.0,
    "host:solve": 790.0, "host:sync.solve.read": 6.0, "host:sync.solve.eigh": 14.0,
    "count:sync.solve.read": 16, "count:sync.solve.eigh": 48, "count:edge_pick.launch": 4,
}


def stream(stage_ms: dict) -> dict:
    return {"kind": "stream", "frames": 4, "stage_ms": stage_ms}


@pytest.mark.parametrize("name,value", [
    ("solve_grids_ms.stream", 25.0),
    ("solve_correspond_ms.stream", 75.0),
    ("solve_gn_ms.stream", 70.0),
    ("solve_wait_ms.stream", 5.0),  # (6 + 14) ms over 4 frames: host time, not device time
    ("program_syncs_per_frame.stream", 16.0),  # (16 + 48) syncs over 4 frames; launches are no syncs
])
def test_a_solver_reader_divides_its_spans_by_the_window_frames(name, value):
    assert spec.reader(name)(stream(STAGE_MS)) == pytest.approx(value)


@pytest.mark.parametrize("name", ["solve_grids_ms.stream", "solve_correspond_ms.stream", "solve_gn_ms.stream",
                                  "solve_wait_ms.stream", "program_syncs_per_frame.stream"])
def test_a_solver_reader_finds_nothing_in_a_program_without_its_spans(name):
    # the parent's stage set: the frame's stages and the whole solve, device ms alone
    before = {"ground": 5.0, "dcvc": 10.0, "edge": 3.0, "features": 8.0, "voxel": 2.0, "solve": 800.0,
              "submap": 4.0}
    assert spec.reader(name)(stream(before)) is None
    assert spec.reader(name)({"kind": "batch", "profile": {"kernels": {}}}) is None


def test_the_solver_readers_are_listed_for_the_stream_cell_alone():
    bench = spec.benchmark()
    names = {"solve_grids_ms.stream", "solve_correspond_ms.stream", "solve_gn_ms.stream", "solve_wait_ms.stream",
             "program_syncs_per_frame.stream"}
    layer = {m["name"]: m for m in bench["per_layer"] if m["name"] in names}
    assert set(layer) == names
    assert all(m["workloads"] == ["cell_plane.stream-urban"] and m["moves"] == "stream_frames_per_s"
               for m in layer.values())
    assert {m["name"] for m in spec.metrics_for(bench["per_layer"], "cell_plane.batch64-urban")}.isdisjoint(names)
