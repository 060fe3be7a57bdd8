"""The readers of the solver's spans and the program's sync counters, on
hand-built records of the stream's and the batch's traced runs, and the
batch's traced run recording the spans."""
from __future__ import annotations

import contextlib

import pytest
import torch

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


@pytest.mark.parametrize("name,value", [
    ("solve_grids_ms.batch", 25.0),
    ("solve_correspond_ms.batch", 75.0),
    ("solve_gn_ms.batch", 70.0),
])
def test_a_batch_solver_reader_divides_its_spans_by_the_window_solves(name, value):
    rec = {"kind": "batch", "solves": 4, "batch": 64, "stage_ms": STAGE_MS}
    assert spec.reader(name)(rec) == pytest.approx(value)
    assert spec.reader(name)(stream(STAGE_MS)) is None


@pytest.mark.parametrize("name", ["solve_grids_ms.stream", "solve_correspond_ms.stream", "solve_gn_ms.stream",
                                  "solve_wait_ms.stream", "program_syncs_per_frame.stream", "solve_grids_ms.batch",
                                  "solve_correspond_ms.batch", "solve_gn_ms.batch"])
def test_a_solver_reader_finds_nothing_in_a_program_without_its_spans(name):
    # the parent's stage set: the frame's stages and the whole solve, device ms alone
    before = {"ground": 5.0, "dcvc": 10.0, "edge": 3.0, "features": 8.0, "voxel": 2.0, "solve": 800.0,
              "submap": 4.0}
    assert spec.reader(name)(stream(before)) is None
    assert spec.reader(name)({"kind": "batch", "profile": {"kernels": {}}}) is None
    # a batch record of a run whose spans recorded host time alone (no CUDA events)
    host_only = {k: v for k, v in STAGE_MS.items() if ":" in k}
    assert spec.reader(name)({"kind": "batch", "solves": 4, "stage_ms": host_only}) is None


def test_the_solver_readers_are_listed_for_the_stream_cell_alone():
    bench = spec.benchmark()
    names = {"solve_grids_ms.stream", "solve_correspond_ms.stream", "solve_gn_ms.stream", "solve_wait_ms.stream",
             "program_syncs_per_frame.stream"}
    layer = {m["name"]: m for m in bench["per_layer"] if m["name"] in names}
    assert set(layer) == names
    assert all(m["workloads"] == ["cell_plane.stream-urban"] and m["moves"] == "stream_frames_per_s"
               for m in layer.values())
    assert {m["name"] for m in spec.metrics_for(bench["per_layer"], "cell_plane.batch64-urban")}.isdisjoint(names)


def test_the_batch_solver_readers_are_listed_for_the_two_batch_cells_alone():
    bench = spec.benchmark()
    names = {"solve_grids_ms.batch", "solve_correspond_ms.batch", "solve_gn_ms.batch"}
    layer = {m["name"]: m for m in bench["per_layer"] if m["name"] in names}
    assert set(layer) == names
    assert all(m["workloads"] == ["cell_plane.batch64-urban", "knn.batch64-urban"] and m["layer"] == "solver"
               and m["moves"] == "batch_frames_per_s" and m["source"] == "program_span" for m in layer.values())
    assert {m["name"] for m in spec.metrics_for(bench["per_layer"], "cell_plane.stream-urban")}.isdisjoint(names)


def test_the_batch_traced_run_records_the_solver_spans_and_counts_syncs_with_them_off(tiny_bench, monkeypatch):
    """At the tiny size on the CPU (spans record host ms there; the sync
    count and the profile, which need a card, stand in)."""
    from lidar_bench.harness import batch, cell, programs, scans as scans_mod
    from lidar_bench.tests.conftest import SEED, StepClock

    port = programs.port("cpu")
    seen = []

    def count_syncs(fn):
        seen.append(("syncs", port.stages.enabled))
        return fn(), 0

    @contextlib.contextmanager
    def profiled():
        seen.append(("profile", port.stages.enabled))
        yield {"busy_s": 0.5, "window_s": 1.0, "kernels": {}, "device_ops": [], "idle_gaps": []}

    monkeypatch.setattr(batch, "time", StepClock())
    monkeypatch.setattr(batch.tr, "count_syncs", count_syncs)
    monkeypatch.setattr(batch.tr, "profiled", profiled)
    config, traffic = spec.config("kitti-hdl64.cell_plane", tiny_bench), spec.traffic("batch64-urban", tiny_bench)
    scans = scans_mod.drive_scans(traffic["drive"], config["sensor"], int(traffic["drive_seed"]), 1,
                                  tiny_bench / ".scan_cache")
    torch.use_deterministic_algorithms(True)
    try:
        drv = cell.driver(port, config, traffic, scans, "cpu", SEED)
        drv.setup()
        rec = drv.traced(0.5, port.stages)
    finally:
        torch.use_deterministic_algorithms(False)
    assert rec["kind"] == "batch" and rec["solves"] == 2
    assert {"host:solve.grids", "host:solve.correspond", "host:solve.gn"} <= set(rec["stage_ms"])
    assert rec["stage_ms"]["count:sync.solve.read"] >= 2 * 2  # a flag read a round, 2 rounds or more a solve
    assert not port.stages.enabled
    assert seen == [("syncs", False)] * traffic["trace"]["sync_solves"] + [("profile", False)]
    assert len(drv.collect()["pose"]) == drv.size * (rec["solves"] + traffic["trace"]["sync_solves"]
                                                     + traffic["trace"]["profile_solves"])
