"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a real run (set-up, window, reference, check)
on the CPU at the tiny size, past the harness's look for a card, with one
fault planted in the port: a step that returns its state unchanged, half
of the batch left out (the other half standing in for it), and an answer
altered where it is produced. The cells run on one chip, so there is no
exchange between chips to leave out.
"""
from __future__ import annotations

import pytest
import torch

from lidar_bench.harness import programs
from tloam_torch.cloud import map_tensors
from tloam_torch.pipeline import frontend


def _moved(pose: torch.Tensor, metres: float) -> torch.Tensor:
    out = pose.clone()
    out[..., 0, 3] += metres
    return out


@pytest.mark.parametrize("cell", ["cell_plane.stream-urban", "cell_plane.batch64-urban"])
def test_a_sound_run_is_correct(cpu_run, cell):
    out = cpu_run(cell, seconds=2.0)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert all(n["value"] <= n["limit"] for n in out["check"].values())


def test_a_step_that_returns_its_state_unchanged(cpu_run, monkeypatch):
    step = frontend.odometry_step

    def stuck(state, raw, cfg):
        _, _, diag = step(state, raw, cfg)
        return state, state.pose, diag

    monkeypatch.setattr(frontend, "odometry_step", stuck)
    out = cpu_run("cell_plane.stream-urban", seconds=2.0)
    assert not out["correct"] and out["failed"] >= 1, out["check"]


def test_a_stream_pose_altered_where_it_is_produced(cpu_run, monkeypatch):
    solve, calls = frontend.scan_matching, []

    def altered(*a, **kw):
        pose, diag = solve(*a, **kw)
        calls.append(1)
        # window frame 4 (calls 1-2 are the warm-up's); at this size the step
        # clamp replaces frame 2's solve by the prediction, altered or not
        return (_moved(pose, 0.01) if len(calls) == 6 else pose), diag

    monkeypatch.setattr(frontend, "scan_matching", altered)
    out = cpu_run("cell_plane.stream-urban", seconds=3.0)
    assert len(calls) >= 6
    assert not out["correct"], out["check"]


def test_half_of_the_batch_left_out(cpu_run):
    port = programs.port("cpu")

    def half(scans, submaps, predict, tls):
        h = predict.shape[0] // 2
        cut = lambda x: x[:h]  # noqa: E731
        pose, diag = port.solve(map_tensors(scans, cut), map_tensors(submaps, cut), predict[:h], tls)
        twice = lambda x: torch.cat([x, x])  # noqa: E731
        return twice(pose), map_tensors(diag, twice)

    out = cpu_run("cell_plane.batch64-urban", seconds=0.5, program=port._replace(solve=half))
    assert not out["correct"], out["check"]


def test_a_batch_pose_altered_where_it_is_produced(cpu_run):
    port = programs.port("cpu")

    def altered(*a):
        pose, diag = port.solve(*a)
        pose = pose.clone()
        pose[5] = _moved(pose[5], 0.01)
        return pose, diag

    out = cpu_run("cell_plane.batch64-urban", seconds=0.5, program=port._replace(solve=altered))
    assert not out["correct"] and out["failed"] >= 1, out["check"]


def test_the_reference_recovers_the_drive_by_hand(tiny_bench):
    """The reference alone, against the raycaster's ground truth: a tiny
    straight drive at 0.3 m a frame is tracked to a few centimetres."""
    import numpy as np

    from lidar_bench.harness import scans as scans_mod, spec
    from lidar_bench.tests.conftest import SEED

    config, traffic = spec.config("kitti-hdl64.cell_plane", tiny_bench), spec.traffic("stream-urban", tiny_bench)
    drive = dict(traffic["drive"], frames=5, step=0.3)
    scans = scans_mod.drive_scans(drive, config["sensor"], SEED, 1, tiny_bench / ".scan_cache")
    ref = programs.reference()
    cfg = programs.pipeline_config(ref, config)
    torch.use_deterministic_algorithms(True)
    try:
        state, poses = ref.frontend.init_state(cfg, "cpu"), []
        for xyz, inten in scans:
            q, n = ref.Cloud.pack_scan(xyz, inten, capacity=config["sensor"]["capacity"])
            state, pose, _ = ref.frontend.odometry_step_packed(state, q, n, cfg)
            poses.append(pose.numpy().astype(np.float64))
    finally:
        torch.use_deterministic_algorithms(False)
    gt = scans_mod.ground_truth(drive)
    gt_rel = np.linalg.inv(gt[0]) @ gt
    err = np.linalg.norm(np.stack(poses)[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
    assert gt_rel[-1, 0, 3] == pytest.approx(1.2, abs=0.01)
    assert err.max() < 0.05, err
