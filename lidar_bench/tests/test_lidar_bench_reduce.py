"""The reductions the harness applies to what a run measures."""
from __future__ import annotations

import numpy as np
import pytest

from lidar_bench.harness import check, peaks, trace


def test_p90_is_taken_over_all_frames_not_over_chunk_medians():
    # 100 frames: 89 at 100 ms and 11 slow ones at 500 ms, all in the last
    # chunk; a median of 10-frame chunks would never see them
    times = [100.0] * 89 + [500.0] * 11
    assert trace.percentile(times, 90) == pytest.approx(500.0)
    assert np.median([np.median(times[i:i + 10]) for i in range(0, 100, 10)]) == 100.0
    assert trace.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 90) == pytest.approx(4.6)


def test_busy_time_is_the_union_of_device_intervals():
    intervals = [(0.0, 4.0), (2.0, 6.0), (5.0, 7.0), (10.0, 12.0), (11.0, 11.5)]
    assert trace.union_length(intervals) == pytest.approx(9.0)  # 0-7 and 10-12, overlaps once
    assert sum(e - s for s, e in intervals) == pytest.approx(12.5)  # a plain sum counts them twice
    window = (0.0, 20.0)
    idle = 1.0 - trace.union_length(intervals) / (window[1] - window[0])
    assert idle == pytest.approx(0.55)
    assert trace.idle_gaps(intervals, *window) == [(7.0, 10.0), (12.0, 20.0)]
    assert trace.idle_gaps([], 0.0, 3.0) == [(0.0, 3.0)]


def test_idle_gaps_are_named_by_the_innermost_host_event_open_across_them():
    cpu = sorted([(0.0, 10.0, "aten::item"), (1.0, 9.0, "cudaStreamSynchronize"), (12.0, 13.0, "aten::add")],
                 key=lambda c: (c[0], -c[1]))
    assert trace.name_gaps(cpu, [(2.0, 8.0), (10.5, 11.5), (12.2, 12.8)]) == [
        "cudaStreamSynchronize", "host, between operations", "aten::add"]


def test_edge_pick_bound_counts_each_byte_once_from_the_shapes():
    rings, width, picks = 64, 2304, 20
    nbytes = rings * width * (4 * 4) + rings * 4 + rings * width * (1 + 1 + 4)
    assert nbytes == 3244288
    bound = peaks.edge_pick_bound_s(rings, width, picks)
    assert bound == pytest.approx(max(nbytes / 3.35e12, rings * width * 110 / 67e12))
    assert bound == pytest.approx(nbytes / 3.35e12)  # bytes bound it: 0.97 us
    # twice the rings, twice the least time
    assert peaks.edge_pick_bound_s(2 * rings, width, picks) == pytest.approx(2 * bound)


def _rot_z(a, t):
    T = np.eye(4)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = t
    return T


def test_pose_gaps_by_hand():
    ref = np.stack([np.eye(4), _rot_z(0.3, [1.0, 2.0, 0.0])])
    prog = np.stack([_rot_z(0.1, [3.0, 4.0, 0.0]), _rot_z(0.3, [1.0, 2.0, 0.0])])
    m, rad = check.pose_gaps(prog, ref)
    np.testing.assert_allclose(m, [5.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(rad, [0.1, 0.0], atol=1e-12)


def test_compare_fails_an_answer_past_a_limit_and_skips_unnamed_numbers():
    ref = {"pose": np.stack([np.eye(4)] * 3), "rounds": np.array([0, 3, 4]),
           "corr": np.array([[0, 0, 0, 0], [100, 50, 20, 10], [100, 50, 20, 10]])}
    ans = {"key": np.array([0, 1, 2, 1]), "pose": np.stack([np.eye(4)] * 3 + [_rot_z(0.0, [0.002, 0, 0])]),
           "rounds": np.array([0, 3, 4, 5]), "corr": np.array([[0, 0, 0, 0], [100, 50, 20, 10],
                                                              [100, 50, 20, 10], [100, 50, 20, 11]])}
    v = check.compare(ans, ref, {"pose_gap_m": 1e-3, "corr_gap": 0.2})
    assert (v["correct"], v["attempted"], v["failed"]) == (False, 4, 1)
    assert set(v["numbers"]) == {"pose_gap_m", "corr_gap"}
    assert v["numbers"]["pose_gap_m"]["value"] == pytest.approx(0.002)
    assert v["numbers"]["corr_gap"]["value"] == pytest.approx(0.1)
    ans["pose"][3] = np.nan
    assert check.compare(ans, ref, {"pose_gap_m": 1.0})["numbers"]["pose_gap_m"]["value"] == float("inf")
