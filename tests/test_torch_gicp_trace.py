"""The tracer (tloam_torch/utils/timing.STAGES) around GICP's covariances.

In a solve with ``plane_residual="gicp"`` the span ``solve.grids.cov``
brackets the four clouds' covariance fits inside ``solve.grids``, and the
counter ``gicp.cov_points`` adds each fitted cloud's slots (frames x
capacity, from the shape). Point-to-plane solves move neither. With the
tracer off a GICP solve gives the same bits and the same operations as
with no tracer at all. Frames are 24 x 768 synthetic scans under the
reduced capacities of tests/test_pipeline.py, on the CPU.

This file imports neither JAX nor the JAX package.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from tloam_torch.cloud import Cloud, stack_tensors
from tloam_torch.config import OdometryConfig, PipelineConfig, TLSConfig
from tloam_torch.models.registration import scan_matching
from tloam_torch.pipeline import frontend
from tloam_torch.utils import synthetic, timing
from tloam_torch.utils.op_count import count_ops

STAGES = timing.STAGES
CFG = PipelineConfig(
    odometry=OdometryConfig(scan_edge_cap=2048, scan_sphere_cap=256, scan_planar_cap=1024, scan_ground_cap=4096,
                            submap_edge_cap=8192, submap_ground_cap=8192,
                            tls=TLSConfig(max_per_cell=8, plane_residual="gicp")),
    max_voxels=16384, max_clusters=64, frame_planar_cap=2048, frame_sphere_cap=512,
)
RINGS, AZ = 24, 768
MODES = {"gicp": dict(plane_residual="gicp"), "cell_plane": dict(corr_mode="cell_plane"),
         "knn": dict(corr_mode="knn")}


@pytest.fixture(scope="module")
def problems():
    """Frames 2 and 3 of a short straight drive as solver inputs (scan
    features, submap features, prediction), the drive stepped with GICP."""
    scene = synthetic.Scene.urban(np.random.default_rng(5))
    gt = synthetic.straight_trajectory(4, step=0.6)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    # the CPU's accumulating index_put_ adds in a thread-dependent order otherwise
    torch.use_deterministic_algorithms(True)
    try:
        state = frontend.init_state(CFG, "cpu")
        out = []
        for i in range(4):
            q, n = Cloud.pack_scan(*synthetic.simulate_scan(gt[i], scene, rings=RINGS, az_steps=AZ,
                                                            rng=np.random.default_rng(i), noise=0.005),
                                   capacity=RINGS * AZ)
            if i >= 2:
                raw = Cloud.from_packed(torch.as_tensor(q), int(n))
                out.append((frontend.preprocess_frame(raw, CFG).scan, frontend.submap_features(state.submap, CFG),
                            state.predict.clone()))
            state, _, _ = frontend.odometry_step_packed(state, q, n, CFG)
        yield out
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)


def _tls(mode: str) -> TLSConfig:
    return dataclasses.replace(CFG.odometry.tls, **{"plane_residual": "point_to_plane", **MODES[mode]})


def _slots(scan, submap) -> int:
    """The slots of the four clouds GICP fits covariances for."""
    return sum(int(np.prod(c.valid.shape)) for c in (scan.planar, scan.ground, submap.planar, submap.ground))


@pytest.mark.parametrize("mode", list(MODES))
def test_the_covariance_span_and_counter_fire_in_gicp_alone(problems, mode, monkeypatch):
    """One frame, then a batch of two: the span sits in solve.grids and the
    counter adds the four clouds' slots of every frame; point-to-plane
    solves record neither."""
    seen, stack = set(), ["(top)"]
    stage = STAGES.stage

    @contextlib.contextmanager
    def recording(name):
        seen.add((stack[-1], name))
        stack.append(name)
        try:
            with stage(name):
                yield
        finally:
            stack.pop()

    monkeypatch.setattr(STAGES, "stage", recording)
    tls = _tls(mode)
    gicp = mode == "gicp"
    batch = stack_tensors(problems)
    STAGES.enable()
    try:
        for scan, submap, predict in (problems[0], batch):
            scan_matching(scan, submap, predict, tls)
            got = STAGES.collect()
            parents = {parent for parent, name in seen if name == "solve.grids.cov"}
            assert parents == ({"solve.grids"} if gicp else set())
            assert ("host:solve.grids.cov" in got) == gicp
            assert got.get("count:gicp.cov_points", 0) == (_slots(scan, submap) if gicp else 0)
            seen.clear()
    finally:
        STAGES.enable(False)
    assert _slots(*batch[:2]) == 2 * _slots(*problems[0][:2])


def test_a_gicp_solve_gives_the_same_bits_with_spans_on_and_off(problems):
    scan, submap, predict = problems[0]
    tls = _tls("gicp")
    off = scan_matching(scan, submap, predict, tls)
    STAGES.enable()
    try:
        on = scan_matching(scan, submap, predict, tls)
        assert "host:solve.grids.cov" in STAGES.collect()
    finally:
        STAGES.enable(False)
    leaves = lambda out: [t for t in [out[0], *out[1]] if t is not None]  # noqa: E731
    assert len(leaves(off)) == len(leaves(on)) > 10
    for a, b in zip(leaves(off), leaves(on)):
        assert torch.equal(a, b)
    assert int(off[1].iterations) > 0


def test_the_tracer_off_adds_no_operation_to_a_gicp_solve(problems, monkeypatch):
    scan, submap, predict = problems[1]
    tls = _tls("gicp")
    assert not STAGES.enabled
    _, ops_off = count_ops(lambda: scan_matching(scan, submap, predict, tls))
    monkeypatch.setattr(STAGES, "stage", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(STAGES, "sync", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(STAGES, "count", lambda name, n=1: None)
    _, ops_bare = count_ops(lambda: scan_matching(scan, submap, predict, tls))
    assert ops_off == ops_bare and sum(ops_off.values()) > 1000
