"""The slice end to end: tloam_torch.pipeline.frontend against the JAX
odometry step on a 3-frame synthetic drive (tests.test_pipeline.CFG, 24 x 768
scans, as tests/test_config_boxes_images.py:64).

Per-frame poses agree to 1e-3 m / 1e-3 rad (float32 sums in another order
move the solve by ~1e-5); cluster counts and boxes are equal; the
per-family correspondence counts agree to 2%. The state-carry case starts
the port from the JAX state after frame 0 (state_from_numpy) and must then
agree with the JAX frames 1-2 at the same tolerance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tloam_torch import config as tcfg_mod
from tloam_torch.cloud import Cloud as TCloud
from tloam_torch.pipeline import frontend as tfront

from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.ops import se3 as jse3
from tloam_tpu.pipeline import frontend as jfront
from tloam_tpu.utils import synthetic as jsyn

from tests.test_pipeline import CFG
from tests.test_torch_common import f32, np_of

N_FRAMES = 3
CAP = 24 * 768
TOL_M = 1e-3
TOL_RAD = 1e-3


def torch_cfg(c):
    """The port's copy of a JAX config dataclass, field for field."""
    if not dataclasses.is_dataclass(c):
        return c
    cls = getattr(tcfg_mod, type(c).__name__)
    return cls(**{f.name: torch_cfg(getattr(c, f.name)) for f in dataclasses.fields(c)})


TCFG = torch_cfg(CFG)


@pytest.fixture(scope="module")
def drive():
    """The JAX reference drive: scans, the state BEFORE each frame, poses
    and diagnostics."""
    scene = jsyn.Scene.urban(np.random.default_rng(5))
    gt = jsyn.straight_trajectory(N_FRAMES, step=0.6)
    scans = [
        jsyn.simulate_scan(gt[i], scene, rings=24, az_steps=768, rng=np.random.default_rng(i), noise=0.005)
        for i in range(N_FRAMES)
    ]
    state = jfront.init_state(CFG, jnp.float32)
    states, poses, diags = [], [], []
    for xyz, inten in scans:
        states.append(state)
        raw = JCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, dtype=jnp.float32)
        state, pose, diag = jfront.odometry_step_nodonate(state, raw, CFG)
        poses.append(np.asarray(pose))
        diags.append(diag)
    return scans, states, np.stack(poses), diags


def assert_frame_matches(pose_t, diag_t, pose_j, diag_j, frame):
    dxi = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(pose_j) @ np_of(pose_t))))
    assert np.abs(dxi[:3]).max() < TOL_M and np.abs(dxi[3:]).max() < TOL_RAD, (frame, dxi)
    assert int(diag_t.num_clusters) == int(diag_j.num_clusters), frame
    bv = np.asarray(diag_j.box_valid)
    assert bv.sum() >= 1 and np.array_equal(np_of(diag_t.box_valid), bv), frame
    np.testing.assert_array_equal(np_of(diag_t.box_min)[bv], np.asarray(diag_j.box_min)[bv])
    np.testing.assert_array_equal(np_of(diag_t.box_max)[bv], np.asarray(diag_j.box_max)[bv])
    nc_t, nc_j = np_of(diag_t.num_corr).astype(float), np.asarray(diag_j.num_corr).astype(float)
    np.testing.assert_allclose(nc_t, nc_j, rtol=0.02, err_msg=f"frame {frame}")


def test_run_sequence_matches_jax(drive):
    scans, _, poses_j, diags_j = drive
    poses_t, diags_t = tfront.run_sequence(list(enumerate(scans)), TCFG, device="cpu", raw_cap=CAP)
    assert poses_t.shape == (N_FRAMES, 4, 4) and np.isfinite(poses_t).all()
    for i in range(N_FRAMES):
        assert_frame_matches(poses_t[i], diags_t[i], poses_j[i], diags_j[i], i)
    # frames 1-2 really registered: every family but sphere (24-ring scans
    # carry no sphere features) found correspondences
    assert (np.stack([d.num_corr for d in diags_t[1:]])[:, :3] > 0).all()


def test_state_carry_from_jax(drive):
    scans, states_j, poses_j, diags_j = drive
    st = tfront.state_from_numpy(states_j[1], device="cpu")
    assert st.frame_idx == 1
    back = tfront.state_to_numpy(st)
    for a, b in zip(
        (back.pose, back.submap.frame_poses, back.submap.edge_map.xyz, back.submap.ground_map.valid),
        (states_j[1].pose, states_j[1].submap.frame_poses, states_j[1].submap.edge_map.xyz,
         states_j[1].submap.ground_map.valid),
    ):
        assert np.array_equal(a, np.asarray(b))
    for i in (1, 2):
        xyz, inten = scans[i]
        raw = TCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, device="cpu")
        st, pose, diag = tfront.odometry_step(st, raw, TCFG)
        assert_frame_matches(pose, diag, poses_j[i], diags_j[i], i)
    assert st.frame_idx == 3


def test_packed_step_matches_unpacked(drive):
    """odometry_step_packed (the path chip_smoke.py drives) equals
    odometry_step on the dequantized cloud."""
    scans, _, _, _ = drive
    q, n = TCloud.pack_scan(*scans[0], capacity=CAP)
    st_p, pose_p, diag_p = tfront.odometry_step_packed(tfront.init_state(TCFG, "cpu"), q, n, TCFG)
    raw = TCloud.from_packed(torch.from_numpy(q), n)
    st_u, pose_u, diag_u = tfront.odometry_step(tfront.init_state(TCFG, "cpu"), raw, TCFG)
    assert np.array_equal(np_of(pose_p), np_of(pose_u))
    assert int(diag_p.num_clusters) == int(diag_u.num_clusters)
    assert np.array_equal(np_of(st_p.submap.edge_map.xyz), np_of(st_u.submap.edge_map.xyz))


def test_off_default_config_raises():
    for cfg in (
        dataclasses.replace(TCFG, frame_planar_fill=64),
        dataclasses.replace(TCFG, sphere_index_bug=True),
        dataclasses.replace(TCFG, odometry=dataclasses.replace(TCFG.odometry, mapping_flag=True)),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP A14"):
            tfront.init_state(cfg, "cpu")
