"""Every odometry mode that chip_smoke.py drives on the card, end to end:
tloam_torch.pipeline.frontend against the JAX odometry step on the 3-frame
drive of tests/test_torch_frontend.py (24 x 768 scans), under the same
dotted overrides as chip_smoke.MODES, at that file's tolerances: poses
1e-3 m / 1e-3 rad, cluster counts and boxes equal, correspondence counts
within 2%.

Two modes get 5e-3 m: kNN correspondences and GICP fit planes, lines and
covariances to the 5 or 10 nearest submap points, and on a ring scan those
are often one ring arc, nearly collinear, whose plane normal is float noise
(tests/test_torch_modes_registration.py measures it). The measured gaps:
corr_knn 1.46e-3 m (frame 1), gicp 3.00e-3 m (frame 2); rotations stay
under 6.1e-4 rad. On surfaces without such arcs the solves agree to 1e-6
(test_scan_matching_modes_match).

With mapping_flag the global map is held by its count after every frame;
its points move with the pose (a 3e-4 m pose gap moves a voxel mean by up
to 0.19 m when a point changes voxel), so _accumulate_global_map is held to
1e-6 m on equal inputs. Also the port's copy of the config loader."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tloam_torch import config as tcfg_mod
from tloam_torch.cloud import Cloud as TCloud
from tloam_torch.pipeline import frontend as tfront

from tloam_tpu import config as jcfg_mod
from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.ops import se3 as jse3
from tloam_tpu.pipeline import frontend as jfront
from tloam_tpu.utils import synthetic as jsyn

from tests.test_pipeline import CFG
from tests.test_torch_common import f32, np_of
from tests.test_torch_frontend import CAP, N_FRAMES, TOL_RAD, torch_cfg

# chip_smoke.MODES at the test sizes: a global map of 16384 points
MODES = {
    "corr_knn": ["odometry.tls.corr_mode=knn"],
    "pca_exact": ["feature.pca_mode=exact"],
    "gicp": ["odometry.tls.plane_residual=gicp"],
    "reference": ["odometry.tls.mu_init=reference_zero", "sphere_submap_from_planar=true", "sphere_index_bug=true",
                  "odometry.mapping_flag=true", "odometry.global_map_cap=16384", "frame_planar_fill=1024"],
}


TOL_M = {"corr_knn": 5e-3, "gicp": 5e-3}


def assert_frame_matches(pose_t, diag_t, pose_j, diag_j, frame, tol_m=1e-3):
    """tests/test_torch_frontend.assert_frame_matches with the translation
    tolerance as an argument."""
    dxi = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(pose_j) @ np_of(pose_t))))
    assert np.abs(dxi[:3]).max() < tol_m and np.abs(dxi[3:]).max() < TOL_RAD, (frame, dxi)
    assert int(diag_t.num_clusters) == int(diag_j.num_clusters), frame
    bv = np.asarray(diag_j.box_valid)
    assert bv.sum() >= 1 and np.array_equal(np_of(diag_t.box_valid), bv), frame
    np.testing.assert_array_equal(np_of(diag_t.box_min)[bv], np.asarray(diag_j.box_min)[bv])
    np.testing.assert_array_equal(np_of(diag_t.box_max)[bv], np.asarray(diag_j.box_max)[bv])
    nc_t, nc_j = np_of(diag_t.num_corr).astype(float), np.asarray(diag_j.num_corr).astype(float)
    np.testing.assert_allclose(nc_t, nc_j, rtol=0.02, err_msg=f"frame {frame}")


def jax_cfg(mode: str):
    cfg = CFG
    for ov in MODES[mode]:
        key, _, val = ov.partition("=")
        cfg = jcfg_mod.replace_path(cfg, key, val)
    return cfg


@pytest.fixture(scope="module")
def scans():
    scene = jsyn.Scene.urban(np.random.default_rng(5))
    gt = jsyn.straight_trajectory(N_FRAMES, step=0.6)
    return [jsyn.simulate_scan(gt[i], scene, rings=24, az_steps=768, rng=np.random.default_rng(i), noise=0.005)
            for i in range(N_FRAMES)]


def jax_drive(scans, cfg):
    """The JAX drive: the state BEFORE each frame, poses and diagnostics."""
    state = jfront.init_state(cfg, jnp.float32)
    states, poses, diags = [], [], []
    for xyz, inten in scans:
        states.append(state)
        raw = JCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, dtype=jnp.float32)
        state, pose, diag = jfront.odometry_step_nodonate(state, raw, cfg)
        poses.append(np.asarray(pose))
        diags.append(diag)
    states.append(state)
    return states, np.stack(poses), diags


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_drive_matches_jax(scans, mode):
    cfg = jax_cfg(mode)
    tol_m = TOL_M.get(mode, 1e-3)
    states_j, poses_j, diags_j = jax_drive(scans, cfg)
    tcfg = torch_cfg(cfg)
    st = tfront.init_state(tcfg, "cpu")
    for i, (xyz, inten) in enumerate(scans):
        raw = TCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, device="cpu")
        st, pose, diag = tfront.odometry_step(st, raw, tcfg)
        assert_frame_matches(pose, diag, poses_j[i], diags_j[i], i, tol_m)
        gj = states_j[i + 1].global_map
        assert st.global_map.capacity == gj.capacity
        assert int(st.global_map.count()) == int(np.asarray(gj.count())), i
    assert (np.stack([np.asarray(d.num_corr) for d in diags_j[1:]])[:, :3] > 0).all()
    if not cfg.odometry.mapping_flag:
        return
    assert int(np.asarray(states_j[-1].global_map.count())) > 1000
    # state carry with a global map: the port resumes the JAX state
    st = tfront.state_from_numpy(states_j[2], device="cpu")
    assert st.global_map.capacity == 16384
    for a, b in zip(dataclasses.astuple(tfront.state_to_numpy(st).global_map),
                    (states_j[2].global_map.xyz, states_j[2].global_map.intensity, states_j[2].global_map.valid)):
        assert np.array_equal(a, np.asarray(b))
    xyz, inten = scans[2]
    st, pose, diag = tfront.odometry_step(st, TCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, device="cpu"),
                                          tcfg)
    assert_frame_matches(pose, diag, poses_j[2], diags_j[2], 2)
    assert int(st.global_map.count()) == int(np.asarray(states_j[3].global_map.count()))
    # the accumulation itself on equal inputs: the JAX map after frame 1,
    # frame 2's scan and the JAX pose of frame 2
    raw_j = JCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, dtype=jnp.float32)
    want = jfront._accumulate_global_map(states_j[2].global_map, raw_j, jnp.asarray(poses_j[2]), cfg)
    got = tfront._accumulate_global_map(tfront.state_from_numpy(states_j[2], device="cpu").global_map,
                                        TCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, device="cpu"),
                                        tfront._tensor(poses_j[2], st.pose.dtype, "cpu"), tcfg)
    vj = np.asarray(want.valid)
    assert vj.sum() > 1000 and np.array_equal(np_of(got.valid), vj)
    np.testing.assert_allclose(np_of(got.xyz)[vj], np.asarray(want.xyz)[vj], atol=1e-6)


def test_config_overrides_match_jax():
    """The port's replace_path / load_pipeline_config on overrides, as
    tests/test_config_boxes_images.py holds the JAX ones."""
    cfg = tcfg_mod.PipelineConfig()
    cfg2 = tcfg_mod.replace_path(cfg, "odometry.tls.corr_mode", "knn")
    assert cfg2.odometry.tls.corr_mode == "knn"
    assert cfg.odometry.tls.corr_mode == "cell_plane"
    assert tcfg_mod.replace_path(cfg, "odometry.tls.max_iterations", "7").odometry.tls.max_iterations == 7
    assert tcfg_mod.replace_path(cfg, "sphere_submap_from_planar", "true").sphere_submap_from_planar is True
    assert tcfg_mod.replace_path(cfg, "feature.radius", "0.35").feature.radius == pytest.approx(0.35)
    with pytest.raises(KeyError):
        tcfg_mod.replace_path(cfg, "odometry.nope", "1")
    with pytest.raises(KeyError):
        tcfg_mod.replace_path(cfg, "odometry.tls", "x")
    with pytest.raises(ValueError):
        tcfg_mod.replace_path(cfg, "odometry.mapping_flag", "maybe")
    with pytest.raises(ValueError):
        tcfg_mod.load_pipeline_config(None, ["no_equals_sign"])
    tree = {"feature": {"pca_mode": "exact", "k": 16}, "odometry": {"tls": {"plane_residual": "gicp"}}}
    assert tcfg_mod.apply_dict(cfg, tree) == torch_cfg(jcfg_mod.apply_dict(jfront.PipelineConfig(), tree))
    for overrides in MODES.values():
        got = tcfg_mod.load_pipeline_config(None, overrides)
        want = jcfg_mod.load_pipeline_config(None, overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
