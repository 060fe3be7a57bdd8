"""The JAX package's regression guards, on the port (CPU).

Each guard feeds tloam_torch the JAX test's own inputs, built by that
test's helpers and drawn from the same `rng` fixture in the same order, and
asserts the JAX test's bounds:

  * tests/test_failure_containment.py: a frame with no correspondences, or
    with clouds 500 m apart, comes out degenerate with the pose equal to
    the prediction (float64, 1e-12);
  * tests/test_f32_far_origin.py: cell PCA, surf cells and ground recall of
    float32 clouds about 390 m from the origin;
  * tests/test_registration.py: the yaw fan recovers a missed 5.6 deg turn
    onset; GNC rejects 20% gross sphere outliers under 5 mm noise;
  * tests/test_config_boxes_images.py: io.kitti.read_image, gray and color.

Where the JAX call is cheap, the port is also held to it: the degenerate
solves (one compiled program serves both), the cell PCA, read_image."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tloam_torch.cloud import Cloud as TCloud
from tloam_torch.config import FeatureConfig as TFeatureConfig, GroundSegConfig, SensorConfig, TLSConfig
from tloam_torch.io import kitti as tkitti
from tloam_torch.models import features as tfeat, registration as treg, segmentation as tseg
from tloam_torch.ops import voxel as tvox

from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.config import FeatureConfig as JFeatureConfig
from tloam_tpu.io import kitti as jkitti
from tloam_tpu.models import features as jfeat, registration as jreg
from tloam_tpu.ops import se3 as jse3

from tests.test_f32_far_origin import OFFSET, _wall
from tests.test_failure_containment import empty_features
from tests.test_preprocessing import synthetic_scan
from tests.test_registration import CFG, as_features, manhattan_canyon, synthetic_world
from tests.test_torch_common import np_of, two_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("two_threads")

TCFG = TLSConfig(**dataclasses.asdict(CFG))
JSOLVE = jax.jit(jreg.scan_matching, static_argnums=3)


def torch_fs(fs) -> treg.FeatureSet:
    """A JAX FeatureSet -> the port's on the CPU, in the JAX dtype."""
    return treg.FeatureSet(*(TCloud(*(torch.tensor(np.asarray(getattr(c, f))) for f in ("xyz", "intensity", "valid")))
                             for c in fs))


def pose_error(T_true, pose) -> np.ndarray:
    """se3 log of T_true^-1 pose, in float64 (the JAX tests' measure)."""
    return np.asarray(jse3.log(jse3.inv(jnp.asarray(T_true, jnp.float64)) @ jnp.asarray(np_of(pose), jnp.float64)))


def assert_keeps_prediction(scan, submap, predict):
    pose, diag = treg.scan_matching(torch_fs(scan), torch_fs(submap), torch.tensor(np.asarray(predict)), TCFG)
    assert bool(diag.degenerate)
    assert np.all(np.isfinite(np_of(pose)))
    assert np.allclose(np_of(pose), np.asarray(predict), atol=1e-12)
    pose_j, diag_j = JSOLVE(scan, submap, jnp.asarray(predict), CFG)
    np.testing.assert_allclose(np_of(pose), np.asarray(pose_j), atol=1e-12)
    assert bool(diag_j.degenerate) and int(diag.iterations) == int(diag_j.iterations)
    assert np.array_equal(np_of(diag.num_corr), np.asarray(diag_j.num_corr))


def test_no_correspondences_keeps_prediction():
    predict = jse3.exp(jnp.asarray([0.5, -0.2, 0.1, 0.05, 0.0, -0.02]))
    assert_keeps_prediction(empty_features(), empty_features(), predict)


def test_far_apart_clouds_keep_prediction(rng):
    pts = rng.normal(size=(200, 3))
    near = JCloud.from_numpy(pts, capacity=256, dtype=jnp.float64)
    far = JCloud.from_numpy(pts + 500.0, capacity=256, dtype=jnp.float64)
    scan = jreg.FeatureSet(edge=near, sphere=near, planar=near, ground=near)
    submap = jreg.FeatureSet(edge=far, sphere=far, planar=far, ground=far)
    assert_keeps_prediction(scan, submap, jnp.eye(4, dtype=jnp.float64))


def test_cell_pca_far_from_origin(rng):
    """The JAX bounds, and the JAX package's flatness (1e-4) and normals
    (|cos| > 1 - 1e-4) on the wall points."""
    wall = _wall(rng)
    nw = wall.shape[0]
    got = {}
    for name, pts in (("near", wall), ("far", wall + OFFSET)):
        got[name] = tfeat.calculate_pca_info_cell(TCloud.from_numpy(pts, capacity=2048, device="cpu"),
                                                  TFeatureConfig(), max_cells=8192)
    fl_n, fl_f = np_of(got["near"].flatness)[:nw], np_of(got["far"].flatness)[:nw]
    assert np.median(fl_f) > 0.6, np.median(fl_f)
    assert abs(np.median(fl_f) - np.median(fl_n)) < 0.15
    n_f = np_of(got["far"].normal)[:nw]
    assert np.median(np.abs(n_f[:, 2])) < 0.1
    want = jax.jit(lambda c: jfeat.calculate_pca_info_cell(c, JFeatureConfig(), max_cells=8192))(
        JCloud.from_numpy(wall + OFFSET, capacity=2048, dtype=jnp.float32))
    np.testing.assert_allclose(fl_f, np.asarray(want.flatness)[:nw], atol=1e-4)
    assert np.abs(np.sum(n_f * np.asarray(want.normal)[:nw], axis=-1)).min() > 1 - 1e-4


def test_surf_cells_far_from_origin(rng):
    wall = _wall(rng)
    cells = treg._build_surf_cells(TCloud.from_numpy(wall + OFFSET, capacity=2048, device="cpu"), 0.5, 2048)
    surf = np_of(tvox.unpack_records(cells.surf, 12, 16))
    okp = surf[10] > 0.5
    assert okp.sum() > 20
    n = surf[3:6][:, okp]
    d = surf[6][okp]
    nn = np.linalg.norm(n, axis=0)
    assert np.allclose(nn, 1.0, atol=1e-3)
    assert np.median(np.abs(n[0]) / nn) > 0.95
    p = wall[0] + OFFSET
    assert np.abs(n[0] * p[0] + n[1] * p[1] + n[2] * p[2] + d).min() < 0.05


def test_ground_seg_far_from_origin(rng):
    """The JAX test's recall contract on its sensor-centred ring scan."""
    xyz, _ = synthetic_scan(rng, rings=16, with_objects=False)
    res = tseg.ground_remove(TCloud.from_numpy(xyz, capacity=len(xyz), device="cpu"), SensorConfig(),
                             GroundSegConfig())
    g = np_of(res.ground.valid)
    is_ground_true = xyz[:, 2] < -SensorConfig().sensor_height + 0.15
    assert (g & is_ground_true).sum() / max(is_ground_true.sum(), 1) > 0.85


def test_yaw_fan_recovers_missed_turn_onset(rng):
    ground, planar, edge, sphere = manhattan_canyon(rng)
    caps = (8192, 8192, 1024, 256)
    submap = as_features(ground, planar, edge, sphere, caps=caps)
    yaw = np.deg2rad(5.6)
    c, s = np.cos(yaw), np.sin(yaw)
    T_true = np.eye(4)
    T_true[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1.0]]
    T_true[:3, 3] = [1.0, 0.15, 0.0]
    Tn = np.linalg.inv(T_true)
    scan = as_features(*(p @ Tn[:3, :3].T + Tn[:3, 3] for p in (ground, planar, edge, sphere)), caps=caps)
    pose, _ = treg.scan_matching(torch_fs(scan), torch_fs(submap), torch.eye(4, dtype=torch.float64), TCFG)
    err = pose_error(T_true, pose)
    assert np.degrees(abs(err[5])) < 0.5, err
    assert np.linalg.norm(err[:3]) < 0.15, err


def test_scan_matching_with_outliers_and_noise(rng):
    ground, planar, edge, sphere = synthetic_world(rng)
    submap = as_features(ground, planar, edge, sphere)
    T_true = jse3.exp(jnp.asarray(np.array([0.2, 0.1, -0.05, 0.01, 0.02, -0.01])))
    Tn = np.asarray(jse3.inv(T_true))

    def to_scan(pts, noise):
        return pts @ Tn[:3, :3].T + Tn[:3, 3] + rng.normal(size=pts.shape) * noise

    sphere_scan = to_scan(sphere, 0.005)
    n_out = len(sphere_scan) // 5
    sphere_scan[:n_out] += rng.uniform(0.5, 1.0, size=(n_out, 3))
    scan = as_features(to_scan(ground, 0.005), to_scan(planar, 0.005), to_scan(edge, 0.005), sphere_scan)
    pose, _ = treg.scan_matching(torch_fs(scan), torch_fs(submap), torch.eye(4, dtype=torch.float64), TCFG)
    err = pose_error(T_true, pose)
    assert np.linalg.norm(err[:3]) < 1e-2, err
    assert np.linalg.norm(err[3:]) < 2e-3, err


@pytest.mark.parametrize("gray", [True, False])
def test_read_image_gray_and_color(tmp_path, gray):
    from PIL import Image

    arr = (np.arange(12 * 8 * 3) % 255).astype(np.uint8).reshape(12, 8, 3)
    p = tmp_path / "000000.png"
    Image.fromarray(arr).save(p)
    got = tkitti.read_image(p, gray=gray)
    want = jkitti.read_image(p, gray=gray)
    assert got.dtype == np.uint8 and got.shape == ((12, 8) if gray else (12, 8, 3))
    assert np.array_equal(got, want)
    if not gray:
        np.testing.assert_array_equal(got, arr)
