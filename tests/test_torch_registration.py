"""tloam_torch.models.registration against tloam_tpu.models.registration on a
synthetic frame pair (24 x 768 scans; frame 0 seeds the submap, frame 1 is
registered against it), both fed the same JAX-made feature clouds.

Correspondence masks and counts match exactly; the 6x6 H / g of _evaluate
to 1e-4 relative (float32 sums in another order); scan_matching gives the
same round count and corr_trace and a pose within 1e-4 m / 1e-4 rad."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tloam_torch.models import registration as treg
from tloam_torch.pipeline import frontend as tfront

from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.models import registration as jreg
from tloam_tpu.ops import se3 as jse3

from tests.test_pipeline import CFG
from tests.test_torch_common import clouds_from_numpy, jcloud_to_torch, np_of, small_scan, tt


def _to_torch_fs(fs) -> treg.FeatureSet:
    return treg.FeatureSet(*(jcloud_to_torch(c) for c in fs))


def _to_jax_fs(fs):
    return jreg.FeatureSet(*(
        JCloud(jnp.asarray(np_of(c.xyz)), jnp.asarray(np_of(c.intensity)), jnp.asarray(np_of(c.valid)))
        for c in fs
    ))


@pytest.fixture(scope="module")
def pair():
    """(scan features of frame 1, submap seeded by frame 0, prediction) as
    JAX FeatureSets. The port makes them (preprocess parity is tested in
    test_torch_models and test_torch_frontend); both solvers get the same
    numbers."""
    tcfg = tfront.PipelineConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    f0 = tfront.preprocess_frame(clouds_from_numpy(*small_scan(0), 24 * 768)[1], tcfg)
    f1 = tfront.preprocess_frame(clouds_from_numpy(*small_scan(1), 24 * 768)[1], tcfg)
    sub = tfront.seed_submap(tfront.empty_submap(tcfg, "cpu"), f0, tcfg)
    submap = tfront.submap_features(sub, tcfg)
    # a prediction 0.15 m / 0.01 rad behind the truth (frame 1 is 0.6 m ahead)
    predict = np.asarray(jse3.exp(jnp.asarray([0.45, 0.02, 0.0, 0.0, 0.0, 0.01], jnp.float32)))
    scan, submap = _to_jax_fs(f1.scan), _to_jax_fs(submap)
    # 24-ring scans yield no sphere features; give the sphere family seeded
    # landmarks, seen from frame 1's true pose, so its path carries matches
    # (a few scan points have no submap partner and consume the cap budget)
    rng = np.random.default_rng(7)
    cap_m, cap_s = submap.sphere.capacity, scan.sphere.capacity
    land = (rng.uniform([-30, -30, -1], [30, 30, 3], size=(cap_s, 3))).astype(np.float32)
    m_xyz = np.zeros((cap_m, 3), np.float32)
    m_xyz[: cap_s - 20] = land[: cap_s - 20]
    m_valid = np.arange(cap_m) < cap_s - 20
    truth = np.asarray(jse3.exp(jnp.asarray([0.6, 0.0, 0.0, 0.0, 0.0, 0.01], jnp.float32)))
    s_xyz = ((land - truth[:3, 3]) @ truth[:3, :3] + rng.normal(size=land.shape) * 0.02).astype(np.float32)
    sphere = lambda xyz, v: JCloud(jnp.asarray(xyz), jnp.zeros(len(xyz), jnp.float32), jnp.asarray(v))  # noqa: E731
    scan = scan._replace(sphere=sphere(s_xyz, np.ones(cap_s, bool)))
    submap = submap._replace(sphere=sphere(m_xyz, m_valid))
    return scan, submap, predict


def test_correspondences_and_normal_equations(pair):
    scan, submap, predict = pair
    tls = CFG.odometry.tls
    xi = jse3.log(jnp.asarray(predict))
    cells_j = jax.jit(lambda m: {
        "edge": jreg._build_surf_cells(m.edge, tls.edge_dist_thres, 4096, line_mode="cell"),
        "planar": jreg._build_surf_cells(m.planar, tls.planar_dist_thres, 3072),
        "ground": jreg._build_surf_cells(m.ground, tls.ground_dist_thres, 8192),
        "sphere": jreg.voxel.build_hash_grid(m.sphere.xyz, m.sphere.valid, tls.sphere_dist_thres),
    })(submap)
    corr_j = jax.jit(lambda x, s, m, g: jreg._build_correspondences(x, s, m, g, tls))(xi, scan, submap, cells_j)
    sc, sm = _to_torch_fs(scan), _to_torch_fs(submap)
    cells_t = {
        "edge": treg._build_surf_cells(sm.edge, tls.edge_dist_thres, 4096, line_mode="cell"),
        "planar": treg._build_surf_cells(sm.planar, tls.planar_dist_thres, 3072),
        "ground": treg._build_surf_cells(sm.ground, tls.ground_dist_thres, 8192),
        "sphere": treg.voxel.build_hash_grid(sm.sphere.xyz, sm.sphere.valid, tls.sphere_dist_thres),
    }
    corr_t = treg._build_correspondences(tt(np.asarray(xi)), sc, sm, cells_t, tls, use_coarse=False)
    for name in ("plane_valid", "ground_valid", "edge_valid", "sphere_valid"):
        a, b = np_of(getattr(corr_t, name)), np.asarray(getattr(corr_j, name))
        assert b.sum() > 10, name
        assert np.array_equal(a, b), name
    m = np.asarray(corr_j.plane_valid)
    np.testing.assert_allclose(np_of(corr_t.plane_n)[m], np.asarray(corr_j.plane_n)[m], atol=1e-4)

    # normal equations on the SAME correspondences (the JAX ones)
    rng = np.random.default_rng(0)
    wj = jreg._Weights(*(
        jnp.asarray(rng.uniform(0.3, 1.0, size=c.capacity), jnp.float32)
        for c in (scan.planar, scan.ground, scan.edge, scan.sphere)
    ))
    Hj, gj, cj = jreg._evaluate(xi, scan, corr_j, wj)
    ct = treg._Corr(*(None if getattr(corr_j, f) is None else tt(np.asarray(getattr(corr_j, f)))
                      for f in treg._Corr._fields))
    wt = treg._Weights(*(tt(np.asarray(v)) for v in wj))
    Ht, gt, costs_t = treg._evaluate(tt(np.asarray(xi)), sc, ct, wt)
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    np.testing.assert_allclose(np_of(Ht), Hj, rtol=1e-4, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(np_of(gt), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())
    for a, b in zip(costs_t, cj):
        b = np.asarray(b)
        np.testing.assert_allclose(np_of(a), b, rtol=1e-4, atol=1e-4 * max(np.abs(b).max(), 1e-12))


def test_scan_matching_matches(pair):
    scan, submap, predict = pair
    tls = CFG.odometry.tls
    pose_j, diag_j = jax.jit(lambda s, m, p: jreg.scan_matching(s, m, p, tls))(scan, submap, jnp.asarray(predict))
    pose_t, diag_t = treg.scan_matching(_to_torch_fs(scan), _to_torch_fs(submap), tt(predict), tls)
    assert int(diag_t.iterations) == int(diag_j.iterations)
    assert np.array_equal(np_of(diag_t.corr_trace), np.asarray(diag_j.corr_trace))
    assert np.array_equal(np_of(diag_t.coarse_trace), np.asarray(diag_j.coarse_trace))
    assert np.array_equal(np_of(diag_t.aligned_trace), np.asarray(diag_j.aligned_trace))
    assert bool(diag_t.degenerate) == bool(diag_j.degenerate)
    assert bool(diag_t.misaligned) == bool(diag_j.misaligned)
    dxi = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(np.asarray(pose_j)) @ np_of(pose_t))))
    assert np.abs(dxi[:3]).max() < 1e-4 and np.abs(dxi[3:]).max() < 1e-4, dxi

