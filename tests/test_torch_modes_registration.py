"""The non-default registration modes of tloam_torch.models.registration
against tloam_tpu.models.registration, on the frame pair of
tests/test_torch_registration.py (24 x 768 scans, a seeded sphere family).

Tolerances: plane_to_plane, calculate_covariances and the GICP H / g of
_evaluate to 1e-4 relative (float32 sums in another order); the degenerate
(identity) covariances, the kNN and GICP correspondence masks and the
fitness hit counts exactly. scan_matching in every mode: the same round
count, corr_trace, coarse_trace and aligned_trace, and a pose within
1e-4 m / 1e-4 rad (on the `world` fixture: see there)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tloam_torch.models import registration as treg
from tloam_torch.ops import residuals as tres, voxel as tv

from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.models import registration as jreg
from tloam_tpu.ops import residuals as jres, se3 as jse3, voxel as jv

from tests.test_pipeline import CFG
from tests.test_torch_common import f32, jcloud_to_torch, np_of, tt
from tests.test_torch_registration import _to_torch_fs, pair  # noqa: F401  (fixture)

TLS = CFG.odometry.tls


def _rel_close(a, b, rtol=1e-4, err_msg=""):
    b = np.asarray(b)
    np.testing.assert_allclose(np_of(a), b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-12), err_msg=err_msg)


def _spd(rng, n, floor=1e-3):
    A = rng.normal(size=(n, 3, 3))
    return f32(A @ A.transpose(0, 2, 1) / 3.0 + floor * np.eye(3))


def test_plane_to_plane_matches(rng):
    n = 500
    T = f32(jse3.exp(jnp.asarray(f32([0.3, -0.2, 0.1, 0.05, -0.02, 0.3]))))
    src, tgt = f32(rng.normal(size=(n, 3)) * 15), f32(rng.normal(size=(n, 3)) * 15)
    cs, ct = _spd(rng, n), _spd(rng, n)
    w = f32(rng.uniform(0.2, 1.0, size=n))
    want = jres.plane_to_plane(*(jnp.asarray(a) for a in (T, src, cs, tgt, ct, w)))
    got = tres.plane_to_plane(*(tt(a) for a in (T, src, cs, tgt, ct, w)))
    for g, x, name in zip(got, want, ("r", "J", "cost")):
        _rel_close(g, x, err_msg=name)


def _gap(pts: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """(lam1 - lam0) / lam2 of the covariance of each masked point set
    (n, k, 3), in float64."""
    m = ok[..., None].astype(np.float64)
    cnt = np.maximum(m.sum(1), 1.0)
    mean = (pts * m).sum(1) / cnt
    d = (pts - mean[:, None]) * m
    w = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", d, d) / cnt[..., None])
    return (w[:, 1] - w[:, 0]) / np.maximum(w[:, 2], 1e-300)


def _raw_gap(cloud, k: int) -> np.ndarray:
    """_gap of each point's kNN neighbourhood without itself, from the JAX
    neighbour sets; inf where fewer than 3 neighbours."""
    idx, _, ok = jax.jit(lambda c: jv.query_knn(
        jv.build_hash_grid(c.xyz, c.valid, 1.0), c.xyz, c.valid, k=k + 1, radius=1.0, max_per_cell=8))(cloud)
    idx, ok = np.asarray(idx)[:, 1:], np.asarray(ok)[:, 1:]
    gap = _gap(np.asarray(cloud.xyz, np.float64)[idx], ok)
    return np.where(ok.sum(1) >= 3, gap, np.inf)


def test_calculate_covariances_matches(pair, rng):
    """Real submap planar and scan ground clouds, plus a cloud with isolated
    points (identity fallback) and a plane (the eigenvalue clamps).

    A line-like neighbourhood has two raw eigenvalues both under the 1e-3
    clamp; their split, which the 0.1 floor then weights, is float noise
    (measured: the mismatches had (lam1 - lam0) / lam2 < 4e-4, and a few
    entries still moved by 4e-4 at a gap near 1e-3). Points with that gap
    under 1e-2 are held by their eigenvalues (1e-4) and their principal
    axis (|cos| > 1 - 1e-4) alone; all others entry by entry."""
    scan, submap, _ = pair
    flat = np.concatenate([rng.uniform(-2, 2, size=(300, 2)), rng.normal(size=(300, 1)) * 1e-4], axis=1)
    lone = rng.uniform(-200, 200, size=(40, 3))
    extra = JCloud.from_numpy(f32(np.concatenate([flat, lone])), capacity=512, dtype=jnp.float32)
    for cloud in (submap.planar, scan.ground, extra):
        want = np.asarray(jax.jit(lambda c: jreg.calculate_covariances(c, TLS.k_corr, max_per_cell=8))(cloud))
        got = np_of(treg.calculate_covariances(jcloud_to_torch(cloud), TLS.k_corr, max_per_cell=8))
        eye_j = np.all(want == np.eye(3, dtype=np.float32), axis=(1, 2))
        assert np.array_equal(np.all(got == np.eye(3, dtype=np.float32), axis=(1, 2)), eye_j)
        assert (~eye_j).sum() > 200
        posed = _raw_gap(cloud, TLS.k_corr) >= 1e-2
        assert (posed & ~eye_j).sum() > 200
        _rel_close(got[posed], want[posed])
        wj, vj = np.linalg.eigh(want.astype(np.float64))
        wt, vt = np.linalg.eigh(got.astype(np.float64))
        np.testing.assert_allclose(wt, wj, atol=1e-4)
        assert np.abs(np.sum(vt[..., 2] * vj[..., 2], axis=-1)).min() > 1 - 1e-4


def _hash_grids(fs, gicp: bool, mod):
    """The hash grids scan_matching builds outside cell_plane mode."""
    pitch = {"edge": TLS.edge_dist_thres, "sphere": TLS.sphere_dist_thres,
             "planar": TLS.gicp_dist_thres if gicp else TLS.planar_dist_thres,
             "ground": TLS.gicp_dist_thres if gicp else TLS.ground_dist_thres}
    return {k: mod.build_hash_grid(getattr(fs, k).xyz, getattr(fs, k).valid, v) for k, v in pitch.items()}


@pytest.mark.parametrize("mode", ["knn", "gicp", "gicp_coarse"])
def test_mode_correspondences_match(pair, mode):
    """kNN plane/line and GICP 1-NN correspondences (and a GICP coarse
    round's plane projections) at the prediction: masks exactly, targets
    and covariances to 1e-4; then, on the JAX correspondences, the GICP
    normal equations to 1e-4 relative. A kNN plane through 5 nearly
    collinear points (one ring arc: (lam1 - lam0) / lam2 < 1e-2) has no
    defined normal, and the two closed-form eigenvectors differ there
    (measured: 29 of 506 planes, all with that gap under 6e-3); the normals
    are compared on the other planes."""
    scan, submap, predict = pair
    gicp = mode != "knn"
    tls = dataclasses.replace(TLS, corr_mode="knn", plane_residual="gicp" if gicp else "point_to_plane")
    xi = jse3.log(jnp.asarray(predict))
    sc, sm = _to_torch_fs(scan), _to_torch_fs(submap)
    grids_t = _hash_grids(sm, gicp, tv)
    use_coarse = mode == "gicp_coarse"
    cells = lambda mod, m: mod._build_surf_cells(m.planar, tls.planar_dist_thres * tls.coarse_scale, 3072,  # noqa: E731
                                                 precise_thres=0.2 * tls.coarse_scale)
    covs_j = covs_t = None
    if gicp:
        names = (("scan_planar", scan.planar), ("scan_ground", scan.ground),
                 ("submap_planar", submap.planar), ("submap_ground", submap.ground))
        covs_j = {k: jax.jit(lambda c: jreg.calculate_covariances(c, tls.k_corr, max_per_cell=8))(c) for k, c in names}
        covs_t = {k: tt(np.asarray(v)) for k, v in covs_j.items()}
    if use_coarse:
        grids_t["planar_coarse"] = cells(treg, sm)

    def build_j(x, s, m, cj):
        g = _hash_grids(m, gicp, jv)
        if use_coarse:
            g["planar_coarse"] = cells(jreg, m)
        return jreg._build_correspondences(x, s, m, g, tls, cj, None, jnp.asarray(use_coarse) if gicp else None)

    corr_j = jax.jit(build_j)(xi, scan, submap, covs_j)
    posed = {"plane_n": np.ones(scan.planar.capacity, bool), "ground_n": np.ones(scan.ground.capacity, bool)}
    if not gicp:
        for name, s_c, m_c in (("plane_n", scan.planar, submap.planar), ("ground_n", scan.ground, submap.ground)):
            g = jv.build_hash_grid(m_c.xyz, m_c.valid, getattr(tls, name[:-2].replace("plane", "planar") + "_dist_thres"))
            pw = jse3.transform(jse3.exp(xi), s_c.xyz)
            idx, _, ok = jv.query_knn(g, pw, s_c.valid, k=5, radius=g.cell_size, max_per_cell=8)
            posed[name] = _gap(np.asarray(m_c.xyz, np.float64)[np.asarray(idx)], np.asarray(ok)) >= 1e-2
    corr_t = treg._build_correspondences(tt(np.asarray(xi)), sc, sm, grids_t, tls, use_coarse, covs_t)
    for name in ("plane_valid", "ground_valid", "edge_valid", "sphere_valid"):
        a, b = np_of(getattr(corr_t, name)), np.asarray(getattr(corr_j, name))
        assert b.sum() > 10, name
        assert np.array_equal(a, b), name
    for name, m in (("plane_n", corr_j.plane_valid), ("ground_n", corr_j.ground_valid),
                    ("edge_a", corr_j.edge_valid), ("plane_tgt_cov", corr_j.plane_valid),
                    ("ground_tgt_cov", corr_j.ground_valid)):
        if getattr(corr_j, name) is None:
            assert getattr(corr_t, name) is None
            continue
        m = np.asarray(m) & posed.get(name, True)
        assert m.sum() > 10, name
        np.testing.assert_allclose(np_of(getattr(corr_t, name))[m], np.asarray(getattr(corr_j, name))[m],
                                   atol=1e-4, err_msg=name)
    if not gicp:
        return
    rng = np.random.default_rng(0)
    wj = jreg._Weights(*(jnp.asarray(rng.uniform(0.3, 1.0, size=c.capacity), jnp.float32)
                         for c in (scan.planar, scan.ground, scan.edge, scan.sphere)))
    Hj, gj, cj = jreg._evaluate(xi, scan, corr_j, wj, tls.gicp_noise_bound)
    ct = treg._Corr(*(None if getattr(corr_j, f) is None else tt(np.asarray(getattr(corr_j, f)))
                      for f in treg._Corr._fields))
    Ht, gt, costs_t = treg._evaluate(tt(np.asarray(xi)), sc, ct, treg._Weights(*(tt(np.asarray(v)) for v in wj)),
                                     tls.gicp_noise_bound)
    _rel_close(Ht, Hj, err_msg="H")
    _rel_close(gt, gj, err_msg="g")
    for a, b in zip(costs_t, cj):
        _rel_close(a, b)


@pytest.fixture(scope="module")
def world():
    """(scan, submap, truth, prediction) as JAX FeatureSets over randomly
    sampled surfaces: a rippled ground, four walls, 12 poles and 100
    isolated points; the scan is a noisy subset seen from the truth.

    The solves are compared here and not on the ring scans of `pair`: a kNN
    plane or a GICP covariance through one ring arc (nearly collinear
    neighbours) has no defined normal, and the two closed-form eigen solvers
    turn a one-ulp difference of the covariance into normals up to 0.28
    apart (measured). Those planes still pass their gates, so the solves part
    after a round or two; random surfaces have no such neighbourhoods."""
    rng = np.random.default_rng(11)

    def plane(n, u, v, origin, du, dv):
        a, b = rng.uniform(0, 1, size=(2, n, 1))
        return origin + a * du * np.asarray(u) + b * dv * np.asarray(v)

    ground = plane(4000, [1, 0, 0], [0, 1, 0], np.array([-10.0, -10, 0]), 20, 20)
    ground[:, 2] += 0.02 * np.sin(ground[:, 0])
    planar = np.concatenate(
        [plane(2000, [0, 1, 0], [0, 0, 1], np.array([x, -10.0, 0]), 20, 4) for x in (-6, 6)]
        + [plane(1200, [1, 0, 0], [0, 0, 1], np.array([-5.0, y, 0]), 10, 4) for y in (-9, 9)]
    )
    poles = rng.uniform(-5, 5, size=(12, 2))
    edge = np.concatenate([np.stack([np.full(40, x), np.full(40, y), rng.uniform(0, 3, 40)], -1) for x, y in poles])
    edge[:, :2] += rng.normal(size=(len(edge), 2)) * 0.01
    sphere = np.stack([rng.uniform(-5, 5, 100), rng.uniform(-8, 8, 100), rng.uniform(0.5, 3, 100)], -1)

    truth = f32(jse3.exp(jnp.asarray(f32([0.3, -0.2, 0.05, 0.01, -0.01, 0.03]))))
    inv = np.linalg.inv(truth)
    cloud = lambda p, cap: JCloud.from_numpy(f32(p), capacity=cap, dtype=jnp.float32)  # noqa: E731

    def seen(p, n, cap):
        p = p[rng.choice(len(p), size=n, replace=False)]
        return cloud(p @ inv[:3, :3].T + inv[:3, 3] + rng.normal(size=p.shape) * 0.005, cap)

    submap = jreg.FeatureSet(edge=cloud(edge, 1024), sphere=cloud(sphere, 256), planar=cloud(planar, 8192),
                             ground=cloud(ground, 8192))
    scan = jreg.FeatureSet(edge=seen(edge, 400, 1024), sphere=seen(sphere, 100, 256),
                           planar=seen(planar, 1000, 1024), ground=seen(ground, 3000, 4096))
    return scan, submap, truth


@pytest.mark.parametrize(
    "corr_mode,plane_residual,mu_init,behind",
    [("knn", "point_to_plane", "residual", 0.15), ("cell_plane", "gicp", "residual", 0.15),
     ("knn", "gicp", "residual", 0.15), ("knn", "gicp", "residual", 0.03),
     ("cell_plane", "point_to_plane", "reference_zero", 0.15)],
)
def test_scan_matching_modes_match(world, corr_mode, plane_residual, mu_init, behind):
    """Every solver mode from a prediction `behind` metres (and 0.01 rad of
    yaw) short of the truth. The kNN point-to-plane solve has no coarse
    grid, and GICP turns off the alignment-gated mechanisms: 0.15 m short,
    GICP never passes its 0.1 m gate and alternates fine and coarse rounds
    (yaw fan, coarse plane projections); 0.03 m short it aligns and runs the
    GNC weights on its own scale. The traces are equal and the poses agree
    to 1e-4 (measured gap 5.3e-7) in every mode, GICP included."""
    scan, submap, truth = world
    xi = jse3.log(jnp.asarray(truth)) - jnp.asarray(f32([behind, 0, 0, 0, 0, 0.01]))
    predict = f32(jse3.exp(xi))
    tls = dataclasses.replace(TLS, corr_mode=corr_mode, plane_residual=plane_residual, mu_init=mu_init)
    pose_j, diag_j = jax.jit(lambda s, m, p: jreg.scan_matching(s, m, p, tls))(scan, submap, jnp.asarray(predict))
    pose_t, diag_t = treg.scan_matching(_to_torch_fs(scan), _to_torch_fs(submap), tt(predict), tls)
    assert int(diag_t.iterations) == int(diag_j.iterations)
    for name in ("corr_trace", "coarse_trace", "aligned_trace"):
        assert np.array_equal(np_of(getattr(diag_t, name)), np.asarray(getattr(diag_j, name))), name
    for name in ("degenerate", "misaligned", "never_aligned"):
        assert bool(getattr(diag_t, name)) == bool(getattr(diag_j, name)), name
    assert np.asarray(diag_j.corr_trace)[0, 0] > 500
    dxi = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(np.asarray(pose_j)) @ np_of(pose_t))))
    assert np.abs(dxi[:3]).max() < 1e-4 and np.abs(dxi[3:]).max() < 1e-4, dxi
    err = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(truth) @ np.asarray(pose_j))))
    assert np.abs(err).max() < 0.01, err


@pytest.mark.parametrize("factor_num", [3, 2])
def test_scan_matching_factor_num_matches(world, factor_num):
    """factor_num 3 drops the sphere family and 2 the edge family too
    (registration.cpp:517-559; the mode matrix's factor3): from a
    prediction 0.15 m and 0.01 rad short of the truth, the dropped families
    have no correspondence in either package, the traces are equal and the
    poses agree to 1e-4, as in test_scan_matching_modes_match."""
    scan, submap, truth = world
    xi = jse3.log(jnp.asarray(truth)) - jnp.asarray(f32([0.15, 0, 0, 0, 0, 0.01]))
    predict = f32(jse3.exp(xi))
    tls = dataclasses.replace(TLS, factor_num=factor_num)
    pose_j, diag_j = jax.jit(lambda s, m, p: jreg.scan_matching(s, m, p, tls))(scan, submap, jnp.asarray(predict))
    pose_t, diag_t = treg.scan_matching(_to_torch_fs(scan), _to_torch_fs(submap), tt(predict), tls)
    dropped = slice(3, 4) if factor_num == 3 else slice(2, 4)  # num_corr: planar, ground, edge, sphere
    assert not np.asarray(diag_j.num_corr)[dropped].any() and not np_of(diag_t.num_corr)[dropped].any()
    assert np.asarray(diag_j.num_corr)[:2].min() > 500
    assert int(diag_t.iterations) == int(diag_j.iterations)
    for name in ("corr_trace", "coarse_trace", "aligned_trace"):
        assert np.array_equal(np_of(getattr(diag_t, name)), np.asarray(getattr(diag_j, name))), name
    dxi = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(np.asarray(pose_j)) @ np_of(pose_t))))
    assert np.abs(dxi).max() < 1e-4, dxi
    err = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(truth) @ np.asarray(pose_j))))
    assert np.abs(err).max() < 0.01, err


def test_fitness_score_matches(pair):
    scan, submap, predict = pair
    sw = scan.transform(jnp.asarray(predict))
    fit_j, rmse_j = jax.jit(lambda a, b: jreg.fitness_score(a, b, dataclasses.replace(TLS, fitness_thres=0.3)))(
        sw, submap)
    fit_t, rmse_t = treg.fitness_score(_to_torch_fs(sw), _to_torch_fs(submap), dataclasses.replace(TLS, fitness_thres=0.3))
    assert float(fit_j) > 0.5
    np.testing.assert_allclose(float(fit_t), float(fit_j), rtol=1e-6)
    np.testing.assert_allclose(float(rmse_t), float(rmse_j), rtol=1e-4)
