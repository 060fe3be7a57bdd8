"""tloam_torch's Cloud methods, ops/cloud_ops.py, ops/factories.py and the
library ops of ops/voxel.py against the JAX package, on the CPU.

Integer, mask, trace and label outputs are exactly equal. Floats agree to
1e-5 (positions at the 10 m scale of these clouds: float32 sums and
products in another order), window moments to 1e-5 relative. The random
ops are compared through their deterministic parts, fed the JAX package's
own draws (jax.random.uniform and jax.random.choice under the same key).
Mirrors tests/test_cloud_ops.py, test_factories.py, test_cloud_voxel.py
(the cloud methods) and test_f32_far_origin.py (cell tables)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tloam_torch.cloud import Cloud as TCloud, map_tensors, stack_tensors
from tloam_torch.ops import cloud_ops as tops, factories as tfac, se3 as tse3, voxel as tv
from tloam_torch.pipeline import frontend as tfront

from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.ops import cloud_ops as jops, factories as jfac, se3 as jse3, voxel as jv

from tests.test_torch_common import f32, np_of, tt, two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads")

ATOL = 1e-5


def pair(xyz, inten=None, cap=None, normals=None, colors=None):
    """The same host data as a JAX Cloud and a port Cloud (CPU)."""
    kw = {k: None if v is None else f32(v) for k, v in (("normals", normals), ("colors", colors))}
    inten = None if inten is None else f32(inten)
    return (JCloud.from_numpy(f32(xyz), inten, capacity=cap, dtype=jnp.float32, **kw),
            TCloud.from_numpy(f32(xyz), inten, capacity=cap, device="cpu", **kw))


def assert_clouds_match(ct, cj, atol=ATOL):
    for name in ("xyz", "intensity", "valid", "normals", "colors"):
        a, b = getattr(ct, name), getattr(cj, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if b.dtype == jnp.bool_:
            assert np.array_equal(np_of(a), np.asarray(b)), name
        else:
            np.testing.assert_allclose(np_of(a), np.asarray(b), atol=atol, err_msg=name)


@pytest.fixture
def clouds(rng):
    n, cap = 200, 256
    xyz = rng.normal(size=(n, 3)) * 10.0
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    jc, tc = pair(xyz, rng.uniform(size=n), cap, normals=normals, colors=rng.uniform(size=(n, 3)))
    keep = rng.uniform(size=cap) < 0.7
    return jc.mask(jnp.asarray(keep)), tc.mask(tt(keep)), rng


# each case: (JAX op, port op) on (cloud, framework array constructor, rng)
CASES = {
    "transform": lambda c, A, r: c.transform(A(np.asarray(jse3.exp(jnp.asarray(r.normal(size=6) * 0.3))))),
    "translate": lambda c, A, r: c.translate(A(r.normal(size=3))),
    "rotate_about_centroid": lambda c, A, r: c.rotate(A(np.asarray(jse3.exp(jnp.asarray(r.normal(size=6))))[:3, :3])),
    "rotate_about_point": lambda c, A, r: c.rotate(A(np.asarray(jse3.exp(jnp.asarray(r.normal(size=6))))[:3, :3]),
                                                   A(r.normal(size=3))),
    "scale": lambda c, A, r: c.scale(1.7),
    "crop_obb": lambda c, A, r: c.crop_obb(A(r.normal(size=3)), A(np.asarray(jse3.exp(jnp.asarray(
        r.normal(size=6))))[:3, :3]), A([8.0, 5.0, 12.0])),
    "crop_aabb": lambda c, A, r: c.crop_aabb(A([-5.0, -8.0, -6.0]), A([9.0, 5.0, 7.0])),
    "compact": lambda c, A, r: c.compact(),
    "compact_shrink": lambda c, A, r: c.compact(150),
    "paint_uniform_color": lambda c, A, r: c.paint_uniform_color(A([0.2, 0.4, 0.8])),
    "concat_channel_in_one": lambda c, A, r: c.concat(c.compact(64)).concat(
        type(c)(c.xyz, c.intensity, c.valid)),
    "remove_close": lambda c, A, r: c.remove_close(9.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cloud_methods_match_jax(clouds, case):
    jc, tc, rng = clouds
    seed = int(rng.integers(1 << 30))
    A_j = lambda a: jnp.asarray(f32(a))  # noqa: E731
    assert_clouds_match(CASES[case](tc, tt, np.random.default_rng(seed)),
                        CASES[case](jc, A_j, np.random.default_rng(seed)))


def test_cloud_reductions_and_channels_match_jax(clouds):
    jc, tc, _ = clouds
    assert tc.has_normals and tc.has_colors and not TCloud.empty(4, device="cpu").has_normals
    for name in ("masked_mean", "min_bound", "max_bound", "masked_xyz"):
        np.testing.assert_allclose(np_of(getattr(tc, name)()), np.asarray(getattr(jc, name)()), atol=ATOL, err_msg=name)
    for a, b in zip(tc.mean_and_covariance(), jc.mean_and_covariance()):
        np.testing.assert_allclose(np_of(a), np.asarray(b), atol=1e-4)


def test_optional_channels_pass_through_trees_and_state(clouds):
    """map_tensors, stack_tensors, the health gate's select and the state's
    numpy exchange keep a cloud's normals and colors (and leave them absent
    where they are)."""
    _, tc, _ = clouds
    plain = TCloud(tc.xyz, tc.intensity, tc.valid)
    twice = map_tensors(tc, lambda t: t * 2 if t.dtype != torch.bool else t)
    assert torch.equal(twice.normals, tc.normals * 2) and torch.equal(twice.colors, tc.colors * 2)
    st = stack_tensors([tc, tc])
    assert st.normals.shape == (2,) + tc.normals.shape and stack_tensors([plain, plain]).normals is None
    sel = tfront._where_cloud(torch.tensor(False), twice, tc)
    assert torch.equal(sel.normals, tc.normals) and tfront._where_cloud(torch.tensor(True), plain, plain).colors is None
    cfg = tfront.PipelineConfig()
    state = tfront.init_state(cfg, device="cpu")
    state = state._replace(global_map=tc)
    back = tfront.state_from_numpy(tfront.state_to_numpy(state), device="cpu")
    assert torch.equal(back.global_map.normals, tc.normals) and torch.equal(back.global_map.colors, tc.colors)
    assert back.submap.edge_map.normals is None


def test_uniform_and_random_downsample_match_jax(rng):
    jc, tc = pair(rng.normal(size=(1000, 3)), cap=1024)
    assert np.array_equal(np_of(tops.uniform_downsample(tc, 5).valid),
                          np.asarray(jops.uniform_downsample(jc, 5).valid))
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(key, (1024,)))
    want = np.asarray(jops.random_downsample_count(jc, 100, key).valid)
    got = tops._keep_count_from_uniform(tt(u), tc.valid, 100)
    assert want.sum() == 100 and np.array_equal(np_of(got), want)
    # the port's own draws: a uniform of the cloud's capacity
    g = torch.Generator().manual_seed(3)
    u_t = torch.rand(1024, generator=torch.Generator().manual_seed(3))
    out = tops.random_downsample_ratio(tc, 0.3, g)
    assert torch.equal(out.valid, tc.valid & (u_t < 0.3)) and 200 < int(out.count()) < 400
    assert int(tops.random_downsample_count(tc, 100, torch.Generator().manual_seed(4)).count()) == 100


def test_voxel_downsample_and_trace_matches_jax(rng):
    pts = rng.uniform(-2, 2, size=(400, 3))
    pts[200:230] = pts[:30]  # shared voxels far apart in the input order
    jc, tc = pair(pts, rng.uniform(size=400), 512)
    keep = np.arange(512) % 9 != 4
    jc, tc = jc.mask(jnp.asarray(keep)), tc.mask(tt(keep))
    for max_out in (256, 40):  # 40 < the voxel count: the tail is dropped
        oj, trj = jops.voxel_downsample_and_trace(jc, 1.0, max_out)
        ot, trt = tops.voxel_downsample_and_trace(tc, 1.0, max_out)
        assert np.array_equal(np_of(trt), np.asarray(trj))
        assert_clouds_match(ot, oj)


def test_outlier_removal_matches_jax(rng):
    dense = rng.normal(size=(300, 3))
    lonely = np.array([[30.0, 0, 0], [50.0, 50, 50], [-40, 0, 0]])
    jc, tc = pair(np.concatenate([dense, lonely]), cap=512)
    for nb, r in ((5, 1.0), (12, 0.6)):
        assert np.array_equal(np_of(tops.remove_radius_outliers(tc, nb, r).valid),
                              np.asarray(jops.remove_radius_outliers(jc, nb, r).valid))
    # The radius 4 cbrt(vol / n) sets the hash cell. XLA's float32 cube root
    # is not correctly rounded (it is 1-2 ulp from the float64 root rounded
    # once, which the port takes on every device, in most inputs), so the
    # cells may shift by a rounding. This test holds that no cell is filled
    # past its cap (max_per_cell 256 here; the default 16 overflows at this
    # radius, about 4 point spacings): then every neighbour within the
    # radius is found whatever the exact cell boundaries, and the keep-sets
    # must be equal.
    span = jc.max_bound() - jc.min_bound()
    r_j = float(4.0 * jnp.cbrt(jnp.maximum(jnp.prod(span), 1e-9) / jnp.maximum(jc.count(), 1)))
    r_t = float(tops.statistical_radius(tc))
    assert abs(r_t - r_j) <= 2 * np.spacing(np.float32(r_j))
    cap = 256
    for r in (r_t, r_j):
        grid = tv.build_hash_grid(tc.xyz, tc.valid, r)
        assert int((grid.dt.payload[grid.dt.check != tv._SENTINEL] & 255).max()) < cap
    for nb, ratio in ((10, 2.0), (6, 1.0)):
        want = np.asarray(jops.remove_statistical_outliers(jc, nb, ratio, max_per_cell=cap).valid)
        got = np_of(tops.remove_statistical_outliers(tc, nb, ratio, max_per_cell=cap).valid)
        assert np.array_equal(got, want) and not want[300:303].any() and want[:300].mean() > 0.8


def test_normals_match_jax(rng):
    pts = np.concatenate([rng.uniform(-2, 2, size=(400, 2)), rng.normal(size=(400, 1)) * 0.01], axis=1)
    jc, tc = pair(pts, cap=512)
    nj = jops.estimate_normals(jc, radius=0.5, max_nn=16)
    nt = tops.estimate_normals(tc, radius=0.5, max_nn=16)
    v = np.asarray(jc.valid)
    np.testing.assert_allclose(np_of(nt.normals)[v], np.asarray(nj.normals)[v], atol=1e-4)
    # orientation: both from the JAX normals, so the signs are exactly equal
    tc_n = dataclasses.replace(tc, normals=tt(np.asarray(nj.normals)))
    for fj, ft, arg in ((jops.orient_normals_towards, tops.orient_normals_towards, [0.0, 0.0, 10.0]),
                        (jops.orient_normals_direction, tops.orient_normals_direction, [0.0, 0.3, -1.0])):
        assert np.array_equal(np_of(ft(tc_n, tt(f32(arg))).normals), np.asarray(fj(nj, jnp.asarray(f32(arg))).normals))
    with pytest.raises(ValueError, match="no normals"):
        tops.orient_normals_towards(tc, tt(f32([0, 0, 1])))
    u = rng.normal(size=(120, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    flips = u * rng.choice([-1.0, 1.0], size=(120, 1))
    assert np.array_equal(tops.orient_normals_consistent(u * 5.0, flips, k=8),
                          jops.orient_normals_consistent(u * 5.0, flips, k=8))


@pytest.mark.parametrize("cc_iters", [64, 3])
def test_cluster_dbscan_matches_jax(rng, cc_iters):
    """Two blobs, noise, and a 60-point chain whose labels need more rounds
    than one convergence check covers; with cc_iters = 3 both packages stop
    before convergence and must still agree."""
    a = rng.normal(size=(150, 3)) * 0.2
    b = rng.normal(size=(150, 3)) * 0.2 + np.array([10.0, 0, 0])
    chain = np.stack([np.linspace(0, 18, 60), np.full(60, 6.0), np.zeros(60)], axis=1)
    noise = np.array([[5.0, 5, 5], [-5, -5, 5]])
    jc, tc = pair(np.concatenate([a, b, chain, noise]), cap=512)
    want = np.asarray(jops.cluster_dbscan(jc, eps=0.5, min_points=3, cc_iters=cc_iters))
    got = np_of(tops.cluster_dbscan(tc, eps=0.5, min_points=3, cc_iters=cc_iters))
    assert np.array_equal(got, want) and got.dtype == np.int32
    assert len(np.unique(want[want >= 0])) >= 3 and (want[360:] == -1).all()


def test_ransac_matches_jax_through_its_draws(rng):
    ground = np.concatenate([rng.uniform(-5, 5, size=(400, 2)), np.full((400, 1), 2.0)], axis=1)
    ground += rng.normal(size=ground.shape) * 0.01
    clutter = rng.uniform(-5, 5, size=(100, 3))
    jc, tc = pair(np.concatenate([ground, clutter]), cap=512)
    key = jax.random.PRNGKey(1)
    H = 64
    p = jc.valid / jnp.maximum(jnp.sum(jc.valid), 1)
    tri = np.asarray(jax.random.choice(key, 512, shape=(H, 3), p=p, replace=True))
    plane_j, inl_j = jops.segment_plane_ransac(jc, 0.05, 3, H, key)
    plane_t, inl_t = tops._ransac_from_triples(tc, tt(tri).long(), 0.05)
    assert np.array_equal(np_of(inl_t), np.asarray(inl_j)) and np.asarray(inl_j)[:400].mean() > 0.97
    np.testing.assert_allclose(np_of(plane_t), np.asarray(plane_j), atol=1e-4)
    plane_g, inl_g = tops.segment_plane_ransac(tc, 0.05, 3, H, torch.Generator().manual_seed(0))
    assert np_of(inl_g)[:400].mean() > 0.97 and abs(abs(float(plane_g[2])) - 1.0) < 1e-3


def test_distances_match_jax(rng):
    jc, tc = pair(rng.normal(size=(50, 3)), cap=64)
    far = f32([0.5, 0.0, 0.0])
    for got, want in (
        (tops.point_cloud_distance(tc.translate(tt(far)), tc, radius=3.0),
         jops.point_cloud_distance(jc.translate(jnp.asarray(far)), jc, radius=3.0)),
        (tops.point_cloud_distance(tc.translate(tt(far * 20)), tc, radius=3.0),
         jops.point_cloud_distance(jc.translate(jnp.asarray(far * 20)), jc, radius=3.0)),
        (tops.mahalanobis_distance(tc), jops.mahalanobis_distance(jc)),
        (tops.nearest_neighbor_distance(tc, radius=5.0), jops.nearest_neighbor_distance(jc, radius=5.0)),
    ):
        got, want = np_of(got), np.asarray(want)
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-4)


def test_hull_utilities_match_jax(rng):
    u = rng.normal(size=(300, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    for a, b in zip(tops.convex_hull(u), jops.convex_hull(u)):
        assert np.array_equal(a, b)
    cam = np.array([10.0, 0, 0])
    assert np.array_equal(tops.hidden_point_removal(u * 2, cam, 100.0), jops.hidden_point_removal(u * 2, cam, 100.0))


def test_factories_match_jax(rng):
    H, W = 24, 32
    depth = f32(rng.uniform(1.0, 4.0, size=(H, W)))
    depth[0, 0], depth[1, 1], depth[2, 2] = 0.0, np.nan, 9.0  # invalid, non-finite, truncated
    intr = (30.0, 31.0, 15.5, 12.0)
    T = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6) * 0.2)), np.float32)
    for stride, ext in ((1, None), (2, T)):
        cj = jfac.cloud_from_depth_image(jnp.asarray(depth), intr, None if ext is None else jnp.asarray(ext),
                                         stride=stride, depth_trunc=5.0)
        ct = tfac.cloud_from_depth_image(tt(depth), intr, None if ext is None else tt(ext), stride=stride,
                                         depth_trunc=5.0)
        assert_clouds_match(ct, cj, atol=1e-4)
    for color in (rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8), f32(rng.uniform(size=(H, W, 1)))):
        assert_clouds_match(tfac.cloud_from_rgbd(tt(depth), tt(color), intr),
                            jfac.cloud_from_rgbd(jnp.asarray(depth), jnp.asarray(color), intr))
    idx = rng.integers(-5, 5, size=(20, 3)).astype(np.int32)
    col = f32(rng.uniform(size=(20, 3)))
    assert_clouds_match(
        tfac.cloud_from_voxel_grid(tt(idx), 0.5, tt(f32([10.0, 0.0, -1.0])), colors=tt(col)),
        jfac.cloud_from_voxel_grid(jnp.asarray(idx), 0.5, jnp.asarray(f32([10.0, 0.0, -1.0])), colors=jnp.asarray(col)))


def test_se3_identity_and_ring_intensity_match_jax(rng):
    from tloam_torch.models import segmentation as tseg
    from tloam_tpu.models import segmentation as jseg

    assert np.array_equal(np_of(tse3.identity(batch=(2, 3))), np.asarray(jse3.identity(jnp.float32, (2, 3))))
    jc, tc = pair(rng.normal(size=(40, 3)), rng.uniform(0, 5, size=40), 48)
    ring = rng.integers(0, 64, size=48).astype(np.int32)
    assert_clouds_match(tseg.attach_ring_intensity(tc, tt(ring)), jseg.attach_ring_intensity(jc, jnp.asarray(ring)))


def test_record_packing_matches_jax(rng):
    cols = f32(rng.normal(size=(10, 37)))
    cols[3, 5] = -0.0
    for width in (16, 32):
        pj = jv.pack_records(jnp.asarray(cols), width)
        pt = tv.pack_records(tt(cols), width)
        assert np.array_equal(np_of(pt), np.asarray(pj))
        assert np.array_equal(np_of(tv.unpack_records(pt, 10, width)), np.asarray(jv.unpack_records(pj, 10, width)))
        idx = rng.integers(0, 37, size=50).astype(np.int32)
        assert np.array_equal(np_of(tv.gather_records(pt, tt(idx), width, 7)),
                              np.asarray(jv.gather_records(pj, jnp.asarray(idx), width, 7)))


def test_block_window_records_match_jax(rng):
    pts = f32(rng.uniform(-3, 3, size=(600, 3)))
    valid = np.ones(600, bool)
    valid[::11] = False
    bj = jv.build_block_table(jnp.asarray(pts), jnp.asarray(valid), 0.5, 1024)
    bt = tv.build_block_table(tt(pts), tt(valid), 0.5, 1024)
    vals = f32(rng.normal(size=(1024, 10)))
    sj = jv.scatter_cell_records(bj, jnp.asarray(vals))
    st = tv.scatter_cell_records(bt, tt(vals))
    rows_j, found_j = jv.block_window_probe_rows(bj, bj.cx, bj.cy, bj.cz)
    rows_t, found_t = tv.block_window_probe_rows(bt, bt.cx, bt.cy, bt.cz)
    assert np.array_equal(np_of(found_t), np.asarray(found_j))
    assert np.array_equal(np_of(tv.block_window_records(st, rows_t, found_t)),
                          np.asarray(jv.block_window_records(sj, rows_j, found_j)))


FAR = np.array([310.0, -240.0, 0.0])  # hundreds of metres from the origin


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_cell_table_and_anchored_moments_match_jax(rng, offset):
    wy, wz = np.meshgrid(np.linspace(-3, 3, 70), np.linspace(0, 2, 26))
    wall = np.stack([np.zeros(wy.size), wy.ravel(), wz.ravel()], -1)
    pts = f32(wall + rng.normal(size=wall.shape) * 0.002 + offset * FAR)
    valid = np.ones(len(pts), bool)
    valid[::13] = False
    tj = jv.build_cell_table(jnp.asarray(pts), jnp.asarray(valid), 0.5, 512)
    tt_ = tv.build_cell_table(tt(pts), tt(valid), 0.5, 512)
    for name in ("cx", "cy", "cz", "cell_valid", "point_cell"):
        assert np.array_equal(np_of(getattr(tt_, name)), np.asarray(getattr(tj, name))), name
    nj = jv.cell_neighbor_index(tj)
    nt = tv.cell_neighbor_index(tt_)
    assert np.array_equal(np_of(nt), np.asarray(nj)) and (np.asarray(nj) >= 0).sum(1).max() > 1
    aj, mj = jv.anchored_window_moments(jnp.asarray(pts), jnp.asarray(valid), tj, nj, 0.5)
    at, mt = tv.anchored_window_moments(tt(pts), tt(valid), tt_, nt, 0.5)
    for a, b in zip(at, aj):
        assert np.array_equal(np_of(a), np.asarray(b))
    for a, b in zip(mt, mj):
        b = np.asarray(b)
        np.testing.assert_allclose(np_of(a), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
