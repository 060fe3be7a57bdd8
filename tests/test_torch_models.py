"""tloam_torch.models (segmentation, dcvc, edge, features) against the JAX
package on a small synthetic scan (24 rings x 768 azimuth steps).

Integer and mask outputs must match exactly: ring ids, ground/object masks,
DCVC labels and boxes, edge/general masks, feature class masks and
selections. Floats: PCA scalars and plane fits 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tloam_torch.config import PipelineConfig as TCfg
from tloam_torch.models import dcvc as tdcvc, edge as tedge, features as tfeat, segmentation as tseg

from tloam_tpu.models import dcvc as jdcvc, edge as jedge, features as jfeat, segmentation as jseg
from tloam_tpu.pipeline.frontend import PipelineConfig as JCfg

from tests.test_torch_common import clouds_from_numpy, jcloud_to_torch, np_of, small_scan, tt
from tests.test_torch_cuda import SETTINGS, boundary_rows

CAP = 24 * 768


@pytest.fixture(scope="module")
def frame():
    """One small scan taken through the JAX stages up to each module's
    input: (raw, ground-seg result, objects, ring, dcvc result)."""
    cfg = JCfg()
    xyz, inten = small_scan(1)
    cj, _ = clouds_from_numpy(xyz, inten, CAP)
    cj = cj.remove_nonfinite().remove_close(cfg.sensor.near_dis)
    seg = jax.jit(lambda c: jseg.ground_remove(c, cfg.sensor, cfg.ground))(cj)
    cl = jax.jit(lambda c: jdcvc.dcvc_segment(c, cfg.dcvc, cfg.sensor, 16384, 64, cc_iters=6))(seg.objects)
    return cj, seg, cl


def test_ground_remove_matches(frame):
    cj, seg_j, _ = frame
    cfg = TCfg()
    seg_t = tseg.ground_remove(jcloud_to_torch(cj), cfg.sensor, cfg.ground)
    assert np.array_equal(np_of(seg_t.ring), np.asarray(seg_j.ring))
    assert np.array_equal(np_of(seg_t.ground.valid), np.asarray(seg_j.ground.valid))
    assert np.array_equal(np_of(seg_t.objects.valid), np.asarray(seg_j.objects.valid))
    assert np.array_equal(np_of(seg_t.objects.intensity), np.asarray(seg_j.objects.intensity))
    pj = np.asarray(seg_j.planes)
    np.testing.assert_allclose(np_of(seg_t.planes), pj, rtol=1e-5, atol=1e-5 * np.abs(pj).max())
    assert np.asarray(seg_j.ground.valid).sum() > 1000


def test_weighted_axis_plane_matches(rng):
    pts = rng.normal(size=(40, 50, 3)) * [4.0, 3.0, 0.1]
    m = np.concatenate([pts.sum(1), (pts[..., :, None] * pts[..., None, :]).sum(1)[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]],
                        np.full((40, 1), 50.0)], axis=1).astype(np.float32)
    a = np_of(tseg.weighted_axis_plane(tt(m)))
    b = np.asarray(jseg.weighted_axis_plane(jnp.asarray(m)))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_dcvc_matches(frame):
    _, seg_j, cl_j = frame
    cfg = TCfg()
    cl_t = tdcvc.dcvc_segment(jcloud_to_torch(seg_j.objects), cfg.dcvc, cfg.sensor, 16384, 64, cc_iters=6)
    lab = np.asarray(cl_j.labels)
    assert lab.max() >= 3
    assert np.array_equal(np_of(cl_t.labels), lab)
    assert int(cl_t.num_clusters) == int(cl_j.num_clusters)
    bv = np.asarray(cl_j.box_valid)
    assert np.array_equal(np_of(cl_t.box_valid), bv)
    np.testing.assert_array_equal(np_of(cl_t.box_min)[bv], np.asarray(cl_j.box_min)[bv])
    np.testing.assert_array_equal(np_of(cl_t.box_max)[bv], np.asarray(cl_j.box_max)[bv])
    assert np.array_equal(np_of(cl_t.segmented.valid), np.asarray(cl_j.segmented.valid))


def _edge_inputs(frame):
    _, seg_j, cl_j = frame
    n = seg_j.objects.capacity
    okey = np.asarray(cl_j.labels).astype(np.int32) * n + np.arange(n, dtype=np.int32)
    return cl_j.segmented, np.asarray(seg_j.ring), okey


def test_extract_edges_plain_matches_jax(frame):
    """extract_edges with the plain pick rounds (the CUDA kernel's CPU twin)
    against the JAX XLA branch — the bit-parity twin of the Pallas kernel
    (tests/test_preprocessing.py:300)."""
    cloud_j, ring, okey = _edge_inputs(frame)
    kw = dict(sensor_model=64, ring_min_num=131, ring_width=1024)
    out_t = tedge.extract_edges(jcloud_to_torch(cloud_j), tt(ring), tt(okey), **kw)
    out_x = jax.jit(lambda c, r, o: jedge.extract_edges(c, r, o, **kw))(
        cloud_j, jnp.asarray(ring), jnp.asarray(okey))
    assert np.asarray(out_x.edge_mask).sum() > 50
    assert np.array_equal(np_of(out_t.edge_mask), np.asarray(out_x.edge_mask))
    assert np.array_equal(np_of(out_t.general_mask), np.asarray(out_x.general_mask))
    cx = np.asarray(out_x.curvature)
    np.testing.assert_allclose(np_of(out_t.curvature), cx, rtol=1e-5, atol=1e-6 * cx.max())


@pytest.mark.parametrize("num_sectors,picks", SETTINGS)
def test_pick_rounds_plain_matches_jax_dense_path(rng, num_sectors, picks):
    """Dense planes with short rings, rings longer than W (cyclic taps),
    exact curvature ties and picks within 5 columns of the sector
    boundaries (chains that cross sectors), under the sector settings the
    CUDA kernel maps to warps in different ways: the plain pick rounds
    equal the Pallas kernel run in interpreter mode, and the curvature
    plane equals _dense_geometry."""
    R, W = 16, 512
    xs, ys, zs, val = (np.zeros((R, W), np.float32) for _ in range(4))
    lens = np.array([100, 530, 400, 512, 300, 600, 200, 450, 512, 300, 450, 530, 200, 400, 600, 333], np.int32)
    for p, b in zip((xs, ys, zs, val), boundary_rows(rng, lens[8:], W, num_sectors)):
        p[8:] = b
    for r in range(8):
        m = min(lens[r], W)
        if r % 2:
            x = np.arange(m) * 0.25
            x[rng.choice(np.arange(10, m - 10), 12, replace=False)] += 1.0  # identical spikes
            y = np.full(m, 3.0)
        else:
            az = np.linspace(0, 2 * np.pi, m, endpoint=False)
            rad = 7.0 + rng.normal(size=m) * 0.03
            rad[rng.choice(m, 15, replace=False)] -= 1.5
            x, y = rad * np.cos(az), rad * np.sin(az)
        xs[r, :m], ys[r, :m], zs[r, :m], val[r, :m] = x, y, 0.1 * r, 1.0
    kw = dict(num_sectors=num_sectors, picks_per_sector=picks, curv_thres=0.1, suppress_gap_sq=0.05, ring_min_num=131)
    e_t, p_t, c_t = tedge._pick_rounds_plain(tt(xs), tt(ys), tt(zs), tt(val), tt(lens), **kw)
    lenr = np.zeros((R, 128), np.float32)
    lenr[:, 0] = lens
    e_j, p_j = jax.jit(lambda *a: jedge._pick_rounds_pallas(*a, **kw, interpret=True))(
        *(jnp.asarray(a) for a in (xs, ys, zs, val, lenr)))
    assert np.asarray(e_j).sum() > 30
    assert np.asarray(e_j)[8:].sum() > 5 * num_sectors  # the boundary rows pick too
    assert np.array_equal(np_of(e_t), np.asarray(e_j))
    assert np.array_equal(np_of(p_t), np.asarray(p_j))
    d_j, _, _ = jedge._dense_geometry(*(jnp.asarray(a) for a in (xs, ys, zs, val)), jnp.asarray(lenr[:, :1]),
                                      num_sectors=num_sectors, ring_min_num=131)
    np.testing.assert_allclose(np_of(c_t), np.asarray(d_j), rtol=1e-6)


def test_features_match(frame):
    """Cell PCA, class masks, top-k selections and the sector picks."""
    cloud_j, ring, okey = _edge_inputs(frame)
    cfg = JCfg()
    ej = jax.jit(lambda c, r, o: jedge.extract_edges(c, r, o, ring_min_num=131, ring_width=1024))(
        cloud_j, jnp.asarray(ring), jnp.asarray(okey))
    gj = cloud_j.mask(ej.general_mask)
    sel_j = jax.jit(lambda c: jfeat.extract_planar_sphere(c, cfg.feature))(gj)
    gt = jcloud_to_torch(gj)
    sel_t = tfeat.extract_planar_sphere(gt, TCfg().feature)
    pj, pt = sel_j.pca, sel_t.pca
    hi = np.asarray(pj.has_info)
    assert hi.sum() > 500 and np.array_equal(np_of(pt.has_info), hi)
    for name in ("cvr", "flatness", "sphericity"):
        a, b = np_of(getattr(pt, name))[hi], np.asarray(getattr(pj, name))[hi]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
    nj = np.asarray(pj.normal)[hi]
    dots = np.abs(np.sum(np_of(pt.normal)[hi] * nj, axis=-1))
    assert np.quantile(dots, 0.99) > 1 - 1e-5
    assert np.array_equal(np_of(pt.num_neigh), np.asarray(pj.num_neigh))
    for name in ("planar_scan", "planar_submap", "sphere_scan", "sphere_submap"):
        assert np.array_equal(np_of(getattr(sel_t, name)), np.asarray(getattr(sel_j, name))), name
    flat = np.asarray(pj.flatness)
    for mask, cap, sectors in ((sel_j.planar_submap, 2048, 16), (sel_j.sphere_scan, 256, 16), (sel_j.planar_scan, 400, 0)):
        oj = jfeat.gather_top(gj, mask, jnp.asarray(flat), cap, sectors=sectors)
        ot = tfeat.gather_top(gt, tt(np.asarray(mask)), tt(flat), cap, sectors=sectors)
        assert np.array_equal(np_of(ot.valid), np.asarray(oj.valid))
        np.testing.assert_array_equal(np_of(ot.xyz), np.asarray(oj.xyz))
    key = np.random.default_rng(3).integers(-5, 1100, size=5000).astype(np.int32)
    assert np.array_equal(np_of(tfeat.matmul_histogram(tt(key), 1024)),
                          np.asarray(jfeat.matmul_histogram(jnp.asarray(key), 1024)))
