"""The non-default feature paths of the port against the JAX package on the
small scan of tests/test_torch_models.py (24 rings x 768 azimuth steps):
exact per-point kNN PCA, the sphere-index bug under both PCA modes, the
chunked kNN query and the planar coverage fill's voxel_select_top.

Integer and mask outputs match exactly (has_info, num_neigh, the four
selection masks, kNN indices, keep-sets); cvr, flatness and sphericity to
1e-5; selected points bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tloam_torch.config import PipelineConfig as TCfg
from tloam_torch.models import features as tfeat
from tloam_torch.ops import voxel as tv

from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.models import edge as jedge, features as jfeat
from tloam_tpu.ops import voxel as jv
from tloam_tpu.pipeline.frontend import PipelineConfig as JCfg

from tests.test_torch_common import f32, jcloud_to_torch, np_of, tt
from tests.test_torch_models import _edge_inputs, frame  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def general(frame):  # noqa: F811
    """The general (non-edge) cloud of the small scan, as the JAX edge stage
    leaves it (the input of the feature stage), compacted, with 12 blobs
    of 100 points, uniform in balls of 0.3 m, added: 24-ring scans carry no
    sphere features. The sphere class hangs on a local-max gate (cvr >= the
    cvr of every neighbour, or of every neighbour cell); a pair whose cvr
    agree to the last bits is decided by rounding, and the two packages
    round differently (measured: one such pair with 60-point blobs in 0.4 m
    balls). These blobs hold no such pair in either PCA mode."""
    cloud_j, ring, okey = _edge_inputs(frame)
    ej = jax.jit(lambda c, r, o: jedge.extract_edges(c, r, o, ring_min_num=131, ring_width=1024))(
        cloud_j, jnp.asarray(ring), jnp.asarray(okey))
    g = cloud_j.mask(ej.general_mask)
    keep = np.asarray(g.valid)
    rng = np.random.default_rng(4)
    centres = rng.uniform([-15, -15, 0.5], [15, 15, 2.5], size=(12, 3))
    d = rng.normal(size=(12, 100, 3))
    d *= 0.3 * rng.uniform(size=(12, 100, 1)) ** (1 / 3) / np.linalg.norm(d, axis=-1, keepdims=True)
    blobs = (centres[:, None] + d).reshape(-1, 3)
    xyz = np.concatenate([np.asarray(g.xyz)[keep], blobs])
    inten = np.concatenate([np.asarray(g.intensity)[keep], np.ones(len(blobs))])
    return JCloud.from_numpy(f32(xyz), f32(inten), capacity=g.capacity, dtype=jnp.float32)


@pytest.mark.parametrize("pca_mode,bug", [("exact", False), ("exact", True), ("cell", True)])
def test_feature_modes_match(general, pca_mode, bug):
    """Exact PCA scalars and every selection mask; with the sphere-index bug
    the sphere masks are the first slots of the cloud."""
    gj = general
    jc = dataclasses.replace(JCfg().feature, pca_mode=pca_mode)
    tc = dataclasses.replace(TCfg().feature, pca_mode=pca_mode)
    sel_j = jax.jit(lambda c: jfeat.extract_planar_sphere(c, jc, sphere_index_bug=bug))(gj)
    sel_t = tfeat.extract_planar_sphere(jcloud_to_torch(gj), tc, sphere_index_bug=bug)
    pj, pt = sel_j.pca, sel_t.pca
    hi = np.asarray(pj.has_info)
    assert hi.sum() > 500 and np.array_equal(np_of(pt.has_info), hi)
    assert np.array_equal(np_of(pt.num_neigh), np.asarray(pj.num_neigh))
    for name in ("cvr", "flatness", "sphericity"):
        a, b = np_of(getattr(pt, name))[hi], np.asarray(getattr(pj, name))[hi]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("planar_scan", "planar_submap", "sphere_scan", "sphere_submap"):
        b = np.asarray(getattr(sel_j, name))
        assert b.sum() > 0, name
        assert np.array_equal(np_of(getattr(sel_t, name)), b), name
    if bug:
        n = int(np.asarray(sel_j.sphere_submap).sum())
        assert np.asarray(sel_j.sphere_submap)[: n - 1].all()
    if pca_mode == "exact":
        # the local-max gate over the point's own neighbour set, where it
        # decides the sphere class (elsewhere near-zero cvr ties abound)
        idx, ok = np.asarray(pj.neigh_idx), np.asarray(pj.neigh_ok)
        cvr = np.asarray(pj.cvr)
        want = np.all(~ok | (cvr[:, None] >= cvr[idx]), axis=-1)
        cand = hi & ~np.asarray(sel_j.planar_submap) & (cvr > jc.cvr_submap)
        assert cand.sum() > 50
        assert np.array_equal(np_of(pt.local_max)[cand], want[cand])


def test_chunked_query_knn_matches(general):
    """Exact PCA's query (k=20, 16 a cell, 432 candidates a query) in
    chunks equals the unchunked query, and its indices equal JAX's."""
    gj = general
    cfg = JCfg().feature
    xyz, valid = np.asarray(gj.xyz), np.asarray(gj.valid)
    gt = tv.build_hash_grid(tt(xyz), tt(valid), cfg.radius)
    whole = tv.query_knn(gt, tt(xyz), tt(valid), k=cfg.k, radius=cfg.radius, max_per_cell=16)
    chunked = tv.query_knn(gt, tt(xyz), tt(valid), k=cfg.k, radius=cfg.radius, max_per_cell=16, chunk_size=1000)
    for a, b in zip(whole, chunked):
        assert np.array_equal(np_of(a), np_of(b))
    ij, dj, okj = jax.jit(lambda p, v: jv.query_knn(
        jv.build_hash_grid(p, v, cfg.radius), p, v, k=cfg.k, radius=cfg.radius, max_per_cell=16, chunk_size=1000
    ))(jnp.asarray(xyz), jnp.asarray(valid))
    okj = np.asarray(okj)
    assert okj.sum() > 10000
    assert np.array_equal(np_of(chunked[2]), okj)
    assert np.array_equal(np_of(chunked[0])[okj], np.asarray(ij)[okj])
    np.testing.assert_allclose(np_of(chunked[1])[okj], np.asarray(dj)[okj], rtol=1e-5)
    xt, yt, zt = tv.gather_planes(tt(xyz), chunked[0])
    assert np.array_equal(np_of(yt), xyz[:, 1][np_of(chunked[0])])


@pytest.mark.parametrize("max_out", [1024, 150])
def test_voxel_select_top_matches(general, rng, max_out):
    """The planar coverage fill on the real general cloud (its flatness as
    the score), with room for every voxel and with uniform thinning."""
    gj = general
    xyz, inten, valid = (np.asarray(a) for a in (gj.xyz, gj.intensity, gj.valid))
    score = f32(rng.uniform(size=len(xyz)))
    score[::5] = score[1::5]  # exact ties inside a voxel
    oj = jv.voxel_select_top(*(jnp.asarray(a) for a in (xyz, inten, valid, score)), 0.6, max_out)
    ot = tv.voxel_select_top(*(tt(a) for a in (xyz, inten, valid, score)), 0.6, max_out)
    assert np.asarray(oj[2]).sum() >= min(max_out, 150)
    for a, b in zip(ot, oj):
        assert np.array_equal(np_of(a), np.asarray(b))
