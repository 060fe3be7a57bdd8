"""tloam_torch.ops.voxel against tloam_tpu.ops.voxel.

Integer outputs (hashes, tables, keep-sets, neighbour indices) match
exactly; voxel_downsample positions to 1e-6 m; window moments to 1e-5
relative (float32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tloam_torch.ops import voxel as tv

from tloam_tpu.ops import voxel as jv

from tests.test_torch_common import f32, np_of, small_scan, tt


def test_int32_hash_wraps_like_xla(rng):
    c = rng.integers(-20000, 20000, size=(4000, 3)).astype(np.int32)
    c[:3] = [[2**31 - 1] * 3, [-(2**31)] * 3, [2**30, -(2**30), 12345]]
    np.testing.assert_array_equal(np_of(tv._hash_coords(tt(c))), np.asarray(jv._hash_coords(jnp.asarray(c))))
    np.testing.assert_array_equal(
        np_of(tv._hash2_parts(tt(c[:, 0]), tt(c[:, 1]), tt(c[:, 2]))),
        np.asarray(jv._hash2_parts(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]), jnp.asarray(c[:, 2]))),
    )
    h1 = np.asarray(jv._hash_coords(jnp.asarray(c)))
    h2 = np.asarray(jv._hash2_coords(jnp.asarray(c)))
    np.testing.assert_array_equal(np_of(tv._check_code(tt(h1), tt(h2))), np.asarray(jv._check_code(jnp.asarray(h1), jnp.asarray(h2))))
    np.testing.assert_array_equal(
        np_of(tv._block_hashes(tt(c[:, 0]), tt(c[:, 1]), tt(c[:, 2]))[0]),
        np.asarray(jv._block_hashes(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]), jnp.asarray(c[:, 2]))[0]),
    )


@pytest.mark.parametrize("voxel_size,max_out", [(0.3, 4096), (0.3, 300), (1e-4, 8192)])
def test_voxel_downsample_matches(rng, voxel_size, max_out):
    xyz, inten = small_scan(0)
    n = 8192
    xyz = f32(xyz[:n])
    valid = np.ones(n, bool)
    valid[::7] = False
    inten = f32(rng.uniform(size=n) * 3)
    # op by op: under jit XLA re-associates the mean's divisions (a few ulp)
    oj = jv.voxel_downsample(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(valid), voxel_size, max_out)
    ot = tv.voxel_downsample(tt(xyz), tt(inten), tt(valid), voxel_size, max_out)
    assert np.array_equal(np_of(ot[2]), np.asarray(oj[2]))  # keep-set
    np.testing.assert_allclose(np_of(ot[0]), np.asarray(oj[0]), atol=1e-6)
    # intensity: within one fixed-point quantum 1/qi. XLA:CPU's exp2(15.0)
    # returns 32767.984, not the power of two 32768 the quantizer means
    # (the port's torch.exp2 is exact), so the JAX means carry that error.
    qi = 2.0 ** np.floor(np.log2(2**30 / (n * np.abs(inten[valid]).max())))
    np.testing.assert_allclose(np_of(ot[1]), np.asarray(oj[1]), atol=1e-6 + 1.0 / qi)


def test_sort_with_payload_and_unpermute(rng):
    key = rng.integers(0, 50, size=2000).astype(np.int32)
    pay = rng.normal(size=2000).astype(np.float32)
    kj, pj = jv.sort_with_payload(jnp.asarray(key), jnp.asarray(pay))
    kt, pt = tv.sort_with_payload(tt(key), tt(pay))
    assert np.array_equal(np_of(kt), np.asarray(kj)) and np.array_equal(np_of(pt), np.asarray(pj))
    perm = rng.permutation(2000).astype(np.int32)
    np.testing.assert_array_equal(np_of(tv.unpermute(tt(perm).long(), tt(pay))),
                                  np.asarray(jv.unpermute(jnp.asarray(perm), jnp.asarray(pay))))


def test_hash_grid_knn_matches(rng):
    pts = f32(rng.uniform(-6, 6, size=(3000, 3)))
    valid = rng.uniform(size=3000) > 0.1
    q = f32(rng.uniform(-6.5, 6.5, size=(1500, 3)))
    qv = rng.uniform(size=1500) > 0.05
    for k, radius in ((1, 0.5), (5, 0.9)):
        ij, dj, okj = jax.jit(lambda p, v, q_, qv_: jv.query_knn(
            jv.build_hash_grid(p, v, 1.0), q_, qv_, k=k, radius=radius, max_per_cell=8
        ))(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(q), jnp.asarray(qv))
        gt = tv.build_hash_grid(tt(pts), tt(valid), 1.0)
        it, dt, okt = tv.query_knn(gt, tt(q), tt(qv), k=k, radius=radius, max_per_cell=8)
        okj = np.asarray(okj)
        assert okj.sum() > 100
        assert np.array_equal(np_of(okt), okj)
        assert np.array_equal(np_of(it)[okj], np.asarray(ij)[okj])
        np.testing.assert_allclose(np_of(dt)[okj], np.asarray(dj)[okj], rtol=1e-5)


def test_block_table_probe_and_window_moments(rng):
    xyz, _ = small_scan(0)
    xyz = f32(xyz[:6000])
    valid = rng.uniform(size=6000) > 0.05
    cs, V = 0.5, 4096
    bj = jax.jit(lambda p, v: jv.build_block_table(p, v, cs, V))(jnp.asarray(xyz), jnp.asarray(valid))
    bt = tv.build_block_table(tt(xyz), tt(valid), cs, V)
    for name in ("cx", "cy", "cz", "cell_valid", "point_cell", "cell_store"):
        np.testing.assert_array_equal(np_of(getattr(bt, name)), np.asarray(getattr(bj, name)), err_msg=name)
    q = np.floor(f32(rng.uniform(-30, 30, size=(2000, 3))) / cs).astype(np.int32)
    q[:500] = np.floor(xyz[:500] / cs).astype(np.int32)
    rj, fj, _, wj = jax.jit(jv.block_window_probe)(bj, *(jnp.asarray(q[:, i]) for i in range(3)))
    rt, ft, wt = tv.block_window_probe(bt, *(tt(q[:, i]) for i in range(3)))
    fj = np.asarray(fj)
    assert fj.sum() > 500
    assert np.array_equal(np_of(ft), fj) and np.array_equal(np_of(wt), np.asarray(wj))
    assert np.array_equal(np_of(rt)[fj], np.asarray(rj)[fj])

    (aj, mj, cj, cellj) = jax.jit(lambda p, v, b: jv.block_window_moments(p, v, b, cs, return_cell=True))(
        jnp.asarray(xyz), jnp.asarray(valid), bj)
    (at, mt, ct, cellt) = tv.block_window_moments(tt(xyz), tt(valid), bt, cs, return_cell=True)
    cv = np.asarray(bj.cell_valid)
    for a, b in zip(at + mt, aj + mj):
        b = np.asarray(b)[cv]
        np.testing.assert_allclose(np_of(a)[cv], b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    cellj = np.asarray(cellj)
    np.testing.assert_allclose(np_of(cellt), cellj, rtol=1e-5, atol=1e-5 * np.abs(cellj).max())
    vals = f32(rng.normal(size=V))
    mxj = np.asarray(jv.block_window_scalar_max(bj, jnp.asarray(vals), *cj))
    mxt = np_of(tv.block_window_scalar_max(bt, tt(vals), *ct))
    np.testing.assert_array_equal(mxt[cv], mxj[cv])
    recs = f32(rng.normal(size=(V, 13)))
    np.testing.assert_array_equal(np_of(tv.scatter_cell_records(bt, tt(recs), 16)),
                                  np.asarray(jv.scatter_cell_records(bj, jnp.asarray(recs), 16)))
