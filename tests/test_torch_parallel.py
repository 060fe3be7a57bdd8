"""tloam_torch's batch axis against the JAX package and against itself.

The port's batched solve (tloam_torch.parallel.batched.vmap_scan_matching)
on the synthetic frame pairs of tests/test_parallel.py (capacities
4096/4096/1024/256, tests/test_registration.CFG, float64, numpy seed 0):
against the JAX solve of every frame (poses within 2e-5, the JAX test's
own tolerance) and against the port's one-frame solve (integer
diagnostics exact, poses within 2e-5). The batched voxel tables and
lookups at F = 3 hold exactly against three one-frame calls, overflowing
buckets and cells included, and the window moments to float32 rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tloam_torch.cloud import Cloud, map_tensors, stack_tensors as stack
from tloam_torch.config import TLSConfig
from tloam_torch.models import registration as treg
from tloam_torch.ops import se3 as tse3, voxel as tv
from tloam_torch.parallel import batched as tbatched
from tloam_torch.utils.op_count import count_ops

from tloam_tpu.models.registration import scan_matching as jax_scan_matching
from tloam_tpu.ops import se3 as jse3

from tests.test_parallel import make_pair
from tests.test_registration import CFG
from tests.test_torch_common import two_threads  # noqa: F401

TCFG = TLSConfig(**dataclasses.asdict(CFG))
INT_DIAGS = ("iterations", "num_corr", "corr_trace", "coarse_trace", "aligned_trace", "degenerate")


pytestmark = pytest.mark.usefixtures("two_threads")  # the batched CPU solves on 2 intra-op threads


def torch_features(fs) -> treg.FeatureSet:
    """A JAX FeatureSet -> the port's, on the CPU, in the JAX dtype."""
    return treg.FeatureSet(*(Cloud(*(torch.tensor(np.asarray(getattr(c, f))) for f in ("xyz", "intensity", "valid")))
                             for c in fs))


def pairs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [make_pair(rng, dtype=jnp.float64) for _ in range(n)]


def assert_batch_matches_single(scans, submaps, predicts, cfg, poses, diags):
    """Every frame of a batched solve against the port's one-frame solve."""
    for b in range(predicts.shape[0]):
        pose, diag = treg.scan_matching(scans[b], submaps[b], predicts[b], cfg)
        for name in INT_DIAGS:
            assert torch.equal(getattr(diags, name)[b], getattr(diag, name)), (b, name)
        np.testing.assert_allclose(poses[b].numpy(), pose.numpy(), atol=2e-5, err_msg=str(b))


def test_vmap_batched_matches_jax_and_single():
    ps = pairs(4)
    scans, submaps = [torch_features(p[0]) for p in ps], [torch_features(p[1]) for p in ps]
    predicts = torch.eye(4, dtype=torch.float64).expand(4, 4, 4).clone()
    poses, diags = tbatched.vmap_scan_matching(stack(scans), stack(submaps), predicts, TCFG)
    assert poses.shape == (4, 4, 4) and diags.num_corr.shape == (4, 4) and diags.corr_trace.shape[0] == 4
    solve = jax.jit(jax_scan_matching, static_argnums=3)
    for b, (scan, submap, T_true) in enumerate(ps):
        pose_j, diag_j = solve(scan, submap, jnp.eye(4, dtype=jnp.float64), CFG)
        np.testing.assert_allclose(poses[b].numpy(), np.asarray(pose_j), atol=2e-5, err_msg=str(b))
        err = jse3.log(jse3.inv(T_true) @ jnp.asarray(poses[b].numpy()))
        assert np.linalg.norm(np.asarray(err)) < 1e-2, (b, np.asarray(err))
    assert_batch_matches_single(scans, submaps, predicts, TCFG, poses, diags)


@pytest.mark.parametrize("override", [{"corr_mode": "knn"}, {"plane_residual": "gicp"},
                                      {"mu_init": "reference_zero"}])
def test_batched_modes_match_single(override):
    """B = 3 in three off-default modes; frame 2's prediction is 0.5 m and
    0.05 rad off, so where the mode has coarse rounds some round is coarse
    for some frames and fine for others (the per-frame select)."""
    cfg = dataclasses.replace(TCFG, **override)
    ps = pairs(3)
    scans, submaps = [torch_features(p[0]) for p in ps], [torch_features(p[1]) for p in ps]
    predicts = torch.eye(4, dtype=torch.float64).expand(3, 4, 4).clone()
    predicts[2] = tse3.exp(torch.tensor([0.5, -0.25, 0.0, 0.0, 0.0, 0.05], dtype=torch.float64))
    poses, diags = tbatched.vmap_scan_matching(stack(scans), stack(submaps), predicts, cfg)
    assert_batch_matches_single(scans, submaps, predicts, cfg, poses, diags)
    if override.get("corr_mode") != "knn":  # kNN point-to-plane has no coarse rounds
        rounds = diags.iterations.min()
        mixed = diags.coarse_trace[:, :rounds].any(0) & ~diags.coarse_trace[:, :rounds].all(0)
        assert bool(mixed.any()), diags.coarse_trace


def test_batched_solve_issues_the_same_ops_at_every_batch_size():
    """One program over B: 3 copies of a frame (identical branches) issue
    the same aten operations, op for op, as the frame alone (after a first
    solve, which also copies the constant tables once)."""
    (scan, submap, _), = pairs(1)
    scan, submap = torch_features(scan), torch_features(submap)
    counts = {}
    for B in (1, 3):
        args = (stack([scan] * B), stack([submap] * B), torch.eye(4, dtype=torch.float64).repeat(B, 1, 1), TCFG)
        tbatched.vmap_scan_matching(*args)
        (_, diags), counts[B] = count_ops(lambda: tbatched.vmap_scan_matching(*args))
        assert int(diags.iterations.min()) >= 2
    assert sum(counts[1].values()) > 1000
    assert counts[1] == counts[3]


# ---------------------------------------------------------------------------
# voxel tables and lookups with a frame axis
# ---------------------------------------------------------------------------


def frames_of(rng, F=3, n=3000):
    """F clouds of n points in different boxes, with invalid slots, two
    duplicated points and a cloud the cell caps below overflow."""
    pts = np.stack([rng.uniform(-6 - f, 6 + f, size=(n, 3)) for f in range(F)]).astype(np.float32)
    pts[:, 10] = pts[:, 11]
    valid = rng.uniform(size=(F, n)) > 0.1
    return torch.from_numpy(pts), torch.from_numpy(valid)


def leaves(x):
    return [v for item in x for v in leaves(item)] if isinstance(x, tuple) else [x]


def assert_same(got, want):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def assert_frames_equal(batched, singles):
    """Every tensor of frame f of a framed result == the f-th one-frame result."""
    for f, single in enumerate(singles):
        assert_same(map_tensors(batched, lambda x: x[f]), single)


def test_direct_table_frames_exact_with_overflow(rng):
    F, V = 3, 500
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, size=(F, V)).astype(np.int32))
    keys[1, :40] = 7 * 512  # 40 entries in one bucket: 32 overflow
    keys2 = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, size=(F, V)).astype(np.int32))
    valid = torch.from_numpy(rng.uniform(size=(F, V)) > 0.2)
    pay = torch.arange(F * V, dtype=torch.int32).view(F, V)
    table = tv.build_direct_table(keys, keys2, valid, pay)
    singles = [tv.build_direct_table(keys[f], keys2[f], valid[f], pay[f]) for f in range(F)]
    assert_frames_equal(table, singles)
    assert int((singles[1].check != tv._SENTINEL).sum()) < int(valid[1].sum())  # entries dropped
    found, got = tv.direct_lookup(table, keys, keys2)
    for f in range(F):
        assert_frames_equal((found[f:f + 1], got[f:f + 1]), [tv.direct_lookup(singles[f], keys[f], keys2[f])])


def test_hash_grid_and_knn_frames_exact(rng):
    pts, valid = frames_of(rng)
    grid = tv.build_hash_grid(pts, valid, 1.0)
    q = pts + torch.from_numpy(rng.normal(size=pts.shape).astype(np.float32)) * 0.3
    qv = valid.roll(7, dims=1)
    singles = [tv.build_hash_grid(pts[f], valid[f], 1.0) for f in range(3)]
    assert_frames_equal(grid, singles)
    for k, chunk in ((1, None), (5, 700)):
        got = tv.query_knn(grid, q, qv, k=k, radius=0.9, max_per_cell=8, chunk_size=chunk)
        assert int(got[2].sum()) > 1000
        assert_frames_equal(got, [tv.query_knn(singles[f], q[f], qv[f], k=k, radius=0.9, max_per_cell=8)
                                  for f in range(3)])


@pytest.mark.parametrize("max_cells", [4096, 600])
def test_block_table_frames_exact(rng, max_cells):
    """max_cells 600 is below every frame's cell count: cells overflow."""
    pts, valid = frames_of(rng)
    cs = 0.7
    bt = tv.build_block_table(pts, valid, cs, max_cells)
    singles = [tv.build_block_table(pts[f], valid[f], cs, max_cells) for f in range(3)]
    assert_frames_equal(bt, singles)
    if max_cells == 600:
        assert all(bool(s.cell_valid.all()) and bool((s.point_cell < 0)[valid[f]].any()) for f, s in enumerate(singles))
    q = torch.floor(pts.roll(5, dims=1) / cs).to(torch.int32)
    assert_frames_equal(tv.block_window_probe(bt, q[..., 0], q[..., 1], q[..., 2]),
                        [tv.block_window_probe(singles[f], q[f, :, 0], q[f, :, 1], q[f, :, 2]) for f in range(3)])
    recs = torch.from_numpy(rng.normal(size=(3, max_cells, 13)).astype(np.float32))
    assert_frames_equal(tv.scatter_cell_records(bt, recs, 16),
                        [tv.scatter_cell_records(singles[f], recs[f], 16) for f in range(3)])
    # the window moments: the probe cache exactly; the float sums to float32
    # rounding (a cell's points add in input order, but the accumulation's
    # and the window product's blocking follow the size of the whole batch)
    moments = tv.block_window_moments(pts, valid, bt, cs, return_cell=True)
    for f in range(3):
        anchors, sums, cache, cell = tv.block_window_moments(pts[f], valid[f], singles[f], cs, return_cell=True)
        assert_same(map_tensors((moments[0], moments[2]), lambda x: x[f]), (anchors, cache))
        for got, want in zip((*moments[1], moments[3]), (*sums, cell)):
            torch.testing.assert_close(got[f], want)
    vals = recs[..., 0]
    assert_frames_equal(tv.block_window_scalar_max(bt, vals, *moments[2]),
                        [tv.block_window_scalar_max(singles[f], vals[f], *map_tensors(moments[2], lambda x: x[f]))
                         for f in range(3)])
