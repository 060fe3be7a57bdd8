"""The CUDA hash-grid kNN kernel against its plain PyTorch version.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with a card, from the repo root:

    python -m pytest --noconftest tests/test_torch_knn_cuda.py -q

The tests marked `cuda` skip without a card: a CUDA kernel has no CPU mode.
They hold csrc/knn_window.cu to `voxel._query_block` bit for bit in all
three outputs and in every slot. The wrapper's input checks, and a NumPy
transcription of the kernel (its lanes, lists and merge) held bit for bit
to `_query_block`, run everywhere."""
import inspect
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from tloam_torch.config import FeatureConfig, TLSConfig
from tloam_torch.ops import cloud_ops
from tloam_torch.ops import voxel as tv
from tloam_torch.utils.timing import STAGES

SOURCE = Path(tv.__file__).resolve().parent.parent / "csrc" / "knn_window.cu"
CS = 1.0  # the grids' cell size; the radius is 0.9 of it
FLT_MAX = np.float32(np.finfo(np.float32).max)
EMPTY = np.uint64(2**64 - 1)
OFFS = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)], np.int64)


def scene(F: int, M: int, seed: int = 0):
    """F frames of M slots: two cells of 300 points (more than 255 and
    than any C), cells of 2-12 points and scattered points in a cube of
    24 cells. Every third frame, from frame 0, has every slot valid (so the
    last cell's run ends at slot M - 1); the others 70%, the other slots
    holding far garbage. Points come in shuffled order."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1000, 1000, size=(F, M, 3)).astype(np.float32)
    valid = np.zeros((F, M), bool)
    for f in range(F):
        m = M if f % 3 == 0 else int(0.7 * M)
        parts = [(np.array(c) + rng.uniform(0.02, 0.98, size=(300, 3))) * CS for c in ((0, 0, 0), (2, -1, 3))]
        for _ in range((m - 600) // 20):
            parts.append((rng.integers(-8, 8, size=3) + rng.uniform(0.02, 0.98, size=(int(rng.integers(2, 13)), 3))) * CS)
        pts = np.concatenate(parts)[: m]
        pts = np.concatenate([pts, rng.uniform(-12, 12, size=(m - len(pts), 3)) * CS])[rng.permutation(m)]
        slots = np.arange(M) if m == M else np.sort(rng.choice(M, size=m, replace=False))
        xyz[f, slots] = pts
        valid[f, slots] = True
    return xyz, valid


def last_cells(xyz: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(F, 3) the cell of each frame's last run in the grid's order (the
    largest cell key among its valid points)."""
    cells = tv._cell_coords(torch.from_numpy(xyz), CS)
    keys = torch.where(torch.from_numpy(valid), tv._hash_coords(cells), torch.iinfo(torch.int32).min)
    return cells[torch.arange(len(xyz)), keys.argmax(dim=1)].numpy()


def query_set(xyz: np.ndarray, valid: np.ndarray, Q: int, seed: int = 1):
    """Q queries a frame: half near the frame's points (jittered by 0.3
    cells), a quarter anywhere in the cube, some at the dense cells, some
    far from every point; 15% not valid, a third of those NaN. Eight of
    them sit one cell past the frame's last cell in x, y and z, at the far
    corner, so that cell is their window's offset 0 and none of its points
    is within the radius: its slots past its count, clamped at M - 1, fill
    their answer (half of the eight not valid)."""
    rng = np.random.default_rng(seed)
    F = len(xyz)
    q = np.empty((F, Q, 3), np.float32)
    for f in range(F):
        pts = xyz[f][valid[f]]
        near = pts[rng.integers(0, len(pts), size=Q)] + rng.normal(0, 0.3 * CS, size=(Q, 3))
        anywhere = rng.uniform(-12, 12, size=(Q, 3)) * CS
        dense = (rng.uniform(0, 1, size=(Q, 3)) + np.array([2, -1, 3])) * CS
        far = rng.uniform(-1e4, 1e4, size=(Q, 3))
        kind = rng.choice(4, size=Q, p=[0.5, 0.25, 0.15, 0.1])
        q[f] = np.choose(kind[:, None], [near, anywhere, dense, far])
    q[:, :8] = (last_cells(xyz, valid)[:, None, :] + 1.98) * CS
    qv = rng.uniform(size=(F, Q)) > 0.15
    qv[:, :8] = np.arange(8) % 2 == 0
    q[~qv & (rng.uniform(size=(F, Q)) < 1 / 3)] = np.nan
    return q, qv


def forge(grid: tv.HashGrid) -> tv.HashGrid:
    """Copy the check code of slot 0 of every other bucket that holds two
    cells into its slot 1: a lookup of the first cell then sums both
    payloads (a start past the frame's end, clamped at M - 1, and another
    count), and the second cell is not found."""
    check = grid.dt.check.clone()
    two = (check[..., 1] != tv._SENTINEL).nonzero()[::2]
    check[two[:, 0], two[:, 1], 1] = check[two[:, 0], two[:, 1], 0]
    return grid._replace(dt=grid.dt._replace(check=check))


def model(grid: tv.HashGrid, queries: torch.Tensor, query_valid: torch.Tensor, k: int, radius: float, C: int):
    """csrc/knn_window.cu transcribed into NumPy, warp by warp: lane o < 27
    probes window cell o; candidate j = r*32 + lane goes into its lane's
    sorted list of K 64-bit keys (masked bits, j, ok); k rounds take the
    warp's least head. Returns (idx, dist, ok) and, for the coverage checks,
    each output's slot before the clamp and how many probes summed two
    payloads."""
    pts, src = grid.pts.numpy(), grid.src_idx.numpy()
    F, M = src.shape
    B = grid.dt.check.shape[1]
    q, qv = queries.numpy(), query_valid.numpy()
    # 1. probes: the query cells as PyTorch computes them, hashes in 32 bits
    u = (tv._cell_coords(queries, grid.cell_size).numpy().astype(np.int64)[..., None, :] + OFFS) & 0xFFFFFFFF
    u = u.astype(np.uint64)
    h1 = (u[..., 0] * 73856093 + u[..., 1] * 19349663 + u[..., 2] * 83492791) & 0xFFFFFFFF
    h2 = (u[..., 0] * 0x1E3779B1 + u[..., 1] * 0x05EBCA77 + u[..., 2] * 0x42B2AE3D) & 0xFFFFFFFF
    code = ((h2 + h1 * np.uint64(0x1E3779B1)) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    code = np.where(code == tv._SENTINEL, tv._SENTINEL - 1, code)
    row = np.arange(F)[:, None, None] * B + (h1 & np.uint64(B - 1)).astype(np.int64)
    hit = grid.dt.check.numpy().reshape(F * B, 8)[row] == code[..., None]
    pay = np.where(hit, grid.dt.payload.numpy().reshape(F * B, 8)[row], 0).astype(np.int64).sum(-1)
    pay = (pay & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    found = hit.any(-1)
    start = np.where(found, pay >> 8, 0)
    count = np.where(found, np.minimum(pay & 255, C), 0)
    # 2. the lanes' lists
    total = 27 * C
    rounds = -(-total // 32)
    K = next(c for c in (1, 2, 4, 8, 16, 32) if c >= min(k, rounds))
    lists = np.full(q.shape[:2] + (32, K), EMPTY)
    rr = np.float32(radius) * np.float32(radius)
    fi = np.arange(F)[:, None, None]
    for r in range(rounds):
        j = r * 32 + np.arange(32)
        live = j < total
        o, c = np.minimum(j // C, 26), j % C
        cand = live & qv[..., None] & (c < count[..., o])
        p = pts[fi, np.minimum(start[..., o] + c, M - 1)]
        with np.errstate(invalid="ignore"):
            dx, dy, dz = (p[..., a] - q[..., a:a + 1] for a in range(3))
            d = (dx * dx + dy * dy) + dz * dz
            ok = cand & (d <= rr)
        masked = np.where(ok, d, FLT_MAX).astype(np.float32)
        x = (masked.view(np.uint32).astype(np.uint64) << np.uint64(32)) | (j.astype(np.uint64) << np.uint64(1))
        x = np.where(live, x | ok.astype(np.uint64), EMPTY)
        for i in range(K):
            lo, x = np.minimum(x, lists[..., i]), np.maximum(x, lists[..., i])
            lists[..., i] = lo
    # 3. the merge
    kout = min(k, total)
    out = np.empty(q.shape[:2] + (kout,), np.uint64)
    for t in range(kout):
        m = lists[..., 0].min(-1)
        out[..., t] = m
        pop = lists[..., 0] == m[..., None]
        shifted = np.concatenate([lists[..., 1:], np.full(lists.shape[:-1] + (1,), EMPTY)], axis=-1)
        lists = np.where(pop[..., None], shifted, lists)
    j = ((out & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
    raw = np.take_along_axis(start, j // C, -1) + j % C
    idx = src[fi, np.minimum(raw, M - 1)]
    dist = (out >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return (idx, dist, (out & np.uint64(1)).astype(bool)), raw, int((hit.sum(-1) > 1).sum())


@lru_cache(maxsize=4)
def grid_of(F: int, M: int) -> tv.HashGrid:
    xyz, valid = scene(F, M)
    return tv.build_hash_grid(torch.from_numpy(xyz), torch.from_numpy(valid), CS)


@lru_cache(maxsize=8)
def queries_of(F: int, M: int, Q: int):
    xyz, valid = scene(F, M)
    return tuple(torch.from_numpy(a) for a in query_set(xyz, valid, Q))


def plain(grid, q, qv, k, C, radius=0.9 * CS):
    r = torch.full((), radius, dtype=q.dtype, device=q.device)
    return tv._query_block(grid, q, qv, k, r, C)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype is torch.float32 else t


def same(a, b) -> bool:
    return all(torch.equal(bits(x), bits(torch.as_tensor(y, device=x.device))) for x, y in zip(a, b))


def on_card(*xs):
    return tv.map_tensors(xs, lambda t: t.cuda())


def test_kernel_constants_are_the_hash_module_constants():
    src = SOURCE.read_text()
    consts = {name: int(v, 0) for name, v in re.findall(r"\b(k[PQ][123]|kCheckMix|kSentinel) = (0x[0-9A-Fa-f]+|\d+)", src)}
    assert consts == {"kP1": tv._P1, "kP2": tv._P2, "kP3": tv._P3, "kQ1": tv._Q1, "kQ2": tv._Q2, "kQ3": tv._Q3,
                      "kCheckMix": tv._CHECK_MIX, "kSentinel": tv._SENTINEL}
    assert f"kMaxK = {tv.KNN_MAX_K};" in src
    assert np.array_equal(OFFS, tv._OFFS)


def test_every_caller_fits_the_kernel():
    """The k of every query_knn caller in the tree at its defaults: 1 and 5
    in the solver and 11 (TLSConfig.k_corr + 1) in GICP's covariances, 20
    in the exact PCA, and cloud_ops' 1, 2, 8, 16 and 30 (estimate_normals'
    max_nn)."""
    ks = [1, 5, TLSConfig().k_corr + 1, FeatureConfig().k, 2, 8, 16,
          inspect.signature(cloud_ops.estimate_normals).parameters["max_nn"].default]
    assert ks[2:4] == [11, 20] and max(ks) == 30 <= tv.KNN_MAX_K


def test_wrapper_rejects_what_the_kernel_does_not_take():
    grid = grid_of(2, 1024)
    q, qv = queries_of(2, 1024, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tv._query_knn_cuda(grid, q, qv, 5, 0.9, 8)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="1 to 32 neighbours, not k = 33"):
        tv._query_knn_cuda(grid, q, qv, 33, 0.9, 8)
    with pytest.raises(ValueError, match="not k = 0"):
        tv._query_knn_cuda(grid, q, qv, 0, 0.9, 8)
    with pytest.raises(ValueError, match="max_per_cell"):
        tv._query_knn_cuda(grid, q, qv, 5, 0.9, 0)
    with pytest.raises(ValueError, match="queries must be a contiguous torch.float32"):
        tv._query_knn_cuda(grid, q.double(), qv, 5, 0.9, 8)
    with pytest.raises(ValueError, match="queries must be a contiguous"):
        tv._query_knn_cuda(grid, torch.cat([q, q], dim=-1)[..., 1:4], qv, 5, 0.9, 8)
    with pytest.raises(ValueError, match="query_valid must be"):
        tv._query_knn_cuda(grid, q, qv.to(torch.uint8), 5, 0.9, 8)
    with pytest.raises(ValueError, match="query_valid must be"):
        tv._query_knn_cuda(grid, q, qv[:1], 5, 0.9, 8)
    with pytest.raises(ValueError, match="src_idx must be"):
        tv._query_knn_cuda(grid._replace(src_idx=grid.src_idx.int()), q, qv, 5, 0.9, 8)
    with pytest.raises(ValueError, match="dt.check must be"):
        tv._query_knn_cuda(grid._replace(dt=grid.dt._replace(check=grid.dt.check[:, :, :4])), q, qv, 5, 0.9, 8)
    with pytest.raises(ValueError, match="pts must be"):
        tv._query_knn_cuda(grid._replace(pts=grid.pts[:1]), q, qv, 5, 0.9, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tv.query_knn(grid, q.to("meta"), qv, 5)


@pytest.mark.parametrize("k,C,forged", [
    (1, 8, False), (5, 8, False), (11, 8, False), (11, 16, False), (20, 8, False), (32, 1, False),
    (5, 8, True), (16, 16, True),
])
def test_model_matches_plain_on_cpu(k, C, forged):
    """The kernel's algorithm, transcribed, equals the plain version bit for
    bit in every slot; the CPU dispatch runs the plain version and launches
    nothing. The data reach the hard cases: cells of more than 255 points,
    slots clamped at M - 1 in the answers, fewer than k matches, queries
    not valid (NaN among them), and (forged) lookups that sum two
    payloads."""
    grid = grid_of(3, 1024)
    grid = forge(grid) if forged else grid
    q, qv = queries_of(3, 1024, 400)
    want = plain(grid, q, qv, k, C)
    got, raw, multi = model(grid, q, qv, k, 0.9 * CS, C)
    assert same(want, got)
    before = STAGES.counts["knn.launch"]
    assert same(tv.query_knn(grid, q, qv, k, radius=0.9 * CS, max_per_cell=C), want)
    assert STAGES.counts["knn.launch"] == before
    assert want[0].shape == (3, 400, min(k, 27 * C))
    assert (raw > 1023).any() == (min(k, C) > 1 or forged)  # the first slot past a count is slot 1
    assert (want[2].sum(-1) < min(k, 27 * C)).any() and want[2].any()
    assert (grid.dt.payload[grid.dt.check != tv._SENTINEL] & 255).max() == 255
    assert (multi > 0) == forged


def cuda_available():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("k", [1, 5, 11])
@pytest.mark.parametrize("Q", [1024, 4096, 2048, 512])
@pytest.mark.parametrize("M", [12288, 8192])
def test_kernel_matches_plain_on_gpu(M, Q, k, C):
    """The batch cells' shapes (64 frames; the submap's planar and ground
    grids; the scan's planar, ground, edge and sphere queries): every slot
    of all three outputs bit for bit; a second launch repeats it; each
    launch counts once."""
    cuda_available()
    grid, q, qv = on_card(grid_of(64, M), *queries_of(64, M, Q))
    before = STAGES.counts["knn.launch"]
    got = tv.query_knn(grid, q, qv, k, radius=0.9 * CS, max_per_cell=C, chunk_size=100)
    torch.cuda.synchronize()
    assert STAGES.counts["knn.launch"] == before + 1
    assert same(got, plain(grid, q, qv, k, C))
    assert same(tv.query_knn(grid, q, qv, k, radius=0.9 * CS, max_per_cell=C), got)
    assert got[2].any() and not got[2].all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 11])
def test_self_queries_match_plain_on_gpu(k):
    """The covariance call's shape: every slot of a grid queries it."""
    cuda_available()
    grid = on_card(grid_of(64, 12288))[0]
    xyz, valid = (torch.from_numpy(a).cuda() for a in scene(64, 12288))
    got = tv.query_knn(grid, xyz, valid, k, radius=CS, max_per_cell=8)
    assert same(got, plain(grid, xyz, valid, k, 8, radius=CS))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 11])
def test_one_frame_matches_plain_on_gpu(k):
    """One frame of 2-D inputs, as the stream's sphere family calls it,
    with the queries and flags as strided views."""
    cuda_available()
    xyz, valid = scene(1, 12288)
    grid = tv.build_hash_grid(torch.from_numpy(xyz[0]).cuda(), torch.from_numpy(valid[0]).cuda(), CS)
    q, qv = (torch.from_numpy(a[0]).cuda() for a in query_set(xyz, valid, 512))
    q = torch.cat([q, q[:, :1]], dim=-1)[:, :3]
    qv = torch.stack([qv, qv], dim=-1)[:, 1]
    assert not (q.is_contiguous() or qv.is_contiguous())
    got = tv.query_knn(grid, q, qv, k, radius=0.9 * CS, max_per_cell=8)
    assert got[0].shape == (512, k)
    want = plain(tv._enframe(grid), q[None], qv[None], k, 8)
    assert same(got, tuple(w[0] for w in want))


@pytest.mark.cuda
@pytest.mark.parametrize("k,C,forged", [(11, 8, False), (20, 8, False), (32, 1, False), (16, 16, True),
                                        (5, 8, True), (11, 8, True)])
def test_hard_cases_match_plain_and_model_on_gpu(k, C, forged):
    """Four frames of 12288 slots: slots clamped at M - 1 in the answers,
    cells of more than 255 points, fewer than k matches with k > C, k above
    27 C, queries not valid (NaN among them), and (forged) lookups that sum
    two payloads; the kernel equals the plain version on the card and the
    NumPy transcription on the CPU."""
    cuda_available()
    grid = forge(grid_of(4, 12288)) if forged else grid_of(4, 12288)
    q, qv = queries_of(4, 12288, 1024)
    want, raw, multi = model(grid, q, qv, k, 0.9 * CS, C)
    assert (raw > 12287).any() == (min(k, C) > 1 or forged) and (multi > 0) == forged
    grid, q, qv = on_card(grid, q, qv)
    got = tv.query_knn(grid, q, qv, k, radius=0.9 * CS, max_per_cell=C)
    assert same(got, plain(grid, q, qv, k, C))
    assert same(got, want)
