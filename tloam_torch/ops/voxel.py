"""Voxel hashing: downsampling, direct hash tables, hash-grid kNN and the
Morton-block cell store.

Port of the main-path subset of ``tloam_tpu/ops/voxel.py`` (the reference's
VoxelDownSample, PointCloud2.cpp:358-403, and its per-class KDTreeFlann
searches, registration.cpp:892-915). The algorithms and their outputs are
the JAX module's; the TPU-specific layouts (128-lane packed rows) become
plain (n, k) tensors where that changes no result.

Exactness notes:
  * hash arithmetic wraps in int32 exactly as XLA does: products are formed
    in int64 and reduced mod 2^32 (`wrap_i32`), never left to signed
    overflow;
  * every sort is stable (`jnp.argsort` and `lax.sort(is_stable=True)` are);
  * `voxel_downsample` keeps the JAX module's cell-anchored integer fixed
    point, so its sums are exact on every device;
  * `block_window_moments` sums float moments with an accumulating
    `index_put_`, which adds each cell's points in input order on every
    device, so a run repeats bit for bit; its outputs agree with the JAX
    module to float32 rounding (1e-5 relative), not bit for bit.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# Spatial-hash constants (linear forms, see tloam_tpu/ops/voxel.py:39-47)
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_Q1, _Q2, _Q3 = 0x9E3779B1 & 0x7FFFFFFF, 0x85EBCA77 & 0x7FFFFFFF, 0xC2B2AE3D & 0x7FFFFFFF
_SENTINEL = 2**31 - 1


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor mod 2^32 into int32 two's complement."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _lin3(cx, cy, cz, a: int, b: int, c: int) -> torch.Tensor:
    return wrap_i32(cx.long() * a + cy.long() * b + cz.long() * c)


def _cell_coords(points: torch.Tensor, cell_size) -> torch.Tensor:
    return torch.floor(points / cell_size).to(torch.int32)


def _hash_coords(c: torch.Tensor) -> torch.Tensor:
    return _lin3(c[..., 0], c[..., 1], c[..., 2], _P1, _P2, _P3)


def _hash2_parts(cx, cy, cz) -> torch.Tensor:
    return _lin3(cx, cy, cz, _Q1, _Q2, _Q3)


def _first_of_runs(*cols: torch.Tensor) -> torch.Tensor:
    """True at index 0 and wherever any column changes from its predecessor."""
    diff = torch.zeros_like(cols[0][1:], dtype=torch.bool)
    for c in cols:
        diff = diff | (c[1:] != c[:-1])
    return torch.cat([torch.ones(1, dtype=torch.bool, device=diff.device), diff])


def _takepad(a: torch.Tensor, size: int, fill) -> torch.Tensor:
    """Static slice/pad of the leading axis to `size`."""
    if a.shape[0] >= size:
        return a[:size]
    pad = torch.full((size - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


# ---------------------------------------------------------------------------
# Sorting helpers and voxel downsample
# ---------------------------------------------------------------------------


def sort_with_payload(key: torch.Tensor, *cols: torch.Tensor):
    """Stable sort of `cols` by `key`. Returns (sorted_key, sorted_cols...)."""
    sk, order = torch.sort(key, stable=True)
    return (sk, *(c[order] for c in cols))


def unpermute(order_idx: torch.Tensor, *cols: torch.Tensor):
    """Inverse of a permutation: values aligned with a sorted order whose
    original indices are `order_idx` (a permutation of arange(n)), returned
    in original-index order."""
    outs = []
    for c in cols:
        out = torch.empty_like(c)
        out[order_idx] = c
        outs.append(out)
    return tuple(outs) if len(outs) > 1 else outs[0]


def voxel_downsample(xyz, intensity, valid, voxel_size: float, max_out: int):
    """Average points (and intensity) falling in each voxel.

    Returns (xyz (max_out,3), intensity (max_out,), valid (max_out,)). On
    overflow the output thins uniformly over the cell-hash order; the run
    sums are cell-anchored int fixed point (exact), as in the JAX module
    (tloam_tpu/ops/voxel.py:95-221)."""
    n = xyz.shape[0]
    dtype = xyz.dtype
    dev = xyz.device
    coords = _cell_coords(xyz, voxel_size)
    coords = torch.where(valid[:, None], coords, _SENTINEL)
    keys = torch.where(valid, _hash_coords(coords), _SENTINEL)
    _, cx_s, cy_s, cz_s, x_s, y_s, z_s, int_s, vi_s = sort_with_payload(
        keys, coords[:, 0], coords[:, 1], coords[:, 2],
        xyz[:, 0], xyz[:, 1], xyz[:, 2], intensity, valid.to(torch.int32),
    )
    valid_s = vi_s > 0
    first = _first_of_runs(cx_s, cy_s, cz_s)
    seg_id = torch.cumsum(first, 0) - 1
    seg_id = torch.where(valid_s, seg_id, max_out)

    # uniform thinning on capacity overflow (see the JAX module's rationale)
    n_cells = torch.sum(first & valid_s)
    ratio = max_out / torch.clamp(n_cells, min=1).to(dtype)
    row = torch.floor(seg_id.to(dtype) * ratio).long()
    prev_row = torch.floor((seg_id - 1).to(dtype) * ratio).long()
    kept = (seg_id == 0) | (row > prev_row)
    seg_id = torch.where(
        n_cells > max_out,
        torch.where(valid_s & kept, torch.clamp(row, max=max_out - 1), max_out),
        seg_id,
    )

    # run reduction by an exact integer cumsum differenced at run starts
    include = valid_s & (seg_id < max_out)
    qd = float(
        1 << max(0, min(22, int(np.log2((1 << 30) / (n * max(voxel_size, 1e-9))))))
    )
    imax = torch.clamp(
        torch.max(torch.where(valid_s, torch.abs(int_s), torch.zeros_like(int_s))), min=1e-6
    )
    qi = torch.exp2(
        torch.clamp(torch.floor(torch.log2((1 << 30) / (n * imax))), 0.0, 22.0)
    ).to(dtype)
    inc = include.to(torch.int64)

    def quant(v):
        # out-of-range (masked) rows are zeroed before the int conversion
        return torch.round(torch.where(include, v, torch.zeros_like(v))).to(torch.int64) * inc

    dxq = quant((x_s - cx_s.to(dtype) * voxel_size) * qd)
    dyq = quant((y_s - cy_s.to(dtype) * voxel_size) * qd)
    dzq = quant((z_s - cz_s.to(dtype) * voxel_size) * qd)
    inq = quant(int_s * qi)
    # (5, n) scanned along its rows: an (n, 5) scan along dim 0 runs on a
    # handful of device threads
    csum = torch.cumsum(torch.stack([dxq, dyq, dzq, inq, inc]), dim=1).T

    # first element of every included run, compacted in output order
    start_key = torch.where(first & include, seg_id, _SENTINEL)
    pos = torch.arange(n, device=dev)
    sk, sp, scx, scy, scz = sort_with_payload(start_key, pos, cx_s, cy_s, cz_s)
    sk, sp = _takepad(sk, max_out, _SENTINEL), _takepad(sp, max_out, 0)
    scx, scy, scz = (_takepad(a, max_out, 0) for a in (scx, scy, scz))
    out_ok = sk < _SENTINEL
    starts = torch.where(out_ok, sp, n)
    bpos = torch.cat([starts, torch.full((1,), n, dtype=starts.dtype, device=dev)])
    excl = torch.where(
        (bpos > 0)[:, None], csum[torch.clamp(bpos - 1, min=0)], torch.zeros((), dtype=csum.dtype, device=dev)
    )
    sums = (excl[1:] - excl[:-1]).to(dtype)
    cnt = sums[:, 4]
    out_valid = out_ok & (cnt > 0)
    denom = torch.clamp(cnt, min=1.0)
    cell0 = torch.stack([scx, scy, scz], dim=1).to(dtype) * voxel_size
    out_xyz = cell0 + sums[:, :3] / (qd * denom[:, None])
    out_int = sums[:, 3] / (qi * denom)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return (
        torch.where(out_valid[:, None], out_xyz, zero),
        torch.where(out_valid, out_int, zero),
        out_valid,
    )


# ---------------------------------------------------------------------------
# Direct-addressed (bucketized) hash table
# ---------------------------------------------------------------------------

_BUCKET = 8  # slots per bucket
_CHECK_MIX = int(np.uint32(2654435761) & 0x7FFFFFFF)


def _check_code(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Verification code mixing both hashes; SENTINEL is reserved for empty."""
    c = wrap_i32(h2.long() + h1.long() * _CHECK_MIX)
    return torch.where(c == _SENTINEL, _SENTINEL - 1, c)


class DirectTable(NamedTuple):
    """B buckets of 8 (check, payload) slots: check/payload (B, 8) int32;
    empty slots hold SENTINEL in check. B = next_pow2(max(V, 64))."""

    check: torch.Tensor
    payload: torch.Tensor


def build_direct_table(keys, keys2, valid, payload) -> DirectTable:
    """Insert V entries: one stable sort by bucket gives each entry its
    in-bucket rank; ranks >= 8 are dropped (tloam_tpu/ops/voxel.py:328)."""
    V = keys.shape[0]
    dev = keys.device
    B = 1 << int(np.ceil(np.log2(max(V, 64))))
    H = B * _BUCKET
    check = _check_code(keys, keys2)
    bucket = torch.where(valid, keys & (B - 1), B)
    b_s, order = torch.sort(bucket, stable=True)
    check_s, pay_s, valid_s = check[order], payload[order].to(torch.int32), valid[order]
    idx = torch.arange(V, device=dev)
    first = _first_of_runs(b_s)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = idx - start
    tgt = torch.where(valid_s & (rank < _BUCKET), b_s.long() * _BUCKET + rank, H)
    c = torch.full((H + 1,), _SENTINEL, dtype=torch.int32, device=dev)
    p = torch.full((H + 1,), _SENTINEL, dtype=torch.int32, device=dev)
    c[tgt] = check_s
    p[tgt] = pay_s
    return DirectTable(c[:H].view(B, _BUCKET), p[:H].view(B, _BUCKET))


def direct_lookup(table: DirectTable, h1: torch.Tensor, h2: torch.Tensor):
    """Vectorized lookup for any shape. Returns (found bool, payload int32;
    0 where not found)."""
    B = table.check.shape[0]
    shape = h1.shape
    h1f = h1.reshape(-1)
    check = _check_code(h1f, h2.reshape(-1))
    bucket = (h1f & (B - 1)).long()
    hit = table.check[bucket] == check[:, None]  # at most one slot hits
    found = hit.any(dim=-1)
    pay = torch.where(hit, table.payload[bucket], 0).sum(dim=-1).to(torch.int32)
    return found.reshape(shape), pay.reshape(shape)


# ---------------------------------------------------------------------------
# Hash-grid kNN (the sphere family's 1-NN on the main path)
# ---------------------------------------------------------------------------


class HashGrid(NamedTuple):
    """pts (M,3) in hash-sorted order, src_idx (M,) original index of each
    sorted slot, dt cell -> (run start << 8 | count), cell_size (python float)."""

    pts: torch.Tensor
    src_idx: torch.Tensor
    dt: DirectTable
    cell_size: float


def build_hash_grid(points, valid, cell_size: float) -> HashGrid:
    M = points.shape[0]
    dev = points.device
    coords = _cell_coords(points, cell_size)
    keys = torch.where(valid, _hash_coords(coords), _SENTINEL)
    keys2 = torch.where(valid, _hash2_coords(coords), 0)
    keys_s, order = torch.sort(keys, stable=True)
    keys2_s = keys2[order]
    run_first = _first_of_runs(keys_s) & (keys_s != _SENTINEL)
    cell_id = torch.cumsum(run_first, 0) - 1
    cell_id_c = torch.where(keys_s != _SENTINEL, cell_id, M)
    pos = torch.arange(M, device=dev, dtype=torch.int32)
    tgt = torch.where(run_first, cell_id, M)
    crec = torch.full((M + 1, 3), _SENTINEL, dtype=torch.int32, device=dev)
    crec[tgt] = torch.stack([pos, keys_s, keys2_s], dim=1)
    crec = crec[:M]
    unused = crec[:, 1] == _SENTINEL
    starts = torch.where(unused, 0, crec[:, 0])
    cell_key = crec[:, 1]
    cell_key2 = torch.where(unused, 0, crec[:, 2])
    counts = torch.zeros(M + 1, dtype=torch.int32, device=dev).index_add_(
        0, cell_id_c, torch.ones(M, dtype=torch.int32, device=dev)
    )[:M]
    dt = build_direct_table(
        cell_key, cell_key2, cell_key != _SENTINEL,
        starts * 256 + torch.clamp(counts, max=255),
    )
    return HashGrid(points[order], order, dt, float(cell_size))


def _hash2_coords(c: torch.Tensor) -> torch.Tensor:
    return _hash2_parts(c[..., 0], c[..., 1], c[..., 2])


_OFFS = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)], np.int32
)  # (27,3): the JAX module's _OFF1/_OFF2/_OFF3 order


def _query_block(grid: HashGrid, queries, query_valid, k: int, r: torch.Tensor, C: int):
    M = grid.src_idx.shape[0]
    q = queries.shape[0]
    dev = queries.device
    offs = _device_table("offs", dev)
    qc = _cell_coords(queries, grid.cell_size)
    nx = qc[:, 0:1] + offs[None, :, 0]
    ny = qc[:, 1:2] + offs[None, :, 1]
    nz = qc[:, 2:3] + offs[None, :, 2]
    found, pay = direct_lookup(
        grid.dt, _lin3(nx, ny, nz, _P1, _P2, _P3), _hash2_parts(nx, ny, nz)
    )  # (q,27)
    start = (pay >> 8).long()
    count = pay & 255
    ar = torch.arange(C, device=dev)
    slots = (start[:, :, None] + ar).reshape(q, 27 * C)
    slots_c = torch.clamp(slots, max=M - 1)
    within = (ar[None, None, :] < torch.clamp(count, max=C)[:, :, None]).reshape(q, 27 * C)
    match = within & found.repeat_interleave(C, dim=1)
    cand = grid.pts[slots_c]  # (q, 27C, 3)
    dx = cand[..., 0] - queries[:, 0:1]
    dy = cand[..., 1] - queries[:, 1:2]
    dz = cand[..., 2] - queries[:, 2:3]
    dist_sq = dx * dx + dy * dy + dz * dz
    ok = match & (dist_sq <= r * r) & query_valid[:, None]
    BIG = torch.finfo(queries.dtype).max
    masked = torch.where(ok, dist_sq, BIG)
    # lax.top_k order: k smallest, ties to the lower candidate index
    nn_dist, arg = torch.sort(masked, dim=1, stable=True)
    nn_dist, arg = nn_dist[:, :k], arg[:, :k]
    nn_slot = torch.gather(slots_c, 1, arg)
    nn_ok = torch.gather(ok, 1, arg)
    return grid.src_idx[nn_slot], torch.where(nn_ok, nn_dist, BIG), nn_ok


def query_knn(grid: HashGrid, queries, query_valid, k: int, radius=None, max_per_cell: int = 8):
    """Batched kNN within `radius` (defaults to the cell size): (idx (Q,k)
    into the ORIGINAL buffer, dist_sq (Q,k), neighbor_valid (Q,k)). Replaces
    KDTreeFlann::SearchHybrid."""
    r = torch.full((), grid.cell_size if radius is None else radius, dtype=queries.dtype,
                     device=queries.device)
    return _query_block(grid, queries, query_valid, k, r, max_per_cell)


# ---------------------------------------------------------------------------
# Morton-block record store (2x2x2 cell blocks; 8 block rows cover any
# 3x3x3 cell window — tloam_tpu/ops/voxel.py:616-654)
# ---------------------------------------------------------------------------

_EB = np.array([[(i >> k) & 1 for i in range(8)] for k in range(3)], np.int32)  # (3,8)


class BlockTable(NamedTuple):
    """cx/cy/cz (V,) int32 cell coords (sentinel where unused), cell_valid
    (V,), point_cell (N,) cell row per point (-1 invalid), cell_store (V,)
    block_row * 8 + Morton slot, dt block hash -> block row."""

    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    cell_valid: torch.Tensor
    point_cell: torch.Tensor
    cell_store: torch.Tensor
    dt: DirectTable


def _block_hashes(bx, by, bz):
    h1 = _lin3(bx, by, bz, 2654435761 & 0x7FFFFFFF, _P2, _P3)
    h2 = _hash2_parts(bz, bx, by)
    return h1, h2


def build_block_table(points, valid, cell_size: float, max_cells: int) -> BlockTable:
    """Cell dedup + block dedup + block-hash table (tloam_tpu/ops/voxel.py:672)."""
    n = points.shape[0]
    dev = points.device
    coords = _cell_coords(points, cell_size)
    coords = torch.where(valid[:, None], coords, _SENTINEL)
    pkeys = torch.where(valid, _hash_coords(coords), _SENTINEL)
    _, order_p = torch.sort(pkeys, stable=True)
    ps = torch.cat([coords, valid[:, None].to(torch.int32)], dim=1)[order_p]
    ok_s = ps[:, 3] > 0
    first = _first_of_runs(ps[:, 0], ps[:, 1], ps[:, 2])
    seg = torch.cumsum(first, 0) - 1
    seg_c = torch.where(ok_s & (seg < max_cells), seg, max_cells)

    # same-cell writers carry identical rows, so duplicate writes are benign
    cell_rows = torch.full((max_cells + 1, 4), _SENTINEL, dtype=torch.int32, device=dev)
    cell_rows[seg_c] = torch.where(ok_s[:, None], ps, _SENTINEL)
    cell_rows = cell_rows[:max_cells]
    cx, cy, cz = cell_rows[:, 0], cell_rows[:, 1], cell_rows[:, 2]
    cell_valid = cell_rows[:, 3] == 1
    point_cell = torch.full((n,), -1, dtype=torch.int32, device=dev)
    point_cell[order_p] = torch.where(seg_c < max_cells, seg_c, -1).to(torch.int32)

    # --- block dedup over the (small) cell list ---
    B = max_cells
    bx, by, bz = cx >> 1, cy >> 1, cz >> 1
    bh1, _ = _block_hashes(bx, by, bz)
    bkey = torch.where(cell_valid, bh1, _SENTINEL)
    _, order_c = torch.sort(bkey, stable=True)
    bs = torch.stack(
        [
            torch.where(cell_valid, bx, _SENTINEL),
            torch.where(cell_valid, by, _SENTINEL),
            torch.where(cell_valid, bz, _SENTINEL),
            cell_valid.to(torch.int32),
        ],
        dim=1,
    )[order_c]
    okc = bs[:, 3] > 0
    bfirst = _first_of_runs(bs[:, 0], bs[:, 1], bs[:, 2])
    bseg = torch.cumsum(bfirst, 0) - 1
    bseg_c = torch.where(okc, bseg, B)
    cell_block = torch.zeros((max_cells,), dtype=torch.int32, device=dev)
    cell_block[order_c] = torch.clamp(bseg_c, max=B - 1).to(torch.int32)

    block_rows = torch.full((B + 1, 4), _SENTINEL, dtype=torch.int32, device=dev)
    block_rows[bseg_c] = torch.where(okc[:, None], bs, _SENTINEL)
    block_rows = block_rows[:B]
    block_valid = block_rows[:, 3] == 1
    uh1, uh2 = _block_hashes(block_rows[:, 0], block_rows[:, 1], block_rows[:, 2])
    dt = build_direct_table(
        torch.where(block_valid, uh1, _SENTINEL), uh2, block_valid,
        torch.arange(B, dtype=torch.int32, device=dev),
    )
    slot = (cx & 1) + 2 * (cy & 1) + 4 * (cz & 1)
    cell_store = cell_block * 8 + torch.where(cell_valid, slot, 0)
    return BlockTable(cx, cy, cz, cell_valid, point_cell, cell_store, dt)


def block_window_probe_rows(bt: BlockTable, qcx, qcy, qcz):
    """(rows (Q,8) block row ids, found (Q,8)) of the 8 blocks covering each
    query cell's 3x3x3 window."""
    eb = _device_table("eb", qcx.device)
    nbx = (qcx >> 1)[:, None] + eb[0][None, :] + (qcx & 1)[:, None] - 1
    nby = (qcy >> 1)[:, None] + eb[1][None, :] + (qcy & 1)[:, None] - 1
    nbz = (qcz >> 1)[:, None] + eb[2][None, :] + (qcz & 1)[:, None] - 1
    h1, h2 = _block_hashes(nbx, nby, nbz)
    found, rows = direct_lookup(bt.dt, h1, h2)
    return rows, found


def block_window_probe(bt: BlockTable, qcx, qcy, qcz):
    """As block_window_probe_rows, plus the (Q,64) window mask |d| <= 1 of
    each candidate (e, s) at flat index e*8 + s."""
    rows, found = block_window_probe_rows(bt, qcx, qcy, qcz)
    eb = _device_table("eb", qcx.device)

    def dax(l, p, e):  # d[q, e, s] = l[s] + p[q] + 2 e[e] - 2
        return (l[None, None, :] + p[:, None, None] + 2 * e[None, :, None] - 2).reshape(-1, 64)

    window = found.repeat_interleave(8, dim=1)
    for a, qc in enumerate((qcx, qcy, qcz)):
        window = window & (torch.abs(dax(eb[a], qc & 1, eb[a])) <= 1)
    return rows, found, window


def scatter_cell_records(bt: BlockTable, values: torch.Tensor, width: int = 16) -> torch.Tensor:
    """Per-cell records (V, k<=width) -> the (B, 8*width) block store."""
    V, k = values.shape
    B = bt.cx.shape[0]
    vals = torch.nn.functional.pad(values, (0, width - k))
    tgt = torch.where(bt.cell_valid, bt.cell_store, B * 8).long()
    out = torch.zeros((B * 8 + 1, width), dtype=values.dtype, device=values.device)
    out[tgt] = vals
    return out[: B * 8].reshape(B, 8 * width)


def _window_coeff_tables():
    """Integer tables of the window aggregation (tloam_tpu/ops/voxel.py:828):
    out[i, stat] = sum_L rec[i, L] * (W0 + cs W1 + cs^2 W2)[p(i)][L, stat],
    lane L = e*128 + s*16 + f, plus the (8, 64) parity window masks."""
    W0 = np.zeros((8, 8, 8, 16, 10), np.float64)
    W1 = np.zeros_like(W0)
    W2 = np.zeros_like(W0)
    WMAX = np.zeros((8, 8, 8), np.float64)
    for p in range(8):
        px, py, pz = p & 1, (p >> 1) & 1, (p >> 2) & 1
        for e in range(8):
            exb, eyb, ezb = e & 1, (e >> 1) & 1, (e >> 2) & 1
            for s in range(8):
                lx, ly, lz = s & 1, (s >> 1) & 1, (s >> 2) & 1
                dx = lx + px + 2 * exb - 2
                dy = ly + py + 2 * eyb - 2
                dz = lz + pz + 2 * ezb - 2
                if abs(dx) > 1 or abs(dy) > 1 or abs(dz) > 1:
                    continue
                WMAX[p, e, s] = 1.0
                c = (p, e, s)
                W0[c][0, 0] = 1
                W0[c][1, 1] = 1; W1[c][0, 1] = dx
                W0[c][2, 2] = 1; W1[c][0, 2] = dy
                W0[c][3, 3] = 1; W1[c][0, 3] = dz
                W0[c][4, 4] = 1; W1[c][1, 4] = 2 * dx; W2[c][0, 4] = dx * dx
                W0[c][5, 5] = 1; W1[c][2, 5] = dx; W1[c][1, 5] = dy; W2[c][0, 5] = dx * dy
                W0[c][6, 6] = 1; W1[c][3, 6] = dx; W1[c][1, 6] = dz; W2[c][0, 6] = dx * dz
                W0[c][7, 7] = 1; W1[c][2, 7] = 2 * dy; W2[c][0, 7] = dy * dy
                W0[c][8, 8] = 1; W1[c][3, 8] = dy; W1[c][2, 8] = dz; W2[c][0, 8] = dy * dz
                W0[c][9, 9] = 1; W1[c][3, 9] = 2 * dz; W2[c][0, 9] = dz * dz
    rs = lambda W: W.reshape(8, 1024, 10)
    return rs(W0), rs(W1), rs(W2), WMAX.reshape(8, 64)


_W0, _W1, _W2, _WMAX = _window_coeff_tables()
_TABLES = {"offs": _OFFS, "eb": _EB, "w0": _W0, "w1": _W1, "w2": _W2, "wmax": _WMAX > 0.5}


@functools.cache
def _device_table(name: str, device: torch.device) -> torch.Tensor:
    """A constant table, copied to `device` once per process: a copy from
    pageable host memory waits for the device stream, so copying per call
    would stall the host in every frame. Callers never write to it."""
    return torch.as_tensor(_TABLES[name], device=device)


def block_window_moments(xyz, valid, bt: BlockTable, cell_size: float, return_cell: bool = False):
    """27-cell window moments about each cell's own anchor (cnt, sx, sy, sz,
    sxx, sxy, sxz, syy, syz, szz), aggregated by one (V,1024)@(1024,80)
    matmul against the constant parity tables.

    Returns (anchors (3 x (V,)), moments (10 x (V,)), probe cache (rows,
    found, parity)[, per-cell moments (V,10)])."""
    dtype = xyz.dtype
    dev = xyz.device
    V = bt.cx.shape[0]
    B = V
    cs = torch.full((), cell_size, dtype=dtype, device=dev)

    coords = _cell_coords(xyz, cell_size)
    qx = xyz[:, 0] - coords[:, 0].to(dtype) * cs
    qy = xyz[:, 1] - coords[:, 1].to(dtype) * cs
    qz = xyz[:, 2] - coords[:, 2].to(dtype) * cs
    pc = bt.point_cell
    in_cell = valid & (pc >= 0)
    m = in_cell.to(dtype)
    seg = torch.where(in_cell, bt.cell_store[torch.clamp(pc, min=0).long()], B * 8).long()
    z = torch.zeros_like(m)
    vals = torch.stack(
        [
            m,
            qx * m, qy * m, qz * m,
            qx * qx * m, qx * qy * m, qx * qz * m,
            qy * qy * m, qy * qz * m, qz * qz * m,
            z, z, z, z, z, z,
        ],
        dim=1,
    )
    # index_put_ with accumulate sorts the indices and adds each cell's
    # points in input order, the same in every run; index_add_'s CUDA
    # atomics add in a run-dependent order, and the solve carries that noise
    store = torch.zeros((B * 8 + 1, 16), dtype=dtype, device=dev).index_put_((seg,), vals, accumulate=True)
    store = store[: B * 8].reshape(B, 128)

    rows, found = block_window_probe_rows(bt, bt.cx, bt.cy, bt.cz)
    r = store[torch.where(found, rows, 0).reshape(-1).long()]
    r = r * found.reshape(-1, 1).to(dtype)
    rec_flat = r.reshape(V, 1024)

    W = (
        _device_table("w0", dev).to(dtype)
        + cs * _device_table("w1", dev).to(dtype)
        + (cs * cs) * _device_table("w2", dev).to(dtype)
    )  # (8, 1024, 10)
    big = rec_flat @ W.permute(1, 0, 2).reshape(1024, 80)  # (V, 80)
    parity = (bt.cx & 1) + 2 * (bt.cy & 1) + 4 * (bt.cz & 1)
    out = big.view(V, 8, 10)[torch.arange(V, device=dev), parity.long()]

    anchors = (bt.cx.to(dtype) * cs, bt.cy.to(dtype) * cs, bt.cz.to(dtype) * cs)
    moments = tuple(out[:, i] for i in range(10))
    cache = (rows, found, parity)
    if return_cell:
        cell_rec = store.reshape(B * 8, 16)[torch.clamp(bt.cell_store, max=B * 8 - 1).long()][:, :10]
        cell_rec = cell_rec * bt.cell_valid[:, None].to(dtype)
        return anchors, moments, cache, cell_rec
    return anchors, moments, cache


def block_window_scalar_max(bt: BlockTable, cell_values, rows, found, parity):
    """Per-cell max of a scalar over its 27-cell window, reusing a
    block_window_moments probe cache."""
    B = bt.cx.shape[0]
    dtype = cell_values.dtype
    dev = cell_values.device
    NEG = torch.finfo(dtype).min
    flat_tgt = torch.where(
        bt.cell_valid, (bt.cell_store >> 3) * 8 + (bt.cell_store & 7), B * 8
    ).long()
    store = torch.full((B * 8 + 1,), NEG, dtype=dtype, device=dev)
    store[flat_tgt] = torch.where(bt.cell_valid, cell_values, NEG)
    store = store[: B * 8].reshape(B, 8)
    V = rows.shape[0]
    r = store[torch.where(found, rows, 0).reshape(-1).long()]
    r = torch.where(found.reshape(-1, 1), r, NEG).reshape(V, 64)
    wmax = _device_table("wmax", dev)  # (8, 64)
    cand = torch.where(wmax[parity.long()], r, NEG)
    return torch.max(cand, dim=-1).values
