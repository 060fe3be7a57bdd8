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
  * `block_window_moments` sums each cell's float moments serially in
    input order: on a CUDA tensor in the hand-written kernel
    ``csrc/window_moments.cu``, on a CPU tensor in its plain version, an
    accumulating `index_put_` with the same order and arithmetic (the
    card tests hold the two equal bit for bit). A run on the card repeats
    bit for bit; the outputs agree with the JAX module to float32 rounding
    (1e-5 relative), not bit for bit;
  * the tables and lookups the solver calls take an optional leading frame
    axis (see "Frame axis" below): frame f of a batch holds exactly the
    one-frame call's cells, buckets, drops and payloads on frame f; the
    window moments' one matrix product may round a frame differently where
    the library picks its kernel by the batch's size.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tloam_torch import build
from tloam_torch.cloud import map_tensors
from tloam_torch.utils.timing import STAGES

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
# Frame axis. Every table builder and lookup below takes an optional leading
# frame axis F: points (F, n, 3), valid (F, n), and so on; the tables then
# carry it too. Frame f's table is exactly the one-frame call's on frame f.
# The F frames are built by 1-D operations over all F*n entries: each sort
# runs on one int64 key with the frame index in its high bits (a stable
# sort keeps every frame's own order), each scan restarts at the frame
# starts, each scatter target and table row is offset by f x capacity.
# So the host issues the same operations whatever F is.
# ---------------------------------------------------------------------------


def _enframe(x):
    """One frame -> a batch of one (every tensor gains a leading axis)."""
    return map_tensors(x, lambda t: t[None])


def _unframe(x):
    """A batch of one -> the frame (inverse of _enframe)."""
    return map_tensors(x, lambda t: t[0])


def _frame_offsets(F: int, size: int, like: torch.Tensor) -> torch.Tensor:
    """(F, 1, ..., 1) int64 offsets f * size, broadcasting against `like`."""
    return (torch.arange(F, device=like.device) * size).view((F,) + (1,) * (like.ndim - 1))


def take(src: torch.Tensor, idx: torch.Tensor, frames: bool) -> torch.Tensor:
    """src[idx] along src's leading point axis; with `frames`, src (F, M, ...)
    and idx (F, ...) index frame by frame."""
    if not frames:
        return src[idx]
    F, M = src.shape[:2]
    return src.reshape((F * M,) + src.shape[2:])[idx + _frame_offsets(F, M, idx)]


def _frame_key(key: torch.Tensor) -> torch.Tensor:
    """(F, n) int32 keys -> one (F*n,) int64 key ordered by frame, then by
    key: frame in bits 33 and up, key + 2^31 below."""
    k = key.to(torch.int64) + 2**31
    return (k + (torch.arange(key.shape[0], device=key.device)[:, None] << 33)).reshape(-1)


def cumsum_frames(x: torch.Tensor, F: int) -> torch.Tensor:
    """Inclusive int64 cumsum of a (F*n,) tensor, restarting at each frame:
    one 1-D scan less each frame's starting value."""
    x = x.to(torch.int64).view(F, -1)
    cs = torch.cumsum(x.view(-1), 0).view(F, -1)
    return (cs - (cs[:, :1] - x[:, :1])).view(-1)


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
    """B buckets of 8 (check, payload) slots: check/payload ([F,] B, 8)
    int32; empty slots hold SENTINEL in check. B = next_pow2(max(V, 64))."""

    check: torch.Tensor
    payload: torch.Tensor


def build_direct_table(keys, keys2, valid, payload) -> DirectTable:
    """Insert V entries ([F,] V each): one stable sort by bucket gives each
    entry its in-bucket rank; ranks >= 8 are dropped
    (tloam_tpu/ops/voxel.py:328)."""
    if keys.ndim == 1:
        return _unframe(build_direct_table(keys[None], keys2[None], valid[None], payload[None]))
    F, V = keys.shape
    dev = keys.device
    B = 1 << int(np.ceil(np.log2(max(V, 64))))
    H = B * _BUCKET
    check = _check_code(keys, keys2).view(-1)
    bucket = torch.where(valid, keys & (B - 1), B)
    b_s, order = torch.sort(_frame_key(bucket), stable=True)
    check_s, pay_s, valid_s = check[order], payload.reshape(-1)[order].to(torch.int32), valid.reshape(-1)[order]
    idx = torch.arange(F * V, device=dev)
    start = torch.cummax(torch.where(_first_of_runs(b_s), idx, 0), 0).values
    rank = idx - start
    # slot (frame, bucket, rank) -> frame*H + bucket*8 + rank; one drop slot F*H
    slot = (b_s >> 33) * H + ((b_s & 0xFFFFFFFF) - 2**31) * _BUCKET + rank
    tgt = torch.where(valid_s & (rank < _BUCKET), slot, F * H)
    c = torch.full((F * H + 1,), _SENTINEL, dtype=torch.int32, device=dev)
    p = torch.full((F * H + 1,), _SENTINEL, dtype=torch.int32, device=dev)
    c[tgt] = check_s
    p[tgt] = pay_s
    return DirectTable(c[: F * H].view(F, B, _BUCKET), p[: F * H].view(F, B, _BUCKET))


def direct_lookup(table: DirectTable, h1: torch.Tensor, h2: torch.Tensor):
    """Vectorized lookup for any shape (a table with a frame axis takes
    queries (F, ...)). Returns (found bool, payload int32; 0 where not
    found)."""
    if table.check.ndim == 2:
        return _unframe(direct_lookup(_enframe(table), h1[None], h2[None]))
    F, B = table.check.shape[:2]
    shape = h1.shape
    h1f = h1.reshape(F, -1)
    check = _check_code(h1f, h2.reshape(F, -1))
    bucket = (h1f & (B - 1)).long() + _frame_offsets(F, B, h1f)
    hit = table.check.view(F * B, _BUCKET)[bucket] == check[..., None]  # at most one slot hits
    found = hit.any(dim=-1)
    pay = torch.where(hit, table.payload.view(F * B, _BUCKET)[bucket], 0).sum(dim=-1).to(torch.int32)
    return found.reshape(shape), pay.reshape(shape)


# ---------------------------------------------------------------------------
# Hash-grid kNN (the sphere family's 1-NN on the main path)
# ---------------------------------------------------------------------------


class HashGrid(NamedTuple):
    """pts ([F,] M, 3) in hash-sorted order, src_idx ([F,] M) original index
    of each sorted slot, dt cell -> (run start << 8 | count), cell_size
    (python float)."""

    pts: torch.Tensor
    src_idx: torch.Tensor
    dt: DirectTable
    cell_size: float


def build_hash_grid(points, valid, cell_size: float) -> HashGrid:
    if points.ndim == 2:
        return _unframe(build_hash_grid(points[None], valid[None], cell_size))
    F, M = valid.shape
    dev = points.device
    coords = _cell_coords(points, cell_size)
    keys = torch.where(valid, _hash_coords(coords), _SENTINEL)
    keys2 = torch.where(valid, _hash2_coords(coords), 0)
    fk_s, order = torch.sort(_frame_key(keys), stable=True)
    keys_s, keys2_s = keys.view(-1)[order], keys2.view(-1)[order]
    live = keys_s != _SENTINEL
    run_first = _first_of_runs(fk_s) & live
    cell_id = cumsum_frames(run_first, F) - 1  # within the frame
    frame_m = (fk_s >> 33) * M
    pos = (torch.arange(F * M, device=dev) % M).to(torch.int32)
    crec = torch.full((F * M + 1, 3), _SENTINEL, dtype=torch.int32, device=dev)
    crec[torch.where(run_first, frame_m + cell_id, F * M)] = torch.stack([pos, keys_s, keys2_s], dim=1)
    crec = crec[: F * M].view(F, M, 3)
    unused = crec[..., 1] == _SENTINEL
    starts = torch.where(unused, 0, crec[..., 0])
    cell_key = crec[..., 1]
    cell_key2 = torch.where(unused, 0, crec[..., 2])
    counts = torch.zeros(F * M + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(live, frame_m + cell_id, F * M), torch.ones(F * M, dtype=torch.int32, device=dev)
    )[: F * M].view(F, M)
    dt = build_direct_table(
        cell_key, cell_key2, cell_key != _SENTINEL,
        starts * 256 + torch.clamp(counts, max=255),
    )
    return HashGrid(points.reshape(F * M, 3)[order].view(F, M, 3), (order % M).view(F, M), dt, float(cell_size))


def _hash2_coords(c: torch.Tensor) -> torch.Tensor:
    return _hash2_parts(c[..., 0], c[..., 1], c[..., 2])


_OFFS = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)], np.int32
)  # (27,3): the JAX module's _OFF1/_OFF2/_OFF3 order


def _query_block(grid: HashGrid, queries, query_valid, k: int, r: torch.Tensor, C: int):
    """One block of framed queries (F, q, 3) against a framed grid."""
    F, M = grid.src_idx.shape
    q = queries.shape[1]
    dev = queries.device
    offs = _device_table("offs", dev)
    qc = _cell_coords(queries, grid.cell_size)
    nx = qc[..., 0:1] + offs[:, 0]
    ny = qc[..., 1:2] + offs[:, 1]
    nz = qc[..., 2:3] + offs[:, 2]
    found, pay = direct_lookup(
        grid.dt, _lin3(nx, ny, nz, _P1, _P2, _P3), _hash2_parts(nx, ny, nz)
    )  # (F,q,27)
    start = (pay >> 8).long()
    count = pay & 255
    ar = torch.arange(C, device=dev)
    slots = (start[..., None] + ar).reshape(F, q, 27 * C)
    slots_c = torch.clamp(slots, max=M - 1)
    within = (ar < torch.clamp(count, max=C)[..., None]).reshape(F, q, 27 * C)
    match = within & found[..., None].expand(F, q, 27, C).reshape(F, q, 27 * C)
    cand = take(grid.pts, slots_c, True)  # (F, q, 27C, 3)
    dx = cand[..., 0] - queries[..., 0:1]
    dy = cand[..., 1] - queries[..., 1:2]
    dz = cand[..., 2] - queries[..., 2:3]
    dist_sq = dx * dx + dy * dy + dz * dz
    ok = match & (dist_sq <= r * r) & query_valid[..., None]
    BIG = torch.finfo(queries.dtype).max
    masked = torch.where(ok, dist_sq, BIG)
    # lax.top_k order: k smallest, ties to the lower candidate index
    nn_dist, arg = torch.sort(masked, dim=-1, stable=True)
    nn_dist, arg = nn_dist[..., :k], arg[..., :k]
    nn_slot = torch.gather(slots_c, -1, arg)
    nn_ok = torch.gather(ok, -1, arg)
    return take(grid.src_idx, nn_slot, True), torch.where(nn_ok, nn_dist, BIG), nn_ok


def query_knn(grid: HashGrid, queries, query_valid, k: int, radius=None, max_per_cell: int = 8,
              chunk_size: int | None = None):
    """Batched kNN within `radius` (defaults to the cell size): (idx ([F,] Q,
    k) into the ORIGINAL buffer, dist_sq, neighbor_valid). Replaces
    KDTreeFlann::SearchHybrid. With `chunk_size`, queries run in chunks of
    that many, which bounds the candidate gather to chunk_size x 27 x
    max_per_cell points; each query's answer does not depend on the chunk."""
    if grid.pts.ndim == 2:
        return _unframe(query_knn(_enframe(grid), queries[None], query_valid[None], k, radius, max_per_cell,
                                  chunk_size))
    r = torch.full((), grid.cell_size if radius is None else radius, dtype=queries.dtype,
                     device=queries.device)
    Q = queries.shape[1]
    if chunk_size is None or chunk_size >= Q:
        return _query_block(grid, queries, query_valid, k, r, max_per_cell)
    parts = [
        _query_block(grid, queries[:, i:i + chunk_size], query_valid[:, i:i + chunk_size], k, r, max_per_cell)
        for i in range(0, Q, chunk_size)
    ]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def gather_planes(points: torch.Tensor, idx: torch.Tensor):
    """Neighbour coordinates as three ([F,] Q, k) planes."""
    frames = points.ndim == 3
    return tuple(take(points[..., a], idx, frames) for a in range(3))


# ---------------------------------------------------------------------------
# Packed record gathers (tloam_tpu/ops/voxel.py:574-613). On a TPU a gather
# pays per row, so the JAX module packs each record's K values into `width`
# contiguous lanes, 128 // width records to a row. The port keeps the layout
# and computes the same arrays; its own solver gathers (n, k) tensors.
# ---------------------------------------------------------------------------


def pack_records(cols: torch.Tensor, width: int) -> torch.Tensor:
    """Pack a (K <= width, V) SoA block into (ceil(V / (128 / width)), 128)
    rows of `width`-lane records. `width` must divide 128."""
    K, V = cols.shape
    per = 128 // width
    Vp = -(-V // per) * per
    a = torch.nn.functional.pad(cols, (0, Vp - V, 0, width - K))
    return a.T.reshape(Vp // per, 128)


def unpack_records(packed: torch.Tensor, k: int, width: int) -> torch.Tensor:
    """Inverse of pack_records: (rows, 128) -> (k, rows * 128 / width)
    (the first k lanes of each record; trailing pad records included)."""
    per = 128 // width
    return packed.reshape(packed.shape[0] * per, width).T[:k]


def gather_records(packed: torch.Tensor, idx: torch.Tensor, width: int, k: int) -> torch.Tensor:
    """Records packed by pack_records: idx (n,) -> (n, k), the first k lanes
    of each record. Out-of-range idx must be clamped by the caller."""
    per = 128 // width
    grp = packed[idx // per].reshape(-1, per, width)
    sel = (idx % per)[:, None, None] == torch.arange(per, device=idx.device)[None, :, None]
    # the JAX module's masked sum (a -0.0 record lane reads as +0.0)
    rec = torch.sum(torch.where(sel, grp, torch.zeros((), dtype=grp.dtype, device=grp.device)), dim=1)
    return rec.to(packed.dtype)[:, :k]


def neighbour_covariance(points: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor):
    """Covariance (a00, a01, a02, a11, a12, a22) of each point's valid
    neighbours idx ([F,] Q, k), from moments about the point itself:
    raw-coordinate second moments cancel in float32 at map scale."""
    m = ok.to(points.dtype)
    cnt = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    xs, ys, zs = gather_planes(points, idx)
    xs = (xs - points[..., 0:1]) * m
    ys = (ys - points[..., 1:2]) * m
    zs = (zs - points[..., 2:3]) * m
    mx, my, mz = (torch.sum(a, -1) / cnt for a in (xs, ys, zs))
    return (
        torch.sum(xs * xs, -1) / cnt - mx * mx,
        torch.sum(xs * ys, -1) / cnt - mx * my,
        torch.sum(xs * zs, -1) / cnt - mx * mz,
        torch.sum(ys * ys, -1) / cnt - my * my,
        torch.sum(ys * zs, -1) / cnt - my * mz,
        torch.sum(zs * zs, -1) / cnt - mz * mz,
    )


def voxel_select_top(xyz, intensity, valid, score, voxel_size: float, max_out: int):
    """The highest-`score` original point of each occupied voxel (no
    averaging), compacted to `max_out` slots in hash order, thinned
    uniformly on overflow (tloam_tpu/ops/voxel.py:224-289). One int32 key
    sorts by (21 high bits of the cell hash, descending 10-bit score rank);
    run boundaries use the exact cell coordinates."""
    dtype = xyz.dtype
    coords = _cell_coords(xyz, voxel_size)
    coords = torch.where(valid[:, None], coords, _SENTINEL)
    h = _hash_coords(coords) & 0x7FFFFFFF
    lo, width = score_range(score, valid)
    # float -> int32 truncates toward zero, as .astype(int32)
    sq = torch.clamp(((score - lo) / width * 1023.0).to(torch.int32), 0, 1023)
    key = torch.where(valid, ((h >> 10) << 10) | (1023 - sq), _SENTINEL)
    _, cx_s, cy_s, cz_s, x_s, y_s, z_s, int_s, valid_s = sort_with_payload(
        key, coords[:, 0], coords[:, 1], coords[:, 2], xyz[:, 0], xyz[:, 1], xyz[:, 2], intensity, valid,
    )
    winner = _first_of_runs(cx_s, cy_s, cz_s) & valid_s
    seg = torch.cumsum(winner, 0) - 1  # winner rank
    n_cells = torch.sum(winner)
    ratio = max_out / torch.clamp(n_cells, min=1).to(dtype)
    row = torch.floor(seg.to(dtype) * ratio).long()
    prev_row = torch.floor((seg - 1).to(dtype) * ratio).long()
    kept = (seg == 0) | (row > prev_row)
    slot = torch.where(
        n_cells > max_out,
        torch.where(winner & kept, torch.clamp(row, max=max_out - 1), _SENTINEL),
        torch.where(winner, seg, _SENTINEL),
    )
    sk, ox, oy, oz, oi = sort_with_payload(slot, x_s, y_s, z_s, int_s)
    out_ok = _takepad(sk, max_out, _SENTINEL) < _SENTINEL
    m = out_ok.to(dtype)
    out_xyz = torch.stack([_takepad(a, max_out, 0.0) * m for a in (ox, oy, oz)], dim=1)
    return out_xyz, _takepad(oi, max_out, 0.0) * m, out_ok


def score_range(score: torch.Tensor, valid: torch.Tensor):
    """(lo, width) of the valid scores; 0 and 1 where none is valid."""
    smax = torch.max(torch.where(valid, score, -torch.inf))
    smin = torch.min(torch.where(valid, score, torch.inf))
    lo = torch.where(torch.isfinite(smin), smin, 0.0)
    hi = torch.where(torch.isfinite(smax), smax, 1.0)
    return lo, torch.clamp(hi - lo, min=1e-12)


# ---------------------------------------------------------------------------
# Morton-block record store (2x2x2 cell blocks; 8 block rows cover any
# 3x3x3 cell window — tloam_tpu/ops/voxel.py:616-654)
# ---------------------------------------------------------------------------

_EB = np.array([[(i >> k) & 1 for i in range(8)] for k in range(3)], np.int32)  # (3,8)


class BlockTable(NamedTuple):
    """cx/cy/cz ([F,] V) int32 cell coords (sentinel where unused),
    cell_valid ([F,] V), point_cell ([F,] N) cell row per point (-1
    invalid), cell_store ([F,] V) block_row * 8 + Morton slot, dt block hash
    -> block row, point_order ([F,] N) int32 the frame's point indices
    sorted stably by cell key: cell row v is the v-th run of equal cells
    in that order, its points in input order."""

    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    cell_valid: torch.Tensor
    point_cell: torch.Tensor
    cell_store: torch.Tensor
    dt: DirectTable
    point_order: torch.Tensor


def _block_hashes(bx, by, bz):
    h1 = _lin3(bx, by, bz, 2654435761 & 0x7FFFFFFF, _P2, _P3)
    h2 = _hash2_parts(bz, bx, by)
    return h1, h2


def _runs_in_frames(first: torch.Tensor, F: int):
    """(run index within the frame, frame) of every entry of a frame-major
    (F*n,) order whose run starts are `first`; every frame starts a run."""
    n = first.shape[0] // F
    pos = torch.arange(F * n, device=first.device)
    return cumsum_frames(first | (pos % n == 0), F) - 1, pos // n


def build_block_table(points, valid, cell_size: float, max_cells: int) -> BlockTable:
    """Cell dedup + block dedup + block-hash table (tloam_tpu/ops/voxel.py:672)."""
    if points.ndim == 2:
        return _unframe(build_block_table(points[None], valid[None], cell_size, max_cells))
    F, n = valid.shape
    dev = points.device
    coords = _cell_coords(points, cell_size)
    coords = torch.where(valid[..., None], coords, _SENTINEL)
    pkeys = torch.where(valid, _hash_coords(coords), _SENTINEL)
    _, order_p = torch.sort(_frame_key(pkeys), stable=True)
    ps = torch.cat([coords, valid[..., None].to(torch.int32)], dim=-1).view(F * n, 4)[order_p]
    ok_s = ps[:, 3] > 0
    seg, frame = _runs_in_frames(_first_of_runs(ps[:, 0], ps[:, 1], ps[:, 2]), F)
    live = ok_s & (seg < max_cells)

    # same-cell writers carry identical rows, so duplicate writes are benign
    cell_rows = torch.full((F * max_cells + 1, 4), _SENTINEL, dtype=torch.int32, device=dev)
    cell_rows[torch.where(live, frame * max_cells + seg, F * max_cells)] = torch.where(ok_s[:, None], ps, _SENTINEL)
    cell_rows = cell_rows[: F * max_cells].view(F, max_cells, 4)
    cx, cy, cz = cell_rows[..., 0], cell_rows[..., 1], cell_rows[..., 2]
    cell_valid = cell_rows[..., 3] == 1
    point_cell = torch.full((F * n,), -1, dtype=torch.int32, device=dev)
    point_cell[order_p] = torch.where(live, seg, -1).to(torch.int32)

    # --- block dedup over the (small) cell list ---
    B = max_cells
    bx, by, bz = cx >> 1, cy >> 1, cz >> 1
    bh1, _ = _block_hashes(bx, by, bz)
    _, order_c = torch.sort(_frame_key(torch.where(cell_valid, bh1, _SENTINEL)), stable=True)
    bs = torch.stack(
        [
            torch.where(cell_valid, bx, _SENTINEL),
            torch.where(cell_valid, by, _SENTINEL),
            torch.where(cell_valid, bz, _SENTINEL),
            cell_valid.to(torch.int32),
        ],
        dim=-1,
    ).view(F * B, 4)[order_c]
    okc = bs[:, 3] > 0
    bseg, bframe = _runs_in_frames(_first_of_runs(bs[:, 0], bs[:, 1], bs[:, 2]), F)
    cell_block = torch.zeros((F * B,), dtype=torch.int32, device=dev)
    cell_block[order_c] = torch.clamp(torch.where(okc, bseg, B), max=B - 1).to(torch.int32)
    cell_block = cell_block.view(F, B)

    block_rows = torch.full((F * B + 1, 4), _SENTINEL, dtype=torch.int32, device=dev)
    block_rows[torch.where(okc, bframe * B + bseg, F * B)] = torch.where(okc[:, None], bs, _SENTINEL)
    block_rows = block_rows[: F * B].view(F, B, 4)
    block_valid = block_rows[..., 3] == 1
    uh1, uh2 = _block_hashes(block_rows[..., 0], block_rows[..., 1], block_rows[..., 2])
    dt = build_direct_table(
        torch.where(block_valid, uh1, _SENTINEL), uh2, block_valid,
        (torch.arange(F * B, device=dev) % B).to(torch.int32).view(F, B),
    )
    slot = (cx & 1) + 2 * (cy & 1) + 4 * (cz & 1)
    cell_store = cell_block * 8 + torch.where(cell_valid, slot, 0)
    point_order = (order_p % n).to(torch.int32).view(F, n)
    return BlockTable(cx, cy, cz, cell_valid, point_cell.view(F, n), cell_store, dt, point_order)


def block_window_probe_rows(bt: BlockTable, qcx, qcy, qcz):
    """(rows ([F,] Q, 8) block row ids, found) of the 8 blocks covering each
    query cell's 3x3x3 window."""
    eb = _device_table("eb", qcx.device)
    nbx = (qcx >> 1)[..., None] + eb[0] + (qcx & 1)[..., None] - 1
    nby = (qcy >> 1)[..., None] + eb[1] + (qcy & 1)[..., None] - 1
    nbz = (qcz >> 1)[..., None] + eb[2] + (qcz & 1)[..., None] - 1
    h1, h2 = _block_hashes(nbx, nby, nbz)
    found, rows = direct_lookup(bt.dt, h1, h2)
    return rows, found


def block_window_probe(bt: BlockTable, qcx, qcy, qcz):
    """As block_window_probe_rows, plus the ([F,] Q, 64) window mask |d| <= 1
    of each candidate (e, s) at flat index e*8 + s."""
    rows, found = block_window_probe_rows(bt, qcx, qcy, qcz)
    eb = _device_table("eb", qcx.device)
    lead = found.shape[:-1]

    def dax(l, p, e):  # d[..., e, s] = l[s] + p[...] + 2 e[e] - 2
        return (l + p[..., None, None] + 2 * e[:, None] - 2).reshape(lead + (64,))

    window = found[..., None].expand(lead + (8, 8)).reshape(lead + (64,))
    for a, qc in enumerate((qcx, qcy, qcz)):
        window = window & (torch.abs(dax(eb[a], qc & 1, eb[a])) <= 1)
    return rows, found, window


def _store_targets(bt: BlockTable) -> torch.Tensor:
    """Flat row of every cell record in a framed (F*B*8 [+1], ...) store;
    cells that are not valid go to the drop row F*B*8."""
    F, B = bt.cx.shape
    return torch.where(bt.cell_valid, bt.cell_store + _frame_offsets(F, B * 8, bt.cx), F * B * 8)


def block_window_records(store: torch.Tensor, rows: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """The 8 block rows of each query from a (B, 128) store: (Q, 8) ->
    (Q, 64, 16) candidate records (slot-major within a block; zeros where
    the block is absent)."""
    q = rows.shape[0]
    r = store[torch.where(found, rows, 0).reshape(-1).long()]
    r = r.reshape(q, 8, 8, 16) * found[:, :, None, None].to(store.dtype)
    return r.reshape(q, 64, 16)


def scatter_cell_records(bt: BlockTable, values: torch.Tensor, width: int = 16) -> torch.Tensor:
    """Per-cell records ([F,] V, k<=width) -> the ([F,] B, 8*width) block store."""
    if bt.cx.ndim == 1:
        return scatter_cell_records(_enframe(bt), values[None], width)[0]
    F, V, k = values.shape
    B = bt.cx.shape[1]
    vals = torch.nn.functional.pad(values, (0, width - k))
    out = torch.zeros((F * B * 8 + 1, width), dtype=values.dtype, device=values.device)
    out[_store_targets(bt).view(-1)] = vals.view(F * V, width)
    return out[: F * B * 8].view(F, B, 8 * width)


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


def _window_rows(store: torch.Tensor, rows: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """The 8 block rows of every window from a framed (F*B+1, w) store whose
    last row is all zero: rows not found read that row."""
    F = rows.shape[0]
    B = (store.shape[0] - 1) // F
    return store[torch.where(found, rows.long() + _frame_offsets(F, B, rows), F * B)]


def _window_store_plain(xyz, valid, bt: BlockTable, cell_size: float) -> torch.Tensor:
    """The per-cell moment records of a framed table, (F*V*8 + 8, 16): row
    cell_store + f*V*8 holds lanes 0-9 (cnt, q, q q^T) summed over the
    cell's points, q = point - cell anchor; every other row and lanes 10-15
    are 0. The plain version of csrc/window_moments.cu."""
    dtype = xyz.dtype
    dev = xyz.device
    F, n = valid.shape
    B = bt.cx.shape[1]
    cs = torch.full((), cell_size, dtype=dtype, device=dev)
    coords = _cell_coords(xyz, cell_size)
    qx = xyz[..., 0] - coords[..., 0].to(dtype) * cs
    qy = xyz[..., 1] - coords[..., 1].to(dtype) * cs
    qz = xyz[..., 2] - coords[..., 2].to(dtype) * cs
    pc = bt.point_cell
    in_cell = valid & (pc >= 0)
    m = in_cell.to(dtype)
    store_row = take(bt.cell_store, torch.clamp(pc, min=0).long(), True) + _frame_offsets(F, B * 8, pc)
    seg = torch.where(in_cell, store_row, F * B * 8)
    z = torch.zeros_like(m)
    vals = torch.stack(
        [
            m,
            qx * m, qy * m, qz * m,
            qx * qx * m, qx * qy * m, qx * qz * m,
            qy * qy * m, qy * qz * m, qz * qz * m,
            z, z, z, z, z, z,
        ],
        dim=-1,
    )
    # index_put_ with accumulate sorts the indices and adds each cell's
    # points in input order, the same in every run; index_add_'s CUDA
    # atomics add in a run-dependent order, and the solve carries that noise.
    # Points in no cell land in the drop row F*B*8, cleared after.
    store = torch.zeros((F * B * 8 + 8, 16), dtype=dtype, device=dev).index_put_(
        (seg.view(-1),), vals.view(F * n, 16), accumulate=True)
    store[F * B * 8:] = 0.0  # the drop row doubles as the zero row
    return store


_window_fn = None  # the library's launch function, bound at first use


def _window_kernel():
    global _window_fn
    if _window_fn is None:
        fn = build.load("window_moments").tloam_window_moments
        fn.restype = ctypes.c_int
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [ptr] * 7 + [i64] * 2 + [ptr] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ptr]
        _window_fn = fn
    return _window_fn


def _window_store_cuda(xyz, valid, bt: BlockTable, cell_size: float) -> torch.Tensor:
    """Launch csrc/window_moments.cu: one thread per slot of each frame's
    point_order, the first slot of each cell's run sums it. Same store as
    `_window_store_plain`, bit for bit. xyz, valid and the table's tensors
    must be contiguous (cx, cy, cz may share one stride). Each launch adds
    one to the counter ``window_moments.launch``."""
    F, n = valid.shape
    V = bt.cx.shape[-1]
    if not (xyz.dtype is torch.float32 and xyz.shape == (F, n, 3) and xyz.is_contiguous()):
        raise ValueError(f"window_moments: xyz must be a contiguous float32 tensor of shape {(F, n, 3)}")
    if not (valid.dtype is torch.bool and valid.is_contiguous()):
        raise ValueError("window_moments: valid must be a contiguous bool tensor")
    for name, dtype, shape in (("point_cell", torch.int32, (F, n)), ("point_order", torch.int32, (F, n)),
                               ("cell_valid", torch.bool, (F, V)), ("cell_store", torch.int32, (F, V))):
        t = getattr(bt, name)
        if not (t.dtype is dtype and t.shape == shape and t.is_contiguous()):
            raise ValueError(f"window_moments: the table's {name} must be a contiguous {dtype} tensor of shape {shape}")
    coords = (bt.cx, bt.cy, bt.cz)
    if not all(c.dtype is torch.int32 and c.shape == (F, V) and c.stride() == bt.cx.stride() for c in coords):
        raise ValueError(f"window_moments: the table's cx, cy, cz must be int32 of shape {(F, V)}, with one stride")
    dev = xyz.device
    if not (dev.type == "cuda" and all(t.device == dev for t in (valid, bt.point_cell, bt.point_order,
                                                                   bt.cell_valid, bt.cell_store, *coords))):
        raise ValueError("window_moments: every input must be a CUDA tensor on one device")
    fn = _window_kernel()
    store = torch.zeros((F * V * 8 + 8, 16), dtype=torch.float32, device=dev)
    # the launch goes to the current device: switch only when xyz lies elsewhere
    on_dev = contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)
    with on_dev:
        rc = fn(
            xyz.data_ptr(), valid.data_ptr(), bt.point_cell.data_ptr(), bt.point_order.data_ptr(),
            bt.cx.data_ptr(), bt.cy.data_ptr(), bt.cz.data_ptr(), *bt.cx.stride(),
            bt.cell_valid.data_ptr(), bt.cell_store.data_ptr(), store.data_ptr(), F, n, V, cell_size,
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    if rc != 0:
        raise RuntimeError(f"window_moments: kernel launch failed with CUDA error {rc}")
    STAGES.count("window_moments.launch")
    return store


def _window_store(xyz, valid, bt: BlockTable, cell_size: float) -> torch.Tensor:
    """Dispatch by device: the CUDA kernel on a CUDA tensor (points and
    flags made contiguous: the unpacked frame path hands over columns of an
    (n, 4) array), the plain version on a CPU tensor."""
    if xyz.device.type == "cuda":
        return _window_store_cuda(xyz.contiguous(), valid.contiguous(), bt, cell_size)
    if xyz.device.type == "cpu":
        return _window_store_plain(xyz, valid, bt, cell_size)
    raise ValueError(f"window_moments: unsupported device {xyz.device}")


def block_window_moments(xyz, valid, bt: BlockTable, cell_size: float, return_cell: bool = False):
    """27-cell window moments about each cell's own anchor (cnt, sx, sy, sz,
    sxx, sxy, sxz, syy, syz, szz), aggregated by one (F*V,1024)@(1024,80)
    matmul against the constant parity tables.

    Returns (anchors (3 x ([F,] V)), moments (10 x ([F,] V)), probe cache
    (rows, found, parity)[, per-cell moments ([F,] V, 10)])."""
    if xyz.ndim == 2:
        return _unframe(block_window_moments(xyz[None], valid[None], _enframe(bt), cell_size, return_cell))
    dtype = xyz.dtype
    dev = xyz.device
    F = valid.shape[0]
    V = bt.cx.shape[1]
    B = V
    cs = torch.full((), cell_size, dtype=dtype, device=dev)

    store = _window_store(xyz, valid, bt, cell_size)
    flat = store.view(F * B + 1, 128)

    rows, found = block_window_probe_rows(bt, bt.cx, bt.cy, bt.cz)
    rec_flat = _window_rows(flat, rows, found).view(F * V, 1024)
    W = (
        _device_table("w0", dev).to(dtype)
        + cs * _device_table("w1", dev).to(dtype)
        + (cs * cs) * _device_table("w2", dev).to(dtype)
    )  # (8, 1024, 10)
    big = rec_flat @ W.permute(1, 0, 2).reshape(1024, 80)  # (F*V, 80)
    parity = (bt.cx & 1) + 2 * (bt.cy & 1) + 4 * (bt.cz & 1)
    out = torch.take_along_dim(big.view(F, V, 8, 10), parity.long()[..., None, None], dim=-2)[..., 0, :]

    anchors = (bt.cx.to(dtype) * cs, bt.cy.to(dtype) * cs, bt.cz.to(dtype) * cs)
    moments = tuple(out[..., i] for i in range(10))
    cache = (rows, found, parity)
    if return_cell:
        cell_rec = store[torch.clamp(bt.cell_store, max=B * 8 - 1).long() + _frame_offsets(F, B * 8, bt.cell_store)][..., :10]
        cell_rec = cell_rec * bt.cell_valid[..., None].to(dtype)
        return anchors, moments, cache, cell_rec
    return anchors, moments, cache


def block_window_scalar_max(bt: BlockTable, cell_values, rows, found, parity):
    """Per-cell max of a scalar over its 27-cell window, reusing a
    block_window_moments probe cache."""
    if bt.cx.ndim == 1:
        return block_window_scalar_max(_enframe(bt), cell_values[None], rows[None], found[None], parity[None])[0]
    F, B = bt.cx.shape
    dtype = cell_values.dtype
    NEG = torch.finfo(dtype).min
    store = torch.full((F * B * 8 + 8,), NEG, dtype=dtype, device=cell_values.device)
    store[_store_targets(bt)] = torch.where(bt.cell_valid, cell_values, NEG)
    store[F * B * 8:] = NEG  # the drop row reads as empty
    r = _window_rows(store.view(F * B + 1, 8), rows, found).view(F, B, 64)
    wmax = _device_table("wmax", cell_values.device)  # (8, 64)
    cand = torch.where(wmax[parity.long()], r, NEG)
    return torch.max(cand, dim=-1).values


# ---------------------------------------------------------------------------
# Cell tables: unique-voxel indexing for cell-aggregation algorithms
# (tloam_tpu/ops/voxel.py:1005-1162; no mode of the frame runs them)
# ---------------------------------------------------------------------------


class CellTable(NamedTuple):
    """cx/cy/cz (V,) int32 cell coords of each unique cell (sentinel where
    unused), cell_valid (V,), point_cell (N,) int32 row of each point's cell
    (-1 invalid), dt the direct table (h1, h2) -> row."""

    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    cell_valid: torch.Tensor
    point_cell: torch.Tensor
    dt: DirectTable


def build_cell_table(points, valid, cell_size: float, max_cells: int) -> CellTable:
    """Deduplicate occupied cells (in cell-hash order) and hash them."""
    n = points.shape[0]
    dev = points.device
    coords = _cell_coords(points, cell_size)
    coords = torch.where(valid[:, None], coords, _SENTINEL)
    pkeys = torch.where(valid, _hash_coords(coords), _SENTINEL)
    _, order_p = torch.sort(pkeys, stable=True)
    cs = coords[order_p]
    ok_s = valid[order_p]
    seg = torch.cumsum(_first_of_runs(cs[:, 0], cs[:, 1], cs[:, 2]), 0) - 1
    seg_c = torch.where(ok_s & (seg < max_cells), seg, max_cells)
    # same-cell writers carry identical rows, so duplicate writes are benign
    rows = torch.full((max_cells + 1, 3), _SENTINEL, dtype=torch.int32, device=dev)
    rows[seg_c] = torch.where(ok_s[:, None], cs, _SENTINEL)
    cx, cy, cz = rows[:max_cells].unbind(1)
    cell_valid = torch.zeros(max_cells + 1, dtype=torch.bool, device=dev)
    cell_valid[seg_c] = ok_s
    cell_valid = cell_valid[:max_cells]
    point_cell = torch.full((n,), -1, dtype=torch.int32, device=dev)
    point_cell[order_p] = torch.where(seg_c < max_cells, seg_c, -1).to(torch.int32)
    keys = torch.where(cell_valid, _lin3(cx, cy, cz, _P1, _P2, _P3), _SENTINEL)
    dt = build_direct_table(keys, _hash2_parts(cx, cy, cz), cell_valid,
                            torch.arange(max_cells, dtype=torch.int32, device=dev))
    return CellTable(cx, cy, cz, cell_valid, point_cell, dt)


def cell_neighbor_index(table: CellTable) -> torch.Tensor:
    """(V, 27) row of each cell's 26 neighbours and itself (the JAX module's
    _OFF order), -1 where the neighbour cell is unoccupied."""
    offs = _device_table("offs", table.cx.device)
    nx = table.cx[:, None] + offs[:, 0]
    ny = table.cy[:, None] + offs[:, 1]
    nz = table.cz[:, None] + offs[:, 2]
    found, row = direct_lookup(table.dt, _lin3(nx, ny, nz, _P1, _P2, _P3), _hash2_parts(nx, ny, nz))
    return torch.where(found & table.cell_valid[:, None], row, -1)


def anchored_window_moments(xyz, valid, table: CellTable, nbr: torch.Tensor, cell_size: float):
    """27-cell window second-order moments about each cell's OWN anchor
    (cell coord x cell_size), re-anchoring each neighbour's sums with the
    exact parallel-axis shift: raw-coordinate moments cancel in float32
    beyond about 30 m from the origin.

    Returns (anchors (3 x (V,)), moments (cnt, sx, sy, sz, sxx, sxy, sxz,
    syy, syz, szz), each (V,), about each cell's anchor)."""
    dtype = xyz.dtype
    dev = xyz.device
    V = table.cx.shape[0]
    cs = torch.full((), cell_size, dtype=dtype, device=dev)
    pc = table.point_cell
    in_cell = valid & (pc >= 0)
    pcs = torch.clamp(pc, min=0).long()
    qx = xyz[:, 0] - table.cx[pcs].to(dtype) * cs
    qy = xyz[:, 1] - table.cy[pcs].to(dtype) * cs
    qz = xyz[:, 2] - table.cz[pcs].to(dtype) * cs
    m = in_cell.to(dtype)
    vals = torch.stack([m, qx * m, qy * m, qz * m, qx * qx * m, qx * qy * m, qx * qz * m,
                        qy * qy * m, qy * qz * m, qz * qz * m], dim=1)
    # accumulating index_put_: each cell's points in input order, the same
    # sum in every run (index_add_'s CUDA atomics add in a run-dependent order)
    seg = torch.where(in_cell, pc, V).long()
    mom = torch.zeros((V + 1, 10), dtype=dtype, device=dev).index_put_((seg,), vals, accumulate=True)[:V]

    has = (nbr >= 0).to(dtype)  # (V, 27)
    g = mom[torch.clamp(nbr, min=0).long()].unbind(-1)  # 10 x (V, 27)
    offs = _device_table("offs", dev).to(dtype) * cs
    Dx, Dy, Dz = offs[:, 0], offs[:, 1], offs[:, 2]
    n_j, sx_j, sy_j, sz_j = g[0], g[1], g[2], g[3]

    def tot(a):
        return torch.sum(a * has, dim=1)

    moments = (
        tot(n_j),
        tot(sx_j + n_j * Dx),
        tot(sy_j + n_j * Dy),
        tot(sz_j + n_j * Dz),
        tot(g[4] + 2.0 * Dx * sx_j + n_j * Dx * Dx),
        tot(g[5] + Dx * sy_j + Dy * sx_j + n_j * Dx * Dy),
        tot(g[6] + Dx * sz_j + Dz * sx_j + n_j * Dx * Dz),
        tot(g[7] + 2.0 * Dy * sy_j + n_j * Dy * Dy),
        tot(g[8] + Dy * sz_j + Dz * sy_j + n_j * Dy * Dz),
        tot(g[9] + 2.0 * Dz * sz_j + n_j * Dz * Dz),
    )
    anchors = (table.cx.to(dtype) * cs, table.cy.to(dtype) * cs, table.cz.to(dtype) * cs)
    return anchors, moments
