"""TLS-GNC scan-to-map registration — the numerical core.

Port of ``tloam_tpu/models/registration.py`` (the reference's Ceres-based
LocalRegistration, registration.cpp:182-1133). Correspondences come from
per-cell surface fits of the submap (``corr_mode="cell_plane"``, the
default) or from per-query 5-NN plane and line fits (``"knn"``); the planar
and ground families are point-to-plane or GICP plane-to-plane
(``plane_residual="gicp"``, with kNN covariances and 1-NN matches); the
sphere family is hash-grid 1-NN. Then the fused residual/Jacobian reduction
into the 6x6 normal equations, the degeneracy-aware damped Gauss-Newton
inner loop, and the GNC outer loop with alignment gate (the metric planar
cost, or GICP's mean matched distance), mu seeding (``mu_init``),
monotonicity guard, lazy coarse grid, yaw fan, best-round selection and
stall exit.

Batch axis: `scan_matching` solves one frame, or B independent frames when
every input carries a leading B (the JAX package vmaps its solver; this one
is written for a batch, and one frame is the batch of one). Every helper
below takes clouds, poses and tables with or without that leading axis.

Control flow: the JAX solve is one device program (``fori_loop`` +
``cond(done)``). Here the outer loop is a Python loop that reads every
frame's two flags (done, want_coarse) in ONE host sync a round; everything
numeric stays on the device and follows the JAX ``jnp.where`` selects. A
frame that is done keeps its state, traces and round count, as a vmapped
loop masks it; a round in which some frames go coarse and others fine
matches the planar family both ways and selects per frame.

Process group (the JAX ``axis_name``): with ``group``, the scan's points
are sharded over the group's ranks and every statistic the JAX solver
psums or pmaxes is an ``all_reduce`` at the same site; correspondence caps
bind on the global scan order. Only reduced values decide the host
branches, so every rank takes the same ones.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from tloam_torch.cloud import Cloud, map_tensors
from tloam_torch.config import TLSConfig
from tloam_torch.models.segmentation import weighted_axis_plane
from tloam_torch.ops import eig3, residuals as res, se3, voxel
from tloam_torch.utils.timing import STAGES


class FeatureSet(NamedTuple):
    """The four feature classes a frame contributes to registration."""

    edge: Cloud
    sphere: Cloud
    planar: Cloud
    ground: Cloud

    def transform(self, T: torch.Tensor) -> "FeatureSet":
        return FeatureSet(*(c.transform(T) for c in self))


class Diagnostics(NamedTuple):
    iterations: torch.Tensor  # outer GNC rounds executed
    mu: torch.Tensor
    costs: torch.Tensor  # (4,) final [planar, ground, edge, sphere] cost sums
    num_corr: torch.Tensor  # (4,) correspondence counts at the last round
    degenerate: torch.Tensor  # () bool — too few correspondences
    misaligned: torch.Tensor | None = None
    never_aligned: torch.Tensor | None = None
    corr_trace: torch.Tensor | None = None  # (max_iter, 4) int32
    cost_trace: torch.Tensor | None = None  # (max_iter,) mean planar cost
    coarse_trace: torch.Tensor | None = None  # (max_iter,) bool
    aligned_trace: torch.Tensor | None = None  # (max_iter,) bool
    box_min: torch.Tensor | None = None
    box_max: torch.Tensor | None = None
    box_valid: torch.Tensor | None = None
    num_clusters: torch.Tensor | None = None


class _Corr(NamedTuple):
    """Per-family correspondence buffers (fixed shapes = scan capacities).
    In GICP mode plane_n/ground_n hold the TARGET points, plane_d/ground_d
    are unused, and the *_cov fields hold the regularized covariances."""

    plane_n: torch.Tensor
    plane_d: torch.Tensor
    plane_valid: torch.Tensor
    ground_n: torch.Tensor
    ground_d: torch.Tensor
    ground_valid: torch.Tensor
    edge_a: torch.Tensor
    edge_b: torch.Tensor
    edge_valid: torch.Tensor
    sphere_t: torch.Tensor
    sphere_valid: torch.Tensor
    plane_tgt_cov: torch.Tensor | None = None  # (Np,3,3)
    ground_tgt_cov: torch.Tensor | None = None
    plane_src_cov: torch.Tensor | None = None
    ground_src_cov: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# Collectives (the JAX psum / pmax / all_gather sites)
# ---------------------------------------------------------------------------


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _pmax(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-frame condition c (...,) against a, b (..., *)."""
    return torch.where(c.view(c.shape + (1,) * (a.ndim - c.ndim)), a, b)


def calculate_covariances(cloud: Cloud, k_corr: int, radius: float = 1.0, max_per_cell: int = 8) -> torch.Tensor:
    """Per-point regularized neighbourhood covariances for GICP (calculateCov,
    registration.cpp:385-415): kNN(k_corr+1) without the self slot, the
    covariance about the query point, eigenvalues divided by the largest and
    clamped at 1e-3, reassembled. As the JAX module (its :171-181), the
    middle eigenvalue is floored at 0.1 (one sharp direction a point), and
    points with fewer than 3 neighbours fall back to the identity. Counts
    the slots it fits, ([F,] Q) from the shape, in ``gicp.cov_points``."""
    STAGES.count("gicp.cov_points", math.prod(cloud.valid.shape))
    grid = voxel.build_hash_grid(cloud.xyz, cloud.valid, radius)
    idx, _, ok = voxel.query_knn(grid, cloud.xyz, cloud.valid, k=k_corr + 1, radius=radius, max_per_cell=max_per_cell)
    idx, ok = idx[..., 1:], ok[..., 1:]  # drop the self slot (nearest, distance 0)
    a00, a01, a02, a11, a12, a22 = voxel.neighbour_covariance(cloud.xyz, idx, ok)
    cov = torch.stack(
        [torch.stack([a00, a01, a02], -1), torch.stack([a01, a11, a12], -1), torch.stack([a02, a12, a22], -1)],
        dim=-2,
    )
    w, V = eig3.eigh3(cov)
    w_reg = torch.clamp(w / torch.clamp(w[..., 2:3], min=1e-12), min=1e-3)
    w_reg = torch.cat([w_reg[..., :1], torch.clamp(w_reg[..., 1:2], min=0.1), w_reg[..., 2:]], dim=-1)
    out = (V * w_reg[..., None, :]) @ V.transpose(-1, -2)
    degenerate = (torch.sum(ok, dim=-1) < 3) | (w[..., 2] < 1e-9)
    eye = torch.eye(3, dtype=out.dtype, device=out.device)
    return torch.where(degenerate[..., None, None], eye, out)


def _cap_first_n(valid: torch.Tensor, maxnum: int, also_count: torch.Tensor | None = None,
                 group=None) -> torch.Tensor:
    """Keep only the first `maxnum` counted entries in scan order (the
    reference caps, registration.cpp:448 etc.; `also_count` entries consume
    budget without matching — the sphere counter, registration.cpp:551).

    With `group` (the scan sharded contiguously over its ranks, in rank
    order), the cap binds on the GLOBAL scan-order index: each rank offsets
    its local prefix count by the totals of the ranks before it
    (tloam_tpu/models/registration.py:190-217), so a sharded solve admits
    exactly the one-device correspondence set."""
    counted = valid if also_count is None else (valid | also_count)
    n = counted.shape[-1]
    ci = counted.to(torch.int64).reshape(-1, n)
    before = voxel.cumsum_frames(ci.view(-1), ci.shape[0]).view(ci.shape) - ci
    if group is not None:
        # all_gather of the rank totals, as a SUM of one-hot rows
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        totals = torch.zeros((ci.shape[0], size), dtype=torch.int64, device=ci.device)
        totals[:, rank] = ci.sum(-1)
        totals = _psum(totals, group)
        before = before + totals[:, :rank].sum(-1, keepdim=True)
    return valid & (before.view(valid.shape) < maxnum)


# ---------------------------------------------------------------------------
# Cell-plane correspondence cache (corr_mode="cell_plane")
# ---------------------------------------------------------------------------


class _SurfCells(NamedTuple):
    """Per-cell surface geometry over a submap feature cloud: the Morton
    block table and the ([F,] B, 128) block store of 16-lane cell records
    (lanes 0-2 centroid, 3-5 plane normal, 6 plane d, 7-9 line direction,
    10 ok_plane, 11 ok_line, 12 occupied)."""

    bt: voxel.BlockTable
    surf: torch.Tensor
    cell_size: float


def _build_surf_cells(cloud: Cloud, cell_size: float, max_cells: int, precise_thres: float = 0.2,
                      line_mode: str = "window") -> _SurfCells:
    """Window (27-cell) moments -> plane + line fits per cell
    (tloam_tpu/models/registration.py:245)."""
    dtype = cloud.xyz.dtype
    bt = voxel.build_block_table(cloud.xyz, cloud.valid, cell_size, max_cells)
    (anx, any_, anz), mw, _, cellm = voxel.block_window_moments(
        cloud.xyz, cloud.valid, bt, cell_size, return_cell=True
    )
    w_cnt, sx, sy, sz, mxx, mxy, mxz, myy, myz, mzz = mw
    cnt = torch.clamp(w_cnt, min=1.0)

    plane = weighted_axis_plane(torch.stack([sx, sy, sz, mxx, mxy, mxz, myy, myz, mzz, w_cnt], dim=-1))
    # re-express the plane in world coords: n.(p - a) + d_rel = 0
    plane_d = plane[..., 3] + -(plane[..., 0] * anx + plane[..., 1] * any_ + plane[..., 2] * anz)

    cenx_r, ceny_r, cenz_r = sx / cnt, sy / cnt, sz / cnt
    cenx, ceny, cenz = anx + cenx_r, any_ + ceny_r, anz + cenz_r
    a00 = mxx / cnt - cenx_r * cenx_r
    a01 = mxy / cnt - cenx_r * ceny_r
    a02 = mxz / cnt - cenx_r * cenz_r
    a11 = myy / cnt - ceny_r * ceny_r
    a12 = myz / cnt - ceny_r * cenz_r
    a22 = mzz / cnt - cenz_r * cenz_r
    lam0, lam1, lam2 = eig3.eigvalsh3_soa(a00, a01, a02, a11, a12, a22)

    if line_mode == "cell":
        c_cnt = cellm[..., 0]
        ccd = torch.clamp(c_cnt, min=1.0)
        cmx, cmy, cmz = cellm[..., 1] / ccd, cellm[..., 2] / ccd, cellm[..., 3] / ccd
        c00 = cellm[..., 4] / ccd - cmx * cmx
        c01 = cellm[..., 5] / ccd - cmx * cmy
        c02 = cellm[..., 6] / ccd - cmx * cmz
        c11 = cellm[..., 7] / ccd - cmy * cmy
        c12 = cellm[..., 8] / ccd - cmy * cmz
        c22 = cellm[..., 9] / ccd - cmz * cmz
        _, cl1, cl2 = eig3.eigvalsh3_soa(c00, c01, c02, c11, c12, c22)
        dirx, diry, dirz = eig3.eigvec_soa(c00, c01, c02, c11, c12, c22, cl2)
        cenx, ceny, cenz = anx + cmx, any_ + cmy, anz + cmz
        ok_line = bt.cell_valid & (c_cnt >= 4) & (cl2 > 3.0 * cl1)
    else:
        dirx, diry, dirz = eig3.eigvec_soa(a00, a01, a02, a11, a12, a22, lam2)
        ok_line = bt.cell_valid & (w_cnt >= 4) & (lam2 > 3.0 * lam1)

    precise = 2.0 * torch.sqrt(torch.clamp(lam0, min=0.0)) <= precise_thres
    ok_plane = bt.cell_valid & (w_cnt >= 5) & precise
    surf = torch.stack(
        [
            cenx, ceny, cenz,
            plane[..., 0], plane[..., 1], plane[..., 2], plane_d,
            dirx, diry, dirz,
            ok_plane.to(dtype), ok_line.to(dtype), bt.cell_valid.to(dtype),
        ],
        dim=-1,
    )  # ([F,] V, 13)
    return _SurfCells(bt, voxel.scatter_cell_records(bt, surf, 16), float(cell_size))


def _query_surf_cells(cells: _SurfCells, scan_w: torch.Tensor, scan_valid: torch.Tensor):
    """8 block probes + 8 block-row fetches -> the window cell with the
    nearest centroid. Returns (record ([F,] Q, 16), found, centroid
    distance)."""
    dtype = scan_w.dtype
    qc = torch.floor(scan_w / cells.cell_size).to(torch.int32)
    rows, found, window = voxel.block_window_probe(cells.bt, qc[..., 0], qc[..., 1], qc[..., 2])
    r = voxel.take(cells.surf, torch.where(found, rows, 0), cells.bt.cx.ndim == 2)  # ([F,] Q, 8, 128)
    r = (r * found[..., None].to(dtype)).reshape(found.shape[:-1] + (64, 16))  # candidate c = e*8 + s
    d0 = r[..., 0] - scan_w[..., None, 0]
    d1 = r[..., 1] - scan_w[..., None, 1]
    d2 = r[..., 2] - scan_w[..., None, 2]
    K = 1e12
    # empty cells (occupancy lane 0) carry a huge penalty, never a match
    dsq = d0 * d0 + d1 * d1 + d2 * d2 + (K - K * r[..., 12])
    BIG = torch.finfo(dtype).max
    dist_sq = torch.where(window & scan_valid[..., None], dsq, BIG)
    best_d, best = torch.min(dist_sq, dim=-1)  # first minimum, as jnp.argmin
    ok = best_d < K * 0.5
    rec = torch.take_along_dim(r, best[..., None, None], dim=-2)[..., 0, :]
    best_d = torch.where(ok, best_d, 0.0)
    return rec, ok, torch.sqrt(torch.clamp(best_d, min=0.0))


def _plane_correspondences_cell(cells: _SurfCells, scan_w, scan_valid, maxnum: int, gate_scale, group=None):
    rec, ok, cen_dist = _query_surf_cells(cells, scan_w, scan_valid)
    valid = scan_valid & ok & (rec[..., 10] > 0.5) & (cen_dist <= gate_scale * cells.cell_size)
    return rec[..., 3:6], rec[..., 6], _cap_first_n(valid, maxnum, group=group)


def _edge_correspondences_cell(cells: _SurfCells, scan_w, scan_valid, cfg: TLSConfig, group=None):
    rec, ok, cen_dist = _query_surf_cells(cells, scan_w, scan_valid)
    cen = rec[..., 0:3]
    direction = rec[..., 7:10]
    valid = (
        scan_valid & ok & (rec[..., 11] > 0.5)
        & (torch.abs(direction[..., 2]) > cfg.edge_dir_thres)
        & (cen_dist <= cfg.cell_gate_scale * cfg.edge_dist_thres)
    )
    return cen + 0.1 * direction, cen - 0.1 * direction, _cap_first_n(valid, cfg.edge_maxnum, group=group)


def _sphere_correspondences(grid: voxel.HashGrid, submap: Cloud, scan_w, scan_valid, cfg: TLSConfig, group=None):
    """1-NN with squared-distance gate 0.2 (registration.cpp:517-559)."""
    idx, dist_sq, ok = voxel.query_knn(
        grid, scan_w, scan_valid, k=1, radius=cfg.sphere_dist_thres, max_per_cell=cfg.max_per_cell
    )
    tgt = voxel.take(submap.xyz, idx[..., 0], submap.xyz.ndim == 3)
    valid = scan_valid & ok[..., 0] & (dist_sq[..., 0] <= 0.2)
    no_hit = scan_valid & ~ok[..., 0]  # consumes cap budget (registration.cpp:551)
    return tgt, _cap_first_n(valid, cfg.sphere_maxnum, also_count=no_hit, group=group)


def _plane_correspondences(grid: voxel.HashGrid, submap: Cloud, scan_w, scan_valid, dist_thres: float,
                           maxnum: int, max_per_cell: int, group=None):
    """5-NN -> plane fit -> gates (addSurfCostFactor/addGroundCostFactor,
    registration.cpp:571-778): all 5 neighbours found (:589), and the SIGNED
    distance of every neighbour to the plane <= 0.2 (:606-612)."""
    idx, _, ok = voxel.query_knn(grid, scan_w, scan_valid, k=5, radius=dist_thres, max_per_cell=max_per_cell)
    pts = voxel.take(submap.xyz, idx, submap.xyz.ndim == 3)  # ([F,] N, 5, 3)
    nrm, d, _ = eig3.plane_from_points(pts, ok)
    plane_dis = torch.sum(pts * nrm[..., None, :], dim=-1) + d[..., None]
    precise = torch.all(~ok | (plane_dis <= 0.2), dim=-1)
    valid = scan_valid & (torch.sum(ok, dim=-1) >= 5) & precise
    return nrm, d, _cap_first_n(valid, maxnum, group=group)


def _edge_correspondences(grid: voxel.HashGrid, submap: Cloud, scan_w, scan_valid, cfg: TLSConfig, group=None):
    """5-NN -> line fit -> gates (addEdgeCostFactor, registration.cpp:427-505):
    >= 4 neighbours (:445), lam2 > 3 lam1, |dir_z| > edge_dir_thres (:481)."""
    idx, _, ok = voxel.query_knn(
        grid, scan_w, scan_valid, k=5, radius=cfg.edge_dist_thres, max_per_cell=cfg.max_per_cell
    )
    center, direction, is_line = eig3.line_from_points(voxel.take(submap.xyz, idx, submap.xyz.ndim == 3), ok)
    valid = (
        scan_valid & (torch.sum(ok, dim=-1) >= 4) & (is_line > 0.5)
        & (torch.abs(direction[..., 2]) > cfg.edge_dir_thres)
    )
    return center + 0.1 * direction, center - 0.1 * direction, _cap_first_n(valid, cfg.edge_maxnum, group=group)


def _gicp_correspondences(grid: voxel.HashGrid, submap: Cloud, submap_covs, scan_w, scan_valid,
                          dist_thres: float, maxnum: int, max_per_cell: int, group=None):
    """1-NN within the threshold, no plane gate (addSurfCostFactor2/
    addGroundCostFactor2, registration.cpp:649-702,792-845)."""
    idx, _, ok = voxel.query_knn(grid, scan_w, scan_valid, k=1, radius=dist_thres, max_per_cell=max_per_cell)
    nn = idx[..., 0]
    frames = submap.xyz.ndim == 3
    return (voxel.take(submap.xyz, nn, frames), voxel.take(submap_covs, nn, frames),
            _cap_first_n(scan_valid & ok[..., 0], maxnum, group=group))


def _yaw_fan(xi: torch.Tensor, scan: FeatureSet, cells: _SurfCells, cfg: TLSConfig, group=None) -> torch.Tensor:
    """Score 2*yaw_fan_half+1 body-z yaw offsets about xi ([B,] 6) by
    truncated planar point-to-plane cost against the COARSE grid; return xi
    rotated to the best one when it wins by the margin (registration.py:465).
    With `group`, each score is summed over the group's shards."""
    dtype = xi.dtype
    step = math.radians(cfg.yaw_fan_step_deg)
    offs = torch.arange(-cfg.yaw_fan_half, cfg.yaw_fan_half + 1, device=xi.device).to(dtype) * torch.full(
        (), step, dtype=dtype, device=xi.device
    )
    tau_sq = torch.full((), cfg.yaw_fan_tau**2, dtype=dtype, device=xi.device)
    T0 = se3.exp(xi)

    def body_yaw(d):  # d: () or ([B],) yaw offsets
        z = torch.zeros(d.shape + (6,), dtype=dtype, device=xi.device)
        z[..., 5] = d
        return T0 @ se3.exp(z)

    scores = []
    for i in range(offs.shape[0]):
        pw = se3.transform(body_yaw(offs[i]), scan.planar.xyz)
        n, pd, pv = _plane_correspondences_cell(cells, pw, scan.planar.valid, cfg.planar_maxnum, 1.5, group)
        r = torch.sum(pw * n, dim=-1) + pd
        c = torch.where(pv, torch.minimum(r * r, tau_sq), tau_sq)
        scores.append(torch.sum(torch.where(scan.planar.valid, c, 0.0), dim=-1))
    scores = _psum(torch.stack(scores, dim=-1), group)  # ([B,] n_offsets)
    s0 = scores[..., cfg.yaw_fan_half]
    best = torch.argmin(scores, dim=-1, keepdim=True)  # gather: indexing by a device scalar syncs
    take = torch.gather(scores, -1, best)[..., 0] < cfg.yaw_fan_margin * s0
    best_off = torch.where(take, offs[best][..., 0], torch.zeros((), dtype=dtype, device=xi.device))
    return se3.log(body_yaw(best_off))


def _build_correspondences(xi, scan: FeatureSet, submap: FeatureSet, grids: dict, cfg: TLSConfig,
                           use_coarse, gicp_covs: dict | None = None, group=None) -> _Corr:
    """All four families at pose xi ([B,] 6). A coarse round matches the
    PLANAR family against the coarse cell grid: with the full 1.5-cell reach
    in cell_plane mode, and in GICP mode as the projection onto the matched
    coarse plane with identity covariance (registration.py:701-723).
    `use_coarse` is a host bool for every frame, or a ([B],) bool tensor:
    then both matchings run and each frame takes its own."""
    mixed = isinstance(use_coarse, torch.Tensor)
    fine, coarse = mixed or not use_coarse, mixed or bool(use_coarse)
    T = se3.exp(xi)
    planar_w = se3.transform(T, scan.planar.xyz)
    ground_w = se3.transform(T, scan.ground.xyz)
    edge_w = se3.transform(T, scan.edge.xyz)
    covs = {}
    if gicp_covs is not None:
        pn, p_cov, pv = _gicp_correspondences(
            grids["planar"], submap.planar, gicp_covs["submap_planar"], planar_w, scan.planar.valid,
            cfg.gicp_dist_thres, cfg.planar_maxnum, cfg.max_per_cell, group,
        )
        if coarse:
            cn, cd, cv = _plane_correspondences_cell(
                grids["planar_coarse"], planar_w, scan.planar.valid, cfg.planar_maxnum, 1.5, group
            )
            cp = planar_w - cn * (torch.sum(planar_w * cn, dim=-1) + cd)[..., None]
            c_cov = torch.eye(3, dtype=pn.dtype, device=pn.device).expand_as(p_cov)
            if mixed:
                pn, p_cov, pv = _where(use_coarse, cp, pn), _where(use_coarse, c_cov, p_cov), _where(use_coarse, cv, pv)
            else:
                pn, p_cov, pv = cp, c_cov, cv
        # the reference searches ground with the PLANAR threshold too
        # (registration.cpp:813): both families share gicp_dist_thres
        gn, g_cov, gv = _gicp_correspondences(
            grids["ground"], submap.ground, gicp_covs["submap_ground"], ground_w, scan.ground.valid,
            cfg.gicp_dist_thres, cfg.ground_maxnum, cfg.max_per_cell, group,
        )
        pd = torch.zeros_like(pn[..., 0])
        gd = torch.zeros_like(gn[..., 0])
        covs = dict(plane_tgt_cov=p_cov, ground_tgt_cov=g_cov, plane_src_cov=gicp_covs["scan_planar"],
                    ground_src_cov=gicp_covs["scan_ground"])
    elif cfg.corr_mode == "cell_plane":
        match = lambda grid, gate: _plane_correspondences_cell(  # noqa: E731
            grids[grid], planar_w, scan.planar.valid, cfg.planar_maxnum, gate, group)
        if mixed:
            pf, pc = match("planar", cfg.cell_gate_scale), match("planar_coarse", 1.5)
            pn, pd, pv = (_where(use_coarse, c, f) for c, f in zip(pc, pf))
        else:
            pn, pd, pv = match("planar_coarse", 1.5) if coarse else match("planar", cfg.cell_gate_scale)
        gn, gd, gv = _plane_correspondences_cell(grids["ground"], ground_w, scan.ground.valid, cfg.ground_maxnum,
                                                 cfg.cell_gate_scale, group)
    else:
        pn, pd, pv = _plane_correspondences(grids["planar"], submap.planar, planar_w, scan.planar.valid,
                                            cfg.planar_dist_thres, cfg.planar_maxnum, cfg.max_per_cell, group)
        gn, gd, gv = _plane_correspondences(grids["ground"], submap.ground, ground_w, scan.ground.valid,
                                            cfg.ground_dist_thres, cfg.ground_maxnum, cfg.max_per_cell, group)
    if cfg.corr_mode == "cell_plane" and gicp_covs is None:
        ea, eb, ev = _edge_correspondences_cell(grids["edge"], edge_w, scan.edge.valid, cfg, group)
    else:  # GICP takes kNN edges in either corr_mode
        ea, eb, ev = _edge_correspondences(grids["edge"], submap.edge, edge_w, scan.edge.valid, cfg, group)
    st, sv = _sphere_correspondences(
        grids["sphere"], submap.sphere, se3.transform(T, scan.sphere.xyz), scan.sphere.valid, cfg, group
    )
    if cfg.factor_num < 4:
        sv = torch.zeros_like(sv)
    if cfg.factor_num < 3:
        ev = torch.zeros_like(ev)
    return _Corr(pn, pd, pv, gn, gd, gv, ea, eb, ev, st, sv, **covs)


class _Weights(NamedTuple):
    planar: torch.Tensor
    ground: torch.Tensor
    edge: torch.Tensor
    sphere: torch.Tensor


def _evaluate(xi, scan: FeatureSet, corr: _Corr, w: _Weights, gicp_cauchy_scale: float = 1.0):
    """Residuals/Jacobians/costs of every family at pose xi ([B,] 6).
    Returns (H ([B,] 6, 6), g ([B,] 6), per-point GNC costs with zeros at
    invalid slots). The GICP families' Cauchy loss lives on their
    covariance-normalized residual scale, `gicp_cauchy_scale`
    (registration.py:764-781)."""
    T = se3.exp(xi)
    dtype = xi.dtype

    def plane_family(cloud, n, d, valid, weights):
        r, J, cost = res.point_to_plane(T, cloud.xyz, n, d, weights)
        m = valid.to(dtype)
        irls = res.cauchy_weight(r * r) * m
        Jt = J.transpose(-1, -2)
        return Jt @ (J * irls[..., None]), (Jt @ (r * irls)[..., None])[..., 0], cost * m

    def vec_family(r, J, cost, valid, scale=1.0):
        m = valid.to(dtype)
        irls = res.cauchy_weight(torch.sum(r * r, dim=-1), scale) * m
        lead = J.shape[:-3]
        Jf = J.reshape(lead + (-1, 6))
        Jw = (J * irls[..., None, None]).reshape(lead + (-1, 6))
        Jwt = Jw.transpose(-1, -2)
        return Jf.transpose(-1, -2) @ Jw, (Jwt @ r.reshape(lead + (-1, 1)))[..., 0], cost * m

    def gicp_family(cloud, tgt, src_cov, tgt_cov, valid, weights):
        r, J, cost = res.plane_to_plane(T, cloud.xyz, src_cov, tgt, tgt_cov, weights)
        return vec_family(r, J, cost, valid, gicp_cauchy_scale)

    if corr.plane_tgt_cov is not None:
        Hp, gp, cost_p = gicp_family(scan.planar, corr.plane_n, corr.plane_src_cov, corr.plane_tgt_cov,
                                     corr.plane_valid, w.planar)
        Hg, gg, cost_g = gicp_family(scan.ground, corr.ground_n, corr.ground_src_cov, corr.ground_tgt_cov,
                                     corr.ground_valid, w.ground)
    else:
        Hp, gp, cost_p = plane_family(scan.planar, corr.plane_n, corr.plane_d, corr.plane_valid, w.planar)
        Hg, gg, cost_g = plane_family(scan.ground, corr.ground_n, corr.ground_d, corr.ground_valid, w.ground)
    He, ge, cost_e = vec_family(*res.point_to_line(T, scan.edge.xyz, corr.edge_a, corr.edge_b, w.edge),
                                corr.edge_valid)
    Hs, gs, cost_s = vec_family(*res.point_to_point(T, scan.sphere.xyz, corr.sphere_t, w.sphere),
                                corr.sphere_valid)
    return Hp + Hg + He + Hs, gp + gg + ge + gs, _Weights(cost_p, cost_g, cost_e, cost_s)


def _gn_inner(xi, scan: FeatureSet, corr: _Corr, w: _Weights, cfg: TLSConfig, hard_floor_on, w_scale,
              group=None):
    """Damped, degeneracy-aware Gauss-Newton (registration.py:843) on xi
    ([B,] 6): block normalized 6x6 eigen solve, degenerate directions
    zeroed, step clamped to the trust region. With `group`, H and g are
    summed over the group before the (replicated) solve."""
    dtype = xi.dtype
    eye6 = torch.eye(6, dtype=dtype, device=xi.device)
    for _ in range(cfg.inner_iterations):
        H, g, _ = _evaluate(xi, scan, corr, w, _gicp_scale(cfg))
        if group is not None:
            Hg = _psum(torch.cat([H.flatten(-2), g], dim=-1), group)
            H, g = Hg[..., :36].unflatten(-1, (6, 6)), Hg[..., 36:]
        dH = torch.diagonal(H, dim1=-2, dim2=-1)
        s_t = 1.0 / torch.sqrt(torch.clamp(torch.mean(dH[..., :3], dim=-1), min=1e-12))
        s_r = 1.0 / torch.sqrt(torch.clamp(torch.mean(dH[..., 3:], dim=-1), min=1e-12))
        S = torch.stack([s_t, s_t, s_t, s_r, s_r, s_r], dim=-1)
        Hn = H * S[..., :, None] * S[..., None, :]
        # a non-finite system yields a zero step (JAX: NaN delta -> zeros);
        # LAPACK must not see the NaNs
        finite = torch.isfinite(Hn).all(dim=-1).all(dim=-1) & torch.isfinite(g).all(dim=-1)
        # eigh reads its error code back to the host: a host sync a call
        with STAGES.sync("sync.solve.eigh"):
            lam, V = torch.linalg.eigh(_where(finite, Hn, eye6.expand_as(Hn)))
        lam_max = torch.clamp(lam[..., -1:], min=1e-12)
        u_sq = torch.sum((S[..., :, None] * V) ** 2, dim=-2)
        lam_raw = lam / torch.clamp(u_sq, min=1e-30) / torch.clamp(w_scale, min=1e-12)[..., None]
        degen = ((lam < cfg.degen_rel_thres * lam_max) & (lam_raw < cfg.degen_abs_thres)) | (
            hard_floor_on[..., None] & (lam_raw < cfg.degen_abs_hard)
        )
        inv = torch.where(degen, 0.0, 1.0 / (lam + cfg.lm_lambda))
        delta = -S * ((V * inv[..., None, :]) @ (V.transpose(-1, -2) @ (S * g)[..., None]))[..., 0]
        tn = torch.linalg.norm(delta[..., :3], dim=-1)
        rn = torch.linalg.norm(delta[..., 3:], dim=-1)
        scale = torch.clamp(
            torch.minimum(
                cfg.max_step_trans / torch.clamp(tn, min=1e-12),
                cfg.max_step_rot / torch.clamp(rn, min=1e-12),
            ),
            max=1.0,
        )
        delta = delta * scale[..., None]
        delta = _where(finite & torch.isfinite(delta).all(dim=-1), delta, torch.zeros_like(delta))
        xi = se3.boxplus_left(xi, delta)
    return xi


def _gicp_scale(cfg: TLSConfig) -> float:
    return cfg.gicp_noise_bound if cfg.plane_residual == "gicp" else 1.0


def _cells_cap(c: Cloud, divisor: int = 1) -> int:
    """Occupied cells never exceed the point count; don't over-size."""
    return max(1024, min(c.capacity // divisor, 65536))


class _State(NamedTuple):
    """The GNC loop's per-frame state (leading axis B): a frame that is done
    keeps all of it."""

    xi: torch.Tensor
    weights: _Weights
    mu: torch.Tensor
    mu_inited: torch.Tensor
    want_coarse: torch.Tensor
    prev_planar_cost: torch.Tensor
    cost_sums: torch.Tensor
    num_corr: torch.Tensor
    done: torch.Tensor
    prev_mean_planar: torch.Tensor
    xi_best: torch.Tensor
    best_score: torch.Tensor
    best_seen: torch.Tensor
    best_it: torch.Tensor


def _keep(active: torch.Tensor, new, old):
    """new where the frame was active this round, else old (tree-wise)."""
    if isinstance(new, torch.Tensor):
        return _where(active, new, old)
    return type(new)(*(_keep(active, n, o) for n, o in zip(new, old)))


def scan_matching(scan: FeatureSet, submap: FeatureSet, predict_pose: torch.Tensor, cfg: TLSConfig,
                  allow_fallback=True, group=None):
    """Register one frame's features against the submap. Returns (pose (4,4),
    Diagnostics) — the contract of LocalRegistration::scanMatching
    (registration.cpp:879-1133).

    With a leading B on every input (predict_pose (B,4,4), every cloud
    (B, cap, ...)) it solves B independent frames in one loop, and every
    output carries the B. One frame is solved as a batch of one. With
    `group`, `scan` holds this rank's contiguous shard of the frame's scan
    points (the submap and prediction are replicated) and the outputs are
    the group's (tloam_tpu/models/registration.py's axis_name)."""
    if predict_pose.ndim == 2:
        one = lambda x: x[None]  # noqa: E731
        pose, diag = scan_matching(map_tensors(scan, one), map_tensors(submap, one), predict_pose[None], cfg,
                                   allow_fallback, group)
        return pose[0], map_tensors(diag, lambda x: x[0])
    return _solve(scan, submap, predict_pose, cfg, allow_fallback, group)


def _solve(scan: FeatureSet, submap: FeatureSet, predict_pose: torch.Tensor, cfg: TLSConfig, allow_fallback,
           group):
    B = predict_pose.shape[0]
    dtype = scan.planar.xyz.dtype
    dev = scan.planar.xyz.device
    # device scalars by a fill: torch.tensor(v, device=cuda) copies from the host and syncs
    f32 = lambda v: torch.full((), v, dtype=dtype, device=dev)  # noqa: E731
    per_frame = lambda v, dt=dtype: torch.full((B,), v, dtype=dt, device=dev)  # noqa: E731
    xi0 = se3.log(predict_pose.to(dtype))
    # tiny-rotation degeneracy guard (registration.cpp:884-886), fixed axis
    tiny = torch.ones(3, dtype=dtype, device=dev) / math.sqrt(3.0) * 1e-4
    omega_small = torch.linalg.norm(xi0[:, 3:], dim=-1) < 1e-2
    xi0 = _where(omega_small, torch.cat([xi0[:, :3], tiny.expand(B, 3)], dim=-1), xi0)

    gicp = cfg.plane_residual == "gicp"
    # the kNN point-to-plane solve has no coarse grid: no coarse rounds and
    # no yaw fan (registration.py:1052-1093)
    has_coarse = bool(cfg.coarse_scale) and (gicp or cfg.corr_mode == "cell_plane")

    # GNC eps in the residual family's own scale (TLSConfig.gicp_noise_bound)
    noise_bound_sq = (cfg.gicp_noise_bound if gicp else cfg.noise_bound) ** 2
    if noise_bound_sq < 1e-16:
        noise_bound_sq = 1e-2  # registration.cpp:962-964
    # the tables the rounds query: cell tables, hash grids, GICP covariances
    with STAGES.stage("solve.grids"):
        if cfg.corr_mode == "cell_plane" and not gicp:
            grids = {
                "edge": _build_surf_cells(submap.edge, cfg.edge_dist_thres, _cells_cap(submap.edge, 2),
                                          line_mode="cell"),
                "sphere": voxel.build_hash_grid(submap.sphere.xyz, submap.sphere.valid, cfg.sphere_dist_thres),
                "planar": _build_surf_cells(submap.planar, cfg.planar_dist_thres, _cells_cap(submap.planar, 2)),
                "ground": _build_surf_cells(submap.ground, cfg.ground_dist_thres, _cells_cap(submap.ground)),
            }
        else:
            grid = lambda c, pitch: voxel.build_hash_grid(c.xyz, c.valid, pitch)  # noqa: E731
            grids = {
                "edge": grid(submap.edge, cfg.edge_dist_thres),
                "sphere": grid(submap.sphere, cfg.sphere_dist_thres),
                "planar": grid(submap.planar, cfg.gicp_dist_thres if gicp else cfg.planar_dist_thres),
                "ground": grid(submap.ground, cfg.gicp_dist_thres if gicp else cfg.ground_dist_thres),
            }
        gicp_covs = None
        if gicp:
            # with a group, the scan covariances see this rank's shard only, as
            # under the JAX shard_map
            with STAGES.stage("solve.grids.cov"):
                gicp_covs = {
                    name: calculate_covariances(c, cfg.k_corr, max_per_cell=cfg.max_per_cell)
                    for name, c in (("scan_planar", scan.planar), ("scan_ground", scan.ground),
                                    ("submap_planar", submap.planar), ("submap_ground", submap.ground))
                }
    # the alignment-based mechanisms (starved revert, best round, stall
    # exit, misaligned fallback) need the planar cost's metric meaning (m^2);
    # GICP costs live on a covariance-normalized scale
    gate_on_alignment = cfg.plane_residual == "point_to_plane"

    ones = lambda c: torch.ones(c.valid.shape, dtype=dtype, device=dev)  # noqa: E731
    n_planar_cand = torch.clamp(_psum(torch.sum(scan.planar.valid, dim=-1), group), max=cfg.planar_maxnum)

    mi = cfg.max_iterations
    false = per_frame(False, torch.bool)
    st = _State(
        xi=xi0, weights=_Weights(ones(scan.planar), ones(scan.ground), ones(scan.edge), ones(scan.sphere)),
        mu=per_frame(1.0), mu_inited=false, want_coarse=false, prev_planar_cost=per_frame(math.inf),
        cost_sums=torch.zeros((B, 4), dtype=dtype, device=dev),
        num_corr=torch.full((B, 4), 1 << 20, dtype=torch.int32, device=dev), done=false,
        prev_mean_planar=per_frame(math.inf), xi_best=xi0, best_score=per_frame(math.inf), best_seen=false,
        best_it=per_frame(0, torch.int32),
    )
    iterations = per_frame(0, torch.int32)
    # round-major, so that a round's row is contiguous at every B: a strided
    # write would launch a copy kernel where a contiguous one is a memcpy
    corr_trace = torch.zeros((mi, B, 4), dtype=torch.int32, device=dev)
    cost_trace = torch.zeros((mi, B), dtype=dtype, device=dev)
    coarse_trace = torch.zeros((mi, B), dtype=torch.bool, device=dev)
    aligned_trace = torch.zeros((mi, B), dtype=torch.bool, device=dev)
    track_best = bool(cfg.best_round_tau) and gate_on_alignment

    for it in range(mi):
        # one host sync per round for the whole batch: the JAX cond(done) and
        # the coarse-round lax.conds become host branches. With a group both
        # flags derive from reduced values only, so every rank branches alike.
        with STAGES.sync("sync.solve.read"):
            done_h, coarse_h = torch.stack([st.done, st.want_coarse]).tolist()
        live = [not d for d in done_h]
        if not any(live):
            break
        n_coarse = sum(has_coarse and c and a for c, a in zip(coarse_h, live))
        active = ~st.done
        uc = st.want_coarse if has_coarse else false
        # a coarse round for every live frame, for none, or per frame (then
        # the planar family is matched both ways)
        if n_coarse in (0, sum(live)):
            use_coarse = n_coarse > 0
        else:
            use_coarse = uc
        if n_coarse and "planar_coarse" not in grids:
            with STAGES.stage("solve.grids"):
                # lazy coarse grid: built on the first round any frame needs it
                grids["planar_coarse"] = _build_surf_cells(
                    submap.planar, cfg.planar_dist_thres * cfg.coarse_scale, _cells_cap(submap.planar, 2),
                    precise_thres=0.2 * cfg.coarse_scale,
                )
        with STAGES.stage("solve.correspond"):
            xi_in = st.xi
            if n_coarse and cfg.yaw_fan_half > 0:
                xi_in = _where(uc, _yaw_fan(st.xi, scan, grids["planar_coarse"], cfg, group), st.xi)
            corr = _build_correspondences(xi_in, scan, submap, grids, cfg, use_coarse, gicp_covs, group)
        with STAGES.stage("solve.gn"):
            w = st.weights
            w_mass = (
                torch.sum(torch.square(w.planar) * corr.plane_valid, dim=-1)
                + torch.sum(torch.square(w.ground) * corr.ground_valid, dim=-1)
                + torch.sum(torch.square(w.edge) * corr.edge_valid, dim=-1)
                + torch.sum(torch.square(w.sphere) * corr.sphere_valid, dim=-1)
            )
            # the round's four correspondence counts (planar, ground, edge,
            # sphere), summed over the group once: integer sums, exact
            counts = _psum(torch.stack(
                [torch.sum(corr.plane_valid, dim=-1), torch.sum(corr.ground_valid, dim=-1),
                 torch.sum(corr.edge_valid, dim=-1), torch.sum(corr.sphere_valid, dim=-1)], dim=-1
            ), group)
            w_scale = _psum(w_mass, group) / torch.clamp(torch.sum(counts, dim=-1), min=1)
            planar_empty = counts[..., 0] == 0
            xi_new = _gn_inner(xi_in, scan, corr, w, cfg, planar_empty, w_scale, group)

        with STAGES.stage("solve.gnc"):
            _, _, costs = _evaluate(xi_new, scan, corr, w, _gicp_scale(cfg))
            planar_cost = _psum(torch.sum(costs.planar, dim=-1), group)
            ncorr = counts.to(torch.int32)
            n_planar = ncorr[:, 0]
            mean_planar = planar_cost / torch.clamp(n_planar, min=1)

            # monotonicity guard on weighted rounds
            prev_mu_inited = st.mu_inited
            revert = (
                prev_mu_inited & ~uc
                & (mean_planar > torch.clamp(4.0 * st.prev_mean_planar, min=cfg.coarse_cost_thres))
                & (n_planar > 0)
            )
            if gate_on_alignment and cfg.revert_starved_rounds and it == 0:
                revert_starved = ~uc & (n_planar < cfg.fallback_frac * n_planar_cand)
            else:
                revert_starved = false
            if gate_on_alignment:
                frac_ok = n_planar >= cfg.relocal_frac * n_planar_cand
                aligned = (mean_planar <= cfg.coarse_cost_thres) & frac_ok & (n_planar > 0) & ~uc & ~revert
                gnc_ok = (
                    (mean_planar <= cfg.coarse_cost_thres)
                    & (n_planar >= cfg.gnc_frac * n_planar_cand)
                    & (n_planar > 0) & ~uc & ~revert & ~revert_starved
                )
            else:
                # GICP gate (TLSConfig.gicp_align_dist): mean matched NN distance
                # at the round's INPUT pose
                pw_in = se3.transform(se3.exp(xi_in), scan.planar.xyz)
                nn_d = torch.linalg.norm(pw_in - corr.plane_n, dim=-1)
                mean_nn = _psum(torch.sum(torch.where(corr.plane_valid, nn_d, 0.0), dim=-1), group) / torch.clamp(
                    n_planar, min=1)
                aligned = (n_planar > 0) & (mean_nn <= cfg.gicp_align_dist) & ~uc & ~revert
                gnc_ok = aligned
            # mu seeded on the first GNC-eligible fine round
            first_fine = ~st.mu_inited & gnc_ok
            if cfg.mu_init == "reference_zero":
                # the reference reads still-zeroed residual buffers: mu = 1e-10
                mu = torch.where(first_fine, f32(1e-10), st.mu)
            else:
                max_r = torch.maximum(
                    torch.amax(costs.planar, dim=-1),
                    torch.maximum(torch.amax(costs.edge, dim=-1), torch.amax(costs.sphere, dim=-1)),
                )
                mu = torch.where(first_fine, res.gnc_init_mu(_pmax(max_r, group), noise_bound_sq, inlier_mu=1e6), st.mu)
            mu_inited = st.mu_inited | first_fine

            th1, th2 = res.gnc_thresholds(mu[:, None], noise_bound_sq)
            new_w = _Weights(*(
                res.gnc_update_weights(old, c, noise_bound_sq, th1, th2, mu[:, None])
                for old, c in zip(w, costs)
            ))
            do_update = mu_inited & ~uc & ~revert_starved
            new_w = _Weights(*(_where(do_update, n, o) for o, n in zip(w, new_w)))
            new_w = _Weights(*(_where(revert, torch.ones_like(v), v) for v in new_w))
            mu = torch.where(do_update, res.gnc_next_mu(mu, f32(float(it)), cfg.gnc_factor), mu)
            planar_cost_out = torch.where(uc, f32(math.inf), planar_cost)
            if has_coarse:
                lost = ~aligned | (n_planar < cfg.relocal_corr_thres)
                if not gate_on_alignment:
                    # GICP: a fine round matching under relocal_frac is lost
                    lost = lost | (n_planar < cfg.relocal_frac * n_planar_cand)
                want_coarse = lost & ~uc & ~revert
            else:
                want_coarse = st.want_coarse
            cost_sums = torch.stack(
                [planar_cost, _psum(torch.sum(costs.ground, dim=-1), group),
                 _psum(torch.sum(costs.edge, dim=-1), group), _psum(torch.sum(costs.sphere, dim=-1), group)], dim=-1
            )
            # planar-only convergence gate (registration.cpp:1108-1111) + fail-safes
            done = (
                (torch.abs(planar_cost - st.prev_planar_cost) < cfg.cost_threshold)
                & (n_planar > 0) & ~uc & ~want_coarse & ~revert & ~revert_starved
            )
            if cfg.exit_cost_thres and it >= 2:
                # gated on mu seeded on a PREVIOUS round: the seeding round
                # solved unweighted
                done = done | (aligned & prev_mu_inited & (mean_planar < cfg.exit_cost_thres))
            xi_new = _where(revert | revert_starved, st.xi, xi_new)
            prev_mean = torch.where(uc | revert | revert_starved, st.prev_mean_planar, mean_planar)
            xi_best, best_score, best_seen, best_it = st.xi_best, st.best_score, st.best_seen, st.best_it
            if track_best:
                tau_sq = f32(cfg.best_round_tau**2)
                n_cand = torch.clamp(n_planar_cand, min=1).to(dtype)
                score = (planar_cost + (n_cand - n_planar.to(dtype)) * tau_sq) / n_cand
                better = aligned & (score < best_score)
                xi_best = _where(better, xi_new, xi_best)
                best_score = torch.where(better, score, best_score)
                best_seen = best_seen | better
                best_it = torch.where(better, it, best_it)
                if cfg.exit_stall_rounds:
                    done = done | (best_seen & (it - best_it >= cfg.exit_stall_rounds))
            # a frame that was done before this round keeps everything
            st = _keep(active, _State(xi_new, new_w, mu, mu_inited, want_coarse, planar_cost_out, cost_sums,
                                      ncorr, done, prev_mean, xi_best, best_score, best_seen, best_it), st)
            corr_trace[it] = ncorr * active[:, None]
            cost_trace[it] = torch.where(active, mean_planar, 0.0)
            coarse_trace[it] = uc & active
            aligned_trace[it] = aligned & active
            iterations = iterations + active.to(torch.int32)

    xi_final = _where(st.best_seen, st.xi_best, st.xi) if track_best else st.xi
    pose = se3.exp(xi_final)
    num_corr = st.num_corr
    degenerate = torch.sum(num_corr, dim=-1) < cfg.min_total_corr
    if gate_on_alignment and cfg.misaligned_fallback:
        starved = num_corr[:, 0] < cfg.fallback_frac * n_planar_cand
        never_aligned = ~torch.any(aligned_trace, dim=0)
        # a host bool is copied to the device, and the host waits for the copy
        host_bool = not isinstance(allow_fallback, torch.Tensor)
        with STAGES.sync("sync.solve.fallback") if host_bool else contextlib.nullcontext():
            allow = torch.as_tensor(allow_fallback, device=dev)
        misaligned = never_aligned & starved & allow
    else:
        misaligned = never_aligned = false
    pose_override = misaligned if cfg.misaligned_pose_fallback else false
    pose = _where(degenerate | pose_override, predict_pose.to(dtype), pose)
    return pose, Diagnostics(
        iterations, st.mu, st.cost_sums, num_corr, degenerate,
        misaligned=misaligned, never_aligned=never_aligned,
        corr_trace=corr_trace.movedim(0, 1), cost_trace=cost_trace.movedim(0, 1),
        coarse_trace=coarse_trace.movedim(0, 1), aligned_trace=aligned_trace.movedim(0, 1),
    )


def fitness_score(scan: FeatureSet, submap: FeatureSet, cfg: TLSConfig):
    """(total fitness, summed inlier RMSE) over the four families
    (getFitnessScore, registration.cpp:257-296): per family, the fraction of
    scan points with a submap neighbour within fitness_thres and the sqrt of
    their mean squared neighbour distance."""
    dtype = scan.planar.xyz.dtype
    total_fit = torch.zeros((), dtype=dtype, device=scan.planar.device)
    total_rmse = torch.zeros_like(total_fit)
    for s, m in zip(scan, submap):
        grid = voxel.build_hash_grid(m.xyz, m.valid, cfg.fitness_thres)
        _, dist_sq, ok = voxel.query_knn(grid, s.xyz, s.valid, k=1, radius=cfg.fitness_thres,
                                         max_per_cell=cfg.max_per_cell)
        n = torch.sum(ok[:, 0])
        err = torch.sum(torch.where(ok[:, 0], dist_sq[:, 0], 0.0))
        has = n > 0
        total_fit = total_fit + torch.where(has, n / torch.clamp(s.count(), min=1), 0.0)
        total_rmse = total_rmse + torch.where(has, torch.sqrt(err / torch.clamp(n, min=1)), 0.0)
    return total_fit, total_rmse
