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

Control flow: the JAX solve is one device program (``fori_loop`` +
``cond(done)``). Here the outer loop is a Python loop that reads two
device flags per round (done, want_coarse) in ONE host sync; everything
numeric stays on the device and follows the JAX ``jnp.where`` selects.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tloam_torch.cloud import Cloud
from tloam_torch.config import TLSConfig
from tloam_torch.models.segmentation import weighted_axis_plane
from tloam_torch.ops import eig3, residuals as res, se3, voxel


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


def calculate_covariances(cloud: Cloud, k_corr: int, radius: float = 1.0, max_per_cell: int = 8) -> torch.Tensor:
    """Per-point regularized neighbourhood covariances for GICP (calculateCov,
    registration.cpp:385-415): kNN(k_corr+1) without the self slot, the
    covariance about the query point, eigenvalues divided by the largest and
    clamped at 1e-3, reassembled. As the JAX module (its :171-181), the
    middle eigenvalue is floored at 0.1 (one sharp direction a point), and
    points with fewer than 3 neighbours fall back to the identity."""
    grid = voxel.build_hash_grid(cloud.xyz, cloud.valid, radius)
    idx, _, ok = voxel.query_knn(grid, cloud.xyz, cloud.valid, k=k_corr + 1, radius=radius, max_per_cell=max_per_cell)
    idx, ok = idx[:, 1:], ok[:, 1:]  # drop the self slot (nearest, distance 0)
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
    return torch.where(degenerate[:, None, None], eye, out)


def _cap_first_n(valid: torch.Tensor, maxnum: int, also_count: torch.Tensor | None = None) -> torch.Tensor:
    """Keep only the first `maxnum` counted entries in scan order (the
    reference caps, registration.cpp:448 etc.; `also_count` entries consume
    budget without matching — the sphere counter, registration.cpp:551)."""
    counted = valid if also_count is None else (valid | also_count)
    ci = counted.to(torch.int64)
    before = torch.cumsum(ci, 0) - ci
    return valid & (before < maxnum)


# ---------------------------------------------------------------------------
# Cell-plane correspondence cache (corr_mode="cell_plane")
# ---------------------------------------------------------------------------


class _SurfCells(NamedTuple):
    """Per-cell surface geometry over a submap feature cloud: the Morton
    block table and the (B, 128) block store of 16-lane cell records (lanes
    0-2 centroid, 3-5 plane normal, 6 plane d, 7-9 line direction,
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
    plane_d = plane[:, 3] + -(plane[:, 0] * anx + plane[:, 1] * any_ + plane[:, 2] * anz)

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
        c_cnt = cellm[:, 0]
        ccd = torch.clamp(c_cnt, min=1.0)
        cmx, cmy, cmz = cellm[:, 1] / ccd, cellm[:, 2] / ccd, cellm[:, 3] / ccd
        c00 = cellm[:, 4] / ccd - cmx * cmx
        c01 = cellm[:, 5] / ccd - cmx * cmy
        c02 = cellm[:, 6] / ccd - cmx * cmz
        c11 = cellm[:, 7] / ccd - cmy * cmy
        c12 = cellm[:, 8] / ccd - cmy * cmz
        c22 = cellm[:, 9] / ccd - cmz * cmz
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
            plane[:, 0], plane[:, 1], plane[:, 2], plane_d,
            dirx, diry, dirz,
            ok_plane.to(dtype), ok_line.to(dtype), bt.cell_valid.to(dtype),
        ],
        dim=1,
    )  # (V, 13)
    return _SurfCells(bt, voxel.scatter_cell_records(bt, surf, 16), float(cell_size))


def _query_surf_cells(cells: _SurfCells, scan_w: torch.Tensor, scan_valid: torch.Tensor):
    """8 block probes + 8 block-row fetches -> the window cell with the
    nearest centroid. Returns (record (Q,16), found (Q,), centroid distance
    (Q,))."""
    Q = scan_w.shape[0]
    dtype = scan_w.dtype
    qc = torch.floor(scan_w / cells.cell_size).to(torch.int32)
    rows, found, window = voxel.block_window_probe(cells.bt, qc[:, 0], qc[:, 1], qc[:, 2])
    r = cells.surf[torch.where(found, rows, 0).long()]  # (Q, 8, 128)
    r = (r * found[:, :, None].to(dtype)).reshape(Q, 64, 16)  # candidate c = e*8 + s
    d0 = r[..., 0] - scan_w[:, None, 0]
    d1 = r[..., 1] - scan_w[:, None, 1]
    d2 = r[..., 2] - scan_w[:, None, 2]
    K = 1e12
    # empty cells (occupancy lane 0) carry a huge penalty, never a match
    dsq = d0 * d0 + d1 * d1 + d2 * d2 + (K - K * r[..., 12])
    BIG = torch.finfo(dtype).max
    dist_sq = torch.where(window & scan_valid[:, None], dsq, BIG)
    best_d, best = torch.min(dist_sq, dim=1)  # first minimum, as jnp.argmin
    ok = best_d < K * 0.5
    rec = r[torch.arange(Q, device=scan_w.device), best]  # (Q, 16)
    best_d = torch.where(ok, best_d, 0.0)
    return rec, ok, torch.sqrt(torch.clamp(best_d, min=0.0))


def _plane_correspondences_cell(cells: _SurfCells, scan_w, scan_valid, maxnum: int, gate_scale):
    rec, ok, cen_dist = _query_surf_cells(cells, scan_w, scan_valid)
    valid = scan_valid & ok & (rec[:, 10] > 0.5) & (cen_dist <= gate_scale * cells.cell_size)
    return rec[:, 3:6], rec[:, 6], _cap_first_n(valid, maxnum)


def _edge_correspondences_cell(cells: _SurfCells, scan_w, scan_valid, cfg: TLSConfig):
    rec, ok, cen_dist = _query_surf_cells(cells, scan_w, scan_valid)
    cen = rec[:, 0:3]
    direction = rec[:, 7:10]
    valid = (
        scan_valid & ok & (rec[:, 11] > 0.5)
        & (torch.abs(direction[:, 2]) > cfg.edge_dir_thres)
        & (cen_dist <= cfg.cell_gate_scale * cfg.edge_dist_thres)
    )
    return cen + 0.1 * direction, cen - 0.1 * direction, _cap_first_n(valid, cfg.edge_maxnum)


def _sphere_correspondences(grid: voxel.HashGrid, submap: Cloud, scan_w, scan_valid, cfg: TLSConfig):
    """1-NN with squared-distance gate 0.2 (registration.cpp:517-559)."""
    idx, dist_sq, ok = voxel.query_knn(
        grid, scan_w, scan_valid, k=1, radius=cfg.sphere_dist_thres, max_per_cell=cfg.max_per_cell
    )
    tgt = submap.xyz[idx[:, 0]]
    valid = scan_valid & ok[:, 0] & (dist_sq[:, 0] <= 0.2)
    no_hit = scan_valid & ~ok[:, 0]  # consumes cap budget (registration.cpp:551)
    return tgt, _cap_first_n(valid, cfg.sphere_maxnum, also_count=no_hit)


def _plane_correspondences(grid: voxel.HashGrid, submap: Cloud, scan_w, scan_valid, dist_thres: float,
                           maxnum: int, max_per_cell: int):
    """5-NN -> plane fit -> gates (addSurfCostFactor/addGroundCostFactor,
    registration.cpp:571-778): all 5 neighbours found (:589), and the SIGNED
    distance of every neighbour to the plane <= 0.2 (:606-612)."""
    idx, _, ok = voxel.query_knn(grid, scan_w, scan_valid, k=5, radius=dist_thres, max_per_cell=max_per_cell)
    pts = submap.xyz[idx]  # (N,5,3)
    nrm, d, _ = eig3.plane_from_points(pts, ok)
    plane_dis = torch.sum(pts * nrm[:, None, :], dim=-1) + d[:, None]
    precise = torch.all(~ok | (plane_dis <= 0.2), dim=-1)
    valid = scan_valid & (torch.sum(ok, dim=-1) >= 5) & precise
    return nrm, d, _cap_first_n(valid, maxnum)


def _edge_correspondences(grid: voxel.HashGrid, submap: Cloud, scan_w, scan_valid, cfg: TLSConfig):
    """5-NN -> line fit -> gates (addEdgeCostFactor, registration.cpp:427-505):
    >= 4 neighbours (:445), lam2 > 3 lam1, |dir_z| > edge_dir_thres (:481)."""
    idx, _, ok = voxel.query_knn(
        grid, scan_w, scan_valid, k=5, radius=cfg.edge_dist_thres, max_per_cell=cfg.max_per_cell
    )
    center, direction, is_line = eig3.line_from_points(submap.xyz[idx], ok)
    valid = (
        scan_valid & (torch.sum(ok, dim=-1) >= 4) & (is_line > 0.5)
        & (torch.abs(direction[:, 2]) > cfg.edge_dir_thres)
    )
    return center + 0.1 * direction, center - 0.1 * direction, _cap_first_n(valid, cfg.edge_maxnum)


def _gicp_correspondences(grid: voxel.HashGrid, submap: Cloud, submap_covs, scan_w, scan_valid,
                          dist_thres: float, maxnum: int, max_per_cell: int):
    """1-NN within the threshold, no plane gate (addSurfCostFactor2/
    addGroundCostFactor2, registration.cpp:649-702,792-845)."""
    idx, _, ok = voxel.query_knn(grid, scan_w, scan_valid, k=1, radius=dist_thres, max_per_cell=max_per_cell)
    nn = idx[:, 0]
    return submap.xyz[nn], submap_covs[nn], _cap_first_n(scan_valid & ok[:, 0], maxnum)


def _yaw_fan(xi: torch.Tensor, scan: FeatureSet, cells: _SurfCells, cfg: TLSConfig) -> torch.Tensor:
    """Score 2*yaw_fan_half+1 body-z yaw offsets about xi by truncated planar
    point-to-plane cost against the COARSE grid; return xi rotated to the
    best one when it wins by the margin (registration.py:465)."""
    dtype = xi.dtype
    step = math.radians(cfg.yaw_fan_step_deg)
    offs = torch.arange(-cfg.yaw_fan_half, cfg.yaw_fan_half + 1, device=xi.device).to(dtype) * torch.full(
        (), step, dtype=dtype, device=xi.device
    )
    tau_sq = torch.full((), cfg.yaw_fan_tau**2, dtype=dtype, device=xi.device)
    T0 = se3.exp(xi)

    def body_yaw(d):
        z = torch.zeros(6, dtype=dtype, device=xi.device)
        z[5] = d
        return T0 @ se3.exp(z)

    scores = []
    for i in range(offs.shape[0]):
        pw = se3.transform(body_yaw(offs[i]), scan.planar.xyz)
        n, pd, pv = _plane_correspondences_cell(cells, pw, scan.planar.valid, cfg.planar_maxnum, 1.5)
        r = torch.sum(pw * n, dim=-1) + pd
        c = torch.where(pv, torch.minimum(r * r, tau_sq), tau_sq)
        scores.append(torch.sum(torch.where(scan.planar.valid, c, 0.0)))
    scores = torch.stack(scores)
    s0 = scores[cfg.yaw_fan_half]
    best = torch.argmin(scores).reshape(1)  # index_select: indexing by a device scalar syncs
    take = scores.index_select(0, best)[0] < cfg.yaw_fan_margin * s0
    best_off = torch.where(take, offs.index_select(0, best)[0], torch.zeros((), dtype=dtype, device=xi.device))
    return se3.log(body_yaw(best_off))


def _build_correspondences(xi, scan: FeatureSet, submap: FeatureSet, grids: dict, cfg: TLSConfig,
                           use_coarse: bool, gicp_covs: dict | None = None) -> _Corr:
    """All four families at pose xi. A coarse round (host flag) matches the
    PLANAR family against the coarse cell grid: with the full 1.5-cell reach
    in cell_plane mode, and in GICP mode as the projection onto the matched
    coarse plane with identity covariance (registration.py:701-723)."""
    T = se3.exp(xi)
    planar_w = se3.transform(T, scan.planar.xyz)
    ground_w = se3.transform(T, scan.ground.xyz)
    edge_w = se3.transform(T, scan.edge.xyz)
    covs = {}
    if gicp_covs is not None:
        pn, p_cov, pv = _gicp_correspondences(
            grids["planar"], submap.planar, gicp_covs["submap_planar"], planar_w, scan.planar.valid,
            cfg.gicp_dist_thres, cfg.planar_maxnum, cfg.max_per_cell,
        )
        if use_coarse:
            cn, cd, pv = _plane_correspondences_cell(
                grids["planar_coarse"], planar_w, scan.planar.valid, cfg.planar_maxnum, 1.5
            )
            pn = planar_w - cn * (torch.sum(planar_w * cn, dim=-1) + cd)[:, None]
            p_cov = torch.eye(3, dtype=pn.dtype, device=pn.device).expand_as(p_cov)
        # the reference searches ground with the PLANAR threshold too
        # (registration.cpp:813): both families share gicp_dist_thres
        gn, g_cov, gv = _gicp_correspondences(
            grids["ground"], submap.ground, gicp_covs["submap_ground"], ground_w, scan.ground.valid,
            cfg.gicp_dist_thres, cfg.ground_maxnum, cfg.max_per_cell,
        )
        pd = torch.zeros_like(pn[:, 0])
        gd = torch.zeros_like(gn[:, 0])
        covs = dict(plane_tgt_cov=p_cov, ground_tgt_cov=g_cov, plane_src_cov=gicp_covs["scan_planar"],
                    ground_src_cov=gicp_covs["scan_ground"])
    elif cfg.corr_mode == "cell_plane":
        if use_coarse:
            planar_grid, planar_gate = grids["planar_coarse"], 1.5
        else:
            planar_grid, planar_gate = grids["planar"], cfg.cell_gate_scale
        pn, pd, pv = _plane_correspondences_cell(planar_grid, planar_w, scan.planar.valid, cfg.planar_maxnum,
                                                 planar_gate)
        gn, gd, gv = _plane_correspondences_cell(grids["ground"], ground_w, scan.ground.valid, cfg.ground_maxnum,
                                                 cfg.cell_gate_scale)
    else:
        pn, pd, pv = _plane_correspondences(grids["planar"], submap.planar, planar_w, scan.planar.valid,
                                            cfg.planar_dist_thres, cfg.planar_maxnum, cfg.max_per_cell)
        gn, gd, gv = _plane_correspondences(grids["ground"], submap.ground, ground_w, scan.ground.valid,
                                            cfg.ground_dist_thres, cfg.ground_maxnum, cfg.max_per_cell)
    if cfg.corr_mode == "cell_plane" and gicp_covs is None:
        ea, eb, ev = _edge_correspondences_cell(grids["edge"], edge_w, scan.edge.valid, cfg)
    else:  # GICP takes kNN edges in either corr_mode
        ea, eb, ev = _edge_correspondences(grids["edge"], submap.edge, edge_w, scan.edge.valid, cfg)
    st, sv = _sphere_correspondences(
        grids["sphere"], submap.sphere, se3.transform(T, scan.sphere.xyz), scan.sphere.valid, cfg
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
    """Residuals/Jacobians/costs of every family at pose xi. Returns (H (6,6),
    g (6,), per-point GNC costs with zeros at invalid slots). The GICP
    families' Cauchy loss lives on their covariance-normalized residual
    scale, `gicp_cauchy_scale` (registration.py:764-781)."""
    T = se3.exp(xi)
    dtype = xi.dtype

    def plane_family(cloud, n, d, valid, weights):
        r, J, cost = res.point_to_plane(T, cloud.xyz, n, d, weights)
        m = valid.to(dtype)
        irls = res.cauchy_weight(r * r) * m
        return J.T @ (J * irls[:, None]), J.T @ (r * irls), cost * m

    def vec_family(r, J, cost, valid, scale=1.0):
        m = valid.to(dtype)
        irls = res.cauchy_weight(torch.sum(r * r, dim=-1), scale) * m
        Jf = J.reshape(-1, 6)
        Jw = (J * irls[:, None, None]).reshape(-1, 6)
        return Jf.T @ Jw, Jw.T @ r.reshape(-1), cost * m

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


def _gn_inner(xi, scan: FeatureSet, corr: _Corr, w: _Weights, cfg: TLSConfig, hard_floor_on, w_scale):
    """Damped, degeneracy-aware Gauss-Newton (registration.py:843): block
    normalized 6x6 eigen solve, degenerate directions zeroed, step clamped
    to the trust region."""
    dtype = xi.dtype
    eye6 = torch.eye(6, dtype=dtype, device=xi.device)
    for _ in range(cfg.inner_iterations):
        H, g, _ = _evaluate(xi, scan, corr, w, _gicp_scale(cfg))
        dH = torch.diagonal(H)
        s_t = 1.0 / torch.sqrt(torch.clamp(torch.mean(dH[:3]), min=1e-12))
        s_r = 1.0 / torch.sqrt(torch.clamp(torch.mean(dH[3:]), min=1e-12))
        S = torch.cat([s_t.expand(3), s_r.expand(3)])
        Hn = H * S[:, None] * S[None, :]
        # a non-finite system yields a zero step (JAX: NaN delta -> zeros);
        # LAPACK must not see the NaNs
        finite = torch.isfinite(Hn).all() & torch.isfinite(g).all()
        lam, V = torch.linalg.eigh(torch.where(finite, Hn, eye6))
        lam_max = torch.clamp(lam[-1], min=1e-12)
        u_sq = torch.sum((S[:, None] * V) ** 2, dim=0)
        lam_raw = lam / torch.clamp(u_sq, min=1e-30) / torch.clamp(w_scale, min=1e-12)
        degen = ((lam < cfg.degen_rel_thres * lam_max) & (lam_raw < cfg.degen_abs_thres)) | (
            hard_floor_on & (lam_raw < cfg.degen_abs_hard)
        )
        inv = torch.where(degen, 0.0, 1.0 / (lam + cfg.lm_lambda))
        delta = -S * ((V * inv[None, :]) @ (V.T @ (S * g)))
        tn = torch.linalg.norm(delta[:3])
        rn = torch.linalg.norm(delta[3:])
        scale = torch.clamp(
            torch.minimum(
                cfg.max_step_trans / torch.clamp(tn, min=1e-12),
                cfg.max_step_rot / torch.clamp(rn, min=1e-12),
            ),
            max=1.0,
        )
        delta = delta * scale
        delta = torch.where(finite & torch.isfinite(delta).all(), delta, torch.zeros_like(delta))
        xi = se3.boxplus_left(xi, delta)
    return xi


def _gicp_scale(cfg: TLSConfig) -> float:
    return cfg.gicp_noise_bound if cfg.plane_residual == "gicp" else 1.0


def _cells_cap(c: Cloud, divisor: int = 1) -> int:
    """Occupied cells never exceed the point count; don't over-size."""
    return max(1024, min(c.capacity // divisor, 65536))


def scan_matching(scan: FeatureSet, submap: FeatureSet, predict_pose: torch.Tensor, cfg: TLSConfig,
                  allow_fallback=True):
    """Register one frame's features against the submap. Returns (pose (4,4),
    Diagnostics) — the contract of LocalRegistration::scanMatching
    (registration.cpp:879-1133)."""
    dtype = scan.planar.xyz.dtype
    dev = scan.planar.xyz.device
    # device scalars by a fill: torch.tensor(v, device=cuda) copies from the host and syncs
    f32 = lambda v: torch.full((), v, dtype=dtype, device=dev)  # noqa: E731
    xi0 = se3.log(predict_pose.to(dtype))
    # tiny-rotation degeneracy guard (registration.cpp:884-886), fixed axis
    tiny = torch.ones(3, dtype=dtype, device=dev) / math.sqrt(3.0) * 1e-4
    omega_small = torch.linalg.norm(xi0[3:]) < 1e-2
    xi0 = torch.where(omega_small, torch.cat([xi0[:3], tiny]), xi0)

    gicp = cfg.plane_residual == "gicp"
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
    # the kNN point-to-plane solve has no coarse grid: no coarse rounds and
    # no yaw fan (registration.py:1052-1093)
    has_coarse = bool(cfg.coarse_scale) and (gicp or cfg.corr_mode == "cell_plane")

    # GNC eps in the residual family's own scale (TLSConfig.gicp_noise_bound)
    noise_bound_sq = (cfg.gicp_noise_bound if gicp else cfg.noise_bound) ** 2
    if noise_bound_sq < 1e-16:
        noise_bound_sq = 1e-2  # registration.cpp:962-964
    gicp_covs = None
    if gicp:
        gicp_covs = {
            name: calculate_covariances(c, cfg.k_corr, max_per_cell=cfg.max_per_cell)
            for name, c in (("scan_planar", scan.planar), ("scan_ground", scan.ground),
                            ("submap_planar", submap.planar), ("submap_ground", submap.ground))
        }
    # the alignment-based mechanisms (starved revert, best round, stall
    # exit, misaligned fallback) need the planar cost's metric meaning (m^2);
    # GICP costs live on a covariance-normalized scale
    gate_on_alignment = cfg.plane_residual == "point_to_plane"

    ones = lambda c: torch.ones(c.capacity, dtype=dtype, device=dev)  # noqa: E731
    weights = _Weights(ones(scan.planar), ones(scan.ground), ones(scan.edge), ones(scan.sphere))
    n_planar_cand = torch.clamp(torch.sum(scan.planar.valid), max=cfg.planar_maxnum)

    mi = cfg.max_iterations
    xi = xi0
    mu = f32(1.0)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    mu_inited, want_coarse, done = false, false, false
    prev_planar_cost = f32(math.inf)
    cost_sums = torch.zeros(4, dtype=dtype, device=dev)
    num_corr = torch.full((4,), 1 << 20, dtype=torch.int32, device=dev)
    prev_mean_planar = f32(math.inf)
    corr_trace = torch.zeros((mi, 4), dtype=torch.int32, device=dev)
    cost_trace = torch.zeros(mi, dtype=dtype, device=dev)
    coarse_trace = torch.zeros(mi, dtype=torch.bool, device=dev)
    aligned_trace = torch.zeros(mi, dtype=torch.bool, device=dev)
    xi_best, best_score, best_seen = xi0, f32(math.inf), false
    best_it = torch.zeros((), dtype=torch.int32, device=dev)
    track_best = bool(cfg.best_round_tau) and gate_on_alignment
    it = 0

    for _ in range(mi):
        # one host sync per round: the JAX cond(done) and the coarse-round
        # lax.conds become host branches
        done_h, coarse_h = (bool(v) for v in torch.stack([done, want_coarse]).tolist())
        if done_h:
            break
        use_coarse = has_coarse and coarse_h
        if use_coarse and "planar_coarse" not in grids:
            # lazy coarse grid: built on the first coarse round of a solve
            grids["planar_coarse"] = _build_surf_cells(
                submap.planar, cfg.planar_dist_thres * cfg.coarse_scale, _cells_cap(submap.planar, 2),
                precise_thres=0.2 * cfg.coarse_scale,
            )
        xi_in = xi
        if use_coarse and cfg.yaw_fan_half > 0:
            xi_in = _yaw_fan(xi, scan, grids["planar_coarse"], cfg)
        corr = _build_correspondences(xi_in, scan, submap, grids, cfg, use_coarse, gicp_covs)
        uc = torch.full((), use_coarse, dtype=torch.bool, device=dev)

        w_mass = (
            torch.sum(torch.square(weights.planar) * corr.plane_valid)
            + torch.sum(torch.square(weights.ground) * corr.ground_valid)
            + torch.sum(torch.square(weights.edge) * corr.edge_valid)
            + torch.sum(torch.square(weights.sphere) * corr.sphere_valid)
        )
        n_valid = (
            torch.sum(corr.plane_valid) + torch.sum(corr.ground_valid)
            + torch.sum(corr.edge_valid) + torch.sum(corr.sphere_valid)
        )
        w_scale = w_mass / torch.clamp(n_valid, min=1)
        planar_empty = torch.sum(corr.plane_valid) == 0
        xi_new = _gn_inner(xi_in, scan, corr, weights, cfg, planar_empty, w_scale)

        _, _, costs = _evaluate(xi_new, scan, corr, weights, _gicp_scale(cfg))
        planar_cost = torch.sum(costs.planar)
        ncorr = torch.stack(
            [torch.sum(corr.plane_valid), torch.sum(corr.ground_valid),
             torch.sum(corr.edge_valid), torch.sum(corr.sphere_valid)]
        ).to(torch.int32)
        mean_planar = planar_cost / torch.clamp(ncorr[0], min=1)

        # monotonicity guard on weighted rounds
        prev_mu_inited = mu_inited
        revert = (
            prev_mu_inited & ~uc
            & (mean_planar > torch.clamp(4.0 * prev_mean_planar, min=cfg.coarse_cost_thres))
            & (ncorr[0] > 0)
        )
        if gate_on_alignment and cfg.revert_starved_rounds:
            revert_starved = ~uc & (it == 0) & (ncorr[0] < cfg.fallback_frac * n_planar_cand)
        else:
            revert_starved = false
        if gate_on_alignment:
            frac_ok = ncorr[0] >= cfg.relocal_frac * n_planar_cand
            aligned = (mean_planar <= cfg.coarse_cost_thres) & frac_ok & (ncorr[0] > 0) & ~uc & ~revert
            gnc_ok = (
                (mean_planar <= cfg.coarse_cost_thres)
                & (ncorr[0] >= cfg.gnc_frac * n_planar_cand)
                & (ncorr[0] > 0) & ~uc & ~revert & ~revert_starved
            )
        else:
            # GICP gate (TLSConfig.gicp_align_dist): mean matched NN distance
            # at the round's INPUT pose
            pw_in = se3.transform(se3.exp(xi_in), scan.planar.xyz)
            nn_d = torch.linalg.norm(pw_in - corr.plane_n, dim=-1)
            mean_nn = torch.sum(torch.where(corr.plane_valid, nn_d, 0.0)) / torch.clamp(ncorr[0], min=1)
            aligned = (ncorr[0] > 0) & (mean_nn <= cfg.gicp_align_dist) & ~uc & ~revert
            gnc_ok = aligned
        # mu seeded on the first GNC-eligible fine round
        first_fine = ~mu_inited & gnc_ok
        if cfg.mu_init == "reference_zero":
            # the reference reads still-zeroed residual buffers: mu = 1e-10
            mu = torch.where(first_fine, f32(1e-10), mu)
        else:
            max_r = torch.maximum(
                torch.max(costs.planar), torch.maximum(torch.max(costs.edge), torch.max(costs.sphere))
            )
            mu = torch.where(first_fine, res.gnc_init_mu(max_r, noise_bound_sq, inlier_mu=1e6), mu)
        mu_inited = mu_inited | first_fine

        th1, th2 = res.gnc_thresholds(mu, noise_bound_sq)
        new_w = _Weights(*(
            res.gnc_update_weights(old, c, noise_bound_sq, th1, th2, mu)
            for old, c in zip(weights, costs)
        ))
        do_update = mu_inited & ~uc & ~revert_starved
        new_w = _Weights(*(torch.where(do_update, n, o) for o, n in zip(weights, new_w)))
        new_w = _Weights(*(torch.where(revert, torch.ones_like(v), v) for v in new_w))
        mu = torch.where(do_update, res.gnc_next_mu(mu, f32(float(it)), cfg.gnc_factor), mu)
        planar_cost_out = torch.where(uc, f32(math.inf), planar_cost)
        if has_coarse:
            lost = ~aligned | (ncorr[0] < cfg.relocal_corr_thres)
            if not gate_on_alignment:
                # GICP: a fine round matching under relocal_frac is lost
                lost = lost | (ncorr[0] < cfg.relocal_frac * n_planar_cand)
            new_want_coarse = lost & ~uc & ~revert
        else:
            new_want_coarse = want_coarse
        cost_sums = torch.stack(
            [planar_cost, torch.sum(costs.ground), torch.sum(costs.edge), torch.sum(costs.sphere)]
        )
        # planar-only convergence gate (registration.cpp:1108-1111) + fail-safes
        done = (
            (torch.abs(planar_cost - prev_planar_cost) < cfg.cost_threshold)
            & (ncorr[0] > 0) & ~uc & ~new_want_coarse & ~revert & ~revert_starved
        )
        if cfg.exit_cost_thres:
            # gated on mu seeded on a PREVIOUS round: the seeding round
            # solved unweighted
            done = done | (aligned & prev_mu_inited & (mean_planar < cfg.exit_cost_thres) & (it >= 2))
        xi_new = torch.where(revert | revert_starved, xi, xi_new)
        prev_mean_planar = torch.where(uc | revert | revert_starved, prev_mean_planar, mean_planar)
        if track_best:
            tau_sq = f32(cfg.best_round_tau**2)
            n_cand = torch.clamp(n_planar_cand, min=1).to(dtype)
            score = (planar_cost + (n_cand - ncorr[0].to(dtype)) * tau_sq) / n_cand
            better = aligned & (score < best_score)
            xi_best = torch.where(better, xi_new, xi_best)
            best_score = torch.where(better, score, best_score)
            best_seen = best_seen | better
            best_it = torch.where(better, it, best_it)
            if cfg.exit_stall_rounds:
                done = done | (best_seen & (it - best_it >= cfg.exit_stall_rounds))
        corr_trace[it] = ncorr
        cost_trace[it] = mean_planar
        coarse_trace[it] = uc
        aligned_trace[it] = aligned
        xi, weights, want_coarse, prev_planar_cost, num_corr = xi_new, new_w, new_want_coarse, planar_cost_out, ncorr
        it += 1

    xi_final = torch.where(best_seen, xi_best, xi) if track_best else xi
    pose = se3.exp(xi_final)
    degenerate = torch.sum(num_corr) < cfg.min_total_corr
    if gate_on_alignment and cfg.misaligned_fallback:
        starved = num_corr[0] < cfg.fallback_frac * n_planar_cand
        never_aligned = ~torch.any(aligned_trace)
        misaligned = never_aligned & starved & torch.as_tensor(allow_fallback, device=dev)
    else:
        misaligned = never_aligned = false
    pose_override = misaligned if cfg.misaligned_pose_fallback else false
    pose = torch.where(degenerate | pose_override, predict_pose.to(dtype), pose)
    return pose, Diagnostics(
        torch.full((), it, dtype=torch.int32, device=dev), mu, cost_sums, num_corr, degenerate,
        misaligned=misaligned, never_aligned=never_aligned,
        corr_trace=corr_trace, cost_trace=cost_trace,
        coarse_trace=coarse_trace, aligned_trace=aligned_trace,
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
