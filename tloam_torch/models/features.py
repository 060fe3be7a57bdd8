"""PCA planar / sphere feature extraction.

Port of the default (``pca_mode="cell"``) path of
``tloam_tpu/models/features.py`` (the reference's featureExtract,
src/models/feature_extraction/feature_extract.cpp:13-197): cell-aggregated
27-neighbourhood PCA, the planar/sphere classes, histogram-threshold top-k
masks (global and per azimuth sector) and the capacity-bounded compaction.
The exact per-point kNN PCA (``pca_mode="exact"``) waits for a later slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tloam_torch.cloud import Cloud
from tloam_torch.config import FeatureConfig
from tloam_torch.ops import eig3, voxel


def matmul_histogram(key: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Histogram of int keys in [0, n_bins) (out-of-range ignored), int32.
    The JAX module builds it as a one-hot MXU matmul; an integer index_add
    into a sink bin is exact and never syncs with the host."""
    ok = (key >= 0) & (key < n_bins)
    idx = torch.where(ok, key.long(), n_bins)
    hist = torch.zeros(n_bins + 1, dtype=torch.int32, device=key.device)
    return hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))[:n_bins]


class PCAInfo(NamedTuple):
    normal: torch.Tensor  # (N,3) smallest-eigenvector direction
    cvr: torch.Tensor  # (N,)
    flatness: torch.Tensor  # (N,)
    sphericity: torch.Tensor  # (N,)
    num_neigh: torch.Tensor  # (N,)
    has_info: torch.Tensor  # (N,) neighbour-count gate passed
    local_max: torch.Tensor  # (N,) cell cvr >= every neighbour cell's cvr


def calculate_pca_info_cell(cloud: Cloud, cfg: FeatureConfig, max_cells: int = 65536) -> PCAInfo:
    """Cell-aggregated PCA (FeatureConfig.pca_mode "cell"): points are
    binned at pitch `radius`, each cell aggregates its 27-neighbourhood
    moments, and every point inherits its cell's eigen-features."""
    dtype = cloud.xyz.dtype
    bt = voxel.build_block_table(cloud.xyz, cloud.valid, cfg.radius, max_cells)
    _, mw, cache = voxel.block_window_moments(cloud.xyz, cloud.valid, bt, cfg.radius)
    rows, found, parity = cache
    w_cnt, sx, sy, sz, mxx, mxy, mxz, myy, myz, mzz = mw
    cnt = torch.clamp(w_cnt, min=1.0)
    mx, my, mz = sx / cnt, sy / cnt, sz / cnt
    a00 = mxx / cnt - mx * mx
    a01 = mxy / cnt - mx * my
    a02 = mxz / cnt - mx * mz
    a11 = myy / cnt - my * my
    a12 = myz / cnt - my * mz
    a22 = mzz / cnt - mz * mz

    lam0, lam1, lam2 = eig3.eigvalsh3_soa(a00, a01, a02, a11, a12, a22)
    nx_, ny_, nz_ = eig3.eigvec_soa(a00, a01, a02, a11, a12, a22, lam0)
    lam_sum = lam0 + lam1 + lam2
    c_cvr = torch.where(lam_sum > 0, lam0 / torch.clamp(lam_sum, min=1e-30), 0.0)
    lam_hi = torch.clamp(lam2, min=1e-30)
    c_flat = (lam1 - lam0) / lam_hi
    c_sph = lam0 / lam_hi
    nbr_max = voxel.block_window_scalar_max(bt, c_cvr, rows, found, parity)
    c_localmax = c_cvr >= nbr_max

    cell_rec = torch.stack(
        [nx_, ny_, nz_, c_cvr, c_flat, c_sph, w_cnt, c_localmax.to(dtype)], dim=1
    )  # (V, 8)
    in_cell = bt.point_cell >= 0
    prec = cell_rec[torch.clamp(bt.point_cell, min=0).long()] * in_cell.to(dtype)[:, None]
    normal = torch.cat(
        [torch.where(in_cell, prec[:, 0], 1.0)[:, None], prec[:, 1:3]], dim=1
    )
    n_neigh = prec[:, 6].to(torch.int32)
    has_info = cloud.valid & in_cell & (n_neigh > cfg.min_neigh)
    return PCAInfo(
        normal, prec[:, 3], prec[:, 4], prec[:, 5], n_neigh, has_info,
        in_cell & (prec[:, 7] > 0.5),
    )


def _score_range(score: torch.Tensor, cls: torch.Tensor):
    smax = torch.max(torch.where(cls, score, -torch.inf))
    smin = torch.min(torch.where(cls, score, torch.inf))
    lo = torch.where(torch.isfinite(smin), smin, 0.0)
    hi = torch.where(torch.isfinite(smax), smax, 1.0)
    return lo, torch.clamp(hi - lo, min=1e-12)


def top_k_mask(score: torch.Tensor, cls: torch.Tensor, k: int, bins: int = 2048) -> torch.Tensor:
    """Mask of (about) the k highest-score points among `cls` by a one-pass
    histogram threshold (ties inside the threshold bin are all kept)."""
    total = torch.sum(cls)
    lo, width = _score_range(score, cls)
    b = torch.clamp(((score - lo) / width * bins).to(torch.int32), 0, bins - 1)
    b = torch.where(cls, b, bins)
    hist = matmul_histogram(b, bins)
    from_top = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    ar = torch.arange(bins, device=score.device)
    bstar = torch.max(torch.where(from_top >= k, ar, -1))
    thresh = lo + bstar.to(score.dtype) * width / bins
    keep = cls & (score >= thresh) & (bstar >= 0)
    return torch.where(total <= k, cls, keep)


def top_k_mask_segmented(score, cls, seg, n_seg: int, k: int, bins: int = 512) -> torch.Tensor:
    """Per-segment `top_k_mask`: (about) the k highest-score points of `cls`
    within each segment (azimuth sector)."""
    lo, width = _score_range(score, cls)
    b = torch.clamp(((score - lo) / width * bins).to(torch.int32), 0, bins - 1)
    seg_c = torch.clamp(seg, 0, n_seg - 1).long()
    key = torch.where(cls, seg_c * bins + b, n_seg * bins)
    hist = matmul_histogram(key, n_seg * bins).reshape(n_seg, bins)
    from_top = torch.flip(torch.cumsum(torch.flip(hist, (1,)), 1), (1,))
    ar = torch.arange(bins, device=score.device)[None, :]
    bstar = torch.max(torch.where(from_top >= k, ar, -1), dim=1).values
    thresh = lo + bstar.to(score.dtype) * width / bins
    keep = cls & (score >= thresh[seg_c]) & (bstar[seg_c] >= 0)
    seg_tot = torch.sum(hist, dim=1)
    return torch.where(seg_tot[seg_c] <= k, cls, keep)


def azimuth_sectors(xyz: torch.Tensor, n_sectors: int) -> torch.Tensor:
    """Sensor-frame azimuth sector id per point, (N,) int32 in [0, n)."""
    az = torch.atan2(xyz[:, 1], xyz[:, 0])
    s = ((az + math.pi) / (2 * math.pi) * n_sectors).to(torch.int32)
    return torch.clamp(s, 0, n_sectors - 1)


class FeatureSelection(NamedTuple):
    planar_scan: torch.Tensor  # (N,) mask
    planar_submap: torch.Tensor
    sphere_scan: torch.Tensor
    sphere_submap: torch.Tensor
    pca: PCAInfo


def extract_planar_sphere(cloud: Cloud, cfg: FeatureConfig) -> FeatureSelection:
    """Classify + rank planar/sphere features (extractPlanarSphere,
    feature_extract.cpp:131-197)."""
    if cfg.pca_mode != "cell":
        raise NotImplementedError(
            "tloam_torch: pca_mode='exact' is not ported yet (ROADMAP A14)"
        )
    pca = calculate_pca_info_cell(cloud, cfg, cfg.max_cells)
    planar_cls = (
        pca.has_info
        & (pca.flatness > cfg.planar_submap_thres)
        & (torch.abs(pca.normal[:, 2]) < cfg.planar_vertic_thres)
    )
    sphere_cls = pca.has_info & ~planar_cls & (pca.cvr > cfg.cvr_submap) & pca.local_max
    planar_scan = planar_cls & (
        top_k_mask(pca.flatness, planar_cls, cfg.planar_num)
        | (pca.flatness > cfg.planar_scan_thres)
    )
    # the reference ranks spheres by FLATNESS against cvr_scan (quirk kept)
    sphere_top = top_k_mask(pca.flatness, sphere_cls, cfg.sphere_num)
    sphere_scan = sphere_cls & (sphere_top | (pca.flatness > cfg.cvr_scan))
    return FeatureSelection(planar_scan, planar_cls, sphere_scan, sphere_cls, pca)


def gather_top(cloud: Cloud, mask: torch.Tensor, score: torch.Tensor, capacity: int, sectors: int = 0) -> Cloud:
    """Compact the masked points into a fixed-capacity Cloud, preferring the
    highest-score points (per azimuth sector when `sectors` > 0)."""
    if sectors > 0:
        seg = azimuth_sectors(cloud.xyz, sectors)
        sel = top_k_mask_segmented(score, mask, seg, sectors, max(capacity // sectors, 1))
    else:
        sel = top_k_mask(score, mask, capacity)
    rank = torch.cumsum(sel, 0) - 1
    ok = sel & (rank < capacity)
    slot = torch.where(ok, rank, capacity)
    dtype = cloud.xyz.dtype
    vals = torch.cat([cloud.xyz, cloud.intensity[:, None], ok[:, None].to(dtype)], dim=1)
    out = torch.zeros((capacity + 1, 5), dtype=dtype, device=cloud.device)
    out[slot] = vals
    return Cloud(xyz=out[:capacity, :3], intensity=out[:capacity, 3], valid=out[:capacity, 4] > 0.5)
