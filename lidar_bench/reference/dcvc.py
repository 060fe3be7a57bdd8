"""Dynamic Curved-Voxel Clustering (DCVC) — parallel connected components.

Port of ``tloam_tpu/models/dcvc.py`` (the reference's sequential DCVC,
src/models/segmentation/segmentation.cpp:777-1112): curved voxels
(azimuth, polar, pitch), a dense int16 label volume reduced by separable
3-wide box-min passes (shifted ``torch.minimum``, exact), hooking + pointer
jumping rounds, the ``min_seg`` filter, size-ranked labels and per-cluster
AABBs. The partition equals the JAX module's and a union-find oracle's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .cloud import Cloud
from .config import DCVCConfig, SensorConfig
from .voxel import _SENTINEL, _first_of_runs, _lin3, _takepad, sort_with_payload, unpermute

_P1, _P2, _P3 = 73856093, 19349663, 83492791
_POLAR_CAP = 512  # static cap on radial bins (~468 used for 120 m range)
_PITCH_CAP = 32  # static cap on pitch bins (HDL-64 FOV / 1.2 deg ~ 23)
_MAXI16 = 32767


class DCVCResult(NamedTuple):
    labels: torch.Tensor  # (N,) int32 cluster rank 1..K per point, 0 = dropped
    segmented: Cloud  # input cloud masked to clustered points
    box_min: torch.Tensor  # (K,3) cluster AABB minima
    box_max: torch.Tensor  # (K,3)
    box_valid: torch.Tensor  # (K,)
    num_clusters: torch.Tensor  # ()


def curved_voxel_coords(cloud: Cloud, cfg: DCVCConfig, sensor: SensorConfig):
    """Per-point curved-voxel int coords (azimuth, polar, pitch) and the
    in-range mask (segmentation.cpp:791-857)."""
    xyz = cloud.xyz
    dtype = xyz.dtype
    r = torch.linalg.norm(xyz, dim=-1)
    safe_r = torch.clamp(r, min=1e-9)
    pitch = torch.rad2deg(torch.arcsin(torch.clamp(xyz[:, 2] / safe_r, -1.0, 1.0)))
    azim = torch.rad2deg(torch.atan2(xyz[:, 1], xyz[:, 0]))
    azim = torch.where(azim < 0.0, azim + 360.0, azim)

    ok = cloud.valid & (r < sensor.sensor_max_range) & (r > sensor.sensor_min_range)

    min_pitch = torch.min(torch.where(ok, pitch, torch.inf))
    min_polar = torch.min(torch.where(ok, r, torch.inf))
    min_pitch = torch.where(torch.isfinite(min_pitch), min_pitch, 0.0)
    min_polar = torch.where(torch.isfinite(min_polar), min_polar, 0.0)

    # dynamic radial bounds bound(m) = minPolar + m startR - deltaR m(m+1)/2,
    # inverted in closed form and fixed by two exact boundary checks
    def bound(m):
        return min_polar + m * cfg.start_r - cfg.delta_r * m * (m + 1.0) * 0.5

    b2 = cfg.start_r - 0.5 * cfg.delta_r
    if cfg.delta_r > 1e-12:
        B = 2.0 * b2 / cfg.delta_r
        C = 2.0 * torch.clamp(r - min_polar, min=0.0) / cfg.delta_r
        disc = torch.clamp(B * B - 4.0 * C, min=0.0)
        m_est = 2.0 * C / (B + torch.sqrt(disc))
    else:
        m_est = (r - min_polar) / max(cfg.start_r, 1e-9)
    idx = torch.clamp(torch.floor(m_est).to(torch.int32), 0, _POLAR_CAP)
    fidx = idx.to(dtype)
    idx = torch.where(bound(fidx + 1.0) <= r, idx + 1, idx)
    idx = torch.where((idx >= 1) & (bound(fidx) > r), idx - 1, idx)
    polar_idx = torch.clamp(idx, 0, _POLAR_CAP - 1)

    pitch_idx = torch.round((pitch - min_pitch) / cfg.delta_p).to(torch.int32)
    azim_idx = torch.round(azim / cfg.delta_a).to(torch.int32)
    return torch.stack([azim_idx, polar_idx, pitch_idx], dim=-1), ok


def _voxelize(coords: torch.Tensor, ok: torch.Tensor, max_voxels: int):
    """Unique voxels (hash-sorted) + per-point voxel index: (vox_coords
    (V,3), vox_valid (V,), point_vox (N,) or -1)."""
    n = coords.shape[0]
    c = torch.where(ok[:, None], coords, _SENTINEL)
    pkeys = torch.where(ok, _lin3(c[:, 0], c[:, 1], c[:, 2], _P1, _P2, _P3), _SENTINEL)
    idx = torch.arange(n, dtype=torch.int32, device=coords.device)
    _, cxs, cys, czs, oks_i, idx_s = sort_with_payload(
        pkeys, c[:, 0], c[:, 1], c[:, 2], ok.to(torch.int32), idx
    )
    ok_s = oks_i > 0
    first = _first_of_runs(cxs, cys, czs)
    seg = torch.cumsum(first, 0) - 1
    seg = torch.where(ok_s, seg, max_voxels)
    seg_c = torch.clamp(seg, max=max_voxels)

    start_key = torch.where(first & ok_s & (seg < max_voxels), seg, _SENTINEL)
    sk, vx, vy, vz = sort_with_payload(start_key, cxs, cys, czs)
    sk, vx, vy, vz = (_takepad(a, max_voxels, _SENTINEL) for a in (sk, vx, vy, vz))
    vox_valid = sk < _SENTINEL
    vi = vox_valid.to(torch.int32)
    vox_coords = torch.stack([vx * vi, vy * vi, vz * vi], dim=1) + torch.where(
        vox_valid, 0, _SENTINEL
    ).to(torch.int32)[:, None]

    pv_sorted = torch.where(ok_s & (seg < max_voxels), seg_c, -1).to(torch.int32)
    point_vox = unpermute(idx_s.long(), pv_sorted)
    return vox_coords, vox_valid, point_vox


def _win_min(d3: torch.Tensor, dim: int) -> torch.Tensor:
    """3-wide window min along `dim` with MAXI padding (reduce_window SAME)."""
    pad_shape = list(d3.shape)
    pad_shape[dim] = 1
    pad = torch.full(pad_shape, _MAXI16, dtype=d3.dtype, device=d3.device)
    p = torch.cat([pad, d3, pad], dim=dim)
    L = d3.shape[dim]
    return torch.minimum(
        torch.minimum(p.narrow(dim, 0, L), p.narrow(dim, 1, L)), p.narrow(dim, 2, L)
    )


def dcvc_segment(
    cloud: Cloud,
    cfg: DCVCConfig,
    sensor: SensorConfig,
    max_voxels: int = 16384,
    max_clusters: int = 128,
    cc_iters: int = 8,
    dense_passes: int = 2,
) -> DCVCResult:
    """Cluster the non-ground cloud into objects (reference
    objectSegmentation, segmentation.cpp:1085-1112)."""
    dev = cloud.device
    coords, ok = curved_voxel_coords(cloud, cfg, sensor)
    vox_coords, vox_valid, point_vox = _voxelize(coords, ok, max_voxels)

    width = int(round(360.0 / cfg.delta_a)) + 1  # 301 for deltaA=1.2
    V = max_voxels
    A = width + 1
    dense_shape = (_PITCH_CAP, A, _POLAR_CAP)
    dense_n = _PITCH_CAP * A * _POLAR_CAP

    vc_a, vc_p, vc_h = vox_coords[:, 0], vox_coords[:, 1], vox_coords[:, 2]
    in_range = (
        vox_valid
        & (vc_a >= 0) & (vc_a < A)
        & (vc_p >= 0) & (vc_p < _POLAR_CAP)
        & (vc_h >= 0) & (vc_h < _PITCH_CAP)
    )
    vkey = torch.where(
        in_range, (vc_h.long() * A + vc_a) * _POLAR_CAP + vc_p, dense_n
    )  # flat dense slot per voxel (dense_n = dropped)
    vkey_safe = torch.clamp(vkey, max=dense_n - 1)

    ar_v = torch.arange(V, dtype=torch.int32, device=dev)
    label = torch.where(vox_valid, ar_v, V - 1)

    # separable 26-neighbourhood box min: pitch (clamped), azimuth (cyclic
    # over the `width` real columns — the reference's clamp quirk,
    # symmetrized), polar (clamped); see tloam_tpu/models/dcvc.py:219-269
    def box_min_pass(d3):
        d3 = _win_min(d3, 0)
        da = d3[:, :width, :]
        da = torch.cat([da[:, -1:, :], da, da[:, :1, :]], dim=1)
        da = _win_min(da, 1)[:, 1 : width + 1, :]
        d3 = torch.cat([da, d3[:, width:, :].clone().fill_(_MAXI16)], dim=1)
        return _win_min(d3, 2)

    if V > 32768:
        raise ValueError(f"dcvc_segment: dense labels are int16, so max_voxels must be <= 32768, got {V}")
    occ = torch.zeros((dense_n + 1,), dtype=torch.bool, device=dev)
    occ[vkey] = in_range
    occ3 = occ[:dense_n].view(dense_shape)
    for _ in range(cc_iters):
        dense = torch.full((dense_n + 1,), _MAXI16, dtype=torch.int16, device=dev)
        dense[vkey] = label.to(torch.int16)
        d3 = dense[:dense_n].view(dense_shape)
        for p in range(dense_passes):
            d3 = box_min_pass(d3)
            if p + 1 < dense_passes:
                d3 = torch.where(occ3, d3, _MAXI16)
        m = d3.reshape(-1)[vkey_safe].to(torch.int32)  # box min incl. self
        best = torch.minimum(torch.where(in_range, m, _MAXI16), label)
        # hooking: every tree adopts the min label seen by any member
        seg_root = torch.where(vox_valid, label, V).long()
        root_min = torch.full((V + 1,), _SENTINEL, dtype=torch.int32, device=dev)
        root_min = root_min.scatter_reduce(0, seg_root, best, reduce="amin")[:V]
        best = torch.minimum(best, root_min[torch.clamp(label, max=V - 1).long()])
        best = torch.where(vox_valid, best, label)
        label = best[best.long()]  # pointer jumping

    # --- cluster stats ---
    has_vox = point_vox >= 0
    pts_per_vox = torch.zeros(V, dtype=torch.int64, device=dev).index_add_(
        0, torch.clamp(point_vox, min=0).long(), has_vox.to(torch.int64)
    ) * vox_valid
    root = label.long()
    cluster_size = torch.zeros(V, dtype=torch.int64, device=dev).index_add_(0, root, pts_per_vox)
    point_root = torch.where(has_vox, root[torch.clamp(point_vox, min=0).long()], -1)

    # keep clusters with size > min_seg, ranked by size desc (labelAnalysis);
    # ties go to the lower root index, as lax.top_k
    is_root = vox_valid & (torch.arange(V, device=dev) == root) & (cluster_size > cfg.min_seg)
    score = torch.where(is_root, cluster_size, -1)
    top_size, top_root = torch.sort(score, descending=True, stable=True)
    top_size, top_root = top_size[:max_clusters], top_root[:max_clusters]
    box_valid = top_size > 0
    num_clusters = torch.sum(box_valid)

    rank_of_root = torch.zeros((V + 1,), dtype=torch.int32, device=dev)
    ranks = torch.arange(1, max_clusters + 1, dtype=torch.int32, device=dev)
    rank_of_root[torch.where(box_valid, top_root, V)] = torch.where(box_valid, ranks, 0)
    rank_of_root = rank_of_root[:V]
    labels = torch.where(point_root >= 0, rank_of_root[torch.clamp(point_root, min=0)], 0)
    labels = torch.where(cloud.valid, labels, 0).to(torch.int32)

    # --- AABBs per kept cluster (segment min of [xyz, -xyz]) ---
    in_cluster = labels > 0
    lab = torch.where(in_cluster, labels.long() - 1, max_clusters)
    both = torch.cat([cloud.xyz, -cloud.xyz], dim=1)
    # empty clusters keep segment_min's identity (+inf), as in JAX
    init = torch.full((max_clusters + 1, 6), torch.inf, dtype=cloud.xyz.dtype, device=dev)
    seg_both = init.scatter_reduce(
        0, lab[:, None].expand(-1, 6), torch.where(in_cluster[:, None], both, torch.inf),
        reduce="amin",
    )[:max_clusters]
    return DCVCResult(
        labels, cloud.mask(in_cluster), seg_both[:, :3], -seg_both[:, 3:], box_valid, num_clusters
    )
