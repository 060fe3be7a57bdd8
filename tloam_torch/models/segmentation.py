"""Ring estimation + multi-region ground segmentation.

Port of ``tloam_tpu/models/segmentation.py`` (the reference's Segmentation
ground path, src/models/segmentation/segmentation.cpp:174-770): ring ids
from the quadrant-wrap cummax, the 4x3 region partition, seed selection and
the iterative weighted-axis plane fits of all 12 regions at once. The JAX
``fori_loop`` of plane fits is a Python loop here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tloam_torch.cloud import Cloud
from tloam_torch.config import GroundSegConfig, SensorConfig


def quadrant_of(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reference quadrant numbering (segmentation.cpp:345-360): 1..4."""
    q = torch.full(x.shape, 4, dtype=torch.int32, device=x.device)
    q = torch.where((x < 0) & (y <= 0), 3, q)
    q = torch.where((x <= 0) & (y > 0), 2, q)
    return torch.where((x > 0) & (y >= 0), 1, q).to(torch.int32)


def estimate_rings(xyz: torch.Tensor, valid: torch.Tensor, sensor_model: int = 64):
    """Ring id per point (a 4 -> 1 quadrant wrap between consecutive valid
    points starts the next beam, segmentation.cpp:362-377) + masked mean
    height."""
    q = quadrant_of(xyz[:, 0], xyz[:, 1])
    n = q.shape[0]
    idx = torch.arange(n, device=xyz.device)
    packed = torch.where(valid, idx * 8 + q, -1)
    last_packed = torch.cummax(packed, 0).values
    prev_packed = torch.cat([torch.full((1,), -1, dtype=packed.dtype, device=xyz.device), last_packed[:-1]])
    prev_q = torch.where(prev_packed >= 0, prev_packed & 7, 0)
    wrap = valid & (q == 1) & (prev_q == 4)
    ring = torch.clamp(torch.cumsum(wrap.to(torch.int32), 0), max=sensor_model - 1).to(torch.int32)
    m = valid.to(xyz.dtype)
    mean_h = torch.sum(xyz[:, 2] * m) / torch.clamp(torch.sum(m), min=1.0)
    return ring, mean_h


def section_bounds(sensor: SensorConfig, g: GroundSegConfig) -> np.ndarray:
    """Radial section boundaries from the HDL ring-radius table (reference
    initSections, segmentation.cpp:174-223), host-side."""
    num_sec = g.num_sec
    width = int(np.ceil(1.0 * sensor.sensor_model) / num_sec)
    boundary_idx = [width * (i + 1) - 1 for i in range(num_sec)]
    bounds = []
    angle = sensor.init_angle
    bi = 0
    for i in range(sensor.sensor_model):
        if sensor.sensor_model == 64 and i == 31:
            angle += 1.7
        if bi < len(boundary_idx) and i == boundary_idx[bi] and bi <= 3:
            theta = abs(angle / 180.0 * np.pi)
            if theta != 0 and i < sensor.sensor_model:
                bounds.append(sensor.sensor_height / np.tan(theta))
            else:
                bounds.append(sensor.sensor_max_range)
            bi += 1
        angle += sensor.vertical_res
    return np.asarray(bounds, np.float64)


def region_ids(xyz: torch.Tensor, bounds: torch.Tensor, num_sec: int) -> torch.Tensor:
    """Per-point region id q*num_sec + s (fillSectionIndex,
    segmentation.cpp:507-542; quadrants from atan2(-y, x) in [0,360))."""
    x, y = xyz[:, 0], xyz[:, 1]
    r = torch.sqrt(x * x + y * y)
    theta = torch.rad2deg(torch.atan2(-y, x))
    theta = torch.where(theta < 0, theta + 360.0, theta)
    quad = torch.clamp((theta / 90.0).to(torch.int32), 0, 3)
    sec = torch.zeros(r.shape, dtype=torch.int32, device=xyz.device)
    for b in range(bounds.shape[0]):
        sec = sec + (r >= bounds[b]).to(torch.int32)
    sec = torch.clamp(sec, max=num_sec - 1)
    return quad * num_sec + sec


def _rank_in_region(member: torch.Tensor, region: torch.Tensor, num_regions: int) -> torch.Tensor:
    """Order-preserving rank of each point within its region."""
    onehot = region[None, :] == torch.arange(num_regions, device=region.device, dtype=region.dtype)[:, None]
    onehot = onehot & member[None, :]
    ranks = torch.cumsum(onehot.to(torch.int32), dim=1) - 1
    return torch.sum(torch.where(onehot, ranks, 0), dim=0)


def weighted_axis_plane(moments: torch.Tensor) -> torch.Tensor:
    """Batched reference plane fit (findBestPlane, segmentation.cpp:551-616;
    registration.cpp:303-368). moments (..., 10) = [sx, sy, sz, sxx, sxy,
    sxz, syy, syz, szz, count] -> plane (..., 4) [nx, ny, nz, d]."""
    cnt = torch.clamp(moments[..., 9], min=1.0)
    cx, cy, cz = moments[..., 0] / cnt, moments[..., 1] / cnt, moments[..., 2] / cnt
    xx = moments[..., 3] / cnt - cx * cx
    xy = moments[..., 4] / cnt - cx * cy
    xz = moments[..., 5] / cnt - cx * cz
    yy = moments[..., 6] / cnt - cy * cy
    yz = moments[..., 7] / cnt - cy * cz
    zz = moments[..., 8] / cnt - cz * cz

    det_x = yy * zz - yz * yz
    ax_x = torch.stack([det_x, xz * yz - xy * zz, xy * yz - xz * yy], dim=-1)
    det_y = xx * zz - xz * xz
    ax_y = torch.stack([xz * yz - xy * zz, det_y, xy * xz - yz * xx], dim=-1)
    det_z = xx * yy - xy * xy
    ax_z = torch.stack([xy * yz - xz * yy, xy * xz - yz * xx, det_z], dim=-1)

    w = torch.zeros_like(ax_x)
    for ax, det in ((ax_x, det_x), (ax_y, det_y), (ax_z, det_z)):
        weight = det * det
        sgn = torch.where(torch.sum(w * ax, dim=-1) < 0.0, -1.0, 1.0)
        w = w + ax * (sgn * weight)[..., None]

    norm = torch.linalg.norm(w, dim=-1, keepdim=True)
    n = torch.where(norm > 0, w / torch.clamp(norm, min=1e-30), torch.zeros_like(w))
    centroid = torch.stack([cx, cy, cz], dim=-1)
    d = -torch.sum(n * centroid, dim=-1)
    return torch.cat([n, d[..., None]], dim=-1)


class GroundSegResult(NamedTuple):
    ground: Cloud  # intensity = time-only fractional part
    objects: Cloud  # vertical + high points, intensity = ring + time
    ring: torch.Tensor  # (N,) int32 ring id of every input slot
    planes: torch.Tensor  # (12,4) final region plane models (diagnostics)


def ground_remove(cloud: Cloud, sensor: SensorConfig, g: GroundSegConfig) -> GroundSegResult:
    """Multi-region ground extraction (reference groundRemove,
    segmentation.cpp:738-770)."""
    xyz, inten, valid = cloud.xyz, cloud.intensity, cloud.valid
    dtype = xyz.dtype
    dev = xyz.device
    num_regions = g.quadrant * g.num_sec

    ring, mean_h = estimate_rings(xyz, valid, sensor.sensor_model)
    mean_h = mean_h + 0.5  # groundRemove: estimateRingsAndTimes2(...) + 0.5

    high = valid & (xyz[:, 2] > mean_h)
    candidate = valid & ~high

    bounds = torch.as_tensor(section_bounds(sensor, g), dtype=dtype, device=dev)
    region = region_ids(xyz, bounds, g.num_sec)
    region_l = region.long()

    r_norm = torch.linalg.norm(xyz, dim=-1)
    rank = _rank_in_region(candidate, region, num_regions)

    region_oh = (region[:, None] == torch.arange(num_regions, device=dev)[None, :]).to(dtype)

    def region_sum(cols: torch.Tensor) -> torch.Tensor:
        """(N,K) per-point values -> (12,K) per-region sums."""
        return region_oh.T @ cols

    # --- seed selection (segmentGroundThread :640-663) ---
    sub10 = (
        candidate
        & (rank % 10 == 0)
        & (xyz[:, 2] >= -1.5 * sensor.sensor_height)
        & (r_norm >= sensor.sensor_min_range)
        & (r_norm <= sensor.sensor_max_range)
    )
    z_by_region = torch.where(
        sub10[None, :] & (region[None, :] == torch.arange(num_regions, device=dev)[:, None]),
        xyz[None, :, 2],
        torch.inf,
    )  # (12, N)
    low_z = torch.sort(z_by_region, dim=1, stable=True).values[:, : g.ground_seed_num]
    low_ok = torch.isfinite(low_z)
    n_low = torch.sum(low_ok, dim=1)
    av_height = torch.sum(torch.where(low_ok, low_z, 0.0), dim=1) / torch.clamp(n_low, min=1)
    av_height = torch.where(n_low > 0, av_height, 0.0)

    seed = sub10 & (xyz[:, 2] < av_height[region_l] + g.dis)
    cand_m = candidate.to(dtype)
    pre = region_sum(
        torch.cat([seed[:, None].to(dtype), cand_m[:, None], xyz * cand_m[:, None]], dim=1)
    )  # (12, 5): [seed_count, cand_count, sum_x, sum_y, sum_z]
    region_ok = pre[:, 0] > 3  # <=3 seeds: whole region dropped (:668)

    # --- iterative plane refinement on region-anchored coordinates ---
    reg_cnt = torch.clamp(pre[:, 1], min=1.0)
    anchor = pre[:, 2:5] / reg_cnt[:, None]
    cxyz = xyz - anchor[region_l]
    feats = torch.cat(
        [
            cxyz,
            cxyz[:, 0:1] * cxyz[:, 0:1],
            cxyz[:, 0:1] * cxyz[:, 1:2],
            cxyz[:, 0:1] * cxyz[:, 2:3],
            cxyz[:, 1:2] * cxyz[:, 1:2],
            cxyz[:, 1:2] * cxyz[:, 2:3],
            cxyz[:, 2:3] * cxyz[:, 2:3],
            torch.ones_like(cxyz[:, :1]),
        ],
        dim=1,
    )  # (N,10)
    hom = torch.cat([cxyz, torch.ones_like(cxyz[:, :1])], dim=1)

    member = seed
    planes = torch.zeros((num_regions, 4), dtype=dtype, device=dev)
    for i in range(g.max_iter):
        planes = weighted_axis_plane(region_sum(feats * member.to(dtype)[:, None]))
        dis = torch.abs(torch.sum(hom * planes[region_l], dim=-1))
        close = candidate & (dis < g.dis)
        # iters before the last re-select every 5th region point (:687-689)
        new_member = close & (rank % 5 == 0) if i < g.max_iter - 1 else close
        # freeze regions whose member set collapsed (<=3): keep old members
        n_new = region_sum(new_member[:, None].to(dtype))[:, 0]
        member = torch.where((n_new <= 3)[region_l], member, new_member)
    planes = planes.clone()
    planes[:, 3] = planes[:, 3] - torch.sum(planes[:, :3] * anchor, dim=-1)

    ok_pp = region_ok[region_l]
    ground_mask = member & ok_pp
    vertical_mask = candidate & ~member & ok_pp

    # estimateRingsAndTimes2 overwrites intensity with the beam id; ground
    # keeps the (zero) fractional time, objects the ring id
    ground = Cloud(xyz=xyz, intensity=torch.zeros_like(inten), valid=ground_mask)
    objects = Cloud(xyz=xyz, intensity=ring.to(inten.dtype), valid=vertical_mask | high)
    return GroundSegResult(ground, objects, ring, planes)
