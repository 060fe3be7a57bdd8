"""Point-cloud factory constructors: depth image, RGBD and voxel grid.

Port of ``tloam_tpu/ops/factories.py`` (reference: src/open3d/
PointCloud2.cpp:1493-1643, CreatePointCloudFromFloatDepthImage,
CreateFromRGBDImage, CreateFromVoxelGrid). The per-pixel loops are one
vectorized back-projection; pixels that the reference drops are masked.
Every output lies on the input tensor's device.
"""
from __future__ import annotations

import math

import torch

from tloam_torch.cloud import Cloud


def cloud_from_depth_image(
    depth: torch.Tensor,  # (H, W) float metres; <= 0 or non-finite = invalid
    intrinsics: tuple,  # (fx, fy, cx, cy)
    extrinsic: torch.Tensor | None = None,  # (4, 4) world -> camera
    stride: int = 1,
    depth_scale: float = 1.0,
    depth_trunc: float = math.inf,
) -> Cloud:
    """Back-project a depth image (PointCloud2.cpp:1493-1527):
    x = (j - cx) z / fx, y = (i - cy) z / fy, then through extrinsic^-1
    (the camera pose)."""
    fx, fy, cx, cy = intrinsics
    d = depth[::stride, ::stride].to(torch.float32) / depth_scale
    H, W = d.shape
    jj = torch.arange(W, dtype=torch.float32, device=d.device)[None, :]
    ii = torch.arange(H, dtype=torch.float32, device=d.device)[:, None]
    x = (jj * stride - cx) * d / fx
    y = (ii * stride - cy) * d / fy
    pts = torch.stack([x, y, d], dim=-1).reshape(-1, 3)
    valid = (torch.isfinite(d) & (d > 0) & (d < depth_trunc)).reshape(-1)
    if extrinsic is not None:
        pose = torch.linalg.inv(extrinsic.to(d.device))
        pts = pts @ pose[:3, :3].T + pose[:3, 3]
    return Cloud(xyz=pts, intensity=torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device), valid=valid)


def cloud_from_rgbd(
    depth: torch.Tensor,  # (H, W)
    color: torch.Tensor,  # (H, W, 3) or (H, W, 1), uint8 or float
    intrinsics: tuple,
    extrinsic: torch.Tensor | None = None,
    depth_scale: float = 1.0,
    depth_trunc: float = math.inf,
) -> Cloud:
    """Depth back-projection plus per-pixel colors (PointCloud2.cpp:
    1529-1592); uint8 colors are scaled by 1/255 as in the reference."""
    cloud = cloud_from_depth_image(depth, intrinsics, extrinsic, 1, depth_scale, depth_trunc)
    c = color.reshape(-1, color.shape[-1]).to(torch.float32)
    if color.dtype == torch.uint8:
        c = c / 255.0
    if c.shape[-1] == 1:  # grayscale -> replicated channels
        c = c.expand(c.shape[0], 3)
    return Cloud(xyz=cloud.xyz, intensity=cloud.intensity, valid=cloud.valid, colors=c[:, :3])


def cloud_from_voxel_grid(
    grid_indices: torch.Tensor,  # (K, 3) int voxel coordinates
    voxel_size,
    origin: torch.Tensor,  # (3,)
    valid: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
) -> Cloud:
    """One point at each voxel CENTER, origin + (idx + 0.5) * voxel_size,
    carrying the voxel's color (PointCloud2.cpp:1623-1641)."""
    pts = (grid_indices.to(torch.float32) + 0.5) * voxel_size + origin
    n = pts.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=pts.device)
    return Cloud(xyz=pts, intensity=torch.zeros(n, dtype=pts.dtype, device=pts.device), valid=valid, colors=colors)
