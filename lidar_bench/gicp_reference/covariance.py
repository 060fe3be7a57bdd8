"""Each point's neighbour covariance, the helper that the frozen
``voxel`` lacks (a copy of ``tloam_torch/ops/voxel.py``'s
``gather_planes`` and ``neighbour_covariance``).

Upstream's ``calculateCov`` (zhoupengwei/tloam,
``src/lidar_odometry/registration.cpp:385-415``) takes the covariance of a
point's k nearest neighbours about their mean. The moments here are taken
about the query point and then centred: raw-coordinate second moments
cancel in float32 at map scale. Equal in exact arithmetic.
"""
from __future__ import annotations

import torch

from lidar_bench.reference.voxel import take


def gather_planes(points: torch.Tensor, idx: torch.Tensor):
    """Neighbour coordinates as three ([F,] Q, k) planes."""
    frames = points.ndim == 3
    return tuple(take(points[..., a], idx, frames) for a in range(3))


def neighbour_covariance(points: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor):
    """Covariance (a00, a01, a02, a11, a12, a22) of each point's valid
    neighbours idx ([F,] Q, k), from moments about the point itself."""
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
