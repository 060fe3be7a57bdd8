"""The frozen residual families and GNC schedule
(``lidar_bench/reference/residuals.py``), and GICP's ``plane_to_plane``,
a copy of ``tloam_torch/ops/residuals.py``'s.

Upstream's ``PlaneToPlaneErr::Evaluate`` (zhoupengwei/tloam,
``src/lidar_odometry/registration.cpp:126-160``): with M = (C_t + R C_s
R^T)^-1, r = w M (t - T p) and J = M [-w I | w (T p)^]. The GNC cost is
(r0 + r1 + r2)^2, upstream's 3-residual quirk (:143).
"""
from __future__ import annotations

import torch

from lidar_bench.reference import se3
from lidar_bench.reference.residuals import (  # noqa: F401
    _dt, cauchy_weight, gnc_init_mu, gnc_next_mu, gnc_thresholds, gnc_update_weights, point_to_line,
    point_to_plane, point_to_point,
)


def plane_to_plane(T, source, source_cov, target, target_cov, weight):
    """GICP's residual, Jacobian and cost. A singular system gives values
    that are not finite (the regularized covariances never are)."""
    R = T[..., None, :3, :3]  # against the (..., N, 3, 3) covariances
    pw = se3.transform(T, source)
    M = torch.linalg.inv_ex(target_cov + R @ source_cov @ R.transpose(-1, -2))[0]
    r = (M @ (target - pw)[..., None])[..., 0] * weight[..., None]
    J = M @ _dt(pw, weight, -1.0)
    return r, J, torch.square(torch.sum(r, dim=-1))
