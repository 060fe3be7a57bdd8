"""Residual/Jacobian families + the GNC-TLS weight schedule.

Port of ``tloam_tpu/ops/residuals.py`` (the reference's Ceres
SizedCostFunctions, registration.cpp:14-160, and updateWeight,
registration.cpp:858-876). Left perturbation on the world-frame point,
state ``[upsilon, omega]``. For the 3-residual families the GNC "cost" is
(r0+r1+r2)^2, the reference quirk (registration.cpp:32,69,143); for
point-to-plane it is r^2 (registration.cpp:101).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class ResidualBatch(NamedTuple):
    """Flattened per-correspondence residual data ready for normal equations.

    res  : (N, 3) residual components (1-res families put it in [..., 0])
    jac  : (N, 3, 6) Jacobian rows (zero-padded for 1-res families)
    cost : (N,) the GNC bookkeeping cost (see module docstring)
    valid: (N,) bool, whether this correspondence contributes
    """

    res: torch.Tensor
    jac: torch.Tensor
    cost: torch.Tensor
    valid: torch.Tensor


def _dt(pw: torch.Tensor, weight: torch.Tensor, sign: float) -> torch.Tensor:
    """[sign*w I | -sign*w pw^] (...,3,6)."""
    eye = torch.eye(3, dtype=pw.dtype, device=pw.device)
    w = weight[..., None, None]
    return torch.cat([sign * eye * w, -sign * se3.hat(pw) * w], dim=-1)


def point_to_point(T, source, target, weight):
    """r = w (target - T source); J = [-w I | w (T source)^] (registration.cpp:19-47)."""
    pw = se3.transform(T, source)
    r = (target - pw) * weight[..., None]
    J = _dt(pw, weight, -1.0)
    cost = torch.square(torch.sum(r, dim=-1))
    return r, J, cost


def point_to_line(T, source, line_a, line_b, weight):
    """r = w (pw-a)x(pw-b)/|a-b|; J = (b-a)^ [w I | -w pw^] / |a-b|
    (registration.cpp:55-88)."""
    pw = se3.transform(T, source)
    nu = torch.linalg.cross(pw - line_a, pw - line_b, dim=-1)
    de_norm = torch.linalg.norm(line_a - line_b, dim=-1)
    inv_de = 1.0 / torch.clamp(de_norm, min=1e-12)
    r = nu * (weight * inv_de)[..., None]
    J = se3.hat(line_b - line_a) @ _dt(pw, weight, 1.0) * inv_de[..., None, None]
    cost = torch.square(torch.sum(r, dim=-1))
    return r, J, cost


def point_to_plane(T, source, unit_norm, d, weight):
    """r = n.(T source) + d (unweighted, as the reference);
    J = n^T [w I | -w (T source)^] (registration.cpp:96-117)."""
    pw = se3.transform(T, source)
    r = torch.sum(unit_norm * pw, dim=-1) + d
    J = (unit_norm[..., None, :] @ _dt(pw, weight, 1.0))[..., 0, :]
    return r, J, torch.square(r)


# ---------------------------------------------------------------------------
# GNC-TLS schedule (registration.cpp:858-876, 1027-1033, 1049-1050, 1089)
# ---------------------------------------------------------------------------


def gnc_init_mu(max_residual, noise_bound_sq, inlier_mu: float = 1e-10):
    """mu = 1/(2 r_max / eps^2 - 1); `inlier_mu` where that is <= 0 (the
    all-inlier regime — see tloam_tpu.ops.residuals.gnc_init_mu)."""
    mu = 1.0 / (2.0 * max_residual / noise_bound_sq - 1.0)
    return torch.where(mu <= 0.0, torch.full_like(mu, inlier_mu), mu)


def gnc_thresholds(mu, noise_bound_sq):
    """(th1, th2) = ((mu+1)/mu, mu/(mu+1)) * eps^2."""
    return (mu + 1.0) / mu * noise_bound_sq, mu / (mu + 1.0) * noise_bound_sq


def gnc_update_weights(weights, costs, noise_bound_sq, th1, th2, mu):
    """cost==0 keeps the previous weight; cost>=th1 -> 0; cost<=th2 -> 1;
    else sqrt(eps^2 mu (mu+1)/cost) - mu."""
    safe = torch.clamp(costs, min=1e-30)
    mid = torch.sqrt(noise_bound_sq * mu * (mu + 1.0) / safe) - mu
    w = torch.where(
        costs >= th1, torch.zeros_like(costs),
        torch.where(costs <= th2, torch.ones_like(costs), mid),
    )
    w = torch.clamp(w, 0.0, 1.0)
    return torch.where(costs == 0.0, weights, w)


def gnc_next_mu(mu, iter_idx, gnc_factor):
    """mu * exp((iter+1) * gnc_factor), clamped at 1e8 (f32 overflow guard)."""
    return torch.clamp(mu * torch.exp((iter_idx + 1.0) * gnc_factor), max=1e8)


def cauchy_weight(sq_norm, scale: float = 1.0):
    """IRLS weight of the Cauchy loss (registration.cpp:970)."""
    return 1.0 / (1.0 + sq_norm / (scale * scale))
