"""Batched SE(3)/SO(3) Lie-group math on torch tensors.

Port of ``tloam_tpu/ops/se3.py`` (the reference's vendored Sophus headers,
include/third_party/sophus/se3.hpp, so3.hpp). Same conventions:

  * a tangent vector ``xi`` is ``[upsilon (3), omega (3)]``, translation
    first (Sophus ordering);
  * ``exp(xi)`` returns a homogeneous (...,4,4) transform;
  * solver updates are LEFT-multiplicative,
    ``xi [+] delta = log(exp(delta) @ exp(xi))`` (registration.cpp:162-173).

Small-angle branches use Taylor series selected with ``torch.where`` on safe
operands, exactly as the JAX module does.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor, shape=None) -> torch.Tensor:
    e = torch.eye(n, dtype=like.dtype, device=like.device)
    return e if shape is None else e.expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor near 0."""
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    A_t = torch.sin(theta) / theta
    B_t = (1.0 - torch.cos(theta)) / safe_sq
    C_t = (theta - torch.sin(theta)) / (safe_sq * theta)
    A_s = 1.0 - theta_sq / 6.0
    B_s = 0.5 - theta_sq / 24.0
    C_s = 1.0 / 6.0 - theta_sq / 120.0
    return (
        torch.where(small, A_s, A_t),
        torch.where(small, B_s, B_t),
        torch.where(small, C_s, C_t),
    )


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential (Rodrigues): (...,3) -> (...,3,3)."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    WW = W @ W
    return _eye(3, w, W.shape) + A[..., None, None] * W + B[..., None, None] * WW


def left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3): V = I + B W + C W^2."""
    theta_sq = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    WW = W @ W
    return _eye(3, w, W.shape) + B[..., None, None] * W + C[..., None, None] * WW


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: (...,3,3) -> (...,3), accurate up to theta < pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    theta_sq = theta * theta

    small = theta_sq < _EPS
    near_pi = theta > (math.pi - 1e-3)

    w_asym = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis

    safe_theta = torch.where(small | near_pi, torch.ones_like(theta), theta)
    sin_t = torch.sin(safe_theta)
    w_generic = (safe_theta / sin_t)[..., None] * w_asym
    w_small = (1.0 + theta_sq / 6.0)[..., None] * w_asym

    # near pi: axis from the diagonal of (R + I)/2 = axis axis^T, signs from
    # M = R + R^T anchored on the largest component
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + 1e-12), min=0.0
    )
    axis_abs = torch.sqrt(axis_sq)
    k = torch.argmax(axis_abs, dim=-1)
    M = R + R.transpose(-1, -2)
    idx = k[..., None, None].expand(*M.shape[:-1], 1)
    ka = torch.gather(M, -1, idx)[..., 0]
    ar = torch.arange(3, device=R.device)
    anchor_col = torch.where(ar == k[..., None], torch.ones_like(axis_abs), torch.sign(ka))
    axis_pi = axis_abs * anchor_col
    axis_pi = axis_pi / (torch.linalg.norm(axis_pi, dim=-1, keepdim=True) + 1e-12)
    flip = torch.sign(torch.sum(axis_pi * w_asym, dim=-1, keepdim=True))
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    w_pi = theta[..., None] * axis_pi * flip

    w = torch.where(small[..., None], w_small, w_generic)
    return torch.where(near_pi[..., None], w_pi, w)


def inv_left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the SO(3) left Jacobian."""
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    half = theta * 0.5
    cot_coef_t = (1.0 - half * torch.cos(half) / torch.sin(half)) / safe_sq
    cot_coef_s = 1.0 / 12.0 + theta_sq / 720.0
    cot_coef = torch.where(small, cot_coef_s, cot_coef_t)
    W = hat(w)
    WW = W @ W
    return _eye(3, w, W.shape) - 0.5 * W + cot_coef[..., None, None] * WW


def _matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: (...,6) [upsilon, omega] -> (...,4,4)."""
    ups, omega = xi[..., :3], xi[..., 3:]
    R = exp_so3(omega)
    V = left_jacobian_so3(omega)
    return rt_to_mat(R, _matvec(V, ups))


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (...,4,4) -> (...,6) [upsilon, omega]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = log_so3(R)
    ups = _matvec(inv_left_jacobian_so3(omega), t)
    return torch.cat([ups, omega], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (...,4,4) from (...,3,3) rotation and (...,3) translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)  # a fill kernel: `= 1.0` copies a host scalar and syncs
    return torch.cat([top, bottom], dim=-2)


def inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (...,4,4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -_matvec(Rt, t))


def transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points: a 1-D (3,) input is ONE point; any
    ndim>=2 input is a point batch (...,N,3) broadcast against T's batch."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.ndim >= 2:
        return pts @ R.transpose(-1, -2) + t[..., None, :]
    return _matvec(R, pts) + t


def boxplus_left(xi: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """log(exp(delta) @ exp(xi)) — reference registration.cpp:170."""
    return log(exp(delta) @ exp(xi))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint: (...,4,4) -> (...,6,6) acting on [upsilon, omega]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    Z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)
