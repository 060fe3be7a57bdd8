"""Closed-form batched symmetric 3x3 eigendecomposition.

Port of ``tloam_tpu/ops/eig3.py`` (the trigonometric closed form, Smith
1961, standing in for the reference's per-point Eigen
SelfAdjointEigenSolver calls). Eigenvalues ascend, as in Eigen.
"""
from __future__ import annotations

import math

import torch


def eigvalsh3_soa(a00, a01, a02, a11, a12, a22):
    """Eigenvalues from the six unique components. Returns (lo, mid, hi)."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))

    safe_p = torch.where(p > 0.0, p, torch.ones_like(p))
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detB / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo

    isotropic = p2 <= 1e-30
    return (
        torch.where(isotropic, q, e_lo),
        torch.where(isotropic, q, e_mid),
        torch.where(isotropic, q, e_hi),
    )


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (...,3,3), ascending: (...,3)."""
    lo, mid, hi = eigvalsh3_soa(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )
    return torch.stack([lo, mid, hi], dim=-1)


def eigvec_soa(a00, a01, a02, a11, a12, a22, lam):
    """Unit eigenvector for eigenvalue `lam` as (nx, ny, nz): the largest
    cross product of two rows of (A - lam I)."""
    b00, b11, b22 = a00 - lam, a11 - lam, a22 - lam
    c01x = a01 * a12 - a02 * b11
    c01y = a02 * a01 - b00 * a12
    c01z = b00 * b11 - a01 * a01
    c02x = a01 * b22 - a02 * a12
    c02y = a02 * a02 - b00 * b22
    c02z = b00 * a12 - a01 * a02
    c12x = b11 * b22 - a12 * a12
    c12y = a12 * a02 - a01 * b22
    c12z = a01 * a12 - b11 * a02
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = ~use01 & (n02 >= n12)
    vx = torch.where(use01, c01x, torch.where(use02, c02x, c12x))
    vy = torch.where(use01, c01y, torch.where(use02, c02y, c12y))
    vz = torch.where(use01, c01z, torch.where(use02, c02z, c12z))
    norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
    ok = norm > 1e-20
    inv = torch.where(ok, 1.0 / torch.clamp(norm, min=1e-30), torch.zeros_like(norm))
    one, zero = torch.ones_like(vx), torch.zeros_like(vx)
    return (
        torch.where(ok, vx * inv, one),
        torch.where(ok, vy * inv, zero),
        torch.where(ok, vz * inv, zero),
    )


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector for eigenvalue lam (e_x where degenerate)."""
    v = eigvec_soa(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2], lam,
    )
    return torch.stack(v, dim=-1)


def eigh3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigvals (...,3) ascending, eigvecs (...,3,3)) with eigvecs[..., :, i]
    the unit eigenvector of eigvals[..., i], as torch.linalg.eigh."""
    w = eigvalsh3(A)
    v_lo = _eigvec_for(A, w[..., 0])
    v_hi = _eigvec_for(A, w[..., 2])
    v_hi = v_hi - torch.sum(v_hi * v_lo, dim=-1, keepdim=True) * v_lo
    norm_hi = torch.linalg.norm(v_hi, dim=-1, keepdim=True)
    ez = torch.zeros_like(v_lo)
    ez[..., 2] = 1.0
    ey = torch.zeros_like(v_lo)
    ey[..., 1] = 1.0
    alt = torch.linalg.cross(v_lo, ez, dim=-1)
    alt_norm = torch.linalg.norm(alt, dim=-1, keepdim=True)
    alt = torch.where(alt_norm > 1e-6, alt, torch.linalg.cross(v_lo, ey, dim=-1))
    alt = alt / torch.clamp(torch.linalg.norm(alt, dim=-1, keepdim=True), min=1e-30)
    v_hi = torch.where(norm_hi > 1e-10, v_hi / torch.clamp(norm_hi, min=1e-30), alt)
    v_mid = torch.linalg.cross(v_hi, v_lo, dim=-1)
    return w, torch.stack([v_lo, v_mid, v_hi], dim=-1)


def _masked_cov(pts: torch.Tensor, mask: torch.Tensor):
    m = mask.to(pts.dtype)
    cnt = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    mean = torch.sum(pts * m[..., None], dim=-2) / cnt[..., None]
    diff = (pts - mean[..., None, :]) * m[..., None]
    cov = diff.transpose(-1, -2) @ diff / cnt[..., None, None]
    return mean, cov


def plane_from_points(pts: torch.Tensor, mask: torch.Tensor):
    """Masked least-squares plane: (unit normal, d, lam0/sum)."""
    mean, cov = _masked_cov(pts, mask)
    w, V = eigh3(cov)
    n = V[..., :, 0]
    d = -torch.sum(n * mean, dim=-1)
    lam_sum = torch.clamp(torch.sum(w, dim=-1), min=1e-30)
    return n, d, w[..., 0] / lam_sum


def line_from_points(pts: torch.Tensor, mask: torch.Tensor):
    """Masked line fit: (centroid, unit direction, float gate lam2 > 3 lam1)
    (registration.cpp:451-484)."""
    mean, cov = _masked_cov(pts, mask)
    w, V = eigh3(cov)
    is_line = (w[..., 2] > 3.0 * w[..., 1]).to(pts.dtype)
    return mean, V[..., :, 2], is_line
