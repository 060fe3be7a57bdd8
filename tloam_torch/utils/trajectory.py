"""Trajectory I/O + KITTI odometry evaluation (ATE / RPE).

A copy of ``tloam_tpu/utils/trajectory.py`` (numpy only), kept in the port
so that it imports nothing of the JAX package; its code must stay identical.

The reference only WRITES trajectories (savePose, front_end.cpp:169-179 —
KITTI 3x4 rows, committed as doc/tloam_NN.txt) and evaluated offline. This module implements both the writer and the
standard KITTI odometry benchmark metrics (translational % and rotational
deg/100m over 100..800 m segments, as in the README table README.md:31-36),
plus ATE RMSE after SE(3) alignment (Umeyama).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def save_kitti(path: str | Path, poses: np.ndarray) -> None:
    """Write (M,4,4) poses as KITTI 3x4 row-major text (front_end.cpp:169-179)."""
    rows = np.asarray(poses)[:, :3, :4].reshape(len(poses), 12)
    np.savetxt(str(path), rows, fmt="%.18e")


def load_kitti(path: str | Path) -> np.ndarray:
    rows = np.loadtxt(str(path)).reshape(-1, 12)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :4] = rows.reshape(-1, 3, 4)
    return out


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length at each frame."""
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _first_frame_past(dist: np.ndarray, start: int, length: float) -> int:
    i = np.searchsorted(dist, dist[start] + length)
    return int(i) if i < len(dist) else -1


def kitti_odometry_errors(
    gt: np.ndarray,
    est: np.ndarray,
    step: int = 10,
    lengths=None,
    return_count: bool = False,
):
    """KITTI benchmark: average translational error (%) and rotational error
    (deg/100m) over all (start, length) segment pairs.

    Returns (t_err_percent, r_err_deg_per_100m) — plus the contributing
    segment count when `return_count`. `lengths` restricts the segment
    lengths (default: the standard 100..800 m set)."""
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    dist = trajectory_distances(gt)
    seg_lengths = SEGMENT_LENGTHS if lengths is None else tuple(lengths)
    t_errs, r_errs = [], []
    for start in range(0, n, step):
        for length in seg_lengths:
            end = _first_frame_past(dist, start, length)
            if end < 0:
                break
            dg = np.linalg.inv(gt[start]) @ gt[end]
            de = np.linalg.inv(est[start]) @ est[end]
            err = np.linalg.inv(de) @ dg
            t_errs.append(np.linalg.norm(err[:3, 3]) / length)
            cos_r = np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            r_errs.append(np.degrees(np.arccos(cos_r)) / length * 100.0)
    if not t_errs:
        out = (float("nan"), float("nan"))
        return out + (0,) if return_count else out
    out = (100.0 * float(np.mean(t_errs)), float(np.mean(r_errs)))
    return out + (len(t_errs),) if return_count else out


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Best rigid transform aligning src (M,3) onto dst (M,3)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def ate_rmse(gt: np.ndarray, est: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over positions (optionally SE(3)
    aligned)."""
    n = min(len(gt), len(est))
    p_gt = gt[:n, :3, 3]
    p_est = est[:n, :3, 3]
    if align:
        T = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ T[:3, :3].T + T[:3, 3]
    return float(np.sqrt(np.mean(np.sum((p_gt - p_est) ** 2, axis=1))))


def rpe(gt: np.ndarray, est: np.ndarray, delta: int = 1) -> tuple[float, float]:
    """Relative pose error over fixed frame deltas: (trans RMSE m, rot RMSE deg)."""
    n = min(len(gt), len(est))
    ts, rs = [], []
    for i in range(n - delta):
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        de = np.linalg.inv(est[i]) @ est[i + delta]
        err = np.linalg.inv(de) @ dg
        ts.append(np.sum(err[:3, 3] ** 2))
        cos_r = np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rs.append(np.degrees(np.arccos(cos_r)) ** 2)
    return float(np.sqrt(np.mean(ts))), float(np.sqrt(np.mean(rs)))
