"""How ``correct`` is decided: the program's answers against the reference's.

An answer is one pose with its diagnostics: a frame of the stream, or an
entry of a batched solve. Each carries the key of the reference answer it
must match (the frame's index in its pass, the entry's index in the
batch). Each number that ``limits/<cell>.json`` names is compared, as the
worst over all answers, against its limit there:

- ``pose_gap_m``: translation of inv(reference pose) @ program pose;
- ``pose_gap_rad``: rotation angle of the same;
- ``rounds_gap``: |program - reference| GNC rounds;
- ``corr_gap``: |program - reference| correspondences of a family at the
  last round, over max(reference, 1).
"""
from __future__ import annotations

import numpy as np

NUMBERS = ("pose_gap_m", "pose_gap_rad", "rounds_gap", "corr_gap")


def pose_gaps(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(translation m, rotation rad) of inv(b) @ a for (n,4,4) stacks."""
    d = np.linalg.inv(b.astype(np.float64)) @ a.astype(np.float64)
    r = d[:, :3, :3]
    s = 0.5 * np.linalg.norm(np.stack([r[:, 2, 1] - r[:, 1, 2], r[:, 0, 2] - r[:, 2, 0],
                                       r[:, 1, 0] - r[:, 0, 1]], -1), axis=-1)
    c = 0.5 * (np.trace(r, axis1=1, axis2=2) - 1.0)
    return np.linalg.norm(d[:, :3, 3], axis=-1), np.arctan2(s, c)


def compare(answers: dict, ref: dict, limits: dict) -> dict:
    """answers: {"key" (n,), "pose" (n,4,4), "rounds" (n,), "corr" (n,4)};
    ref: {"pose" (K,4,4), "rounds" (K,), "corr" (K,4)} indexed by key.
    Returns {"correct", "attempted", "failed", "numbers": {name: {"value",
    "limit"}}}; an answer fails when a number of its own passes a limit or
    its pose is not finite. A number the limits do not name is not compared."""
    key = np.asarray(answers["key"])
    pose = np.asarray(answers["pose"], np.float64)
    ok_pose = np.isfinite(pose).all(axis=(1, 2))
    safe = np.where(ok_pose[:, None, None], pose, np.eye(4))
    gap_m, gap_rad = pose_gaps(safe, ref["pose"][key])
    rounds = np.abs(np.asarray(answers["rounds"], np.int64) - ref["rounds"][key])
    rc = np.asarray(ref["corr"], np.float64)[key]
    corr = (np.abs(np.asarray(answers["corr"], np.float64) - rc) / np.maximum(rc, 1.0)).max(axis=1)
    each = {"pose_gap_m": gap_m, "pose_gap_rad": gap_rad, "rounds_gap": rounds, "corr_gap": corr}
    bad = ~ok_pose
    numbers = {}
    for name in (n for n in NUMBERS if n in limits):
        v = each[name]
        bad |= v > limits[name]
        worst = float("inf") if not ok_pose.all() else (float(v.max()) if len(v) else 0.0)
        numbers[name] = {"value": worst, "limit": limits[name]}
    n = len(key)
    return {"correct": bool(n > 0 and not bad.any()), "attempted": n, "failed": int(bad.sum()),
            "numbers": numbers}
