"""The long synthetic town drive through tloam_torch on one GPU.

    python3 scripts/torch_long_drive.py                      # 600 frames, route c
    python3 scripts/torch_long_drive.py --frames 60 --out /tmp/ld.json

The counterpart of scripts/long_drive.py: the 600-frame route-c hard-town
loop (world 3, cars 11, occlusions 12, packed int16 transfer, the default
PipelineConfig) through tloam_torch.utils.drives.hard_town_drive. The
raycast cache is filled first by --workers spawned processes
(drives.fill_scan_cache), so the drive replays cached scans; the two times
are reported apart. Writes a JSON in LONGDRIVE_r05.json's fields (KITTI
segment errors with the per-length breakdown, ATE/RPE, drift curve,
degenerate frames) plus the card, the frames/s of the drive and the
largest per-frame translation gap to the JAX package's trajectory
(--jax-traj), and the trajectory beside it (_traj.txt).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--route", default="c")
    ap.add_argument("--world", type=int, default=3)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="processes that fill the raycast cache")
    ap.add_argument("--jax-traj", default=str(REPO / "LONGDRIVE_r05_traj.txt"),
                    help="the JAX package's trajectory of the same drive")
    ap.add_argument("--out", default=str(REPO / "build" / "LONGDRIVE_torch.json"))
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args()

    import torch

    from tloam_torch.config import load_pipeline_config
    from tloam_torch.utils import drives, trajectory

    if not torch.cuda.is_available():
        print("torch_long_drive: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    drive = dict(route=args.route, world_seed=args.world, cars_seed=args.world + 8, occ_seed=args.world + 9)
    raycast_s = drives.fill_scan_cache(args.frames, args.workers, **drive)
    print(f"raycast cache filled in {raycast_s:.1f} s by {args.workers} processes", file=sys.stderr, flush=True)

    cfg = load_pipeline_config(None, args.set)
    est, gt_rel, info = drives.hard_town_drive(
        cfg, frames=args.frames, packed=True,
        progress=lambda i, p, d: print(f"f{i}", file=sys.stderr, flush=True), **drive,
    )
    m = drives.drive_metrics(est, gt_rel)
    per_len = {}
    for L in (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0):
        t_err, r_err, n = trajectory.kitti_odometry_errors(gt_rel, est, lengths=(L,), return_count=True)
        if n:
            per_len[str(int(L))] = {"t_err_pct": round(float(t_err), 4),
                                    "r_err_deg_per_100m": round(float(r_err), 4), "segments": int(n)}
    gap = None
    if os.path.exists(args.jax_traj):
        ref = trajectory.load_kitti(args.jax_traj)
        k = min(len(ref), len(est))
        d = np.linalg.norm(est[:k, :3, 3] - ref[:k, :3, 3], axis=1)
        gap = {"frames": k, "max_m": float(d.max()), "at_frame": int(d.argmax()), "mean_m": float(d.mean())}

    payload = {
        "metric": "long_drive_kitti_errors",
        "frames": args.frames,
        "route": args.route,
        "world_seed": args.world,
        "transfer": "packed_int16",
        "hard": True,
        "config_overrides": args.set,
        "per_segment_length": per_len,
        "segment_lengths_contributing": len(per_len),
        "wall_s": round(info["wall_s"], 1),
        "degenerate_frames": info["degenerate_frames"],
        **m,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": card,
        "torch": torch.__version__,
        "drive_frames_per_s": args.frames / info["wall_s"],
        "raycast_cache_fill_s": raycast_s,
        "raycast_workers": args.workers,
        "translation_gap_to_jax": gap,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    trajectory.save_kitti(str(out).replace(".json", "_traj.txt"), est)
    print(json.dumps({k: payload[k] for k in (
        "kitti_t_err_pct", "kitti_r_err_deg_per_100m", "ate_rmse_m", "degenerate_frames",
        "segment_lengths_contributing", "drive_frames_per_s", "raycast_cache_fill_s", "translation_gap_to_jax",
        "nvidia_smi")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
