"""Frame-by-frame sensitivity of a drive of chip_smoke.py.

    python3 tests/gicp_frame_gaps.py cuda-cpu --seed 0            # on the card
    JAX_PLATFORMS=cpu python3 tests/gicp_frame_gaps.py jax-cpu --seed 0 --frames 7
    python3 tests/gicp_frame_gaps.py cuda-cpu --drive town --frames 96 --from-frame 85

Drives the 30-frame rest start (64 rings x 1870 azimuth steps, capacity
131072, `odometry.tls.plane_residual=gicp`) on one noise realization, or
with --drive town the route-c hard-town drive of the long drive and of
chip_smoke.py's town phase under the default config (raycasts spread over
the cores into the scan cache first), and steps every frame from
--from-frame on a second time from the same state:

  cuda-cpu  the port on the card, each frame also by the port on the CPU;
  jax-cpu   the JAX package on the CPU, each frame also by the port on the
            CPU, from the JAX state.

Prints one JSON line a frame (after the card's name and power limit, on
the card): the drive's drift against the ground truth,
the second step's drift, the gap between the two poses, and both solves'
GNC rounds, correspondence counts and mean planar cost per round. Two
roundings of one solve part by the gap of a frame; the drive carries the
first one's result forward.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax_mode_refs as refs  # noqa: E402


def summary(diag) -> dict:
    a = lambda v: np.asarray(v.cpu() if hasattr(v, "cpu") else v)  # noqa: E731
    return {"rounds": int(a(diag.iterations)), "num_corr": a(diag.num_corr).tolist(),
            "mean_planar_cost": [round(float(c), 4) for c in a(diag.cost_trace)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("pair", choices=["cuda-cpu", "jax-cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--drive", choices=["gicp", "town"], default="gicp")
    ap.add_argument("--from-frame", type=int, default=1, help="the first frame stepped a second time")
    args = ap.parse_args(argv)

    from tloam_torch import build
    from tloam_torch.cloud import Cloud
    from tloam_torch.config import load_pipeline_config
    from tloam_torch.pipeline import frontend as tf
    from tloam_torch.utils import synthetic

    if args.drive == "gicp":
        drive, overrides, _ = refs.MODES["gicp"]
        gt, scans = refs.drive_scans(drive, synthetic, args.seed)
        rel = refs.gt_rel(gt)
    else:
        from tloam_torch.utils import drives

        overrides = []
        drives.fill_scan_cache(args.frames, os.cpu_count() or 1, **refs.TOWN_DRIVE)
        scans = [(x, e) for _, x, e in drives.scan_stream(args.frames, **refs.TOWN_DRIVE)]
        rel = drives.drive_ground_truth(args.frames, refs.TOWN_DRIVE["route"])
    tcfg = load_pipeline_config(None, overrides)
    drift = lambda p, i: float(np.linalg.norm(np.asarray(p)[:3, 3] - rel[i, :3, 3]))  # noqa: E731

    if args.pair == "cuda-cpu":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"card": card}), flush=True)
        build.build()
        state = tf.init_state(tcfg)
        step = lambda st, q, n: tf.odometry_step_packed(st, q, n, tcfg)  # noqa: E731
        to_numpy = tf.state_to_numpy
    else:
        import jax
        import jax.numpy as jnp

        from tloam_tpu.config import load_pipeline_config as jax_load
        from tloam_tpu.pipeline import frontend as jf

        jcfg = jax_load(None, overrides)
        state = jf.init_state(jcfg, jnp.float32)
        def step(st, q, n):
            return jf.odometry_step_packed(st, jnp.asarray(q), jnp.asarray(n, jnp.int32), jcfg)

        to_numpy = lambda st: jax.tree.map(np.asarray, st)  # noqa: E731

    for i, (xyz, inten) in enumerate(scans[: args.frames]):
        q, n = Cloud.pack_scan(xyz, inten, capacity=131072)
        before = to_numpy(state) if i >= max(args.from_frame, 1) else None
        state, pose, diag = step(state, q, n)
        pose = np.asarray(pose.cpu() if hasattr(pose, "cpu") else pose)
        row = {"frame": i, "drift_m": drift(pose, i), "drive": summary(diag)}
        if before is not None:
            _, pose2, diag2 = tf.odometry_step_packed(tf.state_from_numpy(before, device="cpu"), q, n, tcfg)
            pose2 = pose2.numpy()
            row.update(second_drift_m=drift(pose2, i), gap_m=float(np.linalg.norm(pose2[:3, 3] - pose[:3, 3])),
                       second=summary(diag2))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
