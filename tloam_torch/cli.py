"""Command-line entry points: ``tloam-torch run | eval | bench | info``.

Port of ``tloam_tpu/cli.py`` (the reference's roslaunch entry,
launch/tloam_kitti.launch). `run` executes full-sequence odometry over a
KITTI directory, or over the built-in synthetic world when no dataset is
given, writes a KITTI-format trajectory and supports checkpoint/resume.
`run` and `bench` run on the GPU unless ``--device`` names another device
(``--device cpu``); with no GPU and no ``--device`` they raise.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys

import numpy as np


def cmd_run(args) -> int:
    from tloam_torch import device as _device
    from tloam_torch.cloud import Cloud
    from tloam_torch.config import load_pipeline_config
    from tloam_torch.io.kitti import KittiSequence, prefetch_iter
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils import checkpoint as ckpt
    from tloam_torch.utils import synthetic, timing, trajectory

    dev = _device.resolve(args.device)
    cfg = load_pipeline_config(args.config, args.set or ())

    state = frontend.init_state(cfg, dev)
    poses = []
    if args.resume:
        state, saved = ckpt.load_state(args.resume, state, cfg=cfg)
        poses = list(saved)
        print(f"resumed at frame {len(poses)}", file=sys.stderr)
    start = len(poses)

    if args.data:
        seq = KittiSequence.open(args.data, args.sequence)
        n = len(seq) if args.frames is None else min(args.frames, len(seq))
        print(f"KITTI sequence {args.sequence}: {n} frames", file=sys.stderr)
        # a background prefetch thread (the native loader underneath):
        # disk I/O overlaps the device step, the reference's reader-nodelet
        # role (kitti_reader_nodelet.cpp:60-70)
        scan_iter = prefetch_iter(((i, seq.scan(i)) for i in range(start, n)), depth=4)
        cap = 131072
        gt = seq.gt_velo()
    else:
        n = args.frames or 50
        print(f"synthetic sequence: {n} frames", file=sys.stderr)
        scene = synthetic.Scene.urban(np.random.default_rng(3))
        gt = synthetic.straight_trajectory(n, step=1.0, yaw_rate=0.005)
        cap = 64 * 1870

        def gen():
            for i in range(start, n):
                with timing.STAGES.stage("synthesize"):
                    s = synthetic.simulate_scan(gt[i], scene, rings=64, az_steps=1870, rng=np.random.default_rng(i))
                yield i, s

        # raycast synthesis (host work) overlaps the device step through the
        # same prefetch thread as the KITTI path
        scan_iter = prefetch_iter(gen(), depth=2)
        gt = gt.copy()
        gt[:, 2, 3] += 1.73
        gt = np.linalg.inv(gt[0])[None] @ gt

    box_file = open(args.dump_boxes, "w") if args.dump_boxes else None
    # the spans of every frame, collected after its pose read (which has
    # synced): host and device ms a span over the run
    totals = collections.Counter()
    timing.STAGES.enable()
    try:
        for i, (xyz, inten) in scan_iter:
            with timing.STAGES.stage("pack"):
                # packed int16 transfer (Cloud.pack_scan): 8 bytes a point
                q, nv = Cloud.pack_scan(xyz, inten, capacity=cap)
            state, pose, diag = frontend.odometry_step_packed(state, q, nv, cfg)
            poses.append(pose.cpu().numpy())
            totals.update(timing.STAGES.collect())
            if box_file is not None:
                # per-cluster AABBs in the SENSOR frame (the reference
                # publishes them per scan in the lidar frame,
                # segmentation.cpp:1032-1078)
                bv = diag.box_valid.cpu().numpy()
                bmin = diag.box_min.cpu().numpy()[bv].round(3).tolist()
                bmax = diag.box_max.cpu().numpy()[bv].round(3).tolist()
                box_file.write(json.dumps({"frame": i, "box_min": bmin, "box_max": bmax}) + "\n")
            if args.verbose:
                print(f"frame {i}: t={poses[-1][:3, 3].round(3)} iters={int(diag.iterations)} "
                      f"corr={diag.num_corr.cpu().numpy()}", file=sys.stderr)
            if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
                ckpt.save_state(args.checkpoint or "tloam_ckpt.npz", state, np.stack(poses), cfg=cfg)
    finally:
        timing.STAGES.enable(False)
        if box_file is not None:
            box_file.close()
    if box_file is not None:
        print(f"wrote cluster boxes to {args.dump_boxes}", file=sys.stderr)
    est = np.stack(poses)
    out = args.output or "tloam_traj.txt"
    trajectory.save_kitti(out, est)
    print(f"wrote {len(est)} poses to {out}", file=sys.stderr)
    print(timing.report(totals), file=sys.stderr)

    if gt is not None and len(gt) >= 2:
        t_err, r_err = trajectory.kitti_odometry_errors(gt[: len(est)], est)
        ate = trajectory.ate_rmse(gt[: len(est)], est)
        print(json.dumps({
            "frames": len(est),
            "kitti_t_err_pct": None if np.isnan(t_err) else round(t_err, 4),
            "kitti_r_err_deg_per_100m": None if np.isnan(r_err) else round(r_err, 4),
            "ate_rmse_m": round(ate, 4),
        }))
    return 0


def cmd_eval(args) -> int:
    from tloam_torch.utils import trajectory

    est = trajectory.load_kitti(args.est)
    gt = trajectory.load_kitti(args.gt)
    t_err, r_err = trajectory.kitti_odometry_errors(gt, est)
    rpe_t, rpe_r = trajectory.rpe(gt, est)
    print(json.dumps({
        "frames": int(min(len(gt), len(est))),
        "kitti_t_err_pct": round(t_err, 4),
        "kitti_r_err_deg_per_100m": round(r_err, 4),
        "ate_rmse_m": round(trajectory.ate_rmse(gt, est), 4),
        "rpe_trans_m": round(rpe_t, 4),
        "rpe_rot_deg": round(rpe_r, 4),
    }))
    return 0


def cmd_bench(args) -> int:
    from tloam_torch import bench

    bench.main(config=args.config, overrides=args.set or (), device=args.device)
    return 0


def cmd_info(args) -> int:
    import torch

    import tloam_torch

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else [],
        "version": tloam_torch.__version__,
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tloam-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_cfg_flags(sp):
        sp.add_argument("--config", help="YAML/JSON config file (nested keys mirror the dataclass tree)")
        sp.add_argument("--set", action="append", metavar="KEY=VALUE",
                        help="dotted-path override, e.g. odometry.tls.corr_mode=knn (repeatable)")
        sp.add_argument("--device", help="torch device, e.g. cpu (default: cuda; raises without a GPU)")

    r = sub.add_parser("run", help="run odometry over a sequence")
    r.add_argument("--data", help="KITTI odometry root (omit for synthetic)")
    r.add_argument("--sequence", default="00")
    r.add_argument("--frames", type=int)
    r.add_argument("--output", help="trajectory output path (KITTI format)")
    r.add_argument("--checkpoint")
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--resume")
    r.add_argument("--dump-boxes", help="write per-frame DCVC cluster AABBs (JSONL) to this path")
    r.add_argument("-v", "--verbose", action="store_true")
    add_cfg_flags(r)
    r.set_defaults(fn=cmd_run)

    e = sub.add_parser("eval", help="evaluate trajectory vs ground truth")
    e.add_argument("--est", required=True)
    e.add_argument("--gt", required=True)
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("bench", help="run the benchmark")
    add_cfg_flags(b)
    b.set_defaults(fn=cmd_bench)

    i = sub.add_parser("info", help="print torch, CUDA and device info")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
