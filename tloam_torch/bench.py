"""Benchmark: full odometry pipeline throughput on one GPU.

    python -m tloam_torch.bench            # or: tloam-torch bench

The port's counterpart of the JAX package's bench.py, on the same workload:
scans from the raycaster (tloam_torch.utils.synthetic) at HDL-64E density,
64 rings x 1870 azimuth steps against Scene.urban(rng 3, extent 80) along a
straight drive, capacity 131072, the default PipelineConfig. 3 warm-up
frames, then 48 timed frames in which the packed int16 upload of frame i+1
(pinned memory, its own CUDA stream, on a helper thread) overlaps step i.
Timing covers the upload and the whole per-frame pipeline, not the scan
synthesis (which stands in for the sensor).

Prints ONE JSON line, "metric": "synthetic_kitti_odometry_frames_per_s",
with vs_baseline = frames/s / 10 (the sensor's 10 Hz), the compute-only
rate (one device-resident scan stepped again), the kernels' first-use build
time, the frame-sized host-to-device upload rate, and the per-family
correspondence liveness over the timed frames.
"""
from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_WARM, N_TIMED = 3, 48
RINGS, AZ, CAP = 64, 1870, 131072


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(config: str | None = None, overrides=(), device=None) -> dict:
    import torch

    from tloam_torch import build
    from tloam_torch import device as _device
    from tloam_torch.cloud import Cloud
    from tloam_torch.config import load_pipeline_config
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils import synthetic

    dev = _device.resolve(device)
    cfg = load_pipeline_config(config, overrides)
    t = time.perf_counter()
    built = list(build.build(build.KERNELS)) if dev.type == "cuda" else []
    build_s = time.perf_counter() - t

    scene = synthetic.Scene.urban(np.random.default_rng(3), extent=80.0)
    gt = synthetic.straight_trajectory(N_WARM + N_TIMED, step=1.0, yaw_rate=0.005)
    print("synthesizing scans...", file=sys.stderr)
    scans = [synthetic.simulate_scan(gt[i], scene, rings=RINGS, az_steps=AZ, rng=np.random.default_rng(i), noise=0.01)
             for i in range(N_WARM + N_TIMED)]

    # the frame-sized upload (pageable int16 (131072, 4), 1.05 MB), as the
    # step itself uploads: its rate says whether a run was transfer-capped
    probe = np.zeros((CAP, 4), np.int16)
    torch.from_numpy(probe).to(dev)
    _sync(dev)
    t = time.perf_counter()
    for _ in range(6):
        torch.from_numpy(probe).to(dev)
    _sync(dev)
    upload_mbps = 6 * probe.nbytes / 1e6 / (time.perf_counter() - t)

    state = frontend.init_state(cfg, dev)
    t = time.perf_counter()
    for i in range(N_WARM):
        q, n = Cloud.pack_scan(*scans[i], capacity=CAP)
        state, pose, _ = frontend.odometry_step_packed(state, q, n, cfg)
    pose.cpu()
    warmup_s = time.perf_counter() - t

    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def upload(i):
        q, n = Cloud.pack_scan(*scans[i], capacity=CAP)
        if copy_stream is None:
            return torch.from_numpy(q), n, None
        with torch.cuda.stream(copy_stream):
            g = torch.from_numpy(q).pin_memory().to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        return g, n, ev

    corr_seen = []
    with ThreadPoolExecutor(1) as ex:
        t = time.perf_counter()
        fut = ex.submit(upload, N_WARM)
        for i in range(N_WARM, N_WARM + N_TIMED):
            q, n, ev = fut.result()
            if i + 1 < N_WARM + N_TIMED:
                fut = ex.submit(upload, i + 1)
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)
                q.record_stream(torch.cuda.current_stream(dev))
            state, pose, diag = frontend.odometry_step_packed(state, q, n, cfg)
            corr_seen.append(diag.num_corr)
        pose.cpu()
        dt = time.perf_counter() - t
    fps = N_TIMED / dt

    # compute only: one device-resident scan stepped again (zero relative
    # motion, the healthy tracking path), no host-to-device transfer
    q, n = Cloud.pack_scan(*scans[N_WARM], capacity=CAP)
    q = torch.from_numpy(q).to(dev)
    _sync(dev)
    t = time.perf_counter()
    for _ in range(N_TIMED):
        state, pose, diag = frontend.odometry_step_packed(state, q, n, cfg)
    pose.cpu()
    compute_fps = N_TIMED / (time.perf_counter() - t)

    corr = torch.stack(corr_seen).cpu().numpy()  # (N_TIMED, 4)
    print(f"timed {N_TIMED} frames in {dt:.3f}s ({fps:.2f} frames/s); compute-only {compute_fps:.2f} frames/s; "
          f"per-family corr min/mean {corr.min(0)} / {corr.mean(0).round(1)}", file=sys.stderr)
    out = {
        "metric": "synthetic_kitti_odometry_frames_per_s",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 10.0, 3),
        "compute_only_frames_per_s": round(compute_fps, 3),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        # first use of the kernels in this checkout: the nvcc build (0 when
        # build/tloam_torch/ already holds them) and the 3 warm-up frames
        "kernel_build_s": round(build_s, 2),
        "kernels_built": built,
        "warmup_s": round(warmup_s, 2),
        "upload_MBps": round(upload_mbps, 1),
        "corr_mean": [round(v, 1) for v in corr.mean(0).tolist()],
        "corr_min": corr.min(0).tolist(),
        # every residual family must stay populated on every timed frame
        # (planar, ground, edge, sphere)
        "corr_all_alive": bool(corr.min() > 0),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import argparse

    _p = argparse.ArgumentParser()
    _p.add_argument("--config")
    _p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    _p.add_argument("--device")
    _a = _p.parse_args()
    main(_a.config, _a.set, _a.device)
