"""Synthetic-drive harness for accuracy runs (the long drive, sweeps).

Port of ``tloam_tpu/utils/drives.py``. One place defines what a "hard town
drive" is: Scene.town, a street-following route, moving cars, occlusion
dropouts and a per-ring azimuth stagger. The scans are the JAX package's
(the raycaster is an identical copy), and so is the cache layout, so both
packages can share one ``.scan_cache/``.
"""
from __future__ import annotations

import multiprocessing
import os
import time

import numpy as np

ROUTES = {
    "a": "town_trajectory",
    "b": "town_trajectory_b",
    "c": "town_trajectory_loop",
}


def _cache_dir(route, world_seed, cars_seed, occ_seed, rings, az, hard):
    """Per-frame raycast cache (``TLOAM_SCAN_CACHE``, else ``.scan_cache/``
    at the checkout's root). The scan of frame i depends only on the drive
    parameters and i (every trajectory, car and occlusion generator is
    prefix-stable in the frame count, and simulate_scan seeds its noise
    with the frame index), so one cache serves any frame-count prefix and
    any solver config. A 64 x 1870 hard-town raycast takes about 5 s of one
    CPU core; replaying it from the cache takes milliseconds."""
    base = os.environ.get(
        "TLOAM_SCAN_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".scan_cache"),
    )
    return os.path.join(base, f"{route}_w{world_seed}_c{cars_seed}_o{occ_seed}_r{rings}_a{az}_h{int(bool(hard))}")


def scan_stream(
    frames: int,
    route: str = "a",
    world_seed: int = 3,
    cars_seed: int = 11,
    occ_seed: int = 12,
    rings: int = 64,
    az: int = 1870,
    hard: bool = True,
    cache: bool = True,
    frame_offset: int = 0,
    frame_stride: int = 1,
):
    """Yield (i, xyz (N,3) f32, inten (N,) f32) for frames
    offset, offset+stride, ... < frames, raycasting on cache miss."""
    from tloam_torch.utils import synthetic

    cdir = _cache_dir(route, world_seed, cars_seed, occ_seed, rings, az, hard)
    if cache:
        os.makedirs(cdir, exist_ok=True)
    scene = None
    gt = getattr(synthetic, ROUTES[route])(frames, step=1.0)
    if hard:
        cars = synthetic.moving_cars(frames, np.random.default_rng(cars_seed), n_cars=8, extent=140.0)
        occ = synthetic.occlusion_schedule(frames, np.random.default_rng(occ_seed))
        stagger = 0.002
    else:
        cars, occ, stagger = [None] * frames, [None] * frames, 0.0
    for i in range(frame_offset, frames, frame_stride):
        path = os.path.join(cdir, f"f{i:05d}.npz")
        if cache and os.path.exists(path):
            with np.load(path) as z:
                yield i, z["xyz"], z["inten"]
            continue
        if scene is None:
            scene = synthetic.Scene.town(np.random.default_rng(world_seed), extent=140.0)
        xyz, inten = synthetic.simulate_scan(
            gt[i], scene, rings=rings, az_steps=az, rng=np.random.default_rng(i), noise=0.01,
            boxes=cars[i], dropout_sectors=occ[i], ring_stagger=stagger,
        )
        xyz = np.asarray(xyz, np.float32)
        inten = np.asarray(inten, np.float32)
        if cache:
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, xyz=xyz, inten=inten)
            os.replace(tmp, path)
        yield i, xyz, inten


def _fill_worker(frames: int, offset: int, stride: int, drive: dict) -> int:
    return sum(1 for _ in scan_stream(frames, cache=True, frame_offset=offset, frame_stride=stride, **drive))


def fill_scan_cache(frames: int, processes: int, **drive) -> float:
    """Raycast every frame < `frames` of a drive into the cache, spread
    over `processes` spawned processes (process k takes frames k, k + P,
    ...); `drive` takes scan_stream's drive parameters. Returns the wall
    seconds."""
    t = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes) as pool:
        jobs = [pool.apply_async(_fill_worker, (frames, k, processes, drive)) for k in range(processes)]
        done = sum(j.get() for j in jobs)
    if done != frames:
        raise RuntimeError(f"fill_scan_cache: {done} of {frames} frames")
    return time.perf_counter() - t


def drive_ground_truth(frames: int, route: str = "a") -> np.ndarray:
    """Sensor-frame GT poses relative to frame 0 (see hard_town_drive)."""
    from tloam_torch.utils import synthetic

    gt = getattr(synthetic, ROUTES[route])(frames, step=1.0)
    gt_sensor = gt.copy()
    gt_sensor[:, 2, 3] += 1.73
    return np.linalg.inv(gt_sensor[0])[None] @ gt_sensor


def hard_town_drive(
    cfg,
    frames: int = 120,
    route: str = "a",
    world_seed: int = 3,
    cars_seed: int = 11,
    occ_seed: int = 12,
    rings: int = 64,
    az: int = 1870,
    hard: bool = True,
    progress=None,
    collect_diags: bool = False,
    cache: bool = True,
    packed: bool = True,
    device=None,
):
    """Run the full odometry pipeline over a synthetic town drive on
    `device` (``cuda`` unless the caller names one).

    Returns (est (F,4,4), gt_rel (F,4,4) sensor-frame ground truth relative
    to frame 0, info dict with wall time / degenerate count / diags).
    `packed` selects the int16 packed transfer (the command line's path)
    over the f32 transfer; the scans themselves are identical."""
    from tloam_torch import device as _device
    from tloam_torch.cloud import Cloud, map_tensors
    from tloam_torch.pipeline import frontend

    dev = _device.resolve(device)
    cap = 1 << int(np.ceil(np.log2(rings * az)))
    state = frontend.init_state(cfg, dev)
    poses, diags = [], []
    degenerate = 0
    t0 = time.time()
    for i, xyz, inten in scan_stream(
        frames, route=route, world_seed=world_seed, cars_seed=cars_seed,
        occ_seed=occ_seed, rings=rings, az=az, hard=hard, cache=cache,
    ):
        if packed:
            q, n = Cloud.pack_scan(xyz, inten, capacity=cap)
            state, pose, diag = frontend.odometry_step_packed(state, q, n, cfg)
        else:
            raw = Cloud.from_numpy(xyz, inten, capacity=cap, device=dev)
            state, pose, diag = frontend.odometry_step(state, raw, cfg)
        poses.append(pose.cpu().numpy())
        degenerate += int(diag.degenerate)
        if collect_diags:
            diags.append(map_tensors(diag, lambda t: t.cpu().numpy()))
        if progress is not None and i % 20 == 0:
            progress(i, poses[-1], diag)
    wall = time.time() - t0
    return np.stack(poses), drive_ground_truth(frames, route), {
        "wall_s": wall, "degenerate_frames": degenerate, "diags": diags,
    }


def drive_metrics(est: np.ndarray, gt_rel: np.ndarray) -> dict:
    from tloam_torch.utils import trajectory

    t_err, r_err = trajectory.kitti_odometry_errors(gt_rel, est)
    ate = trajectory.ate_rmse(gt_rel, est)
    rpe_t, rpe_r = trajectory.rpe(gt_rel, est)
    drift = np.linalg.norm(est[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
    return {
        "kitti_t_err_pct": None if np.isnan(t_err) else round(float(t_err), 4),
        "kitti_r_err_deg_per_100m": None if np.isnan(r_err) else round(float(r_err), 4),
        "ate_rmse_m": round(float(ate), 4),
        "rpe_trans_m": round(float(rpe_t), 4),
        "rpe_rot_deg": round(float(rpe_r), 4),
        "final_drift_m": round(float(drift[-1]), 4),
        "max_drift_m": round(float(drift.max()), 4),
        "drift_curve_every10": [round(float(d), 3) for d in drift[::10]],
    }
