"""Reference numbers of the JAX package for the mode drives of chip_smoke.py.

    JAX_PLATFORMS=cpu python -m tests.jax_mode_refs corr_knn pca_exact reference gicp
    JAX_PLATFORMS=cpu python -m tests.jax_mode_refs --x64 gicp
    JAX_PLATFORMS=cpu python -m tests.jax_mode_refs --seeds 0 gicp
    JAX_PLATFORMS=cpu python -m tests.jax_mode_refs town
    JAX_PLATFORMS=cpu python -m tests.jax_mode_refs factor3

Runs each named mode through tloam_tpu.pipeline.frontend.odometry_step_packed
on the CPU in pure float32 (x64 off), on the same scans that chip_smoke.py
drives through the port, and prints one JSON line per mode and noise
realization: ATE, final and max drift against the ground truth, the
per-family correspondence minima and, with mapping_flag, the global-map
count after every frame. chip_smoke.py keeps these numbers as constants
(JAX_REF). A realization is the seed offset of the scans' noise (scan i
draws from default_rng(i + offset)); --seeds replaces the mode's own list.

"town" is the first TOWN_FRAMES frames of the route-c hard-town drive of
scripts/long_drive.py (world 3, cars 11, occlusions 12, packed transfer)
through tloam_tpu.utils.drives.hard_town_drive, which chip_smoke.py's
town phase holds the port to (JAX_TOWN_REF). Its raycasts go to the scan
cache (TLOAM_SCAN_CACHE), which the port's drives harness shares.

With --x64 the same program runs with jax_enable_x64 on: the data stay
float32, but Python constants and some intermediates become float64. It is
a second rounding of the same computation, and shows how far a mode's drive
moves under rounding alone.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

# mode -> (drive, dotted config overrides, noise realizations); the same
# table as chip_smoke.MODES
MODES = {
    "default": ("bench", [], (0,)),
    "corr_knn": ("bench", ["odometry.tls.corr_mode=knn"], (0,)),
    "pca_exact": ("bench", ["feature.pca_mode=exact"], (0,)),
    "gicp": ("rest_start", ["odometry.tls.plane_residual=gicp"], (1000, 2000, 3000)),
    "factor3": ("bench", ["odometry.tls.factor_num=3"], (0,)),
    "reference": ("bench", [
        "odometry.tls.mu_init=reference_zero", "sphere_submap_from_planar=true",
        "sphere_index_bug=true", "odometry.mapping_flag=true", "frame_planar_fill=1024",
    ], (0,)),
}


def drive_scans(drive: str, synthetic, seed: int = 0):
    """(ground truth (n,4,4), [(xyz, intensity)]) of chip_smoke.py's drives
    at 64 rings x 1870 azimuth steps: the 23-frame bench drive, or the
    30-frame rest start of tests/test_gicp_globalmap_io.py; scan i's noise
    draws from default_rng(i + seed)."""
    scene = synthetic.Scene.urban(np.random.default_rng(3), extent=80.0)
    if drive == "bench":
        gt = synthetic.straight_trajectory(23, step=1.0, yaw_rate=0.005)
    else:
        xs = np.concatenate([[0.0], np.cumsum(np.minimum(np.arange(30) * 0.12, 1.0))])
        gt = np.stack([np.eye(4)] * 30)
        gt[:, 0, 3] = xs[:30] - 46.0
    scans = [synthetic.simulate_scan(gt[i], scene, rings=64, az_steps=1870,
                                     rng=np.random.default_rng(i + seed), noise=0.01) for i in range(len(gt))]
    return gt, scans


TOWN_FRAMES = 30
TOWN_DRIVE = {"route": "c", "world_seed": 3, "cars_seed": 11, "occ_seed": 12}


def gt_rel(gt: np.ndarray) -> np.ndarray:
    """Sensor poses of the ground truth relative to its first frame."""
    gt_sensor = gt.copy()
    gt_sensor[:, 2, 3] += 1.73
    return np.linalg.inv(gt_sensor[0])[None] @ gt_sensor


def metrics(est: np.ndarray, gt: np.ndarray, ate_rmse) -> dict:
    rel = gt_rel(gt)
    drift = np.linalg.norm(est[:, :3, 3] - rel[:, :3, 3], axis=1)
    return {"ate_m": float(ate_rmse(rel, est)), "final_drift_m": float(drift[-1]),
            "max_drift_m": float(drift.max())}


def run(mode: str, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from tloam_tpu.cloud import Cloud
    from tloam_tpu.config import load_pipeline_config
    from tloam_tpu.pipeline import frontend
    from tloam_tpu.utils import synthetic, trajectory

    drive, overrides, _ = MODES[mode]
    cfg = load_pipeline_config(None, overrides)
    gt, scans = drive_scans(drive, synthetic, seed)
    state = frontend.init_state(cfg, jnp.float32)
    poses, corr, gmap = [], [], []
    t = time.perf_counter()
    for xyz, inten in scans:
        q, n = Cloud.pack_scan(xyz, inten, capacity=131072)
        state, pose, diag = frontend.odometry_step_packed(state, jnp.asarray(q), jnp.asarray(n, jnp.int32), cfg)
        poses.append(np.asarray(pose))
        corr.append(np.asarray(diag.num_corr))
        gmap.append(int(state.global_map.count()))
    out = {"mode": mode, "drive": drive, "seed": seed, "frames": len(scans), "overrides": overrides,
           "jax": jax.__version__, "x64": bool(jax.config.jax_enable_x64), "seconds": time.perf_counter() - t,
           **metrics(np.stack(poses), gt, trajectory.ate_rmse),
           "corr_min": np.stack(corr[1:]).min(axis=0).tolist(),
           "drift_m": np.linalg.norm(np.stack(poses)[:, :3, 3] - gt_rel(gt)[:, :3, 3], axis=1).tolist()}
    if cfg.odometry.mapping_flag:
        out["global_map_counts"] = gmap
    return out


def run_town() -> dict:
    import jax

    from tloam_tpu.config import load_pipeline_config
    from tloam_tpu.utils import drives, trajectory

    t = time.perf_counter()
    est, rel, info = drives.hard_town_drive(load_pipeline_config(None, ()), frames=TOWN_FRAMES, collect_diags=True,
                                            **TOWN_DRIVE)
    drift = np.linalg.norm(est[:, :3, 3] - rel[:, :3, 3], axis=1)
    return {"mode": "town", "frames": TOWN_FRAMES, **TOWN_DRIVE, "jax": jax.__version__,
            "x64": bool(jax.config.jax_enable_x64), "seconds": time.perf_counter() - t,
            "ate_m": float(trajectory.ate_rmse(rel, est)),
            "final_drift_m": float(drift[-1]), "max_drift_m": float(drift.max()),
            "degenerate_frames": info["degenerate_frames"],
            "corr_min": np.stack([d.num_corr for d in info["diags"][1:]]).min(axis=0).tolist(),
            "drift_m": drift.tolist()}


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--x64" in argv:
        argv = [a for a in argv if a != "--x64"]
        jax.config.update("jax_enable_x64", True)
    seeds = None
    if "--seeds" in argv:
        i = argv.index("--seeds")
        seeds = [int(v) for v in argv[i + 1].split(",")]
        argv = argv[:i] + argv[i + 2:]
    for mode in argv or list(MODES):
        if mode == "town":
            print(json.dumps(run_town()), flush=True)
            continue
        for seed in seeds or MODES[mode][2]:
            print(json.dumps(run(mode, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
