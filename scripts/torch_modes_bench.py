"""The mode matrix of tloam_torch on one GPU: every PipelineConfig mode on
the 60-frame hard-town drive, with accuracy against the ground truth.

    python3 scripts/torch_modes_bench.py                          # five modes, 60 frames
    python3 scripts/torch_modes_bench.py --rest-start-realizations 10
    python3 scripts/torch_modes_bench.py --device cpu --frames 3 --rings 24 --az 768 --modes default

The counterpart of scripts/modes_bench.py. The scans are the JAX script's:
Scene.town(rng 3, extent 140), town_trajectory(60, step 1.0),
moving_cars(rng 11, 8 cars), occlusion_schedule(rng 12), noise 0.01, ring
stagger 0.002, which are the first frames of tloam_torch.utils.drives'
route-a hard-town drive of world 3. They are raycast once, by --workers
processes into the drives' scan cache (drives.fill_scan_cache), and every
mode replays them packed through frontend.odometry_step_packed.

Each mode reports the JAX script's fields (frames/s after --warm frames,
warm-up seconds, KITTI t_err, ATE, final and max drift, the last frame's
correspondence counts and GNC rounds, the final-pose delta against the
default) and the host syncs of the last warm frame (CUDA only). default,
pca_exact, corr_knn and factor3 are held to chip_smoke.headroom_limits over
the ATE and max drift of MODES_r05.json (an accuracy record of the JAX
package); gicp is recorded and not held: it diverges on this drive's cold
start in the JAX package too.

--rest-start-realizations N also runs GICP on the 30-frame rest start of
chip_smoke.py's modes phase for noise realizations 0, 1000, ...,
(N - 1) * 1000 (scans raycast by --workers processes) and reports each
one's final and max drift and whether it survived (both under
chip_smoke.GICP_DRIFT_LIMIT_M).

Writes build/MODES_r{round}.json unless --out names a file, and prints one
JSON line with the card.
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

MODES = {
    "default": [],
    "pca_exact": ["feature.pca_mode=exact"],
    "corr_knn": ["odometry.tls.corr_mode=knn"],
    "gicp": ["odometry.tls.plane_residual=gicp"],
    # factor_num=3 drops the point-to-point (sphere) family
    # (registration.cpp:517-559)
    "factor3": ["odometry.tls.factor_num=3"],
}
HELD = ("default", "pca_exact", "corr_knn", "factor3")
DRIVE = {"route": "a", "world_seed": 3, "cars_seed": 11, "occ_seed": 12}
REST_FRAMES = 30


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", type=int, default=4)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--az", type=int, default=1870)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--out", default=None, help="default build/MODES_r{round}.json")
    ap.add_argument("--device", default=None, help="cuda unless named (cpu)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1, help="processes that raycast the scans")
    ap.add_argument("--rest-start-realizations", type=int, default=0, metavar="N",
                    help="also run GICP on N noise realizations of the rest start")
    return ap


def make_scans(frames: int, rings: int, az: int, workers: int) -> list:
    """[(xyz, intensity)] of the drive's first `frames` scans, raycast into
    the scan cache by `workers` processes and read back."""
    from tloam_torch.utils import drives

    drives.fill_scan_cache(frames, max(1, min(workers, frames)), rings=rings, az=az, **DRIVE)
    return [(xyz, inten) for _, xyz, inten in drives.scan_stream(frames, rings=rings, az=az, **DRIVE)]


def run_mode(overrides, scans, gt_rel, n_warm, extra=(), device=None) -> dict:
    """One mode over packed scans [(q, n)]: the JAX script's fields, plus
    the host syncs of the last warm frame on CUDA."""
    import torch

    import chip_smoke
    from tloam_torch import device as _device
    from tloam_torch.config import load_pipeline_config
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils import drives

    dev = _device.resolve(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = load_pipeline_config(None, list(overrides) + list(extra))
    state = frontend.init_state(cfg, dev)
    poses, syncs = [], None
    sync()
    t = time.perf_counter()
    for i in range(n_warm):
        step = functools.partial(frontend.odometry_step_packed, state, *scans[i], cfg)
        if i == n_warm - 1 and dev.type == "cuda":
            (state, pose, diag), syncs = chip_smoke.count_syncs(step)
        else:
            state, pose, diag = step()
        poses.append(pose)
    sync()
    warm_s = time.perf_counter() - t

    t = time.perf_counter()
    for i in range(n_warm, len(scans)):
        state, pose, diag = frontend.odometry_step_packed(state, *scans[i], cfg)
        poses.append(pose)
    sync()
    dt = time.perf_counter() - t
    n_timed = len(scans) - n_warm

    est = torch.stack(poses).cpu().double().numpy()
    m = drives.drive_metrics(est, gt_rel[: len(est)])
    return {
        "frames_per_s": n_timed / dt if n_timed else None,
        "warmup_s": warm_s,
        "final_pose_t": est[-1, :3, 3].round(4).tolist(),
        "corr_last": diag.num_corr.tolist(),
        "iters_last": int(diag.iterations),
        **{k: m[k] for k in ("kitti_t_err_pct", "ate_rmse_m", "final_drift_m", "max_drift_m")},
        "host_syncs_frame": None if syncs is None else {"frame": n_warm - 1, "total": sum(syncs.values()),
                                                        "sites": syncs},
    }


def record_limits(name: str) -> dict:
    """headroom_limits over MODES_r05.json's accuracy for mode `name`."""
    import chip_smoke

    rec = json.loads((REPO / "MODES_r05.json").read_text())["modes"][name]
    ref = {"ate_m": rec["ate_rmse_m"], "max_drift_m": rec["max_drift_m"]}
    return {"record": {**ref, "final_drift_m": rec["final_drift_m"]}, "limits": chip_smoke.headroom_limits(ref)}


def rest_start(n: int, workers: int, device=None) -> dict:
    """GICP on the 30-frame rest start of chip_smoke.py's modes phase, noise
    realizations 0, 1000, ..., (n - 1) * 1000; the scans of each
    realization are raycast by one of `workers` spawned processes."""
    import torch

    import chip_smoke
    from tloam_torch import device as _device
    from tloam_torch.config import load_pipeline_config
    from tloam_torch.pipeline import frontend

    dev = _device.resolve(device)
    seeds = [1000 * k for k in range(n)]
    t = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(max(1, min(workers, n))) as pool:
        drives_ = pool.map(functools.partial(chip_smoke.drive_scans, "rest_start", REST_FRAMES), seeds)
    raycast_s = time.perf_counter() - t
    cfg = load_pipeline_config(None, MODES["gicp"])
    runs = []
    for seed, (gt, scans) in zip(seeds, drives_):
        state = frontend.init_state(cfg, dev)
        poses = []
        for q, nv in scans:
            state, pose, _ = frontend.odometry_step_packed(state, q, nv, cfg)
            poses.append(pose)
        est = torch.stack(poses).cpu().double().numpy()
        ate, drift = chip_smoke.drive_errors(est, gt)
        final, worst = float(drift[-1]), float(drift.max())
        runs.append({"seed": seed, "ate_m": float(ate), "final_drift_m": final, "max_drift_m": worst,
                     "survived": bool(np.isfinite(est).all() and max(final, worst) < chip_smoke.GICP_DRIFT_LIMIT_M),
                     "drift_m": [round(float(x), 4) for x in drift]})
        print(f"rest start {seed}: {runs[-1]}", file=sys.stderr, flush=True)
    return {"frames": REST_FRAMES, "limit_m": chip_smoke.GICP_DRIFT_LIMIT_M, "raycast_s": raycast_s,
            "survived": sum(r["survived"] for r in runs), "realizations": runs}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)

    import torch

    import chip_smoke
    from tloam_torch import device
    from tloam_torch.cloud import Cloud
    from tloam_torch.utils import drives

    dev = device.resolve(args.device)
    print("synthesizing scans...", file=sys.stderr, flush=True)
    t = time.perf_counter()
    raw = make_scans(args.frames, args.rings, args.az, args.workers)
    raycast_s = time.perf_counter() - t
    cap = 1 << int(np.ceil(np.log2(args.rings * args.az)))
    scans = [Cloud.pack_scan(xyz, inten, capacity=cap) for xyz, inten in raw]
    gt_rel = drives.drive_ground_truth(args.frames, DRIVE["route"])

    results = {}
    default_t = None
    for name in args.modes.split(","):
        print(f"--- mode {name} ---", file=sys.stderr, flush=True)
        r = run_mode(MODES[name], scans, gt_rel, args.warm, args.set, dev)
        if name == "default":
            default_t = np.asarray(r["final_pose_t"])
        if default_t is not None:
            r["final_pose_delta_vs_default_m"] = float(np.linalg.norm(np.asarray(r["final_pose_t"]) - default_t))
        if name in HELD and not args.set and (args.rings, args.az, args.frames) == (64, 1870, 60):
            r.update(record_limits(name))
            r["ok"] = bool(np.isfinite(r["ate_rmse_m"]) and r["ate_rmse_m"] < r["limits"]["ate_m"]
                           and r["max_drift_m"] < r["limits"]["max_drift_m"])
        results[name] = r
        print(f"{name}: {r}", file=sys.stderr, flush=True)

    out = {
        "metric": "mode_matrix_long_drive",
        "frames": args.frames,
        "regimes": "hard town drive (route A): turns, stop, reverse, moving cars, occlusion dropouts, ring stagger",
        "rings": args.rings, "az": args.az, "warm": args.warm, "raycast_s": raycast_s,
        "raycast_workers": args.workers,
        **chip_smoke.device_fields(dev),
        "modes": results,
        "gicp_rest_start": (rest_start(args.rest_start_realizations, args.workers, dev)
                            if args.rest_start_realizations else None),
    }
    out["ok"] = all(r.get("ok", True) for r in results.values())
    path = Path(args.out or REPO / "build" / f"MODES_r{args.round:02d}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    rest = out["gicp_rest_start"]
    print(json.dumps({
        "modes": {k: {f: v.get(f) for f in ("frames_per_s", "ate_rmse_m", "final_drift_m", "max_drift_m", "ok")}
                  for k, v in results.items()},
        "gicp_rest_start_survived": None if rest is None else f"{rest['survived']}/{len(rest['realizations'])}",
        "ok": out["ok"], "nvidia_smi": out["nvidia_smi"], "out": str(path)}), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
