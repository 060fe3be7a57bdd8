"""The accuracy sweep of tloam_torch on one GPU: world seeds x routes of the
hard town drive, 120 frames each.

    python3 scripts/torch_sweep.py                                  # routes a,b x 5 worlds
    python3 scripts/torch_sweep.py --routes a --out build/SWEEP_a.json
    python3 scripts/torch_sweep.py --routes b --out build/SWEEP_b.json
    python3 scripts/torch_sweep.py --merge build/SWEEP_a.json,build/SWEEP_b.json

The counterpart of scripts/sweep.py, with scripts/gen_scans.py's work done
by tloam_torch.utils.drives.fill_scan_cache. Run s of a route drives world
3 + 101 s with cars 11 + 101 s and occlusions 12 + 101 s through
drives.hard_town_drive (packed transfer, the default PipelineConfig with
--set overrides) after --workers processes fill its raycast cache. The
file is written after every run, so a cut call leaves a valid one; its
fields and rounding are sweep.py's, and each run adds the raycast seconds,
the drive's frames/s, the card, and its gap to the JAX package's run of the
same route and world in SWEEP_r05.json (an accuracy record). --merge joins
part files, in the order given, into the payload one call would write.

Limits, twice the JAX sweep (SWEEP_r05.json: mean t_err 1.235 %, mean ATE
0.37 m, worst run 4.795 %): mean t_err < 2.47 %, mean ATE < 0.74 m, no
run's t_err above 9.59 %, no degenerate frame in any run. The summary line
holds them; the exit code is 1 when one fails.

Writes build/SWEEP_r{round}.json unless --out names a file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

LIMITS = {"t_err_pct_mean": 2.47, "ate_mean": 0.74, "t_err_pct_max": 9.59, "degenerate_frames": 0}
RECORD = REPO / "SWEEP_r05.json"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", type=int, default=4)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--routes", default="a,b")
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--az", type=int, default=1870)
    ap.add_argument("--out", default=None, help="default build/SWEEP_r{round}.json")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--device", default=None, help="cuda unless named (cpu)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1, help="processes that raycast each run")
    ap.add_argument("--merge", default=None, metavar="A.json,B.json", help="join part files instead of running")
    return ap


def run_list(routes: str, seeds: int) -> list:
    """[(route, seed, world, cars, occlusions)] in sweep.py's order; seed 0
    on route a is the long drive's world (3/11/12)."""
    return [(route, s, 3 + 101 * s, 11 + 101 * s, 12 + 101 * s) for route in routes.split(",") for s in range(seeds)]


def _write(args, runs):
    t_errs = [r["kitti_t_err_pct"] for r in runs if r["kitti_t_err_pct"] is not None]
    ates = [r["ate_rmse_m"] for r in runs]
    payload = {
        "metric": "hard_drive_generalization_sweep",
        "frames": args.frames,
        "config_overrides": args.set,
        "n_runs": len(runs),
        "t_err_pct_mean": round(float(np.mean(t_errs)), 3) if t_errs else None,
        "t_err_pct_max": round(float(np.max(t_errs)), 3) if t_errs else None,
        "t_err_pct_per_run": t_errs,
        "ate_mean": round(float(np.mean(ates)), 3),
        "ate_max": round(float(np.max(ates)), 3),
        "runs": runs,
    }
    out = Path(args.out or REPO / "build" / f"SWEEP_r{args.round:02d}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    return payload


def record_gap(route: str, world: int, m: dict) -> dict:
    """This run against SWEEP_r05.json's run of the same route and world."""
    ref = next((r for r in json.loads(RECORD.read_text())["runs"]
                if r["route"] == route and r["world_seed"] == world), None)
    if ref is None:
        return {"record_r05": None}
    t_gap = None if m["kitti_t_err_pct"] is None or ref["kitti_t_err_pct"] is None else \
        m["kitti_t_err_pct"] - ref["kitti_t_err_pct"]
    return {"record_r05": {"kitti_t_err_pct": ref["kitti_t_err_pct"], "ate_rmse_m": ref["ate_rmse_m"]},
            "t_err_gap_pct": t_gap, "ate_gap_m": m["ate_rmse_m"] - ref["ate_rmse_m"]}


def check(payload: dict) -> dict:
    """The sweep's limits against a payload: {name: (value, limit)}, ok."""
    runs = payload["runs"]
    got = {"t_err_pct_mean": payload["t_err_pct_mean"], "ate_mean": payload["ate_mean"],
           "t_err_pct_max": payload["t_err_pct_max"],
           "degenerate_frames": max((r["degenerate_frames"] for r in runs), default=0)}
    ok = all(v is not None and (v <= LIMITS[k] if k == "degenerate_frames" else v < LIMITS[k]) for k, v in got.items())
    return {"values": got, "limits": LIMITS, "ok": bool(ok and runs)}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.merge:
        parts = [json.loads(Path(p).read_text()) for p in args.merge.split(",")]
        if len({(p["frames"], json.dumps(p["config_overrides"])) for p in parts}) != 1:
            raise ValueError("torch_sweep --merge: the parts ran other frame counts or overrides")
        args.frames, args.set = parts[0]["frames"], parts[0]["config_overrides"]
        payload = _write(args, [r for p in parts for r in p["runs"]])
        card = sorted({r.get("nvidia_smi") for r in payload["runs"]} - {None})
    else:
        payload, card = sweep(args)
    summary = {k: payload[k] for k in ("n_runs", "t_err_pct_mean", "t_err_pct_max", "ate_mean", "ate_max")}
    print(json.dumps({**summary, **check(payload), "nvidia_smi": card}), flush=True)
    return payload


def sweep(args):
    import torch

    import chip_smoke
    from tloam_torch import device
    from tloam_torch.config import load_pipeline_config
    from tloam_torch.utils import drives

    dev = device.resolve(args.device)
    card = chip_smoke.nvidia_smi() if dev.type == "cuda" else None
    cfg = load_pipeline_config(None, args.set)
    runs = []
    for route, s, world, cars, occ in run_list(args.routes, args.seeds):
        drive = dict(route=route, world_seed=world, cars_seed=cars, occ_seed=occ)
        workers = max(1, min(args.workers, args.frames))
        raycast_s = drives.fill_scan_cache(args.frames, workers, rings=args.rings, az=args.az, **drive)
        est, gt_rel, info = drives.hard_town_drive(
            cfg, frames=args.frames, rings=args.rings, az=args.az, device=dev,
            progress=lambda i, p, d: print(f"  [{route}/s{s}] f{i}", file=sys.stderr, flush=True), **drive,
        )
        m = drives.drive_metrics(est, gt_rel)
        m.update(route=route, seed=s, world_seed=world, degenerate_frames=info["degenerate_frames"],
                 wall_s=round(info["wall_s"], 1))
        m.update(raycast_s=raycast_s, raycast_workers=workers, drive_frames_per_s=args.frames / info["wall_s"],
                 finite=bool(np.isfinite(est).all()), nvidia_smi=card, torch=torch.__version__,
                 **record_gap(route, world, m))
        runs.append(m)
        print(f"route {route} seed {s}: t_err={m['kitti_t_err_pct']}% r_err={m['kitti_r_err_deg_per_100m']} "
              f"ate={m['ate_rmse_m']} raycast {raycast_s:.1f} s", file=sys.stderr, flush=True)
        _write(args, runs)  # a cut sweep still leaves a valid file
    return _write(args, runs), card


if __name__ == "__main__":
    sys.exit(0 if check(main())["ok"] else 1)
