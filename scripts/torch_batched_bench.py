"""Batched registration throughput of tloam_torch on one GPU.

    python3 scripts/torch_batched_bench.py                    # B = 64, 128, 256; four modes at B = 64
    python3 scripts/torch_batched_bench.py --batch 128 --modes default,factor3

The counterpart of scripts/batched_bench.py (BASELINE config 3):
parallel.batched.vmap_scan_matching against the one-frame solver. The
inputs are frame 4's scan features of Scene.town(rng 3, extent 140) on
town_trajectory at 64 x 1870, capacity 131072 (the route-a scans of
tloam_torch.utils.drives without the hard add-ons, raycast by --workers
processes), and the submap features and prediction after frames 0-3.
Entry b of a batch is those features with its own N(0, 0.002 m) noise on
the planar points, drawn once for the largest batch from a torch.Generator
seeded 0 on the device, so every batch holds the same first entries. The
JAX script draws its noise from jax.random: the draws differ.

For each B of --batch: frames/s, wall ms, the speedup over the one-frame
loop (--n x 4 solves of the unperturbed entry), peak memory
(torch.cuda.max_memory_allocated) and, printed before the run, the bytes
the batch's inputs take by the feature capacities and the peak that the
previous B's peak scales to. An out-of-memory error ends the run. The
first MODE_BATCH entries of every batch are held to their own one-frame
solves: poses within 5e-3 m and 1e-3 rad (PERF.md section 2).

For each mode of --modes (the overrides of scripts/modes_bench.py) at
B = MODE_BATCH: frames/s batched and in the one-frame loop, and every
entry's pose gap to its own one-frame solve, held to the same limits.

Writes build/BATCHED_r{round}.json unless --out names a file, and prints
one JSON line with the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

RINGS, AZ, CAP = 64, 1870, 131072
MODE_BATCH = 64
NOISE_M, NOISE_SEED = 0.002, 0
SCANS = {"route": "a", "world_seed": 3, "hard": False}  # Scene.town(rng 3), town_trajectory, no cars


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", type=int, default=5)
    ap.add_argument("--batch", default="64,128,256", help="comma list of batch sizes")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--modes", default="default,corr_knn,gicp,factor3",
                    help="modes of scripts/torch_modes_bench.py solved at B = MODE_BATCH")
    ap.add_argument("--device", default=None, help="cuda unless named (cpu)")
    ap.add_argument("--out", default=None, help="default build/BATCHED_r{round}.json")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1, help="processes that raycast the scans")
    return ap


def capture(cfg, dev, workers: int):
    """(scan features of frame 4, submap features and prediction after
    frames 0-3)."""
    from tloam_torch.cloud import Cloud
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils import drives

    drives.fill_scan_cache(5, max(1, min(workers, 5)), rings=RINGS, az=AZ, **SCANS)
    state = frontend.init_state(cfg, dev)
    for i, xyz, inten in drives.scan_stream(5, rings=RINGS, az=AZ, **SCANS):
        raw = Cloud.from_numpy(xyz, inten, capacity=CAP, device=dev)
        if i == 4:
            feats = frontend.preprocess_frame(raw, cfg)
        else:
            state, _, _ = frontend.odometry_step(state, raw, cfg)
    return feats.scan, frontend.submap_features(state.submap, cfg), state.predict.clone()


def tree_bytes(tree) -> int:
    from tloam_torch.cloud import map_tensors

    total = []
    map_tensors(tree, lambda t: total.append(t.numel() * t.element_size()))
    return sum(total)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)

    import torch

    import chip_smoke
    from tloam_torch import device
    from tloam_torch.cloud import Cloud, map_tensors
    from tloam_torch.config import load_pipeline_config
    from tloam_torch.models.registration import scan_matching
    from tloam_torch.parallel import batched

    dev = device.resolve(args.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    modes_table = chip_smoke.load_by_path(REPO / "scripts" / "torch_modes_bench.py").MODES
    cfg = load_pipeline_config(None, [])
    tls = cfg.odometry.tls
    scan, submap, predict = capture(cfg, dev, args.workers)
    entry_bytes = tree_bytes((scan, submap, predict))

    sizes = [int(b) for b in args.batch.split(",") if b]
    modes = [m for m in args.modes.split(",") if m]
    bmax = max(sizes + [MODE_BATCH] * bool(modes))
    gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    noise = torch.randn((bmax,) + scan.planar.xyz.shape, generator=gen, device=dev, dtype=scan.planar.xyz.dtype)

    def batch(B: int):
        tile = lambda x: x.expand((B,) + x.shape).clone()  # noqa: E731
        s = map_tensors(scan, tile)
        s = s._replace(planar=Cloud(s.planar.xyz + noise[:B] * NOISE_M, s.planar.intensity, s.planar.valid))
        return s, map_tensors(submap, tile), tile(predict)

    def entry(b_tree, b: int):
        return map_tensors(b_tree, lambda x: x[b])

    def timed_batched(b_tree, mode_tls):
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else None
        t = time.perf_counter()
        out = batched.vmap_scan_matching(*b_tree, mode_tls)
        sync()
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(args.n):
            out = batched.vmap_scan_matching(*b_tree, mode_tls)
        sync()
        return out, first_s, (time.perf_counter() - t) / args.n, base

    def singles(b_tree, k: int, mode_tls):
        """One-frame solves of entries 0..k-1: (poses (k,4,4), seconds)."""
        sync()
        t = time.perf_counter()
        poses = torch.stack([scan_matching(*entry(b_tree, b), mode_tls)[0] for b in range(k)])
        sync()
        return poses, time.perf_counter() - t

    def held(poses_b, poses_1) -> dict:
        gap_m, gap_rad = chip_smoke.pose_gaps(poses_b, poses_1)
        return {"entries": int(poses_1.shape[0]), "gap_m": gap_m, "gap_rad": gap_rad,
                "ok": gap_m < chip_smoke.POSE_TOL_M and gap_rad < chip_smoke.POSE_TOL_RAD}

    # the one-frame loop on the unperturbed entry (the JAX script's baseline)
    scan_matching(scan, submap, predict, tls)
    sync()
    t = time.perf_counter()
    for _ in range(args.n * 4):
        scan_matching(scan, submap, predict, tls)
    sync()
    single_s = (time.perf_counter() - t) / (args.n * 4)

    ref = {}  # mode -> one-frame poses of the first MODE_BATCH entries
    k = min(MODE_BATCH, bmax)
    ref["default"], default_singles_s = singles(batch(k), k, tls)

    per_b, prev = {}, None
    for B in sizes:
        est = {"inputs_gb": B * entry_bytes / 1e9,
               "solve_peak_gb_scaled": None if prev is None else prev[1] * B / prev[0]}
        print(f"B={B}: inputs {est['inputs_gb']:.3f} GB by the feature capacities; solve peak scaled from "
              f"the previous B {est['solve_peak_gb_scaled']}", file=sys.stderr, flush=True)
        b_tree = batch(B)
        (poses, _), first_s, batched_s, base = timed_batched(b_tree, tls)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        solve_peak = peak - base / 1e9 if cuda else None
        per_b[B] = {
            "batched_frames_per_s": B / batched_s, "batched_wall_ms": 1e3 * batched_s,
            "speedup_vs_single": (B / batched_s) * single_s, "first_call_s": first_s,
            "max_memory_allocated_gb": peak, "solve_peak_gb": solve_peak, "estimate": est,
            "held_to_single": held(poses[:k], ref["default"][:B]),
        }
        prev = (B, solve_peak) if cuda else None
        del b_tree, poses
        print(f"B={B}: {per_b[B]}", file=sys.stderr, flush=True)

    per_mode = {}
    b_tree = batch(MODE_BATCH) if modes else None
    for name in modes:
        mode_tls = load_pipeline_config(None, modes_table[name]).odometry.tls
        (poses, _), first_s, batched_s, _ = timed_batched(b_tree, mode_tls)
        if name not in ref:
            ref[name], s_s = singles(b_tree, MODE_BATCH, mode_tls)
        else:
            s_s = default_singles_s
        per_mode[name] = {"overrides": modes_table[name], "batch": MODE_BATCH,
                          "batched_frames_per_s": MODE_BATCH / batched_s, "batched_wall_ms": 1e3 * batched_s,
                          "first_call_s": first_s, "single_loop_frames_per_s": MODE_BATCH / s_s,
                          "held_to_single": held(poses, ref[name])}
        print(f"{name}: {per_mode[name]}", file=sys.stderr, flush=True)

    payload = {
        "metric": "batched_registration_frames_per_s_one_chip",
        "single_frames_per_s": 1.0 / single_s, "single_wall_ms": 1e3 * single_s,
        "batches": per_b, "modes": per_mode,
        "entry_bytes": entry_bytes, "tolerance": {"m": chip_smoke.POSE_TOL_M, "rad": chip_smoke.POSE_TOL_RAD},
        "inputs": {"scene": "Scene.town(rng 3, extent 140), frame 4", "rings": RINGS, "az": AZ, "capacity": CAP,
                   "noise_m": NOISE_M, "noise": "torch.Generator seeded 0 on the device (the JAX script: "
                                                  "jax.random, other draws)"},
        **chip_smoke.device_fields(dev),
    }
    payload["ok"] = all(r["held_to_single"]["ok"] for r in (*per_b.values(), *per_mode.values()))
    out = Path(args.out or REPO / "build" / f"BATCHED_r{args.round:02d}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps({
        "batches": {B: {k: r[k] for k in ("batched_frames_per_s", "speedup_vs_single", "max_memory_allocated_gb")}
                    for B, r in per_b.items()},
        "modes": {m: {"batched_frames_per_s": r["batched_frames_per_s"], "gap_m": r["held_to_single"]["gap_m"],
                      "gap_rad": r["held_to_single"]["gap_rad"]} for m, r in per_mode.items()},
        "single_frames_per_s": payload["single_frames_per_s"], "ok": payload["ok"],
        "nvidia_smi": payload["nvidia_smi"], "out": str(out)}), flush=True)
    return payload


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
