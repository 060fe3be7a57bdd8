"""Solver-only throughput of tloam_torch on one GPU: GN iterations/s.

    python3 scripts/torch_solver_bench.py                       # 8 feature sets, 4 passes
    python3 scripts/torch_solver_bench.py --device cpu --frames 2 --reps 1

The counterpart of scripts/solver_bench.py (BASELINE config 2). It drives
the real pipeline (tloam_torch.pipeline.frontend, default PipelineConfig)
over Scene.urban(rng 3, extent 80) on a straight trajectory (1 m a frame,
yaw rate 0.005) at 64 x 1870, capacity 131072, and captures the solver's
inputs of --frames frames: the scan features, the submap features and the
prediction before each frame. Then it times
models.registration.scan_matching over --reps passes of them, the clock
read after torch.cuda.synchronize(), and reports:

  * solves/s (one solve = the whole GNC loop of at most max_iterations rounds)
  * the mean outer GNC rounds and inner_iterations (each round runs
    inner_iterations damped GN steps, registration.cpp:1036-1047)
  * GN iterations/s = solves/s x mean outer rounds x inner_iterations
  * the first call's seconds and the host syncs of one solve (CUDA only)

Writes build/GNITERS_r{round}.json unless --out names a file, and prints
one JSON line with the card (nvidia-smi's name and power limit).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

RINGS, AZ, CAP = 64, 1870, 131072


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", type=int, default=3)
    ap.add_argument("--frames", type=int, default=8, help="distinct feature sets")
    ap.add_argument("--reps", type=int, default=4, help="timed passes over them")
    ap.add_argument("--device", default=None, help="cuda unless named (cpu)")
    ap.add_argument("--out", default=None, help="default build/GNITERS_r{round}.json")
    return ap


def capture(frames: int, cfg, dev) -> list:
    """(scan features, submap features, prediction) of frames 1..frames,
    each taken from the pipeline's state before the frame."""
    from tloam_torch.cloud import Cloud
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils import synthetic

    scene = synthetic.Scene.urban(np.random.default_rng(3), extent=80.0)
    gt = synthetic.straight_trajectory(frames + 1, step=1.0, yaw_rate=0.005)
    state = frontend.init_state(cfg, dev)
    inputs = []
    for i in range(frames + 1):
        xyz, inten = synthetic.simulate_scan(gt[i], scene, rings=RINGS, az_steps=AZ,
                                             rng=np.random.default_rng(i), noise=0.01)
        raw = Cloud.from_numpy(xyz, inten, capacity=CAP, device=dev)
        if i >= 1:
            feats = frontend.preprocess_frame(raw, cfg)
            inputs.append((feats.scan, frontend.submap_features(state.submap, cfg), state.predict.clone()))
        state, _, _ = frontend.odometry_step(state, raw, cfg)
    return inputs


def main(argv=None) -> dict:
    args = parser().parse_args(argv)

    import torch

    import chip_smoke
    from tloam_torch import device
    from tloam_torch.config import PipelineConfig
    from tloam_torch.models.registration import scan_matching

    dev = device.resolve(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = PipelineConfig()
    tls = cfg.odometry.tls
    print("building solver inputs via the pipeline...", file=sys.stderr, flush=True)
    inputs = capture(args.frames, cfg, dev)

    sync()
    t = time.perf_counter()
    scan_matching(*inputs[0], tls)
    sync()
    first_s = time.perf_counter() - t
    syncs = None
    if dev.type == "cuda":
        _, syncs = chip_smoke.count_syncs(lambda: scan_matching(*inputs[0], tls))

    rounds = []
    sync()
    t = time.perf_counter()
    for _ in range(args.reps):
        for s, m, p in inputs:
            _, diag = scan_matching(s, m, p, tls)
            rounds.append(diag.iterations)
    sync()
    dt = time.perf_counter() - t

    n_solves = args.reps * len(inputs)
    solves_per_s = n_solves / dt
    mean_outer = float(torch.stack(rounds).double().mean())
    payload = {
        "metric": "gn_iterations_per_s",
        "value": solves_per_s * mean_outer * tls.inner_iterations,
        "unit": "GN iterations/s",
        "solves_per_s": solves_per_s,
        "mean_outer_iters": mean_outer,
        "outer_iters_per_solve": [int(r) for r in rounds[: len(inputs)]],
        "inner_iterations": tls.inner_iterations,
        "n_solves_timed": n_solves,
        "first_call_s": first_s,
        "host_syncs_per_solve": None if syncs is None else sum(syncs.values()),
        "sync_sites": syncs,
        "inputs": {"scene": "Scene.urban(rng 3, extent 80)", "frames": args.frames, "rings": RINGS, "az": AZ,
                   "capacity": CAP},
        **chip_smoke.device_fields(dev),
    }
    out = Path(args.out or REPO / "build" / f"GNITERS_r{args.round:02d}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps({k: v for k, v in payload.items() if k != "sync_sites"}), flush=True)
    return payload


if __name__ == "__main__":
    main()
