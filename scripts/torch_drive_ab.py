"""A/B of the port's default drive between two checkouts, on one card.

    python3 scripts/torch_drive_ab.py <checkout_a> <checkout_b> [--pairs 2]

Runs phases 4 and 5 of each checkout's own chip_smoke.py (the 23-frame
bench drive, 64 x 1870, default PipelineConfig, through
frontend.odometry_step_packed; then the 60-frame canary) in a fresh
process per run, in the order a, b, b, a (repeated --pairs / 2 times), and
prints one JSON line per run: checkout, frames/s over frames 3-22, mean
frame and solve ms, ATE and max drift, the aten operations one more frame
issues (this tree's tloam_torch/utils/op_count.py, loaded by path so that
any checkout can be counted), the canary's ATE and final drift, then the
card. Two runs of one checkout show whether it repeats bit for bit. Use an unpacked `git archive` of the parent commit
as one checkout (under a directory .gitignore lists).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

OP_COUNT = Path(__file__).resolve().parents[1] / "tloam_torch" / "utils" / "op_count.py"

CHILD = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from tloam_torch import build
from tloam_torch.config import PipelineConfig
from tloam_torch.pipeline import frontend

spec = importlib.util.spec_from_file_location("op_count", sys.argv[2])
op_count = importlib.util.module_from_spec(spec)
spec.loader.exec_module(op_count)
build.build()
gt, scans = cs.drive_scans("bench", cs.N_FRAMES)
d = cs.run_drive(PipelineConfig(), scans)
ate, drift = cs.drive_errors(d["est"], gt)
_, ops = op_count.count_ops(lambda: frontend.odometry_step_packed(d["state"], *scans[-1], PipelineConfig()))
lines = []
cs.emit = lines.append  # the canary's own line
cs.canary(torch.device("cuda"))
print(json.dumps({"checkout": sys.argv[1], "frames_per_s": d["frames_per_s"], "frame_ms_mean": d["frame_ms_mean"],
                  "solve_ms_mean": d["stages"].get("solve"), "ate_m": ate, "max_drift_m": float(drift.max()),
                  "edge_pick_launches": d["launches"], "aten_ops_frame": sum(ops.values()),
                  "canary_ate_m": lines[-1]["ate_m"],
                  "canary_final_drift_m": lines[-1]["final_drift_m"], "canary_ok": lines[-1]["ok"]}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    order = [args.a, args.b, args.b, args.a] * max(1, args.pairs // 2)
    for tree in order:
        out = subprocess.run([sys.executable, "-c", CHILD, tree, str(OP_COUNT)], capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
