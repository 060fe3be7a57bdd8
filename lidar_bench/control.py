"""Readings that set a cell's limits: the program's, and the control's.

    python3 lidar_bench/control.py --workload <cell> --seeds 1,2,3 --seconds <s> [--sides program,control]

For each seed, one run of the program (the port, as run.py drives it) and
one of the control: the plain reference that the cell's configuration
names, put in the program's place and computed a step below the
configuration's precision (TF32 matrix products and convolutions for
float32). Each prints one JSON line with the numbers
compared and whether they pass the cell's present limits. All runs share
one process, so set-up is paid once a side. The benchmark's own runs never
run the control.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sides", default="program,control")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ["TLOAM_TORCH_BUILD_DIR"] = str(ROOT / "build" / "tloam_torch")
    import torch

    from lidar_bench.harness import cell, programs, spec

    if not torch.cuda.is_available():
        print("lidar_bench: the control runs on a CUDA device", file=sys.stderr)
        return 2
    config = spec.config(spec.workload(spec.benchmark(), args.workload)["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in args.sides.split(","):
            t0 = time.perf_counter()
            prog = programs.reference(config) if side == "control" else None
            out = cell.run(args.workload, seed, args.seconds, False, "cuda", t0,
                           processes=min(8, os.cpu_count() or 1), program=prog, control=side == "control")
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side, "correct": out["correct"],
                              "attempted": out["attempted"], "failed": out["failed"], "check": out["check"],
                              "metrics": out["metrics"], "device": out["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
