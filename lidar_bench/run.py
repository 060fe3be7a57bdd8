"""Run one cell of the benchmark once, on the card.

    python3 lidar_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are read from BENCHMARK.json and the files under
lidar_bench/ that they name. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 also
breakdown, and last the numbers compared with their limits); the numbers
compared are also the last lines of standard error. The run exits with 2
and prints no result when no card (or fewer than the cell asks for) is
present, and with 3 when a module of JAX or of the JAX package was
loaded.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "tloam_tpu"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    os.environ["TLOAM_TORCH_BUILD_DIR"] = str(ROOT / "build" / "tloam_torch")  # the kernels stay in the checkout
    import torch

    from lidar_bench.harness import cell, spec

    bench = spec.benchmark()
    chips = int(spec.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lidar_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0,
                   processes=min(8, os.cpu_count() or 1), bench=bench)
    found = forbidden_modules()
    if found:
        print(f"lidar_bench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, n in out["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
