"""One run of one cell: set-up, the measured window (or the traced run),
then the check of every answer against the plain reference that the
cell's configuration names (harness/programs.reference)."""
from __future__ import annotations

import contextlib
import gc
import subprocess
import time

import torch

from lidar_bench.harness import check, programs, scans as scans_mod, spec
from lidar_bench.harness.batch import Batch
from lidar_bench.harness.stream import Stream


def driver(prog, config: dict, traffic: dict, scans, device, seed: int):
    cfg = programs.pipeline_config(prog, config)
    if traffic["kind"] == "stream":
        return Stream(prog, cfg, scans, config["sensor"], traffic, device)
    if traffic["kind"] == "batch":
        return Batch(prog, cfg, scans, config["sensor"], traffic, device, seed)
    raise ValueError(f"unknown traffic kind {traffic['kind']!r}")


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run(cell: str, seed: int, seconds: float, trace: bool, device, t0: float, processes: int = 8,
        program=None, control: bool = False, bench: dict | None = None, bench_dir=spec.BENCH_DIR) -> dict:
    """The result of one run. `t0` is the process's start on the host clock.
    With `program` (default: the port) and `control` (TF32 on the program's
    side) the control, `programs.reference(config)`, runs in the program's
    place. `bench` and `bench_dir` (BENCHMARK.json's content and the folder
    of configs, traffic, limits, metrics and the scan cache) default to the
    checkout's."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    bench = bench or spec.benchmark()
    wl = spec.workload(bench, cell)
    config, traffic = spec.config(wl["config"], bench_dir), spec.traffic(wl["traffic"], bench_dir)
    limits = spec.limits(cell, bench_dir)
    ref_prog = programs.reference(config)  # a piece that does not resolve fails here, before any window
    prog = program or programs.port(dev)
    # a traffic mix may fix its drive (and so its work) for every seed; the seed then only reorders
    # it, or draws its sensor noise
    drive_seed = int(traffic.get("drive_seed", seed))
    scans = scans_mod.drive_scans(traffic["drive"], config["sensor"], drive_seed, processes, bench_dir / ".scan_cache")
    if "seed_noise_m" in traffic:
        scans = scans_mod.seeded_noise(scans, float(traffic["seed_noise_m"]), seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    drv = driver(prog, config, traffic, scans, dev, seed)
    with programs.precision(True) if control else contextlib.nullcontext():
        drv.setup()
        setup_s = time.perf_counter() - t0
        if trace:
            rec, e2e = drv.traced(seconds, prog.stages), {}
        else:
            rec, e2e = None, drv.window(seconds)
    answers = drv.collect()
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    with programs.precision(False):
        ref = driver(ref_prog, config, traffic, scans, dev, seed).reference(answers)
    verdict = check.compare(answers, ref, limits)

    metrics = {}
    if trace:
        cfg = programs.pipeline_config(prog, config)
        rec["edge_shape"] = {"rings": cfg.sensor.sensor_model, "width": cfg.edge_ring_width,
                             "picks": prog.edge_picks}
        for m in spec.metrics_for(bench["per_layer"], cell):
            value = spec.reader(m["name"], bench_dir)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in spec.metrics_for(bench["end_to_end"], cell):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out = {
        "correct": verdict["correct"], "attempted": verdict["attempted"], "failed": verdict["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": int(wl["chips"]), "memory_peak_bytes": peak,
                   "power_limit": power_limit() if cuda else None},
    }
    if trace:
        prof = rec["profile"]
        out["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    else:
        out["window"] = {k: v for k, v in e2e.items() if k not in metrics}
    out["check"] = verdict["numbers"]
    return out
