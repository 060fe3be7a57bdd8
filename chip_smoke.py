#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tloam_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

  1. device        require CUDA; print the card's name and power limit
  2. build         compile every kernel from tloam_torch/csrc with nvcc; ptxas
                   registers and static shared memory
  3. kernel_check  each kernel against its plain PyTorch version on the
                   card, bit for bit: seeded random rings (short rings, rings
                   longer than W, exact ties, spikes), the sweep of
                   tests/test_torch_cuda.py (4 sector settings x 3 widths,
                   picks at sector boundaries) and the real dense planes of
                   a full-size synthetic frame; dynamic shared memory per
                   width; times both (CUDA events over 200 wrapper calls,
                   and torch.profiler with device kernels per call)
  4. drive         the full-size 23-frame synthetic drive (64 rings x 1870
                   azimuth steps, capacity 131072, default PipelineConfig)
                   through tloam_torch.pipeline.frontend.odometry_step_packed,
                   with kernel launch counts, frames/s over frames 3-22,
                   per-stage CUDA-event times, ATE and drift against the
                   ground truth, and the per-family correspondence minima;
                   frame 1 counts its host syncs (CUDA sync-debug warnings
                   by source line), frame 2 is traced with torch.profiler
                   (device busy share, top kernels)
  5. canary        the JAX package's 60-frame varied-drive canary (32 x 1024
                   scans, tests/test_long_horizon.py) at its budgets: ATE
                   < 1.0 m, final drift < 2.5 m, max drift < 2.6 m
  6. kernels       one line per kernel: launches in the drive, kernel and
                   plain-version times, bound, agreement

The last two lines are the card (`nvidia-smi --query-gpu=name,power.limit`)
and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# drive limits: the JAX package measured ATE 0.0144 m, max drift 0.034 m on
# this drive (pure-f32 CPU run)
ATE_LIMIT_M = 0.05
DRIFT_LIMIT_M = 0.10
N_FRAMES = 23
TIMED_FROM = 3
SYNC_FRAME = 1  # an untimed frame whose host syncs are counted
PROFILE_FRAME = 2  # an untimed frame traced with torch.profiler

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_by_path(path: Path):
    """Import a file of the checkout as a module (a site package named
    `tests` may shadow the checkout's tests/ directory)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def count_syncs(fn):
    """Run fn with CUDA sync warnings on: (result, {python file:line: syncs})."""
    import collections
    import warnings

    import torch

    sites = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            sites[f"{w.filename.split('tloam_torch/')[-1]}:{w.lineno}"] += 1
    return out, dict(sites.most_common())


def profiled_kernel_ms(fn, reps: int, name: str):
    """(device ms per launch of the kernel `name`, device kernels per call
    of fn) from torch.profiler; the time is None where the profiler records
    no device time for it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_call = sum(ev.device_type == DeviceType.CUDA for ev in prof.events()) / reps
    for ev in prof.key_averages():
        if name in ev.key and ev.count:
            t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            return (t / 1e3 / ev.count if t else None), per_call
    return None, per_call


def profile_frame(fn):
    """Trace fn once: (result, device busy ms, wall ms, top device kernels
    by total ms). Busy is the sum of device kernel and copy times."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    by_name = collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name[:60]] += ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = {k: round(v, 3) for k, v in by_name.most_common(8)}
    return out, busy_ms, wall_ms, top


def random_rings(rng: np.random.Generator, R: int, W: int, ring_min_num: int):
    """Dense ring planes with every case the pick kernel must get right."""
    xs = np.zeros((R, W), np.float32)
    ys = np.zeros((R, W), np.float32)
    zs = np.zeros((R, W), np.float32)
    val = np.zeros((R, W), np.float32)
    lens = np.zeros(R, np.int32)
    for r in range(R):
        kind = r % 4
        if kind == 0:
            n = int(rng.integers(20, ring_min_num))  # too short: no candidates
        elif kind == 1:
            n = int(rng.integers(W - 3, W + 200))  # longer than W: cyclic taps
        else:
            n = int(rng.integers(ring_min_num, W))
        m = min(n, W)
        az = np.linspace(0, 2 * np.pi, m, endpoint=False)
        if kind == 3:
            # dyadic straight segment with identical spikes: exact ties
            x = (np.arange(m) * 0.25).astype(np.float32)
            y = np.full(m, 4.0, np.float32)
            z = np.zeros(m, np.float32)
            spikes = rng.choice(np.arange(20, m - 20), size=min(24, max(m // 40, 1)), replace=False)
            x[spikes] += 1.0
            y[spikes[: len(spikes) // 2]] += 2.0
        else:
            rad = 6.0 + r * 0.3 + rng.normal(size=m) * 0.02
            k = rng.choice(m, size=min(30, m), replace=False)
            rad[k] -= rng.uniform(0.3, 2.5, size=k.size)
            x, y = rad * np.cos(az), rad * np.sin(az)
            z = np.full(m, -1.5 + 0.05 * r) + rng.normal(size=m) * 0.01
        xs[r, :m], ys[r, :m], zs[r, :m], val[r, :m] = x, y, z, 1.0
        lens[r] = n
    return xs, ys, zs, val, lens


def edge_bound_ms(R: int, W: int, picks: int) -> float:
    # each input read once (x, y, z, valid f32 + ring lengths int32), each
    # output written once (edge, picked u8 + curvature f32)
    nbytes = R * W * 16 + R * 4 + R * W * 6
    # geometry ~50 f32 ops an element (33 tap adds, 3+5 curvature, 8 gap,
    # 1 compare); each round ~3 compares an element
    ops = R * W * (50 + 3 * picks)
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS) * 1e3, (
        "bytes" if nbytes / PEAK_BYTES_S >= ops / PEAK_F32_FLOPS else "operations"
    )


def canary(dev) -> bool:
    """The JAX package's 60-frame canary (tests/test_long_horizon.py:41-76):
    a varied drive (turns, stop-and-go, reverse) of 32 x 1024 scans under
    the default solver with the reduced capacities of tests/test_pipeline.py,
    held to the same budgets."""
    from tloam_torch.cloud import Cloud
    from tloam_torch.config import OdometryConfig, PipelineConfig, TLSConfig
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils import synthetic, trajectory

    cfg = PipelineConfig(
        odometry=OdometryConfig(
            scan_edge_cap=2048, scan_sphere_cap=256, scan_planar_cap=1024, scan_ground_cap=4096,
            submap_edge_cap=8192, submap_ground_cap=8192, tls=TLSConfig(max_per_cell=8),
        ),
        max_voxels=16384, max_clusters=64, frame_planar_cap=2048, frame_sphere_cap=512,
    )
    n = 60
    scene = synthetic.Scene.urban(np.random.default_rng(7), extent=50.0)
    gt = synthetic.varied_trajectory(n, step=0.8)
    state = frontend.init_state(cfg, dev)
    poses = []
    t = time.perf_counter()
    for i in range(n):
        xyz, inten = synthetic.simulate_scan(gt[i], scene, rings=32, az_steps=1024,
                                             rng=np.random.default_rng(i), noise=0.005)
        raw = Cloud.from_numpy(xyz, inten, capacity=32 * 1024, device=dev)
        state, pose, _ = frontend.odometry_step(state, raw, cfg)
        poses.append(pose.cpu().numpy())
    seconds = time.perf_counter() - t
    est = np.stack(poses)
    gt_sensor = gt.copy()
    gt_sensor[:, 2, 3] += 1.73
    gt_rel = np.linalg.inv(gt_sensor[0])[None] @ gt_sensor
    drift = np.linalg.norm(est[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
    ate = trajectory.ate_rmse(gt_rel, est)
    ok = bool(np.isfinite(est).all() and drift[-1] < 2.5 and drift.max() < 2.6 and ate < 1.0)
    emit({"phase": "canary", "frames": n, "seconds": seconds, "ate_m": ate,
          "final_drift_m": float(drift[-1]), "max_drift_m": float(drift.max()),
          "budgets": {"ate_m": 1.0, "final_drift_m": 2.5, "max_drift_m": 2.6}, "ok": ok})
    return ok


def main() -> int:
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    from tloam_torch import build
    from tloam_torch.cloud import Cloud
    from tloam_torch.config import PipelineConfig
    from tloam_torch.models import edge
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils import synthetic, trajectory
    from tloam_torch.utils.timing import STAGES

    dev = torch.device("cuda")
    cfg = PipelineConfig()

    # ---- 2. build (always from the sources of this checkout) ----
    t0 = time.time()
    for name in build.KERNELS:
        build.library_path(name).unlink(missing_ok=True)
    logs = build.build(verbose=True)
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "smem" in ln] for k, v in logs.items()}
    emit({"phase": "build", "seconds": round(time.time() - t0, 2), "kernels": list(build.KERNELS), "ptxas": ptxas})

    # ---- 3. kernel_check ----
    kw = dict(num_sectors=6, picks_per_sector=20, curv_thres=0.1, suppress_gap_sq=0.05,
              ring_min_num=cfg.ground.ring_min_num)
    R, W = cfg.sensor.sensor_model, cfg.edge_ring_width

    def compare(planes, kw=kw):
        outs_k = edge._pick_rounds_cuda(*planes, **kw)
        outs_p = edge._pick_rounds_plain(*planes, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs_k, outs_p))
        err = float((outs_k[2] - outs_p[2]).abs().max())
        return same, err, int(outs_k[0].sum()), int(outs_k[1].sum())

    rng = np.random.default_rng(0)
    rand = [torch.from_numpy(a).to(dev) for a in random_rings(rng, R, W, kw["ring_min_num"])]
    same_r, err_r, n_edge_r, n_pick_r = compare(rand)

    # the card tests' sweep: every mapping of sectors to warps (settings of
    # num_sectors and picks), at a width that is no multiple of 32 and at
    # one that needs more than 48 KB of shared memory; 16 rows each put
    # picks within 5 columns of the sector boundaries
    card_tests = load_by_path(Path(__file__).resolve().parent / "tests" / "test_torch_cuda.py")
    SETTINGS, sweep_rings = card_tests.SETTINGS, card_tests.rings
    sweep = []
    for width in (2304, 4096, 1000):
        for ns, picks in SETTINGS:
            kws = dict(kw, num_sectors=ns, picks_per_sector=picks)
            same_s, err_s, n_edge_s, _ = compare(sweep_rings(dev, width=width, num_sectors=ns), kws)
            sweep.append({"W": width, "num_sectors": ns, "picks": picks, "bit_identical": same_s,
                          "max_abs_err": err_s, "edges": n_edge_s})
    same_s = all(s["bit_identical"] and s["edges"] > 0 for s in sweep)
    err_s = max(s["max_abs_err"] for s in sweep)
    smem = {w: build.load("edge_pick").tloam_edge_pick_smem_bytes(w) for w in (1000, W, 4096)}

    scene = synthetic.Scene.urban(np.random.default_rng(3), extent=80.0)
    gt = synthetic.straight_trajectory(N_FRAMES, step=1.0, yaw_rate=0.005)
    scans = []
    for i in range(N_FRAMES):
        xyz, inten = synthetic.simulate_scan(gt[i], scene, rings=64, az_steps=1870,
                                             rng=np.random.default_rng(i), noise=0.01)
        scans.append(Cloud.pack_scan(xyz, inten, capacity=131072))
    q0 = torch.as_tensor(scans[0][0]).to(dev)
    _, objects, obj_ring, clusters = frontend.segment_objects(Cloud.from_packed(q0, scans[0][1]), cfg)
    d = edge.dense_rings(clusters.segmented, obj_ring, frontend.edge_order_key(clusters, objects.capacity),
                         R, kw["ring_min_num"], W)
    real = [d.dx, d.dy, d.dz, d.dval, d.ring_len]
    same_f, err_f, n_edge_f, n_pick_f = compare(real)
    k_ms = cuda_ms(lambda: edge._pick_rounds_cuda(*real, **kw), 200)
    k_dev_ms, k_per_call = profiled_kernel_ms(lambda: edge._pick_rounds_cuda(*real, **kw), 20, "edge_pick_kernel")
    p_ms = cuda_ms(lambda: edge._pick_rounds_plain(*real, **kw), 5)
    bound_ms, bound_by = edge_bound_ms(R, W, kw["picks_per_sector"])
    ok_k = same_r and same_f and same_s and n_edge_f > 0 and n_edge_r > 0
    emit({"phase": "kernel_check", "kernel": "edge_pick", "shape": [R, W],
          "random": {"bit_identical": same_r, "max_abs_err": err_r, "edges": n_edge_r, "picked": n_pick_r},
          "frame": {"bit_identical": same_f, "max_abs_err": err_f, "edges": n_edge_f, "picked": n_pick_f},
          "sweep": sweep, "dynamic_smem_bytes": smem,
          "ms": k_ms, "profiler_device_ms": k_dev_ms, "device_kernels_per_call": k_per_call,
          "plain_ms": p_ms, "bound_ms": bound_ms, "ok": ok_k})
    if not ok_k:
        return 1

    # ---- 4. drive ----
    state = frontend.init_state(cfg)
    STAGES.enable()
    edge.LAUNCHES = 0
    poses, corr, clusters_n, frame_s, stage_ms = [], [], [], [], []
    sync_sites, corr_rounds = {}, []
    for i, (q, n) in enumerate(scans):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = lambda: frontend.odometry_step_packed(state, q, n, cfg)  # noqa: E731
        if i == SYNC_FRAME:
            (state, pose, diag), sync_sites = count_syncs(step)
        elif i == PROFILE_FRAME:
            (state, pose, diag), busy_ms, wall_ms, top_kernels = profile_frame(step)
        else:
            state, pose, diag = step()
        pose_h = pose.cpu().numpy()
        frame_s.append(time.perf_counter() - t)
        stage_ms.append(STAGES.collect())
        poses.append(pose_h)
        corr.append(diag.num_corr.cpu().numpy())
        corr_rounds.append(int(diag.iterations))
        clusters_n.append(int(diag.num_clusters))
    launches = edge.LAUNCHES
    STAGES.enable(False)
    est = np.stack(poses)
    gt_sensor = gt.copy()
    gt_sensor[:, 2, 3] += 1.73
    gt_rel = np.linalg.inv(gt_sensor[0])[None] @ gt_sensor
    ate = trajectory.ate_rmse(gt_rel, est)
    drift = float(np.linalg.norm(est[:, :3, 3] - gt_rel[:, :3, 3], axis=1).max())
    corr_min = np.stack(corr[1:]).min(axis=0).tolist()
    timed = frame_s[TIMED_FROM:]
    stages = {k: float(np.mean([s.get(k, 0.0) for s in stage_ms[TIMED_FROM:]])) for k in stage_ms[-1]}
    ok_d = (
        launches == N_FRAMES and np.isfinite(est).all() and est.shape == (N_FRAMES, 4, 4)
        and ate < ATE_LIMIT_M and drift < DRIFT_LIMIT_M and min(corr_min) > 0
    )
    emit({"phase": "drive", "frames": N_FRAMES, "frames_per_s": len(timed) / sum(timed),
          "frame_ms_mean": 1e3 * float(np.mean(timed)), "frame_ms_max": 1e3 * float(np.max(timed)),
          "stage_ms_mean": stages, "ate_m": ate, "max_drift_m": drift,
          "corr_min_planar_ground_edge_sphere": corr_min,
          "clusters_min_max": [min(clusters_n), max(clusters_n)],
          "edge_pick_launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "host_syncs_frame": {"frame": SYNC_FRAME, "gnc_rounds": int(corr_rounds[SYNC_FRAME]),
                               "total": sum(sync_sites.values()), "sites": sync_sites},
          "profiled_frame": {"frame": PROFILE_FRAME, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                             "idle_share": 1.0 - busy_ms / wall_ms, "top_device_ms": top_kernels},
          "ok": bool(ok_d)})
    if not ok_d:
        return 1

    # ---- 5. canary ----
    ok_c = canary(dev)
    if not ok_c:
        return 1

    # ---- 6. kernels ----
    emit({"kernels": [{
        "name": "edge_pick", "route": "cuda", "source": "tloam_torch/csrc/edge_pick.cu",
        "replaces": "tloam_tpu/models/edge.py:166", "launches": launches,
        "max_abs_err": max(err_r, err_f, err_s), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "match": same_r and same_f and same_s,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
