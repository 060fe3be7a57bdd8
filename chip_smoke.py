#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tloam_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

  1. device        require CUDA; print the card's name and power limit
  2. build         compile every kernel from tloam_torch/csrc with nvcc; ptxas
                   registers and static shared memory
  3. kernel_check  the edge kernel against its plain PyTorch version on the
                   card (kernel_case, one check for phases 3-3c: every output
                   bit for bit, a repeat call, launches a call; ms a call of
                   the wrapper, of the kernel alone and of the plain
                   version; the bound): seeded random rings (short rings,
                   rings longer than W, exact ties, spikes), the sweep of
                   tests/test_torch_cuda.py (4 sector settings x 3 widths,
                   picks at sector boundaries) and the real dense planes of
                   a full-size synthetic frame (timed); dynamic shared
                   memory per width
  3b. window_moments  csrc/window_moments.cu at the batched solve's three
                   cell-table shapes (64 frames of 8192, 12288 and 8192
                   slots: edge, planar, ground; the drive's scans
                   voxel-thinned into two thirds of the slots) and the front
                   end's (one frame of 131072, the scans whole); the
                   index_put_ kernel's own time
  3c. knn          csrc/knn_window.cu at the batched GICP solve's kNN calls
                   (64 frames): the four covariance calls (each cloud
                   queries itself, k = 11) and a round's planar, ground,
                   edge and sphere searches (k = 5 and 1); the share of
                   answers found, the plain version's sort
  4. drive         the full-size 23-frame synthetic drive (64 rings x 1870
                   azimuth steps, capacity 131072, default PipelineConfig)
                   through tloam_torch.pipeline.frontend.odometry_step_packed,
                   with kernel launch counts, frames/s over frames 3-22,
                   per-stage CUDA-event times, ATE and drift against the
                   ground truth, and the per-family correspondence minima;
                   the kNN kernel's launches a frame (the sphere family's
                   1-NN in every GNC round); frame 1 counts its host syncs
                   (CUDA sync-debug warnings
                   by source line), frame 2 is traced with torch.profiler
                   (device busy share, top kernels)
  5. canary        the JAX package's 60-frame varied-drive canary (32 x 1024
                   scans, tests/test_long_horizon.py) at its budgets: ATE
                   < 1.0 m, final drift < 2.5 m, max drift < 2.6 m
  6. modes         one line per off-default mode of MODES (kNN and GICP
                   registration, exact PCA, factor_num 3 without the sphere
                   family, the reference quirks with the global map), each
                   a full-size drive like phase 4's (GICP:
                   three noise realizations of a rest start) with its host
                   syncs, profiled frame, hot-operation times, and the JAX
                   package's own numbers on the same drives and the limits
                   derived from them (JAX_REF)
  7. parallel      tloam_torch.parallel at full width on entries captured
                   from frames 3-10 of phase 4's drive (the port's own scan
                   features, submap and prediction before each frame): the
                   batched solve at B = 1, 8 and 64 (the 8 tiled 8 times,
                   each copy's planar cloud with seeded 2 mm noise) against
                   one-frame solves (poses within 5e-3 m and 1e-3 rad);
                   one solve at B = 1 and at B = 64 (64 copies of one
                   entry) must issue the same host syncs, the same aten
                   operations and the same kernel launches outside the
                   library calls that pick their kernels by size (cuBLAS,
                   cuSOLVER, CUB sorts; those are printed beside);
                   frames/s at B = 8 and 64 against a loop of one-frame
                   solves, device busy share and peak memory; spawned ranks
                   on the one card: the consensus solve of the frame-4 entry
                   on 2 gloo ranks (NCCL refuses two ranks on one GPU), with
                   and without binding caps, a 1-rank NCCL run of it, and
                   the 8 entries frames-sharded 4 + 4
  9. cli           tloam_torch.cli.main on the card: a synthetic run of 12
                   frames with a checkpoint every 6 (and the cluster boxes),
                   a run stopped at frame 6 and resumed from its checkpoint
                   (trajectory and final checkpoint equal to the last bit),
                   the same 12 scans as a KITTI tree read by the native
                   loader (its arrays equal the NumPy reader's), `info`
 10. library       every device op of ops/cloud_ops.py, ops/factories.py
                   and the cell-table and record ops of ops/voxel.py on one
                   full-size scan, on the card and, on the same inputs,
                   through the port on the CPU: integer and mask outputs
                   equal, floats within LIBRARY_TOL; ms per call (CUDA
                   events)
 11. town          the first 30 frames of the route-c hard-town drive
                   through tloam_torch.utils.drives.hard_town_drive, the
                   raycasts spread over processes first, held to limits
                   derived from the JAX package's CPU run (JAX_TOWN_REF)
 12. harness       the measurement scripts (scripts/torch_*.py) through their
                   entry points at reduced sizes: the solver bench on 4
                   frames, the batched bench at B = 128 in default and
                   factor3 (poses held to one-frame solves), the mode
                   matrix's factor3 on phase 4's drive (held to JAX_REF) and
                   one 10-frame sweep run (route a, world 3; no degenerate
                   frame)
  8. kernels       one line per kernel: launches in all drives, kernel and
                   plain-version times, bound, agreement (printed last)

The last two lines are the card (`nvidia-smi --query-gpu=name,power.limit`)
and {"ok": true, "device": {...}}. `--worker` runs one spawned rank of
phase 7 (the script starts them itself).
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
# this drive (pure-f32 CPU run: python -m tests.jax_mode_refs default)
ATE_LIMIT_M = 0.05
DRIFT_LIMIT_M = 0.10
N_FRAMES = 23
TIMED_FROM = 3
SYNC_FRAME = 1  # an untimed frame whose host syncs are counted
PROFILE_FRAME = 2  # an untimed frame traced with torch.profiler

# off-default modes: drive, dotted config overrides and noise realizations
# (tests/jax_mode_refs.py holds the same table). "bench" is phase 4's drive;
# "rest_start" is the 30-frame drive of tests/test_gicp_globalmap_io.py:114-140
# at 64 x 1870: GICP diverges on the bench drive's 1 m/frame cold start in
# the JAX package too (MODES_r05.json, ATE 12.6 m). A realization is the
# seed offset of the scans' noise (scan i draws from default_rng(i + offset)).
# GICP runs three: on realization 0, frames 3-4 are a knife edge where two
# roundings of the same solve part by 4-11 cm in one frame, and the port's
# run ends at 1.18 m where the JAX package's ends at 0.18 m (PERF.md §6;
# tests/gicp_frame_gaps.py).
MODES = {
    "corr_knn": ("bench", ["odometry.tls.corr_mode=knn"], (0,)),
    "pca_exact": ("bench", ["feature.pca_mode=exact"], (0,)),
    "gicp": ("rest_start", ["odometry.tls.plane_residual=gicp"], (1000, 2000, 3000)),
    "factor3": ("bench", ["odometry.tls.factor_num=3"], (0,)),
    "reference": ("bench", [
        "odometry.tls.mu_init=reference_zero", "sphere_submap_from_planar=true",
        "sphere_index_bug=true", "odometry.mapping_flag=true", "frame_planar_fill=1024",
    ], (0,)),
}
# The JAX package on the same drives and realizations, pure float32 on the
# CPU (jax 0.9.0):
#   JAX_PLATFORMS=cpu python -m tests.jax_mode_refs corr_knn pca_exact reference gicp factor3
JAX_REF = {
    "corr_knn": {0: {"ate_m": 0.01384732570128028, "max_drift_m": 0.05133948625126377,
                     "corr_min": [750, 240, 268, 53]}},
    "pca_exact": {0: {"ate_m": 0.02177857775623863, "max_drift_m": 0.048346592577314766,
                      "corr_min": [592, 1856, 64, 17]}},
    "gicp": {
        1000: {"ate_m": 0.08176856884230582, "final_drift_m": 0.2751936026175358,
               "max_drift_m": 0.2960008921202865, "corr_min": [829, 2000, 235, 27]},
        2000: {"ate_m": 0.039488298649995104, "final_drift_m": 0.14941557151499324,
               "max_drift_m": 0.14941557151499324, "corr_min": [789, 2000, 212, 23]},
        3000: {"ate_m": 0.041636664175335125, "final_drift_m": 0.1400471029037131,
               "max_drift_m": 0.15023238533065275, "corr_min": [810, 2000, 242, 19]},
    },
    "factor3": {0: {"ate_m": 0.017214623401848397, "max_drift_m": 0.07197373785575886,
                    "corr_min": [742, 1843, 75, 0]}},
    "reference": {0: {"ate_m": 0.019216195422061804, "max_drift_m": 0.0785994986458988,
                      "corr_min": [768, 1844, 77, 0], "global_map_final": 8391}},
}
GICP_DRIFT_LIMIT_M = 0.5  # tests/test_gicp_globalmap_io.py:139-140

# phase 11: the JAX package on the first 30 frames of the route-c hard-town
# drive (world 3, cars 11, occlusions 12, packed transfer), pure float32 on
# the CPU (jax 0.9.0): JAX_PLATFORMS=cpu python -m tests.jax_mode_refs town
TOWN_FRAMES = 30
TOWN_DRIVE = {"route": "c", "world_seed": 3, "cars_seed": 11, "occ_seed": 12}
JAX_TOWN_REF = {"ate_m": 0.006008177431455849, "final_drift_m": 0.005542616078217099,
                "max_drift_m": 0.017023081556876728, "degenerate_frames": 0, "corr_min": [325, 1532, 44, 0]}


def headroom_limits(ref: dict) -> dict:
    """Phase 4's headroom over a JAX run of the drive (ATE 0.05 m against
    its 0.0144 m, drift 0.10 m against 0.034 m), never less than phase 4's
    limits."""
    return {"ate_m": max(ATE_LIMIT_M, ref["ate_m"] * ATE_LIMIT_M / 0.0144),
            "max_drift_m": max(DRIFT_LIMIT_M, ref["max_drift_m"] * DRIFT_LIMIT_M / 0.034)}


def mode_limits(mode: str, seed: int) -> dict:
    """A bench-drive mode gets headroom_limits over the JAX package's own
    run; GICP gets its test's drift budgets."""
    if MODES[mode][0] == "rest_start":
        return {"final_drift_m": GICP_DRIFT_LIMIT_M, "max_drift_m": GICP_DRIFT_LIMIT_M}
    return headroom_limits(JAX_REF[mode][seed])


# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_fields(dev) -> dict:
    """What a measurement ran on: the device type, the card's name and
    nvidia-smi line (None on the CPU) and the torch version."""
    import torch

    cuda = dev.type == "cuda"
    return {"backend": dev.type, "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "nvidia_smi": nvidia_smi() if cuda else None, "torch": torch.__version__}


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


def launch_count(counter: str) -> int:
    """Launches so far in this process of the kernel the tracer's counter
    `counter` counts (build.KERNEL_ENTRIES)."""
    from tloam_torch.utils.timing import STAGES

    return STAGES.counts[counter]


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
    by total ms). Busy is the sum of device kernel and copy times; the
    device track's copies of the tracer's spans are no work."""
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
        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
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


def kernel_case(kernel: str, call, plain, nbytes: int, ops: int = 0, reps=None) -> tuple[dict, tuple]:
    """One case of a kernel check (phases 3, 3b, 3c): `call` runs the kernel
    `kernel` (of build.KERNELS) through its wrapper, `plain` its plain
    version; each returns a tensor or a tuple of them. Returns (the case's
    fields, the kernel's outputs): every output bit for bit (floats by their
    bits), a repeat call the same, the kernel's launches a call (its
    tracer counter), and the bound: the case's bytes at HBM peak or its f32
    operations at peak, the longer. With reps = (wrapper, kernel, plain)
    calls: ms a call of the wrapper (CUDA events), ms a launch of the
    kernel alone (torch.profiler) and ms a call of the plain version."""
    import torch

    from tloam_torch import build

    def outputs(fn):
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    def bits(t):
        return t.view(torch.int32) if t.dtype is torch.float32 else t

    counter = build.KERNEL_ENTRIES[kernel].counter
    before = launch_count(counter)
    got, again = outputs(call), outputs(call)
    per_call = (launch_count(counter) - before) / 2
    want = outputs(plain)
    torch.cuda.synchronize()
    floats = [(a, b) for a, b in zip(got, want) if a.is_floating_point()]
    rec = {"bit_identical": all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
           "repeats": all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)),
           "launches_per_call": per_call,
           "max_abs_err": max((float((a.double() - b.double()).abs().max()) for a, b in floats), default=None)}
    if reps:
        rec["ms"] = cuda_ms(call, reps[0])
        rec["kernel_ms"], rec["device_kernels_per_call"] = profiled_kernel_ms(call, reps[1], f"{kernel}_kernel")
        rec["plain_ms"] = cuda_ms(plain, reps[2])
    by_bytes, by_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    rec.update(bytes=nbytes, bound_ms=max(by_bytes, by_ops) * 1e3,
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    return rec, got


# (frames, slots, max_cells, cell size) of the window-moment calls: the
# batched solve's edge, planar and ground tables at B = 64
# (registration._solve, TLSConfig's thresholds) and the front end's cell
# PCA of one scan (FeatureConfig radius, max_cells)
WINDOW_SHAPES = ((64, 8192, 4096, 1.0), (64, 12288, 6144, 0.5), (64, 8192, 8192, 0.5), (1, 131072, 65536, 0.2))


def submap_frames(clouds, F: int, n: int, shift: int = 0):
    """F frames of n slots on the clouds' device: frame f holds cloud
    (f + shift) % len(clouds), as it is where it has n slots (the front
    end's call), else voxel-thinned at 0.4 m into two thirds of the slots,
    the rest padding (a submap's cloud)."""
    import torch

    from tloam_torch.ops import voxel

    dev = clouds[0].device
    xyz = torch.zeros((F, n, 3), device=dev)
    valid = torch.zeros((F, n), dtype=torch.bool, device=dev)
    for f in range(F):
        c = clouds[(f + shift) % len(clouds)]
        if n == c.capacity:
            xyz[f], valid[f] = c.xyz, c.valid
        else:
            x, _, ok = voxel.voxel_downsample(c.xyz, c.intensity, c.valid, 0.4, 2 * n // 3)
            xyz[f, : 2 * n // 3], valid[f, : 2 * n // 3] = x, ok
    return xyz, valid


def window_moments_check(clouds) -> tuple[bool, list]:
    """Phase 3b: the window-moment kernel against its plain version at the
    main path's shapes, on the drive's scans (submap_frames)."""
    import torch

    from tloam_torch.ops import voxel

    out = []
    for F, n, V, cs in WINDOW_SHAPES:
        xyz, valid = submap_frames(clouds, F, n)
        bt = voxel.build_block_table(xyz, valid, cs, V)
        counted = int((valid & (bt.point_cell >= 0)).sum())
        rows, run_len = torch.unique_consecutive(bt.point_cell.gather(1, bt.point_order.long()), return_counts=True)
        # each slot's order and row index, each counted point's xyz and flag,
        # each written record (one a valid cell) with its cell row (coords,
        # flag, store row)
        nbytes = F * n * 8 + counted * 13 + int(bt.cell_valid.sum()) * (64 + 17)
        rec, (got,) = kernel_case("window_moments", lambda: voxel._window_store_cuda(xyz, valid, bt, cs),
                                  lambda: voxel._window_store_plain(xyz, valid, bt, cs), nbytes, reps=(50, 20, 5))
        library_ms, _ = profiled_kernel_ms(lambda: voxel._window_store_plain(xyz, valid, bt, cs), 3,
                                           "indexing_backward_kernel")
        out.append({"frames": F, "slots": n, "max_cells": V, "cell_size": cs, **rec, "counted_points": counted,
                    "records": int((got[:, 0] > 0).sum()), "longest_run": int(run_len[rows >= 0].max()),
                    "index_put_kernel_ms": library_ms})
    ok = all(r["bit_identical"] and r["repeats"] and r["records"] > 0 for r in out)
    emit({"phase": "window_moments", "kernel": "window_moments", "shapes": out, "ok": ok})
    return ok, out


# (frames, grid slots, queries a frame or None where the cloud queries
# itself, k, radius = the grid's cell size) of the kNN calls of a batched
# GICP solve at B = 64 (registration._solve, TLSConfig): the covariances of
# the submap's planar and ground clouds and the scan's (k_corr + 1 within
# 1 m), then a round's planar and ground 1-NN matches (1.5 m), edge 5-NN
# (1 m) and sphere 1-NN (0.5 m, the submap's 3 x 1024 slots); the kNN
# mode's planar and ground 5-NN (0.5 m)
KNN_SHAPES = ((64, 12288, None, 11, 1.0), (64, 8192, None, 11, 1.0), (64, 4096, None, 11, 1.0),
              (64, 1024, None, 11, 1.0), (64, 12288, 1024, 1, 1.5), (64, 8192, 4096, 1, 1.5),
              (64, 8192, 2048, 5, 1.0), (64, 3072, 512, 1, 0.5), (64, 12288, 1024, 5, 0.5),
              (64, 8192, 4096, 5, 0.5))
KNN_MAX_PER_CELL = 8  # TLSConfig.max_per_cell


def knn_check(clouds) -> tuple[bool, list]:
    """Phase 3c: the kNN kernel against its plain version at the batched
    solve's shapes: each grid on the drive's scans (submap_frames), its
    queries on the next scans, thinned into two thirds of their slots."""
    import torch

    from tloam_torch.ops import voxel

    C = KNN_MAX_PER_CELL
    out = []
    for F, M, Q, k, radius in KNN_SHAPES:
        xyz, valid = submap_frames(clouds, F, M)
        grid = voxel.build_hash_grid(xyz, valid, radius)
        q, qv = (xyz, valid) if Q is None else submap_frames(clouds, F, Q, 1)
        r = torch.full((), radius, dtype=torch.float32, device=xyz.device)
        nq = q.shape[0] * q.shape[1]
        # from device memory: each query's point, cell and flag, each answer's
        # index, distance and flag; the tables and points stay in L2
        nbytes = nq * (12 + 12 + 1) + nq * k * (8 + 4 + 1)
        rec, got = kernel_case("knn_window", lambda: voxel.query_knn(grid, q, qv, k, radius=radius, max_per_cell=C),
                               lambda: voxel._query_block(grid, q, qv, k, r, C), nbytes, reps=(20, 10, 3))
        sort_ms, _ = profiled_kernel_ms(lambda: voxel._query_block(grid, q, qv, k, r, C), 2, "radixSortKVInPlace")
        out.append({"frames": F, "slots": M, "queries": Q or M, "k": k, "radius": radius, **rec,
                    "ok_share": float(got[2].float().mean()), "plain_sort_kernel_ms": sort_ms})
        del got
    ok = all(r["bit_identical"] and r["repeats"] and r["launches_per_call"] == 1 and 0 < r["ok_share"] < 1
             for r in out)
    emit({"phase": "knn", "kernel": "knn_window", "shapes": out, "ok": ok})
    return ok, out


def canary(dev) -> bool:
    """The JAX package's 60-frame canary (tests/test_long_horizon.py:41-76):
    a varied drive (turns, stop-and-go, reverse) of 32 x 1024 scans under
    the default solver with the reduced capacities of tests/test_pipeline.py,
    held to the same budgets."""
    from tloam_torch.cloud import Cloud
    from tloam_torch.config import OdometryConfig, PipelineConfig, TLSConfig
    from tloam_torch.pipeline import frontend
    from tloam_torch.utils import synthetic

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
    launches0 = launch_count("edge_pick.launch")
    t = time.perf_counter()
    for i in range(n):
        xyz, inten = synthetic.simulate_scan(gt[i], scene, rings=32, az_steps=1024,
                                             rng=np.random.default_rng(i), noise=0.005)
        raw = Cloud.from_numpy(xyz, inten, capacity=32 * 1024, device=dev)
        state, pose, _ = frontend.odometry_step(state, raw, cfg)
        poses.append(pose.cpu().numpy())
    seconds = time.perf_counter() - t
    launches = launch_count("edge_pick.launch") - launches0
    est = np.stack(poses)
    ate, drift = drive_errors(est, gt)
    ok = bool(np.isfinite(est).all() and drift[-1] < 2.5 and drift.max() < 2.6 and ate < 1.0 and launches == n)
    emit({"phase": "canary", "frames": n, "seconds": seconds, "ate_m": ate,
          "final_drift_m": float(drift[-1]), "max_drift_m": float(drift.max()), "edge_pick_launches": launches,
          "budgets": {"ate_m": 1.0, "final_drift_m": 2.5, "max_drift_m": 2.6}, "ok": ok})
    return ok, launches


def sensor_rel(gt: np.ndarray) -> np.ndarray:
    """Sensor poses of a ground-truth base trajectory relative to its first
    frame."""
    gt_sensor = gt.copy()
    gt_sensor[:, 2, 3] += 1.73
    return np.linalg.inv(gt_sensor[0])[None] @ gt_sensor


def drive_errors(est: np.ndarray, gt: np.ndarray):
    """(ATE, per-frame drift) of sensor poses against a ground-truth base
    trajectory, both relative to the first frame."""
    from tloam_torch.utils import trajectory

    gt_rel = sensor_rel(gt)
    return trajectory.ate_rmse(gt_rel, est), np.linalg.norm(est[:, :3, 3] - gt_rel[:, :3, 3], axis=1)


def drive_scans(drive: str, n: int, seed: int = 0):
    """(ground truth (n,4,4), packed scans) of a drive at 64 x 1870,
    capacity 131072: the bench drive, or the rest start; scan i's noise
    draws from default_rng(i + seed)."""
    from tloam_torch.cloud import Cloud
    from tloam_torch.utils import synthetic

    scene = synthetic.Scene.urban(np.random.default_rng(3), extent=80.0)
    if drive == "bench":
        gt = synthetic.straight_trajectory(n, step=1.0, yaw_rate=0.005)
    else:
        xs = np.concatenate([[0.0], np.cumsum(np.minimum(np.arange(n) * 0.12, 1.0))])
        gt = np.stack([np.eye(4)] * n)
        gt[:, 0, 3] = xs[:n] - 46.0
    scans = []
    for i in range(n):
        xyz, inten = synthetic.simulate_scan(gt[i], scene, rings=64, az_steps=1870,
                                             rng=np.random.default_rng(i + seed), noise=0.01)
        scans.append(Cloud.pack_scan(xyz, inten, capacity=131072))
    return gt, scans


def run_drive(cfg, scans) -> dict:
    """Drive the packed scans through frontend.odometry_step_packed, the
    kernels' counts set to 0 just before and read just after (the
    window-moment and kNN kernels' also a frame). Frame
    SYNC_FRAME counts its host syncs, PROFILE_FRAME is traced; every frame
    records its host-clock time and CUDA-event stage times."""
    import torch

    from tloam_torch.pipeline import frontend
    from tloam_torch.utils.timing import STAGES

    state = frontend.init_state(cfg)
    out = {"poses": [], "corr": [], "rounds": [], "clusters": [], "frame_s": [], "stage_ms": [], "global_map": []}
    STAGES.enable()
    launches0, window0, knn0 = (launch_count(c) for c in ("edge_pick.launch", "window_moments.launch", "knn.launch"))
    for i, (q, n) in enumerate(scans):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = lambda: frontend.odometry_step_packed(state, q, n, cfg)  # noqa: E731
        if i == SYNC_FRAME:
            (state, pose, diag), out["sync_sites"] = count_syncs(step)
        elif i == PROFILE_FRAME:
            (state, pose, diag), out["busy_ms"], out["wall_ms"], out["top_kernels"] = profile_frame(step)
        else:
            state, pose, diag = step()
        pose_h = pose.cpu().numpy()
        out["frame_s"].append(time.perf_counter() - t)
        out["stage_ms"].append(STAGES.collect())
        out["poses"].append(pose_h)
        out["corr"].append(diag.num_corr.cpu().numpy())
        out["rounds"].append(int(diag.iterations))
        out["clusters"].append(int(diag.num_clusters))
        out["global_map"].append(int(state.global_map.count()))
    out["launches"] = launch_count("edge_pick.launch") - launches0
    out["window_launches"] = launch_count("window_moments.launch") - window0
    out["window_launches_frame"] = [int(s.get("count:window_moments.launch", 0)) for s in out["stage_ms"]]
    out["knn_launches"] = launch_count("knn.launch") - knn0
    out["knn_launches_frame"] = [int(s.get("count:knn.launch", 0)) for s in out["stage_ms"]]
    STAGES.enable(False)
    out["state"] = state
    out["est"] = np.stack(out["poses"])
    timed = out["frame_s"][TIMED_FROM:]
    out["frames_per_s"] = len(timed) / sum(timed)
    out["frame_ms_mean"] = 1e3 * float(np.mean(timed))
    out["frame_ms_max"] = 1e3 * float(np.max(timed))
    out["stages"] = {k: float(np.mean([s.get(k, 0.0) for s in out["stage_ms"][TIMED_FROM:]]))
                     for k in out["stage_ms"][-1]}
    out["corr_min"] = np.stack(out["corr"][1:]).min(axis=0).tolist()
    out["host_syncs_frame"] = {"frame": SYNC_FRAME, "gnc_rounds": out["rounds"][SYNC_FRAME],
                               "total": sum(out["sync_sites"].values()), "sites": out["sync_sites"]}
    out["profiled_frame"] = {"frame": PROFILE_FRAME, "wall_ms": out["wall_ms"], "device_busy_ms": out["busy_ms"],
                             "idle_share": 1.0 - out["busy_ms"] / out["wall_ms"], "top_device_ms": out["top_kernels"]}
    return out


def op_ms(fn, reps: int) -> dict:
    """Per call of fn: CUDA-event ms over `reps` calls, and the device busy
    ms of `reps` traced calls (torch.profiler) over reps."""
    _, busy_ms, _, _ = profile_frame(lambda: [fn() for _ in range(reps)])
    return {"ms": cuda_ms(fn, reps), "device_ms": busy_ms / reps}


def mode_ops(mode: str, cfg, drive: dict, q, n) -> dict:
    """Times of the mode's hot PyTorch operations (op_ms) on the drive's
    last submap and scan, at the shapes the main path gives them: the 5-NN
    query of the kNN plane fit, the 3x3 inverses and covariance kNN of GICP,
    the k=20 query of exact PCA, the global-map accumulation."""
    import torch

    from tloam_torch.cloud import Cloud
    from tloam_torch.models import edge, features, registration
    from tloam_torch.ops import voxel
    from tloam_torch.pipeline import frontend

    tls = cfg.odometry.tls
    state = drive["state"]
    raw = Cloud.from_packed(torch.as_tensor(q).to(state.pose.device), n)
    feats = frontend.preprocess_frame(raw, cfg)
    sub = frontend.submap_features(state.submap, cfg)
    scan = feats.scan.transform(state.pose)
    out = {}
    if mode == "corr_knn":
        g = voxel.build_hash_grid(sub.ground.xyz, sub.ground.valid, tls.ground_dist_thres)
        out["knn5_query_ground"] = op_ms(lambda: voxel.query_knn(
            g, scan.ground.xyz, scan.ground.valid, k=5, radius=tls.ground_dist_thres,
            max_per_cell=tls.max_per_cell), 20)
        out["plane_corr_ground"] = op_ms(lambda: registration._plane_correspondences(
            g, sub.ground, scan.ground.xyz, scan.ground.valid, tls.ground_dist_thres, tls.ground_maxnum,
            tls.max_per_cell), 20)
    elif mode == "gicp":
        covs = registration.calculate_covariances(scan.ground, tls.k_corr, max_per_cell=tls.max_per_cell)
        R = state.pose[:3, :3]
        rcr = covs + R @ covs @ R.T  # C_t + R C_s R^T, as plane_to_plane forms it
        out["inv3x3_ground"] = op_ms(lambda: torch.linalg.inv_ex(rcr), 20)
        out["covariance_knn_submap_planar"] = op_ms(lambda: registration.calculate_covariances(
            sub.planar, tls.k_corr, max_per_cell=tls.max_per_cell), 20)
    elif mode == "pca_exact":
        _, objects, obj_ring, clusters = frontend.segment_objects(raw, cfg)
        e = edge.extract_edges(clusters.segmented, obj_ring, frontend.edge_order_key(clusters, objects.capacity),
                               sensor_model=cfg.sensor.sensor_model, ring_min_num=cfg.ground.ring_min_num,
                               ring_width=cfg.edge_ring_width)
        general = clusters.segmented.mask(e.general_mask)
        out["pca_exact"] = op_ms(lambda: features.calculate_pca_info(general, cfg.feature), 5)
    elif mode == "reference":
        out["global_map_accumulate"] = op_ms(lambda: frontend._accumulate_global_map(
            state.global_map, raw, state.pose, cfg), 10)
    return out


def run_mode(mode: str, bench_gt, bench_scans):
    """Phase 6 for one mode: its drive on each noise realization, each held
    to its limits; one JSON line. Timing, host syncs and the profiled frame
    are the first realization's. Returns (ok, edge kernel launches, the
    first realization's poses)."""
    from tloam_torch.config import load_pipeline_config

    drive, overrides, seeds = MODES[mode]
    cfg_m = load_pipeline_config(None, overrides)
    # the sphere family may starve under the reference quirks; factor_num=3 drops it
    fam = 3 if mode in ("reference", "factor3") else 4
    t = time.perf_counter()
    runs, first, launches, corr_min, ok_m = [], None, 0, None, True
    for seed in seeds:
        if drive == "bench" and seed == 0:
            gt_m, scans_m = bench_gt, bench_scans
        else:
            gt_m, scans_m = drive_scans(drive, 30, seed)
        d = run_drive(cfg_m, scans_m)
        first = first or d
        launches += d["launches"]
        ate_m, drift_m = drive_errors(d["est"], gt_m)
        got = {"ate_m": ate_m, "final_drift_m": float(drift_m[-1]), "max_drift_m": float(drift_m.max())}
        limits = mode_limits(mode, seed)
        gmap = d["global_map"]
        ok = bool(
            np.isfinite(d["est"]).all() and d["launches"] == len(scans_m)
            and all(got[k] < v for k, v in limits.items()) and min(d["corr_min"][:fam]) > 0
            and (not cfg_m.odometry.mapping_flag or (gmap[0] > 0 and all(b >= a for a, b in zip(gmap, gmap[1:]))))
        )
        ok_m = ok_m and ok
        corr_min = d["corr_min"] if corr_min is None else np.minimum(corr_min, d["corr_min"]).tolist()
        runs.append({"seed": seed, "frames": len(scans_m), **got, "limits": limits, "jax_ref": JAX_REF[mode][seed],
                     "corr_min_planar_ground_edge_sphere": d["corr_min"], "edge_pick_launches": d["launches"],
                     "gnc_rounds_mean": float(np.mean(d["rounds"][1:])),
                     "global_map_counts": gmap if cfg_m.odometry.mapping_flag else None,
                     "drift_m": [round(float(x), 4) for x in drift_m], "ok": ok})
    emit({"phase": "modes", "mode": mode, "drive": drive, "overrides": overrides,
          "frames": sum(r["frames"] for r in runs), "seconds": time.perf_counter() - t,
          "ate_m": max(r["ate_m"] for r in runs), "max_drift_m": max(r["max_drift_m"] for r in runs),
          "corr_min_planar_ground_edge_sphere": corr_min, "edge_pick_launches": launches,
          "frames_per_s": first["frames_per_s"], "frame_ms_mean": first["frame_ms_mean"],
          "stage_ms_mean": first["stages"], "host_syncs_frame": first["host_syncs_frame"],
          "profiled_frame": first["profiled_frame"], "realizations": runs,
          "ops_ms": mode_ops(mode, cfg_m, d, *scans_m[-1]), "ok": ok_m})
    return ok_m, launches, first["est"]


# phase 7: the batched, frame-sharded and consensus solves of tloam_torch.parallel
PAR_FRAMES = range(3, 11)  # frames 3-10 of the bench drive: B = 8 distinct entries
PAR_TILE = 8  # B = 64: those 8 tiled 8 times, each copy's planar cloud with its own noise
PAR_BIG = PAR_TILE * len(PAR_FRAMES)  # 64, also the copies of entry 0 in the counts
PAR_NOISE_M = 0.002
PAR_SEED = 0
PAR_CONSENSUS = 1  # the entry of frame 4
POSE_TOL_M, POSE_TOL_RAD = 5e-3, 1e-3
INT_DIAGS = ("iterations", "num_corr", "corr_trace", "coarse_trace", "aligned_trace")
RANK_TIMEOUT_S = 60  # a collective that waits longer fails the rank
JOIN_TIMEOUT_S = 300
# aten operations whose CUDA implementation picks its kernels, and how many
# it launches, by the size of its input: cuBLAS products, cuSOLVER's eigen
# solve and inverse, CUB's sorts (an accumulating index_put_ sorts its
# indices)
LIBRARY_OPS = frozenset((
    "aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::linalg_eigh", "aten::_linalg_eigh",
    "aten::linalg_inv_ex", "aten::linalg_lu_factor_ex", "aten::sort", "aten::index_put_", "aten::_index_put_impl_",
))


def capture_entries(cfg, scans):
    """(scan features, submap features, prediction) of frames 3-10 of the
    bench drive, each captured from the port's own state before the frame,
    as scripts/batched_bench.py:36-80 does: preprocess_frame (one edge
    kernel launch), submap_features of the state before the frame, and
    state.predict. The state steps through frames 0-10."""
    import torch

    from tloam_torch.cloud import Cloud
    from tloam_torch.pipeline import frontend

    state = frontend.init_state(cfg)
    entries = []
    for i, (q, n) in enumerate(scans[: PAR_FRAMES.stop]):
        raw = Cloud.from_packed(torch.as_tensor(q).to(state.pose.device), n)
        if i in PAR_FRAMES:
            feats = frontend.preprocess_frame(raw, cfg)
            entries.append((feats.scan, frontend.submap_features(state.submap, cfg), state.predict.clone()))
        state, _, _ = frontend.odometry_step(state, raw, cfg)
    return entries


def pose_gaps(a, b):
    """(largest translation gap m, largest rotation gap rad) between two
    (B,4,4) pose stacks."""
    import torch

    from tloam_torch.ops import se3

    d = torch.linalg.inv(b.double()) @ a.double()
    return float(d[:, :3, 3].norm(dim=-1).max()), float(se3.log_so3(d[:, :3, :3]).norm(dim=-1).max())


def kernel_launches(fn):
    """(result, kernel launch calls the host issued, those made inside a
    LIBRARY_OPS operation, device kernel records, Counter of launches by
    the innermost tloam_torch source line) of one traced call of fn. The
    launch calls are exact; the profiler drops a few device records of a
    13k-kernel trace now and then, so those vary by a few from run to
    run."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_stack=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    records = sum(ev.device_type == DeviceType.CUDA and not ev.name.startswith(("Memcpy", "Memset"))
                  for ev in events)
    sites = collections.Counter()
    library = 0
    for ev in events:
        if ev.device_type == DeviceType.CPU and "LaunchKernel" in ev.name:
            p, frame, chain, lib = ev.cpu_parent, None, [], False
            while p is not None:
                lib = lib or p.name in LIBRARY_OPS
                if frame is None:
                    frame = next((f for f in (p.stack or []) if "tloam_torch" in f), None)
                    chain.append(p.name if frame is None and not p.stack else (p.stack or ["?"])[0])
                p = p.cpu_parent
            library += lib
            sites[(frame or " < ".join(chain[:6])).split("tloam_torch/")[-1]] += 1
    return out, sum(sites.values()), library, records, sites


def parallel_worker(job: str, addr: str, world: int, rank: int, workdir: str) -> int:
    """One rank of phase 7's spawned runs. job "gloo": the consensus solves
    of the frame-4 entry (scan halves over the ranks) with and without
    binding caps, then the frames-sharded solve of the 8 entries; job
    "nccl": the uncapped consensus solve in a group of one."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from tloam_torch.config import TLSConfig
    from tloam_torch.cloud import map_tensors
    from tloam_torch.parallel import batched, mesh as mesh_lib

    torch.cuda.set_device(0)
    mesh_lib.bootstrap_distributed(addr, world, rank, backend=job, timeout_s=RANK_TIMEOUT_S)
    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)  # written by run_parallel
    cuda = lambda tree: map_tensors(tree, lambda x: x.cuda())  # noqa: E731
    tls = TLSConfig(**inp["tls"])
    points = mesh_lib.make_mesh(frames=1)  # 1 x world
    out = {}
    for name in ("uncapped", "capped") if job == "gloo" else ("uncapped",):
        cfg = dataclasses.replace(tls, **inp["caps"]) if name == "capped" else tls
        pose, diag = batched.distributed_scan_matching(*cuda(inp["consensus"]), cfg, points)
        out[name] = (pose.cpu(), diag.num_corr.cpu(), diag.iterations.cpu())
    if job == "gloo":
        frames = mesh_lib.make_mesh()  # world x 1
        poses, diags = batched.sharded_scan_matching(*cuda(inp["entries"]), tls, frames)
        out["sharded"] = (poses.cpu(), diags.iterations.cpu())
    torch.cuda.synchronize()
    torch.save(out, Path(workdir) / f"{job}{rank}.pt")
    dist.destroy_process_group()
    return 0


def spawn_ranks(job: str, world: int, workdir: Path):
    """Run `world` ranks of parallel_worker(job) and return their outputs;
    a rank that fails or outlives JOIN_TIMEOUT_S fails the phase."""
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker", job, addr, str(world),
                               str(r), str(workdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            print(log[-3000:], file=sys.stderr)
            raise RuntimeError(f"{job} rank failed with {p.returncode}")
    return [torch.load(workdir / f"{job}{r}.pt") for r in range(world)]


def run_parallel(cfg, scans) -> tuple[bool, int]:
    """Phase 7 (tloam_torch.parallel at full width); one JSON line. Returns
    (ok, edge kernel launches)."""
    import collections
    import dataclasses

    import torch

    from tloam_torch.cloud import Cloud, map_tensors, stack_tensors
    from tloam_torch.models import registration
    from tloam_torch.parallel import batched
    from tloam_torch.utils.op_count import count_ops

    tls = cfg.odometry.tls
    launches0 = launch_count("edge_pick.launch")
    entries = capture_entries(cfg, scans)
    launches = launch_count("edge_pick.launch") - launches0
    dev = entries[0][2].device
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    noisy = []
    for _ in range(PAR_TILE):
        for s, m, p in entries:
            xyz = s.planar.xyz + torch.randn(s.planar.xyz.shape, generator=gen, device=dev) * PAR_NOISE_M
            noisy.append((s._replace(planar=Cloud(xyz, s.planar.intensity, s.planar.valid)), m, p))
    sets = {1: entries[:1], 8: entries, PAR_BIG: noisy}

    # batched against one-frame solves; the one-frame loop is the rate baseline
    check, single_s, singles, batched_out = {}, {}, {}, {}
    for B, ents in sets.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = [registration.scan_matching(*e, tls) for e in ents]
        torch.cuda.synchronize()
        single_s[B] = time.perf_counter() - t
        singles[B] = outs
        pose_b, diag_b = batched.vmap_scan_matching(*stack_tensors(ents), tls)
        batched_out[B] = (pose_b, diag_b)
        gap_m, gap_rad = pose_gaps(pose_b, torch.stack([o[0] for o in outs]))
        differ = sum(
            any(not torch.equal(getattr(diag_b, k)[b], getattr(o[1], k)) for k in INT_DIAGS) for b, o in enumerate(outs)
        )
        check[B] = {"gap_m": gap_m, "gap_rad": gap_rad, "entries_int_diags_differ": differ,
                    "rounds": diag_b.iterations.tolist() if B <= 8 else [int(diag_b.iterations.min()),
                                                                          int(diag_b.iterations.max())]}
    ok_check = all(c["gap_m"] < POSE_TOL_M and c["gap_rad"] < POSE_TOL_RAD for c in check.values())

    # a batch axis, not a loop: at B = 1 and at B = 64 exact copies of entry
    # 0 (identical branches) one solve issues the same host syncs, the same
    # aten operations and the same kernel launches outside LIBRARY_OPS
    # (launches: three traced solves each)
    counts = {}
    for B in (1, PAR_BIG):
        batch = stack_tensors(entries[:1] * B)

        def solve(batch=batch):
            return batched.vmap_scan_matching(*batch, tls)

        count_syncs(solve)  # one-time syncs and table copies of the first call
        (_, diag), sites = count_syncs(solve)
        _, ops = count_ops(solve)
        runs = [kernel_launches(solve) for _ in range(3)]
        rounds = int(diag.iterations.max())
        counts[B] = {"rounds": rounds, "host_syncs": sum(sites.values()),
                     "host_syncs_per_round": sum(sites.values()) / rounds, "sync_sites": sites,
                     "aten_ops": sum(ops.values()), "kernel_launches": [r[1] for r in runs],
                     "library_launches": [r[2] for r in runs],
                     "launches_outside_library": [r[1] - r[2] for r in runs],
                     "device_kernel_records": [r[3] for r in runs], "launch_sites": runs[0][4], "ops": ops}
    for key, name in (("ops", "aten_ops_64_minus_1"), ("launch_sites", "launches_by_site_64_minus_1")):
        diff = collections.Counter(counts[PAR_BIG].pop(key))
        diff.subtract(counts[1].pop(key))
        counts[name] = {k: v for k, v in diff.items() if v}
    counts["library_ops"] = sorted(LIBRARY_OPS)
    big = counts[PAR_BIG]
    ok_counts = (counts[1]["host_syncs"] == big["host_syncs"] and not counts["aten_ops_64_minus_1"]
                 and len(set(counts[1]["launches_outside_library"] + big["launches_outside_library"])) == 1)

    # rates, device busy share and peak memory of the batched solve
    rates = {}
    for B, reps in ((8, 3), (PAR_BIG, 2)):
        batch = stack_tensors(sets[B])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            batched.vmap_scan_matching(*batch, tls)
        torch.cuda.synchronize()
        batched_s = (time.perf_counter() - t) / reps
        _, busy_ms, wall_ms, top = profile_frame(lambda: batched.vmap_scan_matching(*batch, tls))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        batched.vmap_scan_matching(*batch, tls)
        torch.cuda.synchronize()
        rates[B] = {"batched_frames_per_s": B / batched_s, "batched_solve_ms": 1e3 * batched_s,
                    "single_loop_frames_per_s": B / single_s[B], "single_solve_ms": 1e3 * single_s[B] / B,
                    "profiled_solve": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                       "idle_share": 1.0 - busy_ms / wall_ms, "top_device_ms": top},
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "solve_peak_mem_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}

    # consensus (the frame-4 entry's scan halves on two ranks of one card)
    # and the frames-sharded batch, in spawned processes
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_parallel"
    workdir.mkdir(parents=True, exist_ok=True)
    ref_pose, ref_diag = singles[8][PAR_CONSENSUS]
    n_planar, n_ground = ref_diag.num_corr[:2].tolist()
    caps = {"planar_maxnum": n_planar // 2, "ground_maxnum": n_ground // 2}
    cap_pose, cap_diag = registration.scan_matching(*entries[PAR_CONSENSUS], dataclasses.replace(tls, **caps))
    cpu = lambda x: x.cpu()  # noqa: E731
    torch.save({"tls": dataclasses.asdict(tls), "caps": caps,
                "consensus": map_tensors(entries[PAR_CONSENSUS], cpu),
                "entries": map_tensors(stack_tensors(entries), cpu)}, workdir / "inputs.pt")
    t = time.perf_counter()
    gloo = spawn_ranks("gloo", 2, workdir)
    nccl = spawn_ranks("nccl", 1, workdir)
    ranks_s = time.perf_counter() - t

    def consensus(out, pose, diag):
        gap_m, gap_rad = pose_gaps(out[0][None].to(dev), pose[None])
        return {"gap_m": gap_m, "gap_rad": gap_rad, "num_corr": out[1].tolist(), "single_num_corr":
                diag.num_corr.tolist(), "rounds": int(out[2]), "single_rounds": int(diag.iterations),
                "ok": gap_m < POSE_TOL_M and gap_rad < POSE_TOL_RAD and out[1].tolist() == diag.num_corr.tolist()}

    cons = {
        "backend": "gloo: NCCL refuses two ranks on one GPU", "ranks": 2,
        "uncapped": [consensus(r["uncapped"], ref_pose, ref_diag) for r in gloo],
        "capped": [consensus(r["capped"], cap_pose, cap_diag) for r in gloo], "caps": caps,
        "caps_bind": cap_diag.num_corr[:2].tolist() == [caps["planar_maxnum"], caps["ground_maxnum"]],
        "nccl_1_rank": consensus(nccl[0]["uncapped"], ref_pose, ref_diag),
    }
    pose8 = batched_out[8][0]
    sharded = [pose_gaps(r["sharded"][0].to(dev), pose8) for r in gloo]
    shard = {"ranks": 2, "frames_each": 4, "backend": "gloo", "gap_m": max(g[0] for g in sharded),
             "gap_rad": max(g[1] for g in sharded)}
    ok_ranks = (all(c["ok"] for c in cons["uncapped"] + cons["capped"]) and cons["caps_bind"]
                and cons["nccl_1_rank"]["ok"] and shard["gap_m"] < POSE_TOL_M and shard["gap_rad"] < POSE_TOL_RAD)
    ok = bool(ok_check and ok_counts and ok_ranks and launches == PAR_FRAMES.stop + len(PAR_FRAMES))
    emit({"phase": "parallel", "entries": {"frames": [PAR_FRAMES.start, PAR_FRAMES.stop - 1], "B": sorted(sets),
                                           "noise_m": PAR_NOISE_M, "noise_seed": PAR_SEED},
          "tolerance": {"m": POSE_TOL_M, "rad": POSE_TOL_RAD}, "batched_vs_single": check, "counts": counts,
          "rates": rates, "consensus": cons, "frames_sharded": shard, "spawned_runs_s": ranks_s,
          "edge_pick_launches": launches, "ok": ok})
    return ok, launches


# phase 9: the command line
CLI_FRAMES = 12
CLI_STOP = 6  # the interrupted run stops here; the resumed run starts here


def cli_call(argv) -> tuple[int, dict | None]:
    """tloam_torch.cli.main(argv) in this process: (return code, the JSON
    line it printed last, if any)."""
    import contextlib
    import io

    from tloam_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def npz_equal(a: Path, b: Path) -> bool:
    with np.load(a, allow_pickle=False) as x, np.load(b, allow_pickle=False) as y:
        return x.files == y.files and all(np.array_equal(x[k], y[k]) for k in x.files)


def run_cli(workdir: Path) -> tuple[bool, int]:
    """Phase 9 (tloam_torch.cli on the card); one JSON line. Returns (ok,
    edge kernel launches)."""
    import torch

    from tloam_torch.cloud import Cloud
    from tloam_torch.io import kitti, pointcloud_io
    from tloam_torch.utils import synthetic

    workdir.mkdir(parents=True, exist_ok=True)
    w = lambda name: str(workdir / name)  # noqa: E731
    t = time.perf_counter()
    launches0 = launch_count("edge_pick.launch")
    # (a) synthetic: uninterrupted with a checkpoint every 6 frames, then a
    # run stopped at frame 6 and one resumed from its checkpoint
    every = ["--checkpoint-every", str(CLI_STOP)]
    rc_a, m_a = cli_call(["run", "--frames", str(CLI_FRAMES), *every, "--checkpoint", w("a.npz"),
                          "--output", w("a.txt"), "--dump-boxes", w("boxes.jsonl")])
    rc_b, _ = cli_call(["run", "--frames", str(CLI_STOP), *every, "--checkpoint", w("b.npz"), "--output", w("b.txt")])
    rc_c, m_c = cli_call(["run", "--frames", str(CLI_FRAMES), "--resume", w("b.npz"), *every,
                          "--checkpoint", w("c.npz"), "--output", w("c.txt")])
    resume = {"trajectory_equal": Path(w("a.txt")).read_bytes() == Path(w("c.txt")).read_bytes(),
              "final_checkpoint_equal": npz_equal(Path(w("a.npz")), Path(w("c.npz"))),
              "metrics_uninterrupted": m_a, "metrics_resumed": m_c}
    boxes = [json.loads(ln)["frame"] for ln in Path(w("boxes.jsonl")).read_text().splitlines()]
    synthetic_s = time.perf_counter() - t

    # (b) the same 12 scans as a KITTI tree (the command line's own synthetic
    # scans), with a camera<->laser extrinsic that is not the identity
    t = time.perf_counter()
    root = workdir / "kitti"
    seq = root / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True, exist_ok=True)
    scene = synthetic.Scene.urban(np.random.default_rng(3))
    gt = synthetic.straight_trajectory(CLI_FRAMES, step=1.0, yaw_rate=0.005)
    for i in range(CLI_FRAMES):
        xyz, inten = synthetic.simulate_scan(gt[i], scene, rings=64, az_steps=1870, rng=np.random.default_rng(i))
        pointcloud_io.write_kitti_bin(seq / "velodyne" / f"{i:06d}.bin", Cloud.from_numpy(xyz, inten, device="cpu"))
    gt[:, 2, 3] += 1.73
    rel = np.linalg.inv(gt[0])[None] @ gt
    Tr = np.eye(4)
    Tr[:3, :3] = [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]  # KITTI's camera axes
    Tr[:3, 3] = [0.27, -0.08, -0.06]
    (seq / "calib.txt").write_text("Tr: " + " ".join(repr(float(v)) for v in Tr[:3, :4].ravel()) + "\n")
    np.savetxt(seq / "00.txt", (Tr @ rel @ np.linalg.inv(Tr))[:, :3, :4].reshape(CLI_FRAMES, 12))
    lib = kitti.native_loader()
    files = sorted((seq / "velodyne").glob("*.bin"))
    readers_equal = lib is not None and all(
        all(np.array_equal(a, b) for a, b in zip(kitti.read_velodyne(f), kitti.read_velodyne_numpy(f)))
        for f in files)
    rc_k, m_k = cli_call(["run", "--data", str(root), "--output", w("k.txt")])
    kitti_s = time.perf_counter() - t
    rc_i, info = cli_call(["info"])
    launches = launch_count("edge_pick.launch") - launches0
    ok = bool(
        rc_a == rc_b == rc_c == rc_k == rc_i == 0 and resume["trajectory_equal"] and resume["final_checkpoint_equal"]
        and boxes == list(range(CLI_FRAMES)) and readers_equal
        and m_a["ate_rmse_m"] < ATE_LIMIT_M and m_k["ate_rmse_m"] < ATE_LIMIT_M and m_k["frames"] == CLI_FRAMES
        and info["cuda_available"] and info["devices"][0] == torch.cuda.get_device_name(0)
        and launches == 2 * CLI_FRAMES + (CLI_FRAMES - CLI_STOP) + CLI_STOP
    )
    emit({"phase": "cli", "frames": CLI_FRAMES, "stop_resume_at": CLI_STOP, "resume": resume,
          "box_lines": len(boxes), "synthetic_runs_s": synthetic_s,
          "kitti": {"metrics": m_k, "native_loader": lib is not None, "native_equals_numpy": readers_equal,
                    "files": len(files), "seconds": kitti_s},
          "info": info, "ate_limit_m": ATE_LIMIT_M, "edge_pick_launches": launches, "ok": ok})
    return ok, launches


# phase 10: the library ops on one full-size scan, card against CPU. Float
# tolerances: positions and distances in metres at the scan's 100 m scale
# (float32 spacing 7.6e-6 m; the devices sum and multiply in other orders),
# colors in [0, 1] (CUDA divides by a scalar through its reciprocal: 1 ulp),
# each window moment and the Mahalanobis distances relative to their
# largest value, the RANSAC plane's (n, d). A normal is the eigenvector of
# its neighbourhood's smallest eigenvalue, which a rounding of the
# covariance turns by about rounding / (lam1 - lam0): normals are held to
# normal_cos (1 - |cos|) where lam1 - lam0 > normal_gap * lam2, and the
# points below that gap (ring arcs, lines: no stable normal, ROADMAP §C)
# are counted apart.
LIBRARY_TOL = {"m": 1e-4, "color": 1e-6, "rel": 1e-4, "plane": 1e-4, "normal_cos": 1e-3, "normal_gap": 3e-3}


def _cmp(a, b, tol=None, rel=False) -> dict:
    """Card output a against CPU output b: equal for integers and masks (or
    tol None), else the largest difference over the finite entries against
    tol (relative to b's largest with rel); inf must lie at the same
    entries."""
    import torch

    a, b = a.cpu(), b.cpu()
    if tol is None or not a.is_floating_point():
        n = int((a != b).sum())
        return {"differ": n, "ok": n == 0}
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    same_inf = bool(torch.equal(fa, fb) and torch.equal(a[~fa], b[~fb]))
    err = float((a[fa] - b[fb]).abs().max()) if bool(fa.any()) else 0.0
    lim = tol * (float(b[fb].abs().max()) if rel and bool(fb.any()) else 1.0)
    return {"max_abs_err": err, "tol": lim, "ok": same_inf and err <= lim}


def _cmp_normals(a, b, x) -> dict:
    """Normals of the card (a) and the CPU (b) on the host cloud x["c"]:
    held to normal_cos where the neighbourhood's eigenvalue gap is above
    normal_gap (float64 eigenvalues of the CPU covariance)."""
    import torch

    from tloam_torch.ops import eig3, voxel

    c = x["c"]
    grid = voxel.build_hash_grid(c.xyz, c.valid, 0.5)
    idx, _, ok = voxel.query_knn(grid, c.xyz, c.valid, k=16, radius=0.5, max_per_cell=16)
    lam = torch.linalg.eigvalsh(eig3._masked_cov(c.xyz[idx], ok)[1].double())
    posed = (lam[:, 1] - lam[:, 0] > LIBRARY_TOL["normal_gap"] * lam[:, 2]) & c.valid
    off = 1.0 - (a.normals.cpu() * b.normals).sum(-1).abs()
    beyond = off > LIBRARY_TOL["normal_cos"]
    return {"well_posed": int(posed.sum()), "max_1_minus_cos_well_posed": float(off[posed].max()),
            "differ_beyond_tol_well_posed": int((beyond & posed).sum()),
            "differ_beyond_tol_below_gap": int((beyond & c.valid & ~posed).sum()),
            "cause_below_gap": "lam1 - lam0 <= normal_gap * lam2: a ring arc or a line has no stable normal",
            "ok": not bool((beyond & posed).any())}


def library_cases():
    """{name: (fn(inputs) -> outputs, compare(card, cpu, host inputs) ->
    [check])} of phase 10; `inputs` holds the scan "c", the next scan "c2", a uniform
    draw "u", RANSAC triples "tri", normals "n", a depth image "depth",
    colors "color" and voxel cells "cells", all on one device."""
    import dataclasses

    import torch

    from tloam_torch.ops import cloud_ops as co, factories, voxel

    T = LIBRARY_TOL
    intr = (525.0, 525.0, 319.5, 239.5)
    exact = lambda a, b, x: [_cmp(a, b)]  # noqa: E731

    def table(x):
        t = voxel.build_cell_table(x["c"].xyz, x["c"].valid, 0.5, 65536)
        nb = voxel.cell_neighbor_index(t)
        anchors, mom = voxel.anchored_window_moments(x["c"].xyz, x["c"].valid, t, nb, 0.5)
        return t, nb, torch.stack(anchors), torch.stack(mom)

    def records(x):
        cols = x["c"].xyz.T.contiguous()
        packed = voxel.pack_records(cols, 16)
        idx = torch.arange(0, cols.shape[1], 7, device=cols.device)
        bt = voxel.build_block_table(x["c"].xyz, x["c"].valid, 0.5, 65536)
        store = voxel.scatter_cell_records(bt, torch.ones((65536, 10), device=cols.device))
        rows, found = voxel.block_window_probe_rows(bt, bt.cx, bt.cy, bt.cz)
        return (packed, voxel.unpack_records(packed, 3, 16), voxel.gather_records(packed, idx, 16, 3),
                voxel.block_window_records(store, rows, found))

    return {
        "uniform_downsample": (lambda x: co.uniform_downsample(x["c"], 5).valid, exact),
        "random_downsample_count": (lambda x: co._keep_count_from_uniform(x["u"], x["c"].valid, 20000), exact),
        "voxel_downsample_and_trace": (
            lambda x: co.voxel_downsample_and_trace(x["c"], 0.5, 65536),
            lambda a, b, x: [_cmp(a[1], b[1]), _cmp(a[0].valid, b[0].valid), _cmp(a[0].xyz, b[0].xyz, T["m"])]),
        "remove_radius_outliers": (lambda x: co.remove_radius_outliers(x["c"], 8, 0.5).valid, exact),
        "remove_statistical_outliers": (lambda x: co.remove_statistical_outliers(x["c"], 20, 2.0).valid, exact),
        "estimate_normals": (lambda x: co.estimate_normals(x["c"], radius=0.5, max_nn=16),
                             lambda a, b, x: [_cmp_normals(a, b, x)]),
        "orient_normals_towards": (lambda x: co.orient_normals_towards(
            dataclasses.replace(x["c"], normals=x["n"]), torch.zeros(3, device=x["n"].device)).normals, exact),
        "cluster_dbscan": (lambda x: co.cluster_dbscan(x["c"], eps=0.5, min_points=10), exact),
        "segment_plane_ransac": (lambda x: co._ransac_from_triples(x["c"], x["tri"], 0.05),
                                 lambda a, b, x: [_cmp(a[1], b[1]), _cmp(a[0], b[0], T["plane"])]),
        "point_cloud_distance": (lambda x: co.point_cloud_distance(x["c2"], x["c"], radius=2.0),
                                 lambda a, b, x: [_cmp(a, b, T["m"])]),
        "nearest_neighbor_distance": (lambda x: co.nearest_neighbor_distance(x["c"], radius=2.0),
                                      lambda a, b, x: [_cmp(a, b, T["m"])]),
        "mahalanobis_distance": (lambda x: co.mahalanobis_distance(x["c"]),
                                 lambda a, b, x: [_cmp(a, b, T["rel"], rel=True)]),
        "cloud_from_depth_image": (lambda x: factories.cloud_from_depth_image(x["depth"], intr),
                                   lambda a, b, x: [_cmp(a.valid, b.valid), _cmp(a.xyz, b.xyz, T["m"])]),
        "cloud_from_rgbd": (lambda x: factories.cloud_from_rgbd(x["depth"], x["color"], intr),
                            lambda a, b, x: [_cmp(a.valid, b.valid), _cmp(a.xyz, b.xyz, T["m"]),
                                             _cmp(a.colors, b.colors, T["color"])]),
        "cloud_from_voxel_grid": (lambda x: factories.cloud_from_voxel_grid(x["cells"], 0.5, x["c"].xyz[0]),
                                  lambda a, b, x: [_cmp(a.xyz, b.xyz, T["m"])]),
        "cell_table_and_anchored_moments": (table, lambda a, b, x: [
            *(_cmp(getattr(a[0], f), getattr(b[0], f)) for f in ("cx", "cy", "cz", "cell_valid", "point_cell")),
            _cmp(a[1], b[1]), _cmp(a[2], b[2], 0.0), *(_cmp(x, y, T["rel"], rel=True) for x, y in zip(a[3], b[3]))]),
        "records": (records, lambda a, b, x: [_cmp(p, r, 0.0) for p, r in zip(a, b)]),
    }


LIBRARY_REPS = 5


def run_library(scans) -> bool:
    """Phase 10; one JSON line. Inputs: scans 0 and 1 of the bench drive
    (64 x 1870, capacity 131072) and draws made on the CPU, moved to the
    card: the same inputs on both sides."""
    import torch

    from tloam_torch.cloud import Cloud, map_tensors
    from tloam_torch.ops import cloud_ops as co

    (q0, n0), (q1, n1) = scans[0], scans[1]
    g = torch.Generator().manual_seed(0)
    c = Cloud.from_packed(torch.from_numpy(q0), n0)
    host = {
        "c": c,
        "c2": Cloud.from_packed(torch.from_numpy(q1), n1),
        "u": torch.rand(c.capacity, generator=g),
        "tri": torch.multinomial(c.valid.float(), 256 * 3, replacement=True, generator=g).view(256, 3),
        "depth": torch.rand((480, 640), generator=g) * 9.0 - 0.5,  # some pixels <= 0: invalid
        "color": torch.randint(0, 256, (480, 640, 3), generator=g, dtype=torch.uint8),
        "cells": torch.floor(c.xyz[:4096] / 0.5).to(torch.int32),
        "n": co.estimate_normals(c, radius=0.5, max_nn=16).normals,
    }
    dev = {k: map_tensors(v, lambda t: t.cuda()) for k, v in host.items()}
    t0 = time.perf_counter()
    results, ok = {}, True
    for name, (fn, compare) in library_cases().items():
        card = fn(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cpu = fn(host)
        cpu_s = time.perf_counter() - t
        checks = compare(card, cpu, host)
        ok_op = all(ch["ok"] for ch in checks)
        ok = ok and ok_op
        results[name] = {"ms": cuda_ms(lambda: fn(dev), LIBRARY_REPS), "cpu_s": cpu_s, "checks": checks, "ok": ok_op}
    emit({"phase": "library", "points": int(n0), "capacity": c.capacity, "tolerance": LIBRARY_TOL,
          "ms_from": f"CUDA events over {LIBRARY_REPS} calls after one", "ops": results,
          "seconds": time.perf_counter() - t0, "ok": ok})
    return ok


def run_town() -> tuple[bool, int]:
    """Phase 11: the first TOWN_FRAMES frames of the route-c hard-town drive
    through drives.hard_town_drive on the card, the raycasts spread over
    the machine's cores first (a fresh cache in build/, so the raycast time
    is measured every run); one JSON line. Returns (ok, edge launches)."""
    import os
    import shutil

    from tloam_torch.config import PipelineConfig
    from tloam_torch.utils import drives

    cache = Path(__file__).resolve().parent / "build" / "chip_smoke_town"
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["TLOAM_SCAN_CACHE"] = str(cache)
    workers = os.cpu_count() or 1
    raycast_s = drives.fill_scan_cache(TOWN_FRAMES, workers, **TOWN_DRIVE)
    launches0 = launch_count("edge_pick.launch")
    est, rel, info = drives.hard_town_drive(PipelineConfig(), frames=TOWN_FRAMES, collect_diags=True, **TOWN_DRIVE)
    launches = launch_count("edge_pick.launch") - launches0
    drift = np.linalg.norm(est[:, :3, 3] - rel[:, :3, 3], axis=1)
    from tloam_torch.utils import trajectory

    got = {"ate_m": float(trajectory.ate_rmse(rel, est)), "final_drift_m": float(drift[-1]),
           "max_drift_m": float(drift.max())}
    limits = headroom_limits(JAX_TOWN_REF)
    corr_min = np.stack([d.num_corr for d in info["diags"][1:]]).min(axis=0).tolist()
    # the sphere family starves on some frames in the JAX run too (JAX_TOWN_REF)
    ok = bool(np.isfinite(est).all() and launches == TOWN_FRAMES and info["degenerate_frames"] == 0
              and all(got[k] < v for k, v in limits.items()) and min(corr_min[:3]) > 0)
    emit({"phase": "town", "frames": TOWN_FRAMES, **TOWN_DRIVE, "raycast_s": raycast_s, "raycast_workers": workers,
          "drive_s": info["wall_s"], "frames_per_s": TOWN_FRAMES / info["wall_s"], **got, "limits": limits,
          "jax_ref": JAX_TOWN_REF, "degenerate_frames": info["degenerate_frames"],
          "corr_min_planar_ground_edge_sphere": corr_min, "drift_m": [round(float(x), 4) for x in drift],
          "edge_pick_launches": launches, "ok": ok})
    return ok, launches


# phase 12: the measurement entry points (scripts/torch_*.py) at reduced sizes
HARNESS_BATCH = 128
HARNESS_SWEEP_FRAMES = 10


def run_harness(bench_gt, bench_scans, factor3_est) -> tuple[bool, int]:
    """Phase 12: each script's entry point on the card, small: the solver
    bench on 4 frames; the batched bench at B = HARNESS_BATCH in default
    and factor3 (the first 64 entries and the modes' 64 held to one-frame
    solves); the mode matrix's run_mode for factor3 on phase 4's bench
    drive, held to headroom_limits over JAX_REF and set beside phase 6's
    factor3 drive of the same scans; one sweep run of
    HARNESS_SWEEP_FRAMES frames (route a, world 3), raycast into a fresh
    cache. One JSON line. Returns (ok, edge kernel launches)."""
    import os
    import shutil


    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_harness"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    os.environ["TLOAM_SCAN_CACHE"] = str(work / "scan_cache")
    script = lambda name: load_by_path(root / "scripts" / f"{name}.py")  # noqa: E731
    workers = str(os.cpu_count() or 1)
    seconds = {}
    launches0 = launch_count("edge_pick.launch")

    t = time.perf_counter()
    solver = script("torch_solver_bench").main(["--frames", "4", "--reps", "2", "--out", str(work / "gniters.json")])
    seconds["solver_bench"] = time.perf_counter() - t
    ok_solver = bool(np.isfinite([solver["value"], solver["solves_per_s"], solver["mean_outer_iters"]]).all()
                     and solver["n_solves_timed"] == 8)

    t = time.perf_counter()
    bat = script("torch_batched_bench").main(["--batch", str(HARNESS_BATCH), "--n", "2", "--modes", "default,factor3",
                                              "--workers", workers, "--out", str(work / "batched.json")])
    seconds["batched_bench"] = time.perf_counter() - t
    ok_batched = bool(bat["ok"] and set(bat["modes"]) == {"default", "factor3"})

    t = time.perf_counter()
    modes = script("torch_modes_bench")
    f3 = modes.run_mode(modes.MODES["factor3"], bench_scans, sensor_rel(bench_gt), 2)
    seconds["modes_bench_factor3"] = time.perf_counter() - t
    limits = headroom_limits(JAX_REF["factor3"][0])
    # final_pose_t is rounded to 0.1 mm, as the JAX script rounds it
    phase6_t = factor3_est[-1, :3, 3].astype(np.float64).round(4)
    f3_est_gap_m = float(np.abs(np.asarray(f3["final_pose_t"]) - phase6_t).max())
    ok_modes = bool(np.isfinite(f3["ate_rmse_m"]) and f3["ate_rmse_m"] < limits["ate_m"]
                    and f3["max_drift_m"] < limits["max_drift_m"] and f3["corr_last"][3] == 0)

    t = time.perf_counter()
    sw = script("torch_sweep").main(["--frames", str(HARNESS_SWEEP_FRAMES), "--seeds", "1", "--routes", "a",
                                     "--workers", workers, "--out", str(work / "sweep.json")])
    seconds["sweep"] = time.perf_counter() - t
    run = sw["runs"][0]
    ok_sweep = bool(sw["n_runs"] == 1 and run["finite"] and run["degenerate_frames"] == 0
                    and np.isfinite([run["ate_rmse_m"], run["max_drift_m"]]).all())

    launches = launch_count("edge_pick.launch") - launches0
    # one a frame: the solver bench's 5 frames and 4 captures, the batched
    # bench's 4 frames and 1 capture, the bench drive, the sweep run
    expected = (1 + 2 * 4) + (4 + 1) + len(bench_scans) + HARNESS_SWEEP_FRAMES
    ok = ok_solver and ok_batched and ok_modes and ok_sweep and launches == expected
    emit({"phase": "harness", "seconds": seconds,
          "solver_bench": {k: solver[k] for k in ("value", "solves_per_s", "mean_outer_iters", "inner_iterations",
                                                   "first_call_s", "host_syncs_per_solve", "n_solves_timed")},
          "batched_bench": {"batches": bat["batches"], "modes": bat["modes"],
                            "single_frames_per_s": bat["single_frames_per_s"]},
          "modes_bench_factor3": {**f3, "limits": limits, "jax_ref": JAX_REF["factor3"][0],
                                  "final_pose_gap_to_phase_6_m": f3_est_gap_m},
          "sweep_run": {k: run[k] for k in ("route", "world_seed", "ate_rmse_m", "final_drift_m", "max_drift_m",
                                            "degenerate_frames", "raycast_s", "drive_frames_per_s")},
          "edge_pick_launches": launches, "expected_launches": expected,
          "checks": {"solver": ok_solver, "batched": ok_batched, "modes": ok_modes, "sweep": ok_sweep},
          "ok": ok})
    return ok, launches


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=5, metavar=("JOB", "ADDR", "WORLD", "RANK", "DIR"),
                    help="run one rank of the parallel phase's spawned runs (used by the script itself)")
    args = ap.parse_args()
    if args.worker:
        job, addr, world, rank, workdir = args.worker
        return parallel_worker(job, addr, int(world), int(rank), workdir)

    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    from tloam_torch import build
    from tloam_torch.cloud import Cloud
    from tloam_torch.config import PipelineConfig
    from tloam_torch.models import edge
    from tloam_torch.pipeline import frontend

    dev = torch.device("cuda")
    cfg = PipelineConfig()

    # ---- 2. build (always from the sources of this checkout) ----
    t0 = time.time()
    libraries = build.KERNELS + build.HOST_LIBRARIES  # the kernels and the native KITTI loader, built at once
    for name in libraries:
        build.library_path(name).unlink(missing_ok=True)
    logs = build.build(libraries, verbose=True)
    ptxas = {k: [ln.strip() for ln in logs[k].splitlines() if "registers" in ln or "smem" in ln] for k in build.KERNELS}
    emit({"phase": "build", "seconds": round(time.time() - t0, 2), "kernels": list(build.KERNELS),
          "host_libraries": list(build.HOST_LIBRARIES), "ptxas": ptxas})

    # ---- 3. kernel_check ----
    kw = dict(num_sectors=6, picks_per_sector=20, curv_thres=0.1, suppress_gap_sq=0.05,
              ring_min_num=cfg.ground.ring_min_num)
    R, W = cfg.sensor.sensor_model, cfg.edge_ring_width

    def compare(planes, kw=kw, reps=None):
        """The edge kernel's case at these planes; each input read once (x,
        y, z, valid f32 and the ring lengths int32), each output written
        once (edge, picked u8 and curvature f32); the geometry about 50 f32
        operations an element (33 tap adds, 3 + 5 curvature, 8 gap, 1
        compare), each round about 3 compares."""
        r, w = planes[0].shape
        rec, (e, picked, _) = kernel_case(
            "edge_pick", lambda: edge._pick_rounds_cuda(*planes, **kw), lambda: edge._pick_rounds_plain(*planes, **kw),
            r * w * 22 + r * 4, r * w * (50 + 3 * kw["picks_per_sector"]), reps)
        return {**rec, "edges": int(e.sum()), "picked": int(picked.sum())}

    rng = np.random.default_rng(0)
    rand = compare([torch.from_numpy(a).to(dev) for a in random_rings(rng, R, W, kw["ring_min_num"])])

    # the card tests' sweep: every mapping of sectors to warps (settings of
    # num_sectors and picks), at a width that is no multiple of 32 and at
    # one that needs more than 48 KB of shared memory; 16 rows each put
    # picks within 5 columns of the sector boundaries
    card_tests = load_by_path(Path(__file__).resolve().parent / "tests" / "test_torch_cuda.py")
    sweep = [{"W": width, "num_sectors": ns, "picks": picks,
              **compare(card_tests.rings(dev, width=width, num_sectors=ns),
                        dict(kw, num_sectors=ns, picks_per_sector=picks))}
             for width in (2304, 4096, 1000) for ns, picks in card_tests.SETTINGS]
    same_s = all(s["bit_identical"] and s["edges"] > 0 for s in sweep)
    smem = {w: build.load("edge_pick").tloam_edge_pick_smem_bytes(w) for w in (1000, W, 4096)}

    gt, scans = drive_scans("bench", N_FRAMES)
    q0 = torch.as_tensor(scans[0][0]).to(dev)
    _, objects, obj_ring, clusters = frontend.segment_objects(Cloud.from_packed(q0, scans[0][1]), cfg)
    d = edge.dense_rings(clusters.segmented, obj_ring, frontend.edge_order_key(clusters, objects.capacity),
                         R, kw["ring_min_num"], W)
    frame = compare([d.dx, d.dy, d.dz, d.dval, d.ring_len], reps=(200, 20, 5))
    ok_k = rand["bit_identical"] and frame["bit_identical"] and same_s and frame["edges"] > 0 and rand["edges"] > 0
    emit({"phase": "kernel_check", "kernel": "edge_pick", "shape": [R, W], "random": rand, "frame": frame,
          "sweep": sweep, "dynamic_smem_bytes": smem, "ok": ok_k})
    if not ok_k:
        return 1

    # ---- 3b. window_moments ----
    clouds = [Cloud.from_packed(torch.as_tensor(q).to(dev), m) for q, m in scans]
    ok_w, window = window_moments_check(clouds)
    if not ok_w:
        return 1
    ground = window[2]

    # ---- 3c. knn ----
    ok_knn, knn = knn_check(clouds)
    del clouds
    if not ok_knn:
        return 1
    cov = knn[0]

    # ---- 4. drive ----
    d = run_drive(cfg, scans)
    launches = d["launches"]
    per_frame = d["window_launches_frame"]
    est = d["est"]
    ate, drift_f = drive_errors(est, gt)
    drift = float(drift_f.max())
    # the window-moment kernel: the front end's cell PCA every frame, and
    # from the second frame on each cell table of the solve (edge, planar,
    # ground, and the coarse planar grid where a frame asks for it)
    ok_w = per_frame[0] >= 1 and min(per_frame[1:]) >= 4 and sum(per_frame) == d["window_launches"]
    # the kNN kernel: the sphere family's 1-NN in every round of every solve
    knn_frame = d["knn_launches_frame"]
    ok_kf = min(knn_frame[1:]) >= 1 and sum(knn_frame) == d["knn_launches"]
    ok_d = (
        ok_w and ok_kf and launches == N_FRAMES and np.isfinite(est).all() and est.shape == (N_FRAMES, 4, 4)
        and ate < ATE_LIMIT_M and drift < DRIFT_LIMIT_M and min(d["corr_min"]) > 0
    )
    emit({"phase": "drive", "frames": N_FRAMES, "frames_per_s": d["frames_per_s"],
          "frame_ms_mean": d["frame_ms_mean"], "frame_ms_max": d["frame_ms_max"],
          "stage_ms_mean": d["stages"], "ate_m": ate, "max_drift_m": drift,
          "corr_min_planar_ground_edge_sphere": d["corr_min"],
          "clusters_min_max": [min(d["clusters"]), max(d["clusters"])],
          "edge_pick_launches": launches, "window_moments_launches": d["window_launches"],
          "window_moments_launches_frame": per_frame, "knn_launches": d["knn_launches"],
          "knn_launches_frame": knn_frame, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "host_syncs_frame": d["host_syncs_frame"], "profiled_frame": d["profiled_frame"],
          "ok": bool(ok_d)})
    if not ok_d:
        return 1

    # ---- 5. canary ----
    ok_c, canary_launches = canary(dev)
    if not ok_c:
        return 1
    launches += canary_launches

    # ---- 6. modes ----
    mode_est = {}
    for mode in MODES:
        ok_m, mode_launches, mode_est[mode] = run_mode(mode, gt, scans)
        launches += mode_launches
        if not ok_m:
            return 1

    # ---- 7. parallel ----
    ok_p, par_launches = run_parallel(cfg, scans)
    launches += par_launches
    if not ok_p:
        return 1

    # ---- 9. cli ----
    ok_cli, cli_launches = run_cli(Path(__file__).resolve().parent / "build" / "chip_smoke_cli")
    launches += cli_launches
    if not ok_cli:
        return 1

    # ---- 10. library ----
    if not run_library(scans):
        return 1

    # ---- 11. town ----
    ok_t, town_launches = run_town()
    launches += town_launches
    if not ok_t:
        return 1

    # ---- 12. harness ----
    ok_h, harness_launches = run_harness(gt, scans, mode_est["factor3"])
    launches += harness_launches
    if not ok_h:
        return 1

    # ---- 8. kernels ----
    emit({"kernels": [{
        "name": "edge_pick", "route": "cuda", "source": "tloam_torch/csrc/edge_pick.cu",
        "replaces": "tloam_tpu/models/edge.py:166", "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in (rand, frame, *sweep)), "ms": frame["ms"],
        "kernel_ms": frame["kernel_ms"], "plain_ms": frame["plain_ms"], "bound_ms": frame["bound_ms"],
        "bound_by": frame["bound_by"], "library_ms": None, "match": ok_k,
    }, {
        "name": "window_moments", "route": "cuda", "source": "tloam_torch/csrc/window_moments.cu",
        "replaces": None, "shape": [ground["frames"], ground["slots"]],
        "launches": d["window_launches"], "ms": ground["ms"],
        "kernel_ms": ground["kernel_ms"], "plain_ms": ground["plain_ms"], "bound_ms": ground["bound_ms"],
        "bound_by": "bytes", "library_ms": ground["index_put_kernel_ms"], "match": ok_w,
    }, {
        "name": "knn_window", "route": "cuda", "source": "tloam_torch/csrc/knn_window.cu",
        "replaces": None, "shape": [cov["frames"], cov["slots"], cov["k"]],
        "launches": d["knn_launches"], "ms": cov["ms"], "kernel_ms": cov["kernel_ms"],
        "plain_ms": cov["plain_ms"], "bound_ms": cov["bound_ms"], "bound_by": "bytes",
        "library_ms": cov["plain_sort_kernel_ms"], "match": all(r["bit_identical"] for r in knn) and ok_kf,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
