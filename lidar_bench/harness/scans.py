"""The drives' scans: a frozen copy of the port's raycaster, and a cache.

``Scene``, ``simulate_scan`` and ``straight_trajectory`` are copied from
``tloam_torch/utils/synthetic.py`` (itself a copy of the JAX package's
raycaster) and must not follow later edits there: the scans are the
benchmark's inputs. ``drive_scans`` raycasts a traffic mix's drive from
the seed, in spawned processes, and keeps the scans in a cache directory
inside the checkout (a run's is ``lidar_bench/.scan_cache/``, git-ignored),
keyed by the drive's parameters and the seed, so a seed's later runs load
them. ``seeded_noise`` adds a run's sensor noise to a drive cast without
any, so that a traffic mix can fix its drive and let the seed pick the
noise alone.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
from pathlib import Path

import numpy as np

@dataclasses.dataclass
class Scene:
    """Axis-aligned urban toy world. Ground is the z=0 plane."""

    # walls: (axis, coord, lo0, hi0, z_lo, z_hi); axis 0 => plane x=coord
    # spanning y in [lo0, hi0], else plane y=coord spanning x.
    walls: list
    # poles: (cx, cy, radius, z_hi)
    poles: list
    # bushes: (cx, cy, cz, radius) — volumetric scatterers (vegetation):
    # rays intersecting the sphere return at a random depth inside it with
    # probability ~0.6. These produce the isotropic high-cvr neighborhoods
    # that classify as SPHERE features (the reference's cvr>0.15 gate,
    # feature_extract.cpp:151-163); KITTI streets are full of them.
    bushes: list = dataclasses.field(default_factory=list)
    # static AABBs (parked cars, dumpsters): (xmin,ymin,zmin,xmax,ymax,zmax).
    # KITTI streets are lined with parked cars; they are the dominant source
    # of ALONG-street structure (wall fronts only constrain the cross-street
    # direction), without which a street-following drive is longitudinally
    # unobservable near intersection wall gaps (measured: 0.9 m/frame
    # startup loss on the town route before these existed).
    boxes: list = dataclasses.field(default_factory=list)

    @staticmethod
    def urban(rng: np.random.Generator | None = None, extent: float = 60.0) -> "Scene":
        rng = rng or np.random.default_rng(0)
        walls = []
        # building fronts parallel to the street (x axis)
        for y in (-8.0, 8.0):
            x0 = -extent
            while x0 < extent:
                seg = rng.uniform(8, 20)
                if rng.uniform() < 0.8:
                    walls.append((1, y + rng.uniform(-1, 1), x0, x0 + seg, 0.0, rng.uniform(3, 8)))
                x0 += seg + rng.uniform(0, 4)
        # cross walls flanking the lane (longitudinal structure). They stop
        # short of the driving corridor |y| < 3: the original versions
        # spanned y in [-8..-4, 4..8] THROUGH y=0, so any trajectory down
        # the street drove *through* them — an unphysical instantaneous
        # 100%-view flip no real drive produces (the sensor teleports
        # through a solid wall). Real occlusion events are covered by
        # simulate_scan's dropout_sectors / moving cars instead.
        for _ in range(6):
            x = rng.uniform(-extent, extent)
            walls.append((0, x, rng.uniform(-8, -6), rng.uniform(-4, -3), 0.0, rng.uniform(2, 5)))
            walls.append((0, x + rng.uniform(-2, 2), rng.uniform(3, 4), rng.uniform(6, 8), 0.0, rng.uniform(2, 5)))
        poles = [
            (rng.uniform(-extent, extent), rng.uniform(-7, 7) * rng.choice([1]), 0.15, rng.uniform(2.5, 5.0))
            for _ in range(40)
        ]
        # hedges hugging the building fronts (so sphere features land within
        # the 0.45 m match gate of planar wall points — the reference's
        # sphere submap IS the planar deque, front_end.cpp:221-229)
        bushes = []
        for axis, coord, lo0, hi0, _, _ in walls:
            # hedge rows on ~80% of street-front walls (0.5 starved the
            # sphere family to 0 correspondences on some bench frames —
            # KITTI streets have near-continuous vegetation/clutter rows)
            if axis != 1 or rng.uniform() > 0.8:
                continue
            x0 = lo0
            while x0 < hi0:
                r = rng.uniform(0.4, 0.9)
                side = -1.0 if coord > 0 else 1.0
                bushes.append(
                    (x0 + r, coord + side * r * 0.7, r * 0.9, r)
                )
                x0 += 2 * r + rng.uniform(0.5, 3.5)
        return Scene(walls, poles, bushes)


def simulate_scan(
    pose: np.ndarray,
    scene: Scene,
    rings: int = 32,
    az_steps: int = 1024,
    sensor_height: float = 1.73,
    min_elev_deg: float = -24.9,
    max_elev_deg: float = 2.0,
    min_range: float = 1.0,
    max_range: float = 80.0,
    noise: float = 0.01,
    rng: np.random.Generator | None = None,
    boxes: list | None = None,
    dropout_sectors: list | None = None,
    ring_stagger: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Cast one scan from `pose` (sensor->world, sensor at z=+sensor_height
    above its local ground contact). Returns (xyz (N,3) sensor frame,
    intensity (N,)) for hit rays only, ring-major azimuth-ordered.

    KITTI-realism knobs (VERDICT r2 next #9):
      boxes: per-FRAME dynamic obstacles (moving cars/trucks), each an AABB
        (xmin, ymin, zmin, xmax, ymax, zmax) in WORLD coordinates at this
        frame's timestamp — they both add non-static returns (which violate
        the rigid-world assumption the solver makes, like real traffic does)
        and occlude static structure behind them.
      dropout_sectors: list of (az_lo, az_hi) SENSOR-frame azimuth intervals
        (radians, in [0, 2pi), lo<hi) where returns drop with p=0.9 —
        occlusion dropouts from close passers-by / self-occlusion.
      ring_stagger: HDL-64 lasers are fired in a time-staggered order, so
        each ring's azimuth grid is phase-shifted; stagger offsets ring r's
        azimuths by (r % 4) * ring_stagger radians (0 = idealized grid).
    """
    rng = rng or np.random.default_rng(0)
    R, t = pose[:3, :3], pose[:3, 3]
    origin = t + np.array([0.0, 0.0, sensor_height])

    elevs = np.radians(np.linspace(min_elev_deg, max_elev_deg, rings))
    azims = np.linspace(0, 2 * np.pi, az_steps, endpoint=False)
    el, az = np.meshgrid(elevs, azims, indexing="ij")  # ring-major
    if ring_stagger:
        az = az + ((np.arange(rings) % 4) * ring_stagger)[:, None]
    dirs_s = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1
    ).reshape(-1, 3)
    dirs_w = dirs_s @ R.T

    tmin = np.full(dirs_w.shape[0], np.inf)

    # ground plane z=0
    dz = dirs_w[:, 2]
    tg = np.where(dz < -1e-9, -origin[2] / np.where(dz < -1e-9, dz, -1.0), np.inf)
    tmin = np.minimum(tmin, np.where(tg > 0, tg, np.inf))

    # walls
    for axis, coord, lo0, hi0, z_lo, z_hi in scene.walls:
        d = dirs_w[:, axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            tw = (coord - origin[axis]) / d
        hit = np.isfinite(tw) & (tw > 0)
        tw = np.where(hit, tw, 0.0)
        p = origin[None, :] + tw[:, None] * dirs_w
        other = 1 - axis
        hit &= (p[:, other] >= lo0) & (p[:, other] <= hi0)
        hit &= (p[:, 2] >= z_lo) & (p[:, 2] <= z_hi)
        tmin = np.minimum(tmin, np.where(hit, tw, np.inf))

    # bushes: volumetric scatter — ray hits the sphere with p=0.6 and
    # returns at a random depth inside [t_in, t_out]
    for cx, cy, cz, rad in scene.bushes:
        oc = origin - np.array([cx, cy, cz])
        b = 2 * (dirs_w @ oc)
        c = oc @ oc - rad * rad
        disc = b * b - 4 * c  # a == 1 (unit directions)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_in = (-b - sq) / 2
        t_out = (-b + sq) / 2
        hit = (disc > 0) & (t_out > 0) & (rng.uniform(size=b.shape) < 0.6)
        t_in = np.maximum(t_in, 0.0)
        tb = t_in + rng.uniform(size=b.shape) * (t_out - t_in)
        tmin = np.minimum(tmin, np.where(hit, tb, np.inf))

    # AABB obstacles — static scene boxes (parked cars) + per-frame dynamic
    # ones (moving traffic): slab-method ray/box intersection
    for box in list(scene.boxes) + list(boxes or ()):
        lo = np.asarray(box[:3], float)
        hi = np.asarray(box[3:], float)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs_w
        t1 = (lo[None, :] - origin[None, :]) * inv
        t2 = (hi[None, :] - origin[None, :]) * inv
        t_near = np.max(np.minimum(t1, t2), axis=1)
        t_far = np.min(np.maximum(t1, t2), axis=1)
        hit = (t_far >= np.maximum(t_near, 0.0)) & (t_near > 0)
        tmin = np.minimum(tmin, np.where(hit, t_near, np.inf))

    # poles (infinite cylinder capped at z_hi)
    for cx, cy, rad, z_hi in scene.poles:
        ox, oy = origin[0] - cx, origin[1] - cy
        dx, dy = dirs_w[:, 0], dirs_w[:, 1]
        a = dx * dx + dy * dy
        b = 2 * (ox * dx + oy * dy)
        c = ox * ox + oy * oy - rad * rad
        disc = b * b - 4 * a * c
        with np.errstate(divide="ignore", invalid="ignore"):
            tq = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
        hit = (disc > 0) & (tq > 0)
        z = origin[2] + tq * dirs_w[:, 2]
        hit &= (z >= 0.0) & (z <= z_hi)
        tmin = np.minimum(tmin, np.where(hit, tq, np.inf))

    hit_mask = np.isfinite(tmin) & (tmin >= min_range) & (tmin <= max_range)
    if dropout_sectors:
        az_flat = np.mod(az.reshape(-1), 2 * np.pi)
        for lo_a, hi_a in dropout_sectors:
            in_sector = (az_flat >= lo_a) & (az_flat < hi_a)
            drop = in_sector & (rng.uniform(size=az_flat.shape) < 0.9)
            hit_mask &= ~drop
    tmin = np.where(hit_mask, tmin, 0.0)
    pts_w = origin[None, :] + tmin[:, None] * dirs_w
    if noise > 0:
        pts_w = pts_w + rng.normal(size=pts_w.shape) * noise
    # back to sensor frame (sensor origin at `origin`, orientation R)
    pts_s = (pts_w - origin[None, :]) @ R
    xyz = pts_s[hit_mask].astype(np.float32)
    inten = np.full(xyz.shape[0], 0.5, np.float32)
    return xyz, inten


def straight_trajectory(n_frames: int, step: float = 0.8, yaw_rate: float = 0.01):
    """Ground-truth sensor poses: forward motion with mild yaw."""
    poses = []
    x, y, yaw = 0.0, 0.0, 0.0
    for _ in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T[0, 3], T[1, 3] = x, y
        poses.append(T)
        x += step * c
        y += step * s
        yaw += yaw_rate
    return np.stack(poses)


def scene_for(drive: dict, seed: int) -> Scene:
    if drive["scene"] != "urban":
        raise ValueError(f"unknown scene {drive['scene']!r}")
    return Scene.urban(np.random.default_rng([seed, 0]), extent=float(drive["extent"]))


def ground_truth(drive: dict) -> np.ndarray:
    """(frames, 4, 4) sensor poses of the drive (the same for every seed)."""
    if drive["trajectory"] != "straight":
        raise ValueError(f"unknown trajectory {drive['trajectory']!r}")
    return straight_trajectory(int(drive["frames"]), step=float(drive["step"]), yaw_rate=float(drive["yaw_rate"]))


def _cast(drive: dict, sensor: dict, seed: int, frames: list[int]) -> list[tuple[np.ndarray, np.ndarray]]:
    scene, gt = scene_for(drive, seed), ground_truth(drive)
    return [simulate_scan(gt[i], scene, rings=int(sensor["rings"]), az_steps=int(sensor["az_steps"]),
                          rng=np.random.default_rng([seed, 1, i]), noise=float(drive["noise"]))
            for i in frames]


def cache_path(drive: dict, sensor: dict, seed: int, cache_dir: Path) -> Path:
    key = json.dumps({"drive": drive, "sensor": sensor}, sort_keys=True)
    return cache_dir / f"{hashlib.sha256(key.encode()).hexdigest()[:16]}_s{seed}.npz"


def drive_scans(drive: dict, sensor: dict, seed: int, processes: int,
                cache_dir: Path) -> list[tuple[np.ndarray, np.ndarray]]:
    """Every scan of the drive, [(xyz (N,3) f32, intensity (N,) f32)], the
    same for the same drive, sensor and seed: from the cache in
    `cache_dir`, else raycast over `processes` spawned processes and
    cached there."""
    path = cache_path(drive, sensor, seed, cache_dir)
    n = int(drive["frames"])
    if path.exists():
        with np.load(path) as z:
            return [(z[f"xyz{i}"], z[f"inten{i}"]) for i in range(n)]
    jobs = [list(range(k, n, processes)) for k in range(processes)]
    if processes > 1:
        with multiprocessing.get_context("spawn").Pool(processes) as pool:
            parts = pool.starmap(_cast, [(drive, sensor, seed, j) for j in jobs])
    else:
        parts = [_cast(drive, sensor, seed, jobs[0])]
    scans = [None] * n
    for job, part in zip(jobs, parts):
        for i, s in zip(job, part):
            scans[i] = s
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f:
        np.savez(f, **{f"{k}{i}": a for i, (x, t) in enumerate(scans) for k, a in (("xyz", x), ("inten", t))})
    os.replace(tmp, path)
    return scans


def seeded_noise(scans: list[tuple[np.ndarray, np.ndarray]], sigma: float,
                 seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The scans with N(0, `sigma`) metres of sensor noise on every point,
    drawn from `seed`. The points, their number and the scene stay those of
    the drive, so every seed gets the same sizes and nearly the same work."""
    out = []
    for i, (xyz, inten) in enumerate(scans):
        draw = np.random.default_rng([seed, 2, i]).standard_normal(xyz.shape, dtype=np.float32)
        out.append((xyz + np.float32(sigma) * draw, inten))
    return out
