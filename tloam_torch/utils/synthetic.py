"""Synthetic spinning-LiDAR scan generator (tiny CPU raycaster).

A copy of ``tloam_tpu/utils/synthetic.py`` (numpy only), kept in the port
so that it imports nothing of the JAX package; its code must stay identical.

No KITTI data ships in this environment, so pipeline tests and benchmarks
synthesize HDL-64E-like scans: ring-major, azimuth-ordered point streams
(matching the ordering the reference's ring estimator assumes,
segmentation.cpp:362-377) cast against a parametric urban scene (ground
plane, vertical walls, cylindrical poles). Geometry is exact (analytic ray
intersections), so ground-truth poses are available for trajectory metrics.
"""
from __future__ import annotations

import dataclasses

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

    @staticmethod
    def town(
        rng: np.random.Generator | None = None,
        extent: float = 120.0,
        block: float = 40.0,
    ) -> "Scene":
        """Manhattan block grid: streets every `block` metres along BOTH
        axes with building fronts 8 m off each street axis — so a
        trajectory that turns (urban driving) keeps seeing structure, like
        a real city does. The single-street `urban` scene starves any path
        that leaves its corridor, which tests the scene, not the pipeline."""
        rng = rng or np.random.default_rng(0)
        walls = []
        bushes = []
        grid = np.arange(-extent, extent + 1e-6, block)
        for axis in (0, 1):  # 0: wall plane x=const, 1: wall plane y=const
            for g in grid:
                for side in (-8.0, 8.0):
                    c = g + side + rng.uniform(-1, 1)
                    x0 = -extent
                    while x0 < extent:
                        seg = rng.uniform(8, 20)
                        # leave gaps at intersections (crossing streets)
                        mid = x0 + seg / 2
                        near_cross = np.min(np.abs(grid - mid)) < 10.0
                        if rng.uniform() < 0.8 and not near_cross:
                            walls.append(
                                (axis, c, x0, x0 + seg, 0.0, rng.uniform(3, 8))
                            )
                            if rng.uniform() < 0.5:
                                r = rng.uniform(0.4, 0.9)
                                off = (-1.0 if side > 0 else 1.0) * r * 0.7
                                bx = x0 + seg * rng.uniform(0.2, 0.8)
                                if axis == 1:
                                    bushes.append((bx, c + off, r * 0.9, r))
                                else:
                                    bushes.append((c + off, bx, r * 0.9, r))
                        x0 += seg + rng.uniform(0, 4)
        poles = [
            (
                float(rng.choice(grid)) + rng.uniform(-7, 7),
                float(rng.choice(grid)) + rng.uniform(-7, 7),
                0.15,
                rng.uniform(2.5, 5.0),
            )
            for _ in range(120)
        ]
        # parked cars lining both sides of every street (see Scene.boxes)
        boxes = []
        L, W, H = 4.3, 1.7, 1.4
        for axis in (0, 1):
            for g in grid:
                for side in (-6.5, 6.5):
                    s0 = -extent
                    while s0 < extent:
                        s0 += rng.uniform(10, 28)
                        lane = g + side + rng.uniform(-0.5, 0.5)
                        if rng.uniform() < 0.55:
                            if axis == 0:  # street along y at x=g
                                boxes.append(
                                    (lane - W / 2, s0 - L / 2, 0.0,
                                     lane + W / 2, s0 + L / 2, H)
                                )
                            else:
                                boxes.append(
                                    (s0 - L / 2, lane - W / 2, 0.0,
                                     s0 + L / 2, lane + W / 2, H)
                                )
        return Scene(walls, poles, bushes, boxes)


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


def varied_trajectory(n_frames: int, step: float = 1.0, seed: int = 0):
    """Long-horizon ground truth with the hard regimes a straight drive
    misses: sharp turns, stop-and-go, and a reverse segment. Segment
    schedule (fractions of n_frames):
      0.00-0.25 straight, 0.25-0.35 left turn (~0.06 rad/frame),
      0.35-0.50 straight, 0.50-0.56 STOP, 0.56-0.70 straight,
      0.70-0.78 REVERSE, 0.78-0.88 right turn, 0.88-1.0 straight.
    """
    del seed
    poses = []
    x, y, yaw = 0.0, 0.0, 0.0
    for i in range(n_frames):
        f = i / max(n_frames, 1)
        if 0.25 <= f < 0.35:
            v, w = step, 0.06
        elif 0.50 <= f < 0.56:
            v, w = 0.0, 0.0  # stop-and-go
        elif 0.70 <= f < 0.78:
            v, w = -0.5 * step, 0.0  # reverse
        elif 0.78 <= f < 0.88:
            v, w = step, -0.06
        else:
            v, w = step, 0.0
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T[0, 3], T[1, 3] = x, y
        poses.append(T)
        x += v * c
        y += v * s
        yaw += w
    return np.stack(poses)


def town_trajectory(n_frames: int, step: float = 1.0, block: float = 40.0):
    """Street-following ground truth for `Scene.town`: straights, two 90-deg
    left turns and one right turn at intersections (0.098 rad/frame — a
    ~10 m turning radius), a stop, and a reverse segment — every hard
    regime of `varied_trajectory`, but routed along the block grid so the
    path never passes through a building (varied_trajectory was designed
    for open/corridor worlds; in the town it drove mid-block through walls,
    an unphysical instantaneous full-view flip). Turn arcs cross wall rows
    only inside the intersection gaps Scene.town leaves (near_cross < 10)."""
    R_frames = 16  # quarter turn
    w = (np.pi / 2) / R_frames / step  # rad per unit step
    segs = [
        (36, step, 0.0),         # west->east along the y=0 street
        (R_frames, step, w),     # left onto the x=0 street, heading north
        (20, step, 0.0),
        (7, 0.0, 0.0),           # stop-and-go
        (10, -0.5 * step, 0.0),  # reverse
        (R_frames, step, -w),    # right onto the y=block street, heading east
        (59, step, 0.0),
        (R_frames, step, w),     # left onto the x=2*block street, north
    ]
    # start mid-block (dense building fronts both sides): intersection wall
    # gaps leave the first frames longitudinally under-constrained, and with
    # an identity motion model the startup frame has no prediction to lean
    # on — real KITTI sequences likewise begin in feature-rich streets
    x, y, yaw = -46.0, 0.0, 0.0
    poses = []

    def emit():
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T[0, 3], T[1, 3] = x, y
        poses.append(T)

    for n, v, wr in segs:
        for _ in range(n):
            if len(poses) >= n_frames:
                return np.stack(poses)
            emit()
            x += v * np.cos(yaw)
            y += v * np.sin(yaw)
            yaw += wr * abs(v) if v else 0.0
    while len(poses) < n_frames:
        emit()
        x += step * np.cos(yaw)
        y += step * np.sin(yaw)
    return np.stack(poses)


def town_trajectory_b(n_frames: int, step: float = 1.0, block: float = 40.0):
    """Second street-following route for generalization sweeps (VERDICT r3
    weak #1: every solver threshold was tuned on the ONE town_trajectory
    drive). Same block grid and regime families, different order and
    geometry: starts south-bound on a cross street, takes an early RIGHT
    turn, long straight, stop, a reverse-then-forward on the SAME heading
    (no turn co-onset — distinct from route A's hardest event), then a
    late left turn. Stays on the street grid (never crosses walls)."""
    R_frames = 16
    w = (np.pi / 2) / R_frames / step
    segs = [
        (18, step, 0.0),          # south along the x=block street
        (R_frames, step, w),      # left at the (block, 0) intersection, east
        (16, step, 0.0),
        (5, 0.0, 0.0),            # stop
        (10, -0.5 * step, 0.0),   # reverse
        (14, step, 0.0),          # forward again, SAME heading (pure reversal)
        (R_frames, step, -w),     # right at the (2*block, 0) intersection
        (25, step, 0.0),          # south
    ]
    # start mid-block heading SOUTH on the x=block vertical street
    x, y, yaw = float(block), 26.0, -np.pi / 2
    poses = []

    def emit():
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T[0, 3], T[1, 3] = x, y
        poses.append(T)

    for n, v, wr in segs:
        for _ in range(n):
            if len(poses) >= n_frames:
                return np.stack(poses)
            emit()
            x += v * np.cos(yaw)
            y += v * np.sin(yaw)
            yaw += wr * abs(v) if v else 0.0
    while len(poses) < n_frames:
        emit()
        x += step * np.cos(yaw)
        y += step * np.sin(yaw)
    return np.stack(poses)


def town_trajectory_loop(n_frames: int, step: float = 1.0, block: float = 40.0):
    """Unbounded-length street-following route for statistically meaningful
    KITTI segment metrics (≥500 frames / ≥3 segment lengths): route A's
    opening straight + stop-and-go + reverse, then a closed 4-left-turn
    block circuit (x in [-block, 0], y in [0, block]) repeated forever.
    Every turn arc crosses wall rows only inside Scene.town's intersection
    gaps, and the path never leaves the scene — so a 500+ frame drive keeps
    full scan density the whole way, unlike routes A/B whose tail straights
    eventually exit the world extent."""
    R_frames = 16
    w = (np.pi / 2) / R_frames / step
    prelude = [
        (36, step, 0.0),         # west->east along the y=0 street
        (7, 0.0, 0.0),           # stop-and-go
        (10, -0.5 * step, 0.0),  # reverse
        (5, step, 0.0),          # recover to the x=0 intersection
    ]
    lap = [
        (R_frames, step, w),     # left onto x=0, heading north
        (20, step, 0.0),         # to y=30
        (R_frames, step, w),     # left onto y=block, heading west
        (20, step, 0.0),         # to x=-30
        (R_frames, step, w),     # left onto x=-block, heading south
        (20, step, 0.0),         # to y=10
        (R_frames, step, w),     # left onto y=0, heading east
        (20, step, 0.0),         # back to x=-10
    ]
    x, y, yaw = -46.0, 0.0, 0.0
    poses = []

    def emit():
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T[0, 3], T[1, 3] = x, y
        poses.append(T)

    def run(segs):
        nonlocal x, y, yaw
        for n, v, wr in segs:
            for _ in range(n):
                if len(poses) >= n_frames:
                    return True
                emit()
                x += v * np.cos(yaw)
                y += v * np.sin(yaw)
                yaw += wr * abs(v) if v else 0.0
        return False

    if run(prelude):
        return np.stack(poses)
    while not run(lap):
        pass
    return np.stack(poses)


def moving_cars(
    n_frames: int,
    rng: np.random.Generator,
    n_cars: int = 8,
    extent: float = 120.0,
    block: float = 40.0,
):
    """Per-frame dynamic obstacles for `Scene.town`: cars driving along the
    street axes (streets run on the block grid). Returns a list of length
    n_frames; element i is the list of world-frame AABBs to pass as
    `simulate_scan(..., boxes=...)` for frame i.

    Cars are ~4.4 x 1.8 x 1.5 m, drive at 0.4-1.8 m/frame (4-18 m/s at
    10 Hz) in a lane offset ±(2-5) m from a street axis, both directions.
    """
    grid = np.arange(-extent, extent + 1e-6, block)
    cars = []
    for _ in range(n_cars):
        axis = int(rng.integers(0, 2))  # 0: drives along x, 1: along y
        street = float(rng.choice(grid))
        lane = street + float(rng.uniform(2.0, 5.0)) * float(rng.choice([-1, 1]))
        s0 = float(rng.uniform(-extent, extent))
        v = float(rng.uniform(0.4, 1.8)) * float(rng.choice([-1, 1]))
        cars.append((axis, lane, s0, v))
    L, W, H = 4.4, 1.8, 1.5
    frames = []
    for i in range(n_frames):
        boxes = []
        for axis, lane, s0, v in cars:
            s = s0 + v * i
            # wrap around so cars stay in the scene for the whole drive
            s = (s + extent) % (2 * extent) - extent
            if axis == 0:
                boxes.append((s - L / 2, lane - W / 2, 0.0, s + L / 2, lane + W / 2, H))
            else:
                boxes.append((lane - W / 2, s - L / 2, 0.0, lane + W / 2, s + L / 2, H))
        frames.append(boxes)
    return frames


def occlusion_schedule(n_frames: int, rng: np.random.Generator, p: float = 0.25):
    """Per-frame dropout sectors: with probability p a frame loses 1-2
    azimuth sectors of 15-45 degrees (close passer-by / self-occlusion)."""
    out = []
    for _ in range(n_frames):
        sectors = []
        if rng.uniform() < p:
            for _ in range(int(rng.integers(1, 3))):
                width = np.radians(rng.uniform(15, 45))
                lo = rng.uniform(0, 2 * np.pi - width)
                sectors.append((float(lo), float(lo + width)))
        out.append(sectors)
    return out
