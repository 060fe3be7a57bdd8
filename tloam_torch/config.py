"""Dataclass configuration mirroring the reference's four YAML files.

Field-for-field copy of ``tloam_tpu/config.py`` plus ``PipelineConfig``
(``tloam_tpu/pipeline/frontend.py:50-116``), with its loader: a file and
dotted-path overrides such as ``"odometry.tls.corr_mode=knn"``. The port keeps its own copy
because importing any ``tloam_tpu`` module imports JAX; a test holds the two
equal field for field. Defaults are the reference's shipped values (cited
per field in ``tloam_tpu/config.py``).

Reference config files (loaded via WORK_SPACE_PATH, work_space_path.h.in:14):
  config/kitti/kitti_reader.yaml      -> DataConfig
  config/mapping/segmentation.yaml    -> SensorConfig, GroundSegConfig, DCVCConfig
  config/mapping/feature.yaml         -> FeatureConfig
  config/mapping/lidar_odometry.yaml  -> OdometryConfig, TLSConfig
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """velodyne: block of segmentation.yaml."""

    sensor_model: int = 64  # HDL-64E
    scan_period: float = 0.1  # 10 Hz
    sensor_height: float = 1.73
    vertical_res: float = 0.4
    init_angle: float = -24.9
    sensor_min_range: float = 1.0
    sensor_max_range: float = 120.0
    near_dis: float = 3.0


@dataclasses.dataclass(frozen=True)
class GroundSegConfig:
    """groundSeg: block of segmentation.yaml."""

    quadrant: int = 4
    num_sec: int = 3
    dis: float = 0.3
    max_iter: int = 3
    ground_seed_num: int = 20
    ring_min_num: int = 131


@dataclasses.dataclass(frozen=True)
class DCVCConfig:
    """DCVC: block of segmentation.yaml."""

    start_r: float = 0.35
    delta_r: float = 0.0004
    delta_p: float = 1.2
    delta_a: float = 1.2
    min_seg: int = 80


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """feature.yaml (PCA planar/sphere extraction)."""

    radius: float = 0.2
    k: int = 20
    min_neigh: int = 10
    planar_num: int = 500
    sphere_num: int = 300
    cvr_scan: float = 0.25
    cvr_submap: float = 0.15
    planar_scan_thres: float = 0.75
    planar_submap_thres: float = 0.65
    planar_vertic_thres: float = 0.25
    # "cell": cell-aggregated 27-neighborhood PCA (TPU-fast default);
    # "exact": per-point hybrid-search kNN PCA (reference-faithful)
    pca_mode: str = "cell"
    # cell-table capacity for pca_mode="cell": the window probe/fetch work
    # scales with this, so keep it near the realistic occupied-cell count.
    # Urban HDL-64E object clouds occupy only ~3-4k cells at 0.2 m pitch
    # (wall sampling is much denser than the cell pitch; measured on 117k-pt
    # scans) — 8192 is ~2x headroom, and halving from 16384 cut
    # pca_features 8.3 -> 5.3 ms (STAGES r4 A/B). Overflow cells lose
    # their features, they are never mis-assigned.
    max_cells: int = 8192


@dataclasses.dataclass(frozen=True)
class TLSConfig:
    """TLS: block of lidar_odometry.yaml — the solver hyper-parameters."""

    k_corr: int = 10
    factor_num: int = 4  # 2=planar+ground, 3=+edge, 4=+sphere
    edge_dist_thres: float = 1.0
    edge_dir_thres: float = 0.85
    edge_maxnum: int = 1200
    sphere_dist_thres: float = 0.5
    sphere_maxnum: int = 200
    planar_dist_thres: float = 0.5
    planar_maxnum: int = 2500
    ground_dist_thres: float = 0.5
    ground_maxnum: int = 2000
    # reference: 4 (lidar_odometry.yaml). Healthy frames exit early through
    # the alignment gate (exit_cost_thres below), so raising the ceiling
    # only spends rounds on frames that are still converging — measured: a
    # reverse->forward turn recovers ~60-70% of its 3.4 deg/frame yaw lag
    # per 5-round frame and accumulates a 33 deg error; 7 rounds close the
    # per-frame gap.
    max_iterations: int = 7
    inner_iterations: int = 4  # ceres options.max_num_iterations
    cost_threshold: float = 5e-9
    # alignment-based early exit (in addition to the reference's planar
    # cost-delta gate, which needs f64 bit-stability and in practice never
    # fires in f32): a round that is aligned, has GNC engaged (so at least
    # one weighted outlier pass ran), sits below this mean planar cost, and
    # is at least the 3rd round is converged — measured healthy tracking
    # runs at ~3e-5 m^2 and rounds 3/4/5 reproduce the same cost to noise.
    # 0 disables. This is what lets max_iterations=7 cost nothing on
    # healthy frames (they exit at 3 rounds; only still-converging frames
    # spend the ceiling). 3e-4 (mean |r| ~ 1.7 cm): full-density healthy
    # tracking sits at 1-2e-4 — a 1e-4 threshold left bench frames just
    # above it, paying all 7 rounds (15.2 fps); at 3e-4 they exit at round
    # 3 (18.1 fps) and the hard-drive accuracy IMPROVES (t_err 5.64 ->
    # 4.97%, r_err 5.46 -> 3.71 deg/100m — late rounds on converged frames
    # only let aliased matches wander).
    exit_cost_thres: float = 3e-4
    gnc_factor: float = 11.8
    noise_bound: float = 0.01
    fitness_thres: float = 0.02
    # --- TPU-build-specific knobs ---
    # "residual": GNC-TLS-proper mu init from the max residual of the first
    #   fine round's CONVERGED solution (seeding from pre-alignment residuals
    #   collapses every weight ~100x exactly on high-error turn-onset frames
    #   — measured). "reference_zero": reproduce the reference's emergent
    #   behavior (residual buffers are still zero-initialized when mu is set
    #   on iter 0, registration.cpp:934,1027-1033, so mu always starts 1e-10).
    mu_init: str = "residual"
    lm_lambda: float = 1e-6  # Levenberg damping for the 6x6 solve
    # degeneracy handling (stands in for Ceres' SUBSPACE_DOGLEG trust
    # region, registration.cpp:1040): eigen-directions of H weaker than
    # degen_rel_thres * lam_max get NO update (solution remapping — the
    # motion-model prediction is kept along them); each inner GN step is
    # clamped to max_step_trans metres / max_step_rot radians.
    degen_rel_thres: float = 1e-3
    # hard absolute floor, active ONLY while the planar family is empty
    # (the ground-only runaway signature): a direction whose raw curvature
    # (summed residual weight) is below this is then treated as
    # unobservable no matter the eigenvalue ratios — a ground-only frame
    # puts xy/yaw at ~5, pure noise from ~2000 near-vertical ground
    # normals, and solving along them walks off at metres/frame. Applying
    # the floor unconditionally (or raising the RELATIVE threshold) instead
    # freezes genuinely-observed yaw at sharp-turn onset (both measured on
    # the 120-frame drive).
    # Both absolute thresholds are in UNIT-WEIGHT curvature (summed residual
    # count): the solver re-normalizes by the mean squared GNC weight before
    # the test, so a uniform weight collapse (which leaves the GN direction
    # unchanged) cannot trip them.
    degen_abs_hard: float = 30.0
    degen_abs_thres: float = 100.0  # raw curvature (summed residual weight)
    max_step_trans: float = 1.0
    max_step_rot: float = 0.3
    max_per_cell: int = 8  # hash-grid candidate cap per neighbor cell
    # plane-family residual: "point_to_plane" (the reference's wired default,
    # addSurfCostFactor) or "gicp" (its PlaneToPlaneErr/addSurfCostFactor2
    # covariance-weighted variant, registration.cpp:119-160,649-702)
    plane_residual: str = "point_to_plane"
    # GICP alignment gate (metres): mean matched nearest-neighbor distance
    # at the round's INPUT pose. gicp has no point-to-plane cost gate, and
    # without one GNC engaged on round 0 of a cold start — immediately
    # truncating the large (1 m-offset) residuals that carry the whole
    # correction signal, so the solve under-moved ~0.15 m/frame and froze
    # (MODES_r04/r05 gicp: ATE 12-15 m on the 60-frame 1 m/frame drive).
    # Rounds whose mean matched distance exceeds this are treated as
    # misaligned: GNC stays off (pure unweighted GICP pulls at full signal)
    # and the next round goes coarse (+ yaw fan). Healthy gicp tracking
    # measures ~0.02 m.
    gicp_align_dist: float = 0.1
    # GICP-mode noise bound (GNC eps, in the GICP residual scale). The
    # metric noise_bound (0.01 m) is meaningless for GICP residuals
    # r = (C_t + R C_s R^T)^-1 d: covariances are normalized to unit max
    # eigenvalue and clamped at 1e-3 (calculateCov, registration.cpp:
    # 385-415), so an inlier with normal noise sigma=0.01 m carries
    # |r| ~ 0.01/(2e-3) = 5 and GNC cost ~ 25 — with eps^2 = 1e-4 the
    # th1/th2 thresholds collapse below EVERY cost once mu ramps and all
    # weights zero out (measured round 4: mu=inf, frozen rounds 2-6, the
    # MODES_r03 8.6 m stall). eps must sit at the inlier cost scale.
    gicp_noise_bound: float = 5.0
    # GICP-mode correspondence search radius (planar + ground; the
    # reference searches ground with planar_dist_thres too,
    # registration.cpp:813). The hash-window 1-NN reach is ~1.5x this.
    # 0.5 m cannot see a 1 m/frame startup motion — only the distant
    # cross-track facades observe along-track error, and they sit outside
    # the window; the mode then never bootstraps its velocity estimate
    # (measured: pose frozen at ~0.1 m over an 8 m drive).
    gicp_dist_thres: float = 1.5
    # correspondence engine: "cell_plane" precomputes 27-cell-window plane /
    # line fits over the submap once per solve and answers queries with hash
    # probes (TPU-fast default); "knn" re-fits from per-query k-nearest
    # neighbors every iteration (reference-faithful)
    corr_mode: str = "cell_plane"
    # failure containment: if fewer total correspondences than this survive,
    # keep the motion-model prediction instead of trusting a degenerate
    # solve (the reference ASSERTS >=10 features per class and aborts the
    # process, registration.cpp:928-929; we degrade gracefully instead)
    min_total_corr: int = 30
    # cell_plane match-distance gate, in units of the matched grid's cell
    # size (1.0 mirrors the knn radius gate; the 27-cell window physically
    # reaches 1.5 cells). Measured on the 60-frame varied drive: >1 admits
    # off-cell planes and degrades straight segments — keep 1.0.
    cell_gate_scale: float = 1.0
    # coarse-to-fine matching: ROUND 0 always matches planar against a grid
    # coarse_scale x coarser with the full 27-window centroid reach
    # (~2.25 m at 3.0) — the constant-velocity prediction is structurally
    # behind at startup (a full step of error) and sharp-turn onset
    # (0.06 rad/frame of yaw lag), where the fine window reach (~1.5 cells)
    # loses every point past ~12 m. A coarse round is also re-entered
    # whenever a round loses the planar family entirely (post-occlusion
    # re-localization, relocal_corr_thres). Coarse rounds never touch the
    # GNC weight / mu schedule (their coarse-plane residuals would poison
    # it — measured on the varied drive). coarse_scale=0 disables.
    coarse_scale: float = 3.0
    # starvation trigger: a round with fewer planar matches than this also
    # forces a coarse round (the fully-lost signature)
    relocal_corr_thres: int = 1
    # yaw-hypothesis fan on coarse (lost) rounds: before a coarse round
    # solves, score 2*yaw_fan_half+1 yaw offsets (multiples of
    # yaw_fan_step_deg about the current estimate) by truncated planar
    # point-to-plane cost against the coarse grid, and restart from the
    # best. Rationale (measured, DIAG_REVERSE round 4): at turn onset the
    # whole 0.098 rad/frame yaw step can be missed in ONE frame — in a
    # Manhattan world point-to-plane residuals are yaw-blind for near
    # points (they slide along the wall) while the yaw-informative distant
    # points sit outside every match gate, so both fine and coarse GN
    # rounds converge back to the unrotated local minimum (frame 37: gt
    # dyaw +5.62 deg, est +0.08, cost stalled at 3.6e-2 for all 7 rounds;
    # the -6 deg heading error then dead-reckoned into 36 m of drift).
    # The fan is the basin-escape mechanism GN itself cannot provide.
    # Healthy frames never take a coarse round, so they never pay for it.
    # yaw_fan_half=0 disables.
    yaw_fan_half: int = 2
    yaw_fan_step_deg: float = 3.0
    # truncation radius (metres) for unmatched/outlier points in the fan
    # score: unmatched candidates pay tau^2, so hypotheses are ranked by
    # robust alignment, not just matched-subset residuals
    yaw_fan_tau: float = 0.5
    # acceptance margin: a non-zero hypothesis is taken only when its score
    # beats the zero-offset score by this factor. A genuinely missed turn
    # step slashes the truncated cost (most candidates unmatched -> matched);
    # Manhattan aliasing / moving-car structure wins only marginally —
    # without the margin the fan injected -3.9 deg on a straight occluded
    # frame (DIAG_REVERSE2 f34) and overshot a turn by -9 deg (f92).
    yaw_fan_margin: float = 0.85
    # best-round selection: the pose returned is the ALIGNED round whose
    # robust score (planar cost + best_round_tau^2 per unmatched candidate,
    # averaged over candidates) is lowest — NOT the last round's. Measured
    # (DIAG_REVERSE3): with 7 outer rounds in f32, late rounds can wander
    # off an aligned solution through aliased matches (f11: round-0 cost
    # 8.2e-4 aligned -> round-6 3.4e-2, +1.2 deg yaw injected; f14: a
    # half-cell translation alias scored marginally lower cost on FEWER
    # matches — the unmatched-candidate penalty is what rejects it). The
    # single-step monotonicity guard cannot catch gradual wander; this
    # does. 0 disables (return the final round, pre-round-4 behavior).
    best_round_tau: float = 0.1
    # stall exit: stop when the best robust score has not improved for this
    # many consecutive rounds (requires best_round_tau). Healthy frames
    # improve only on round 0 and exit after 3 rounds (matching the r3
    # exit_cost_thres behavior); wander rounds stop paying for themselves
    # (measured DIAG_REVERSE4: mean 5.24 rounds/frame because wander pushed
    # the CURRENT round's cost above exit_cost_thres even when round 0 was
    # already converged); genuinely-recovering frames keep improving their
    # best score and still spend the full ceiling. 0 disables.
    exit_stall_rounds: int = 2
    # match-fraction trigger: a fine round that matched fewer than this
    # fraction of the scan's planar candidates is not trusted as "aligned"
    # even when its residuals are small — the matched nearby subset is
    # self-consistent while the unmatched distant points carry the
    # misalignment signal (startup frame 1: 297/1024 matched, mean cost
    # small, pose 0.84 m off — measured). Healthy tracking sits at 0.7-0.9.
    relocal_frac: float = 0.5
    # GNC engagement floor — deliberately LOWER than relocal_frac: mu
    # seeding / weight updates only need residuals to measure local fit
    # (mean planar cost under coarse_cost_thres), not a majority match.
    # Worlds with legitimately thin match fractions (fresh geometry each
    # frame; route-a world 407 tracks at 0.07 m drift without ever reaching
    # 0.5) otherwise never engage GNC at all and solve UNWEIGHTED with
    # moving-car outliers in every round — the measured source of their
    # knife-edge sensitivity (r5: flipping failures across numerically
    # equivalent refactors). The cost gate still guards against seeding mu
    # while grossly misaligned.
    gnc_frac: float = 0.5
    # alignment gate (mean planar point-to-plane cost, m^2) deciding both
    # (a) when a coarse round is needed and (b) when GNC may engage:
    # 2e-3 = mean |r| ~ 4.5 cm. Healthy tracking sits at ~1e-4; turn-onset /
    # startup misalignment at ~1e-2 (measured on the 120-frame drive).
    coarse_cost_thres: float = 2e-3
    # misaligned-frame containment: when NO round of a solve passes the
    # alignment gate (total-occlusion flip — a gateway/tunnel exit changes
    # the whole view in one frame), keep the motion-model prediction instead
    # of the solved pose: the solve converged onto the self-consistent
    # nearby subset and carries the full misalignment (measured: solved
    # 0.81 m off where the prediction was 0.16 m off). point_to_plane mode
    # only (gicp costs have no metric alignment meaning).
    #
    # By default the flag only COMPUTES the signal: it feeds the frontend's
    # submap health gate (a distrusted frame does not push features into the
    # maps) and the motion-model rotation damping. The POSE override below
    # is opt-in: at full scan density the solver is strong enough that
    # overriding it with dead reckoning freezes genuine motion (measured: a
    # turn tracked at 0.02 m/frame error with the override off dead-reckoned
    # straight at 1.2 m/frame with it on); in starved regimes (reduced
    # density, heavy occlusion) the override wins — enable it there.
    misaligned_fallback: bool = True
    misaligned_pose_fallback: bool = False
    # fallback trigger fraction: distrust the solve only when the final
    # round matched under THIS fraction of the planar candidates. Distinct
    # from (and much lower than) relocal_frac: relocal_frac decides when a
    # round is not yet "aligned" enough to engage GNC / skip coarse rounds
    # (conservative is safe there); the fallback overrides a converged
    # solve with dead reckoning, where conservatism has real cost —
    # measured: a 44%-matched healthy recovery solve was held at a stale
    # 0.35 m/frame fallback step for 3 extra frames by a 0.5 trigger.
    fallback_frac: float = 0.2
    # starved-round revert: a fine GNC round that matched fewer than
    # fallback_frac of the planar candidates does not commit its xi delta —
    # the coarse round / yaw fan that follows restarts from the round's
    # INPUT estimate (the motion model on round 0) instead of a pose solved
    # on an aliased 4% sliver. Measured (SWEEP_r04 route-a world 205 f19):
    # without this, a post-occlusion recovery round matched 41/900, moved
    # xi into a +7 deg yaw basin, and the fan — scored about the moved xi,
    # reach ±6 deg — locked the wrong basin permanently (7.9 deg/100 m
    # rotation error for the remaining 100 frames).
    revert_starved_rounds: bool = False


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Top-level lidar_odometry.yaml (front-end / submap management)."""

    ground_down_sample: float = 0.3
    ground_down_sample_submap: float = 0.45
    edge_down_sample: float = 0.1
    edge_down_sample_submap: float = 0.3
    # window lengths for the sphere/planar frame deques (front_end.cpp:
    # 212-218). sphere_frame_size only matters with
    # sphere_submap_from_planar=False (the reference quirk assembles BOTH
    # submaps from the planar deque, front_end.cpp:221-229).
    sphere_frame_size: int = 3
    planar_frame_size: int = 3
    edge_crop_box_length: float = 100.0
    ground_crop_box_length: float = 100.0
    mapping_flag: bool = False
    global_map_voxel: float = 1.0  # front_end.cpp:272 VoxelDownSample(1.0)
    global_map_cap: int = 262144
    # submap health gate: a frame whose solve was degenerate or misaligned
    # does NOT push its features into the submap (its pose is a motion-model
    # guess — pushing transforms every feature by that guess and poisons the
    # maps; measured: one misaligned frame put z in [-10, +2.6] garbage into
    # the ground map). After `submap_gate_streak` CONSECUTIVE unhealthy
    # frames the gate yields and pushes anyway: if the world really changed
    # (occlusion flip), re-mapping from the new view is the only way back.
    submap_health_gate: bool = True
    submap_gate_streak: int = 2
    # never-aligned push veto: a frame whose solve passed NO alignment round
    # yet was trusted for pose (matched above fallback_frac) may carry an
    # undetected basin error — its features are kept OUT of the submap for
    # the first submap_gate_streak consecutive unvalidated frames, so the
    # next frame can re-localize against a still-clean map (SWEEP_r04
    # route-a world 205: one such frame at +7.9 deg permanently poisoned the
    # submap). The veto deliberately expires after submap_gate_streak frames
    # and never touches rotation damping or the fallback streak: on worlds
    # where the alignment gate is chronically unattainable (route-a world
    # 407 tracks at 0.07 m drift without ever passing it), stronger
    # treatment froze the map / dead-reckoned through turns (measured r5).
    gate_never_aligned: bool = False
    # motion-model damping on unhealthy (degenerate/misaligned) frames: the
    # fallback pose IS the prediction, so the same relative step re-applies
    # every fallback frame — an erroneous yaw rate (measured -4.25 deg/frame
    # for 3 straight frames post-occlusion) dead-reckons into metres of
    # drift. A car's yaw rate decays fast when unobserved; its forward
    # inertia does not: decay the rotation part of the step, keep
    # translation. 1.0 = no damping.
    fallback_rot_decay: float = 0.5
    # physical step clamp: a solved frame-to-frame translation exceeding
    # model_speed + max_step_accel*(1 + consecutive_clamps) metres is not a
    # vehicle motion — it is an aliased solve. The frame keeps the
    # motion-model pose instead (and counts as unhealthy). The bound OPENS
    # linearly with consecutive clamped frames so a genuine large
    # re-localization correction is admitted after ~|offset|/accel frames,
    # while the measured runaway mode (route-a world 306 r5: solved steps
    # 1.3 -> 3.4 -> 9 m/frame, 998 m of drift in 100 frames) is braked to
    # linear growth. 0.75 m/frame^2 = 75 m/s^2 at 10 Hz — far beyond any
    # car, so legitimate accelerations are never touched. 0 disables.
    max_step_accel: float = 0.75
    tls: TLSConfig = dataclasses.field(default_factory=TLSConfig)

    # --- static buffer capacities (TPU build; power-of-two friendly) ---
    # Right-sized in round 4 from measured occupancy + the family caps they
    # feed (STAGES r4 A/B: scan_matching 33.9 -> 20.6 ms, fused step
    # 60.4 -> 43.7 ms, with LONGDRIVE accuracy re-validated after):
    #  * scan ground/edge buffers thin UNIFORMLY when they bind
    #    (ops/voxel.voxel_downsample), so halving them keeps spatial
    #    coverage while halving every per-row probe/eval in the solver;
    #    the 2000/1200 correspondence caps stay satisfiable (ground: 4096
    #    rows at ~0.9 match rate >> 2000; measured).
    #  * submap edge/ground maps at 0.3/0.45 m voxels occupy well under
    #    8192 cells over the +-100 m crop on 64-ring urban scans.
    scan_edge_cap: int = 2048
    scan_sphere_cap: int = 512
    scan_planar_cap: int = 1024
    scan_ground_cap: int = 4096
    submap_edge_cap: int = 8192
    submap_ground_cap: int = 8192
    # (planar/sphere submap capacity = frame window x per-frame cap — see
    # PipelineConfig.frame_planar_cap/frame_sphere_cap)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """kitti_reader.yaml."""

    data_path: str = ""
    sequence: str = "00"
    # how many KITTI image channels to read per frame (0 = none, up to 4:
    # image_0/1 grayscale + image_2/3 color — kitti_reader.cpp:63-88)
    image_kind_size: int = 0
    raw_cloud_cap: int = 131072  # KITTI HDL-64E scans are ~120k points


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """All static hyper-parameters of the front end (the rationale of every
    capacity is documented on ``tloam_tpu.pipeline.frontend.PipelineConfig``)."""

    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    ground: GroundSegConfig = dataclasses.field(default_factory=GroundSegConfig)
    dcvc: DCVCConfig = dataclasses.field(default_factory=DCVCConfig)
    feature: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    sphere_submap_from_planar: bool = False
    sphere_index_bug: bool = False
    max_voxels: int = 8192
    max_clusters: int = 128
    pick_sectors: int = 16
    frame_planar_cap: int = 4096
    frame_sphere_cap: int = 1024
    frame_planar_fill: int = 0
    frame_planar_voxel: float = 0.6

    @property
    def frame_planar_total(self) -> int:
        return self.frame_planar_cap + self.frame_planar_fill

    general_cap: int = 49152
    edge_ring_width: int = 2304
    dcvc_cc_iters: int = 6


# ---------------------------------------------------------------------------
# Config loading + dotted-path overrides (tloam_tpu/config.py:429-494)
# ---------------------------------------------------------------------------


def _coerce(old, raw: str):
    """Parse a CLI string into the type of the value it replaces."""
    if isinstance(old, bool):
        low = raw.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"expected a boolean, got {raw!r}")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    return raw


def replace_path(cfg, dotted: str, value):
    """A copy of a (nested, frozen) dataclass with the field at `dotted`
    (e.g. "odometry.tls.corr_mode") replaced; a string value is coerced to
    the type of the field it replaces."""
    head, _, rest = dotted.partition(".")
    if not hasattr(cfg, head):
        avail = [f.name for f in dataclasses.fields(cfg)]
        raise KeyError(f"no config field {head!r}; available: {avail}")
    old = getattr(cfg, head)
    if rest:
        new = replace_path(old, rest, value)
    elif dataclasses.is_dataclass(old):
        raise KeyError(f"{dotted!r} is a config section, not a field")
    else:
        new = _coerce(old, value) if isinstance(value, str) else value
    return dataclasses.replace(cfg, **{head: new})


def apply_dict(cfg, tree: dict):
    """Apply a nested dict (parsed YAML/JSON) onto a dataclass config."""
    for key, val in tree.items():
        old = getattr(cfg, key)
        if isinstance(val, dict):
            cfg = dataclasses.replace(cfg, **{key: apply_dict(old, val)})
        else:
            cfg = replace_path(cfg, key, val)
    return cfg


def load_pipeline_config(path: str | None = None, overrides=()) -> PipelineConfig:
    """A PipelineConfig from the defaults, an optional YAML/JSON file holding
    a nested mapping that mirrors the dataclass tree, and dotted-path
    overrides ("odometry.tls.corr_mode=knn"). `yaml` is imported only when
    a file is given."""
    cfg = PipelineConfig()
    if path:
        import yaml

        with open(path) as f:
            tree = yaml.safe_load(f) or {}
        if not isinstance(tree, dict):
            raise ValueError(f"config file {path} must hold a mapping")
        cfg = apply_dict(cfg, tree)
    for ov in overrides:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} must look like key=value")
        cfg = replace_path(cfg, key.strip(), val.strip())
    return cfg
