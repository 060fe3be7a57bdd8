"""Dataclass configuration mirroring the reference's YAML files.

A copy of the fields of ``tloam_torch/config.py`` (itself a field-for-field
copy of ``tloam_tpu/config.py``) and of ``PipelineConfig`` that the
reference's frame path reads, with their loader: dotted-path overrides such
as ``"odometry.tls.corr_mode=knn"``. The port's other settings (GICP, the
exact PCA, the global map, the optional quirks and gates) have no field
here, so a configuration that sets one fails to load. Defaults are the
reference's shipped values (cited per field in ``tloam_tpu/config.py``),
and the port's own knobs where the reference has none.

Reference config files (loaded via WORK_SPACE_PATH, work_space_path.h.in:14):
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
    """feature.yaml (PCA planar/sphere extraction; the cell-aggregated PCA)."""

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
    max_cells: int = 8192  # cell-table capacity of the cell-aggregated PCA


@dataclasses.dataclass(frozen=True)
class TLSConfig:
    """TLS: block of lidar_odometry.yaml — the solver hyper-parameters
    (point-to-plane residuals, mu seeded from the first fine round's
    residuals, all four families)."""

    edge_dist_thres: float = 1.0
    edge_dir_thres: float = 0.85
    edge_maxnum: int = 1200
    sphere_dist_thres: float = 0.5
    sphere_maxnum: int = 200
    planar_dist_thres: float = 0.5
    planar_maxnum: int = 2500
    ground_dist_thres: float = 0.5
    ground_maxnum: int = 2000
    max_iterations: int = 7  # reference: 4
    inner_iterations: int = 4  # ceres options.max_num_iterations
    cost_threshold: float = 5e-9
    exit_cost_thres: float = 3e-4  # alignment-based early exit (0 disables)
    gnc_factor: float = 11.8
    noise_bound: float = 0.01
    lm_lambda: float = 1e-6  # Levenberg damping for the 6x6 solve
    # degeneracy handling (stands in for Ceres' SUBSPACE_DOGLEG trust region)
    degen_rel_thres: float = 1e-3
    degen_abs_hard: float = 30.0  # active only while the planar family is empty
    degen_abs_thres: float = 100.0  # raw curvature (summed residual weight)
    max_step_trans: float = 1.0
    max_step_rot: float = 0.3
    max_per_cell: int = 8  # hash-grid candidate cap per neighbor cell
    corr_mode: str = "cell_plane"  # "cell_plane" (27-cell window fits) or "knn" (per-query refits)
    min_total_corr: int = 30
    cell_gate_scale: float = 1.0
    coarse_scale: float = 3.0  # coarse-to-fine matching (0 disables)
    relocal_corr_thres: int = 1
    yaw_fan_half: int = 2  # yaw-hypothesis fan on coarse rounds (0 disables)
    yaw_fan_step_deg: float = 3.0
    yaw_fan_tau: float = 0.5
    yaw_fan_margin: float = 0.85
    best_round_tau: float = 0.1  # best-round selection (0 disables)
    exit_stall_rounds: int = 2  # stall exit (0 disables)
    relocal_frac: float = 0.5
    gnc_frac: float = 0.5
    coarse_cost_thres: float = 2e-3
    fallback_frac: float = 0.2  # misaligned-frame signal (the pose is not overridden)


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Top-level lidar_odometry.yaml (front-end / submap management)."""

    ground_down_sample: float = 0.3
    ground_down_sample_submap: float = 0.45
    edge_down_sample: float = 0.1
    edge_down_sample_submap: float = 0.3
    # window lengths for the sphere/planar frame deques (front_end.cpp:212-218)
    sphere_frame_size: int = 3
    planar_frame_size: int = 3
    edge_crop_box_length: float = 100.0
    ground_crop_box_length: float = 100.0
    # submap health gate: an unhealthy frame pushes nothing into the submap
    # until submap_gate_streak consecutive unhealthy frames
    submap_gate_streak: int = 2
    fallback_rot_decay: float = 0.5  # motion-model rotation decay on unhealthy frames
    max_step_accel: float = 0.75  # physical step clamp, m/frame^2
    tls: TLSConfig = dataclasses.field(default_factory=TLSConfig)
    # static buffer capacities
    scan_edge_cap: int = 2048
    scan_sphere_cap: int = 512
    scan_planar_cap: int = 1024
    scan_ground_cap: int = 4096
    submap_edge_cap: int = 8192
    submap_ground_cap: int = 8192


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """All static hyper-parameters of the front end (the rationale of every
    capacity is documented on ``tloam_tpu.pipeline.frontend.PipelineConfig``)."""

    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    ground: GroundSegConfig = dataclasses.field(default_factory=GroundSegConfig)
    dcvc: DCVCConfig = dataclasses.field(default_factory=DCVCConfig)
    feature: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    max_voxels: int = 8192
    max_clusters: int = 128
    pick_sectors: int = 16
    frame_planar_cap: int = 4096
    frame_sphere_cap: int = 1024
    general_cap: int = 49152
    edge_ring_width: int = 2304
    dcvc_cc_iters: int = 6


# ---------------------------------------------------------------------------
# Dotted-path overrides (tloam_tpu/config.py:429-494)
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


def load_pipeline_config(path: str | None = None, overrides=()) -> PipelineConfig:
    """A PipelineConfig from the defaults and dotted-path overrides
    ("odometry.tls.corr_mode=knn"). The reference reads no config file."""
    if path:
        raise ValueError("the reference takes its configuration as overrides, not as a file")
    cfg = PipelineConfig()
    for ov in overrides:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} must look like key=value")
        cfg = replace_path(cfg, key.strip(), val.strip())
    return cfg
