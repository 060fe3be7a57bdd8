"""The frozen reference's configuration with the fields of the GICP surface
factor.

``TLSConfig`` adds to the frozen fields (``lidar_bench/reference/config.py``)
the five that ``plane_residual=gicp`` reads, copied from
``tloam_torch/config.py``. Upstream (zhoupengwei/tloam,
``config/mapping/lidar_odometry.yaml`` and
``src/lidar_odometry/registration.cpp``) has ``k_corr`` and the choice of
factor; the port adds three knobs, departures from upstream:

- ``gicp_dist_thres`` 1.5 m: the planar and ground match radius. Upstream
  searches both with ``planar_dist_thres`` (ground too, registration.cpp:813),
  which cannot see a 1 m a frame startup motion through a hash window;
- ``gicp_noise_bound`` 5.0: the GNC bound, and the Cauchy scale, on the
  covariance-normalized residual. Upstream takes the metric
  ``noise_bound`` (0.01 m), under which every weight of an inlier with
  normal noise falls to 0;
- ``gicp_align_dist`` 0.1 m: the alignment gate, the mean matched distance
  at a round's input pose. Upstream has no gate; without one GNC engages
  on a cold round and truncates the residuals that carry the correction.

Other fields, overrides and defaults are the frozen reference's.
"""
from __future__ import annotations

import dataclasses

from lidar_bench.reference import config as frozen
from lidar_bench.reference.config import replace_path


@dataclasses.dataclass(frozen=True)
class TLSConfig(frozen.TLSConfig):
    k_corr: int = 10  # calculateCov's neighbours (lidar_odometry.yaml)
    plane_residual: str = "point_to_plane"  # or "gicp": PlaneToPlaneErr, addSurfCostFactor2
    gicp_align_dist: float = 0.1
    gicp_noise_bound: float = 5.0
    gicp_dist_thres: float = 1.5


@dataclasses.dataclass(frozen=True)
class OdometryConfig(frozen.OdometryConfig):
    tls: TLSConfig = dataclasses.field(default_factory=TLSConfig)


@dataclasses.dataclass(frozen=True)
class PipelineConfig(frozen.PipelineConfig):
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)


def load_pipeline_config(path: str | None = None, overrides=()) -> PipelineConfig:
    """A PipelineConfig from the defaults and dotted-path overrides
    ("odometry.tls.plane_residual=gicp"). The reference reads no config file."""
    if path:
        raise ValueError("the reference takes its configuration as overrides, not as a file")
    cfg = PipelineConfig()
    for ov in overrides:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} must look like key=value")
        cfg = replace_path(cfg, key.strip(), val.strip())
    return cfg
