"""The plain reference of the configuration kitti-hdl64.gicp: the frozen
reference (``lidar_bench/reference/``) with upstream T-LOAM's
covariance-weighted surface factor, ``odometry.tls.plane_residual=gicp``.

Upstream (zhoupengwei/tloam, ``src/lidar_odometry/registration.cpp``)
weights each planar and ground match by the two points' neighbourhood
covariances: ``PlaneToPlaneErr`` (:119-160), its matches by
``addSurfCostFactor2`` (:649-702) and ``addGroundCostFactor2`` (:792-845),
the covariances by ``calculateCov`` (:385-415).

The frozen reference leaves GICP out. This piece brings the modules that
differ, each a frozen copy of the port's GICP path at the commit that added
the configuration, with no kernel, stage timer or process group:

- ``config``: the frozen fields and the GICP ones (``k_corr``,
  ``plane_residual``, ``gicp_dist_thres``, ``gicp_noise_bound``,
  ``gicp_align_dist``);
- ``covariance``: the neighbour covariance that the frozen ``voxel`` lacks;
- ``residuals``: the frozen families and ``plane_to_plane``;
- ``registration``: covariances, GICP 1-NN matches, the GICP family, its
  GNC scale and alignment gate, over the frozen helpers;
- ``frontend``: the frozen frame path, its imports reaching this
  package's ``registration`` (a batch's problems are captured through it).

The rest (cloud, segmentation, DCVC, edges, features, eig3, se3, voxel) is
the frozen reference's; ``cloud`` is bound here. It imports nothing of ``tloam_torch``,
``tloam_tpu`` or JAX, and of the benchmark only ``lidar_bench.reference``;
its neighbours come from the frozen copy of the hash grid, not from the
port. Nothing of it may be edited to follow the port.
"""
from lidar_bench.reference import cloud  # noqa: F401

from . import config, frontend, registration  # noqa: F401
