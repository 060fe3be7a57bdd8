"""Batched, frame-sharded and point-sharded registration.

Port of ``tloam_tpu/parallel/batched.py`` onto the solver's batch axis and
``torch.distributed``:

  * `vmap_scan_matching` — B independent frames in one solve: the batch
    axis of models/registration.scan_matching (one loop, one host sync a
    round for the whole batch). Not a loop over frames, and not
    ``torch.vmap``: the solver's per-round host branch and its scatters do
    not vmap.
  * `sharded_scan_matching` — the batch split over the mesh's "frames"
    axis. Each rank solves its slice; ranks that share a frames coordinate
    solve the same slice (the JAX ``P("frames")`` replicates over points).
    Every rank returns the whole batch, gathered as a SUM all_reduce of
    zero-filled (B, ...) buffers over the frames axis.
  * `distributed_scan_matching` — ONE frame with its scan points sharded
    over the "points" axis: every rank holds the whole frame and cuts its
    shard; the submap is replicated; the 6x6 normal equations, the GNC
    statistics and the cost sums are all-reduced each step (the collective
    Schur reduction) and the correspondence caps bind on the global scan
    order, so the sharded solve admits the one-device correspondence set.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tloam_torch.config import TLSConfig
from tloam_torch.cloud import map_tensors
from tloam_torch.models.registration import FeatureSet, scan_matching
from tloam_torch.parallel.mesh import axis_slice, shard_cloud_points


def vmap_scan_matching(scans: FeatureSet, submaps: FeatureSet, predict_poses: torch.Tensor, cfg: TLSConfig):
    """Solve B independent frames (a leading B on every leaf, predict_poses
    (B,4,4)) in one batched solve: (poses (B,4,4), Diagnostics with a
    leading B on every leaf)."""
    return scan_matching(scans, submaps, predict_poses, cfg)


def _gather_frames(x: torch.Tensor, sl: slice, B: int, group) -> torch.Tensor:
    """This rank's rows sl of a (B, ...) output -> the whole (B, ...) on every
    rank of `group`: a SUM of zero-filled buffers (bools travel as int32)."""
    full = torch.zeros((B,) + x.shape[1:], dtype=torch.int32 if x.dtype == torch.bool else x.dtype,
                       device=x.device)
    full[sl] = x
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full.bool() if x.dtype == torch.bool else full


def sharded_scan_matching(scans: FeatureSet, submaps: FeatureSet, predict_poses: torch.Tensor, cfg: TLSConfig,
                          mesh: DeviceMesh):
    """Frame-parallel batched solve: the batch over mesh axis "frames" (B
    divisible by its size); every rank holds and returns the whole batch."""
    B = predict_poses.shape[0]
    sl = axis_slice(mesh, "frames", B)
    cut = lambda x: x[sl]  # noqa: E731
    pose, diag = vmap_scan_matching(map_tensors(scans, cut), map_tensors(submaps, cut), predict_poses[sl], cfg)
    gather = lambda x: _gather_frames(x, sl, B, mesh.get_group("frames"))  # noqa: E731
    return gather(pose), map_tensors(diag, gather)


def distributed_scan_matching(scan: FeatureSet, submap: FeatureSet, predict_pose: torch.Tensor, cfg: TLSConfig,
                              mesh: DeviceMesh, axis: str = "points"):
    """Consensus registration of ONE frame with its scan features sharded
    over mesh axis `axis` (scan capacities divisible by its size): (pose,
    Diagnostics), the same on every rank of the axis."""
    local = shard_cloud_points(scan, mesh, axis)
    return scan_matching(local, submap, predict_pose, cfg, group=mesh.get_group(axis))
