"""Process-group bootstrap, the (frames, points) device mesh, and the
helpers that cut a rank's share of a batch or of a frame's points.

Port of ``tloam_tpu/parallel/mesh.py`` onto ``torch.distributed``: one
process a device. The "frames" axis splits a batch of frames over the
ranks; the "points" axis shards one frame's scan points for the consensus
solve (parallel.batched). Where the JAX module places arrays on a mesh
(``NamedSharding``), these helpers return the rank's own slice: every rank
holds the whole batch or frame and cuts its part.
"""
from __future__ import annotations

import datetime

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tloam_torch import device as _device
from tloam_torch.cloud import map_tensors

TIMEOUT_S = 60.0


def bootstrap_distributed(coordinator_address: str, num_processes: int, process_id: int,
                          backend: str | None = None, device=None, timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group at "host:port" (``tcp://``) as rank
    `process_id` of `num_processes`. The backend defaults to ``nccl`` on a
    CUDA device and ``gloo`` on the CPU (`device` as in
    tloam_torch.device.resolve); a failure raises and never falls back to
    another backend. A collective that waits longer than `timeout_s` fails.
    Idempotent: a second call returns at once."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if _device.resolve(device).type == "cuda" else "gloo"
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=addr, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_frame_range(n_frames: int) -> tuple[int, int]:
    """The contiguous [start, stop) slice of a frame stream this process
    reads (rank 0 of 1 outside a process group)."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = (n_frames + p - 1) // p
    return min(i * per, n_frames), min((i + 1) * per, n_frames)


def make_mesh(n_devices: int | None = None, frames: int | None = None,
              axis_names: tuple[str, str] = ("frames", "points"), device=None) -> DeviceMesh:
    """A (frames, points) mesh over the group's ranks, rank r at coordinate
    (r // points, r % points). With `frames` unset every rank is its own
    frame group (points axis of size 1); frames=2 on 4 ranks is 2 x 2: two
    frame groups, each summing over 2 point shards."""
    n = n_devices or dist.get_world_size()
    f = frames or n
    assert n == dist.get_world_size(), f"a mesh spans every rank: {n} != {dist.get_world_size()}"
    assert n % f == 0, f"{n} devices not divisible into {f} frame groups"
    return init_device_mesh(_device.resolve(device).type, (f, n // f), mesh_dim_names=axis_names)


def axis_slice(mesh: DeviceMesh, axis: str, n: int) -> slice:
    """This rank's contiguous share of n items along mesh axis `axis`."""
    k = mesh.size(mesh.mesh_dim_names.index(axis))
    assert n % k == 0, f"{n} not divisible over the {k} ranks of {axis!r}"
    i = mesh.get_local_rank(axis)
    return slice(i * (n // k), (i + 1) * (n // k))


def frame_sharding(mesh: DeviceMesh):
    """Batch-of-frames arrays: this rank's slice of the leading axis."""
    return lambda x: x[axis_slice(mesh, "frames", x.shape[0])]


def point_sharding(mesh: DeviceMesh):
    """Per-frame point buffers (B, N, ...): this rank's slice of axis 1."""
    return lambda x: x[:, axis_slice(mesh, "points", x.shape[1])]


def replicated(mesh: DeviceMesh):
    return lambda x: x


def shard_cloud_points(tree, mesh: DeviceMesh, axis: str = "points"):
    """A FeatureSet / Cloud with every leaf cut to this rank's slice of its
    leading (point) axis along `axis`."""
    return map_tensors(tree, lambda x: x[axis_slice(mesh, axis, x.shape[0])])


__all__ = [
    "TIMEOUT_S", "bootstrap_distributed", "process_frame_range", "make_mesh", "axis_slice", "frame_sharding",
    "point_sharding", "replicated", "shard_cloud_points",
]

