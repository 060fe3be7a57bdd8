"""Fixed-capacity masked point cloud — the port's core container.

Port of ``tloam_tpu/cloud.py`` (the reference's
``open3d::geometry::PointCloud2``, include/tloam/open3d/PointCloud2.hpp).
A cloud is a fixed-capacity buffer plus a validity mask; ops that erase
points are mask updates and ops that merge clouds concatenate buffers, so
every shape on the main path is static, as in the JAX package. Only the
main-path surface is ported (normals, colors, OBB crop and the Open3D-style
op families come later).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tloam_torch import device as _device


@dataclasses.dataclass(frozen=True)
class Cloud:
    """xyz (N,3) float, intensity (N,) float, valid (N,) bool."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)

    # ---- constructors ----------------------------------------------------

    @staticmethod
    def empty(capacity: int, dtype=torch.float32, batch: tuple = (), device=None) -> "Cloud":
        dev = _device.resolve(device)
        return Cloud(
            xyz=torch.zeros(batch + (capacity, 3), dtype=dtype, device=dev),
            intensity=torch.zeros(batch + (capacity,), dtype=dtype, device=dev),
            valid=torch.zeros(batch + (capacity,), dtype=torch.bool, device=dev),
        )

    @staticmethod
    def from_numpy(
        xyz: np.ndarray,
        intensity: np.ndarray | None = None,
        capacity: int | None = None,
        dtype=torch.float32,
        device=None,
    ) -> "Cloud":
        """Pad (or truncate) host data to a fixed capacity bucket and move
        it to `device` as ONE packed (cap,4) transfer."""
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        if intensity is None:
            intensity = np.zeros((n,), np.float32)
        if n > cap:
            xyz, intensity = xyz[:cap], intensity[:cap]
            n = cap
        packed = np.zeros((cap, 4), np.float32)
        packed[:n, :3] = xyz
        packed[:n, 3] = intensity
        p = torch.from_numpy(packed).to(_device.resolve(device), dtype)
        return Cloud(
            xyz=p[:, :3],
            intensity=p[:, 3],
            valid=torch.arange(cap, device=p.device) < n,
        )

    # 4 mm fixed point: int16 covers +-131 m — beyond the HDL-64E's 120 m
    # max range — at 2.5x finer than the sensor's ~1 cm noise floor
    PACK_SCALE = 0.004
    PACK_INT_SCALE = 1.0 / 1000.0

    @staticmethod
    def pack_scan(
        xyz: np.ndarray, intensity: np.ndarray | None = None,
        capacity: int | None = None,
    ) -> tuple[np.ndarray, int]:
        """Quantize a raw scan for host->device transfer: ONE (cap, 4)
        int16 array (x, y, z at 4 mm fixed point; intensity at 1/1000).
        Points beyond int16 range are EXCLUDED (a stable filter keeps the
        ring/azimuth order), never clamped onto the range shell."""
        limit = 32767 * Cloud.PACK_SCALE
        in_range = np.max(np.abs(xyz), axis=1) <= limit
        if not in_range.all():
            xyz = xyz[in_range]
            intensity = intensity[in_range] if intensity is not None else None
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        if n > cap:
            xyz = xyz[:cap]
            intensity = intensity[:cap] if intensity is not None else None
            n = cap
        q = np.zeros((cap, 4), np.int16)
        np.clip(
            np.rint(xyz / Cloud.PACK_SCALE), -32767, 32767, out=q[:n, :3],
            casting="unsafe",
        )
        if intensity is not None:
            np.clip(
                np.rint(intensity / Cloud.PACK_INT_SCALE), -32767, 32767,
                out=q[:n, 3], casting="unsafe",
            )
        return q, n

    @staticmethod
    def from_packed(q: torch.Tensor, n, dtype=torch.float32) -> "Cloud":
        """Dequantize a pack_scan array that already lies on the device."""
        return Cloud(
            xyz=q[:, :3].to(dtype) * Cloud.PACK_SCALE,
            intensity=q[:, 3].to(dtype) * Cloud.PACK_INT_SCALE,
            valid=torch.arange(q.shape[0], device=q.device) < n,
        )

    # ---- core ops (reference PointCloud2.cpp counterparts) ---------------

    def transform(self, T: torch.Tensor) -> "Cloud":
        """Rigid transform of the points (PointCloud2.cpp:71-77); T may carry
        leading batch dims matching the cloud's."""
        R = T[..., :3, :3]
        t = T[..., :3, 3]
        xyz = self.xyz @ R.transpose(-1, -2) + t[..., None, :]
        return dataclasses.replace(self, xyz=xyz)

    def mask(self, keep: torch.Tensor) -> "Cloud":
        """Logical-AND a predicate into validity (SelectByIndex)."""
        return dataclasses.replace(self, valid=self.valid & keep)

    def remove_nonfinite(self) -> "Cloud":
        return self.mask(torch.all(torch.isfinite(self.xyz), dim=-1))

    def remove_close(self, near_dis: float) -> "Cloud":
        """Drop points within near_dis of the sensor (segmentation.cpp:472-499)."""
        return self.mask(torch.sum(self.xyz * self.xyz, dim=-1) > near_dis * near_dis)

    def crop_aabb(self, lo: torch.Tensor, hi: torch.Tensor) -> "Cloud":
        """Axis-aligned crop box (PointCloud2.cpp:551-560)."""
        inside = torch.all((self.xyz >= lo) & (self.xyz <= hi), dim=-1)
        return self.mask(inside)

    def concat(self, other: "Cloud") -> "Cloud":
        """Merge two clouds (operator+=) by buffer concatenation."""
        return Cloud(
            xyz=torch.cat([self.xyz, other.xyz], dim=-2),
            intensity=torch.cat([self.intensity, other.intensity], dim=-1),
            valid=torch.cat([self.valid, other.valid], dim=-1),
        )


def map_tensors(x, fn):
    """Apply fn to every tensor of a tree of Clouds, NamedTuples (a
    FeatureSet, a table) and tuples; other leaves stay as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, Cloud):
        return Cloud(fn(x.xyz), fn(x.intensity), fn(x.valid))
    if isinstance(x, tuple):
        vals = (map_tensors(v, fn) for v in x)
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def stack_tensors(trees):
    """Equal trees (as map_tensors walks them) -> one tree whose every
    tensor is the stack of theirs along a new leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, Cloud):
        return Cloud(*(torch.stack([getattr(t, f) for t in trees]) for f in ("xyz", "intensity", "valid")))
    if isinstance(first, tuple):
        vals = (stack_tensors(list(x)) for x in zip(*trees))
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    return first
