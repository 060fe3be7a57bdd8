"""Fixed-capacity masked point cloud — the port's core container.

Port of ``tloam_tpu/cloud.py`` (the reference's
``open3d::geometry::PointCloud2``, include/tloam/open3d/PointCloud2.hpp).
A cloud is a fixed-capacity buffer plus a validity mask; ops that erase
points are mask updates and ops that merge clouds concatenate buffers, so
every shape on the main path is static, as in the JAX package. Every op
keeps all channels aligned: xyz, intensity, validity and the optional
normals and colors (None when absent). The larger op families (outlier
removal, DBSCAN, RANSAC, normals, downsample variants) live in
ops/cloud_ops.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Cloud:
    """xyz (N,3) float, intensity (N,) float, valid (N,) bool; optional
    normals (N,3) and colors (N,3) RGB in [0, 1]."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    valid: torch.Tensor
    normals: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def channels(self) -> tuple:
        """(xyz, intensity, valid, normals, colors), None where absent: the
        JAX Cloud's leaf order."""
        return (self.xyz, self.intensity, self.valid, self.normals, self.colors)

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # ---- constructors ----------------------------------------------------

    @staticmethod
    def empty(capacity: int, dtype=torch.float32, batch: tuple = (), device=None) -> "Cloud":
        dev = torch.device(device or "cpu")
        return Cloud(
            xyz=torch.zeros(batch + (capacity, 3), dtype=dtype, device=dev),
            intensity=torch.zeros(batch + (capacity,), dtype=dtype, device=dev),
            valid=torch.zeros(batch + (capacity,), dtype=torch.bool, device=dev),
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
        """Rigid transform of points AND normals (PointCloud2.cpp:71-77); T
        may carry leading batch dims matching the cloud's."""
        R = T[..., :3, :3]
        t = T[..., :3, 3]
        xyz = self.xyz @ R.transpose(-1, -2) + t[..., None, :]
        normals = None if self.normals is None else self.normals @ R.transpose(-1, -2)
        return dataclasses.replace(self, xyz=xyz, normals=normals)

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
        """Merge two clouds (operator+=, PointCloud2.cpp:96-132) by buffer
        concatenation. A channel present in only one input is zero-filled
        for the other (the reference resizes with zeros)."""

        def cat3(a, b):
            if a is None and b is None:
                return None
            a = torch.zeros_like(self.xyz) if a is None else a
            b = torch.zeros_like(other.xyz) if b is None else b
            return torch.cat([a, b], dim=-2)

        return Cloud(
            xyz=torch.cat([self.xyz, other.xyz], dim=-2),
            intensity=torch.cat([self.intensity, other.intensity], dim=-1),
            valid=torch.cat([self.valid, other.valid], dim=-1),
            normals=cat3(self.normals, other.normals),
            colors=cat3(self.colors, other.colors),
        )

def map_tensors(x, fn):
    """Apply fn to every tensor of a tree of Clouds, NamedTuples (a
    FeatureSet, a table) and tuples; other leaves stay as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, Cloud):
        return Cloud(*(None if t is None else fn(t) for t in x.channels()))
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
        chans = zip(*(t.channels() for t in trees))
        return Cloud(*(None if c[0] is None else torch.stack(c) for c in chans))
    if isinstance(first, tuple):
        vals = (stack_tensors(list(x)) for x in zip(*trees))
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    return first
