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

from tloam_torch import device as _device


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

    @property
    def has_normals(self) -> bool:
        return self.normals is not None

    @property
    def has_colors(self) -> bool:
        return self.colors is not None

    def channels(self) -> tuple:
        """(xyz, intensity, valid, normals, colors), None where absent: the
        JAX Cloud's leaf order."""
        return (self.xyz, self.intensity, self.valid, self.normals, self.colors)

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
        normals: np.ndarray | None = None,
        colors: np.ndarray | None = None,
    ) -> "Cloud":
        """Pad (or truncate) host data to a fixed capacity bucket and move
        it to `device` as ONE packed (cap, 4 [+3 normals] [+3 colors])
        transfer."""
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        if intensity is None:
            intensity = np.zeros((n,), np.float32)
        n = min(n, cap)
        extra = {k: a for k, a in (("normals", normals), ("colors", colors)) if a is not None}
        packed = np.zeros((cap, 4 + 3 * len(extra)), np.float32)
        packed[:n, :3] = xyz[:n]
        packed[:n, 3] = intensity[:n]
        for j, a in enumerate(extra.values()):
            packed[:n, 4 + 3 * j: 7 + 3 * j] = a[:n]
        p = torch.from_numpy(packed).to(_device.resolve(device), dtype)
        return Cloud(
            xyz=p[:, :3],
            intensity=p[:, 3],
            valid=torch.arange(cap, device=p.device) < n,
            **{k: p[:, 4 + 3 * j: 7 + 3 * j] for j, k in enumerate(extra)},
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

    def translate(self, t: torch.Tensor) -> "Cloud":
        return dataclasses.replace(self, xyz=self.xyz + t[..., None, :])

    def _center(self, center) -> torch.Tensor:
        return (self.masked_mean() if center is None else center)[..., None, :]

    def rotate(self, R: torch.Tensor, center: torch.Tensor | None = None) -> "Cloud":
        """Rotate about a center (default: the masked centroid),
        PointCloud2.cpp:85-94."""
        c = self._center(center)
        Rt = R.transpose(-1, -2)
        normals = None if self.normals is None else self.normals @ Rt
        return dataclasses.replace(self, xyz=(self.xyz - c) @ Rt + c, normals=normals)

    def scale(self, s, center: torch.Tensor | None = None) -> "Cloud":
        c = self._center(center)
        return dataclasses.replace(self, xyz=(self.xyz - c) * s + c)

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

    def crop_obb(self, center: torch.Tensor, R: torch.Tensor, half_extent: torch.Tensor) -> "Cloud":
        """Oriented crop box (PointCloud2.cpp:561-569): rotate into the box
        frame and test the axis-aligned extents."""
        local = (self.xyz - center[..., None, :]) @ R
        return self.mask(torch.all(torch.abs(local) <= half_extent, dim=-1))

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

    def compact(self, capacity: int | None = None) -> "Cloud":
        """Gather valid points to the front (stable), in the JAX Cloud's slot
        order; the result has min(capacity, N) slots."""
        cap = capacity if capacity is not None else self.capacity
        idx = torch.argsort((~self.valid).to(torch.uint8), dim=-1, stable=True)[..., :cap]
        take1 = lambda a: torch.gather(a, -1, idx)  # noqa: E731
        idx3 = idx[..., None].expand(idx.shape + (3,))
        take3 = lambda a: None if a is None else torch.gather(a, -2, idx3)  # noqa: E731
        return Cloud(take3(self.xyz), take1(self.intensity), take1(self.valid),
                     take3(self.normals), take3(self.colors))

    def paint_uniform_color(self, rgb: torch.Tensor) -> "Cloud":
        """PaintUniformColor (the Geometry utility the reference inherits)."""
        rgb = torch.as_tensor(rgb, device=self.xyz.device)
        return dataclasses.replace(self, colors=torch.broadcast_to(rgb, self.xyz.shape).to(self.xyz.dtype))

    def masked_xyz(self, fill: float = 1e9) -> torch.Tensor:
        """Points with invalid slots pushed to a far sentinel, so padding
        never wins a nearest-neighbour race."""
        return torch.where(self.valid[..., None], self.xyz, fill)

    def masked_mean(self) -> torch.Tensor:
        m = self.valid.to(self.xyz.dtype)
        cnt = torch.clamp(torch.sum(m, dim=-1), min=1.0)
        return torch.sum(self.xyz * m[..., None], dim=-2) / cnt[..., None]

    def mean_and_covariance(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Masked mean and covariance (PointCloud2.cpp:655-665)."""
        m = self.valid.to(self.xyz.dtype)
        cnt = torch.clamp(torch.sum(m, dim=-1), min=1.0)
        mean = torch.sum(self.xyz * m[..., None], dim=-2) / cnt[..., None]
        diff = (self.xyz - mean[..., None, :]) * m[..., None]
        return mean, diff.transpose(-1, -2) @ diff / cnt[..., None, None]

    def min_bound(self) -> torch.Tensor:
        return torch.amin(torch.where(self.valid[..., None], self.xyz, torch.inf), dim=-2)

    def max_bound(self) -> torch.Tensor:
        return torch.amax(torch.where(self.valid[..., None], self.xyz, -torch.inf), dim=-2)


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
