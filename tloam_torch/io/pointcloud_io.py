"""Point-cloud files: PLY / PCD / KITTI .bin writers and a PCD reader.

Port of ``tloam_tpu/io/pointcloud_io.py`` (the role of the reference's ROS
conversion layer, src/open3d/open3d_to_ros.cpp): whatever channels a Cloud
carries (xyz, intensity, normals, colors) are written, valid points only,
from host copies of the port's tensors. A file written here is byte for
byte the JAX package's for the same values.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from tloam_torch.cloud import Cloud


def _host_channels(cloud: Cloud) -> dict:
    v = cloud.valid.cpu().numpy()
    out = {"xyz": cloud.xyz.cpu().numpy()[v], "intensity": cloud.intensity.cpu().numpy()[v]}
    if cloud.normals is not None:
        out["normals"] = cloud.normals.cpu().numpy()[v]
    if cloud.colors is not None:
        out["colors"] = cloud.colors.cpu().numpy()[v]
    return out


def write_ply(path: str | Path, cloud: Cloud) -> int:
    """ASCII PLY with channel negotiation (like Open3dToRos's 8 layouts)."""
    ch = _host_channels(cloud)
    n = len(ch["xyz"])
    props = ["property float x", "property float y", "property float z", "property float intensity"]
    cols = [ch["xyz"], ch["intensity"][:, None]]
    if "normals" in ch:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(ch["normals"])
    if "colors" in ch:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("\n".join(props) + "\n")
        f.write("end_header\n")
        data = np.concatenate(cols, axis=1)
        for i in range(n):
            row = " ".join(f"{v:.6f}" for v in data[i])
            if "colors" in ch:
                rgb = np.clip(ch["colors"][i] * 255, 0, 255).astype(int)
                row += " " + " ".join(str(c) for c in rgb)
            f.write(row + "\n")
    return n


def write_pcd(path: str | Path, cloud: Cloud) -> int:
    """Binary PCD v0.7 (x y z intensity)."""
    ch = _host_channels(cloud)
    n = len(ch["xyz"])
    data = np.concatenate([ch["xyz"], ch["intensity"][:, None]], axis=1).astype(np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
        "TYPE F F F F\nCOUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())
    return n


def read_pcd(path: str | Path):
    """Read a binary or ascii PCD with x y z [intensity] fields: (xyz (N,3),
    intensity (N,)) float32 host arrays."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode().strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        n = int(header["POINTS"])
        if header["DATA"] == "binary":
            raw = np.frombuffer(f.read(4 * len(fields) * n), np.float32).reshape(n, len(fields))
        else:
            raw = np.loadtxt(f, dtype=np.float32).reshape(n, len(fields))
    xyz = raw[:, :3]
    inten = raw[:, 3] if len(fields) > 3 else np.zeros(n, np.float32)
    return xyz, inten


def write_kitti_bin(path: str | Path, cloud: Cloud) -> int:
    """KITTI velodyne .bin (float32 x, y, z, intensity records)."""
    ch = _host_channels(cloud)
    data = np.concatenate([ch["xyz"], ch["intensity"][:, None]], axis=1).astype(np.float32)
    data.tofile(str(path))
    return len(data)
