"""tloam_torch.io (KITTI reader, native loader, PLY/PCD/bin files) against
tloam_tpu.io, on the CPU. Files written by the two packages are byte for
byte equal, and every array read is exactly equal. Mirrors
tests/test_io_trajectory.py and tests/test_gicp_globalmap_io.py::
test_ply_pcd_bin_roundtrip."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tloam_torch.cloud import Cloud as TCloud
from tloam_torch.io import kitti as tk, pointcloud_io as tio

from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.io import kitti as jk, pointcloud_io as jio

from tests.test_torch_common import f32, tt


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """A miniature KITTI sequence tree (as tests/test_io_trajectory.py)."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("kitti")
    seq = root / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    for i in range(3):
        pts = rng.normal(size=(500, 4)).astype(np.float32)
        pts[5, 0] = np.nan
        pts[9, 3] = np.inf
        pts.tofile(seq / "velodyne" / f"{i:06d}.bin")
    Tr = np.eye(4)
    Tr[:3, 3] = [0.1, -0.05, -0.2]
    with open(seq / "calib.txt", "w") as f:
        for name in ["P0", "P1", "P2", "P3"]:
            f.write(f"{name}: " + " ".join(["0"] * 12) + "\n")
        f.write("Tr: " + " ".join(str(v) for v in Tr[:3, :4].ravel()) + "\n")
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[1, 0, 3] = 1.0
    poses[2, :3, 3] = [2.0, 0.5, 0.1]
    np.savetxt(seq / "00.txt", poses[:, :3, :4].reshape(3, 12))
    return root


def test_velodyne_readers_match_jax(kitti_tree):
    """The native and NumPy readers give the NumPy reader's arrays, with and
    without max_points. (The JAX package's native loader reads max_points
    records before it drops the non-finite ones, so with max_points it
    returns fewer points than its NumPy reader; the port reads the whole
    file natively and then cuts.)"""
    path = kitti_tree / "sequences" / "00" / "velodyne" / "000001.bin"
    assert tk.native_loader() is not None, "the native loader should build with g++ and load"
    for max_points in (None, 100):
        raw = np.fromfile(path, np.float32).reshape(-1, 4)
        raw = raw[np.all(np.isfinite(raw), axis=1)][:max_points]
        outs = [tk.read_velodyne(path, max_points), tk.read_velodyne_numpy(path, max_points)]
        if max_points is None:
            outs.append(jk.read_velodyne(path))
        for xyz, inten in outs:
            assert np.array_equal(xyz, raw[:, :3]) and np.array_equal(inten, raw[:, 3])
            assert xyz.flags.c_contiguous and xyz.dtype == np.float32


def test_sequence_calib_and_ground_truth_match_jax(kitti_tree):
    st = tk.KittiSequence.open(kitti_tree, "00")
    sj = jk.KittiSequence.open(kitti_tree, "00")
    assert len(st) == len(sj) == 3 and st.scan_files == sj.scan_files
    assert np.array_equal(st.calib, sj.calib) and np.array_equal(st.gt_cam, sj.gt_cam)
    assert np.array_equal(st.gt_velo(), sj.gt_velo())
    seq = kitti_tree / "sequences" / "00"
    assert np.array_equal(tk.parse_poses(seq / "00.txt"), jk.parse_poses(seq / "00.txt"))
    assert st.images(1) == [None, None]  # no camera directories: PIL is never imported
    got = [(i, s[0].shape) for i, s in st.prefetch()]
    assert got == [(i, s[0].shape) for i, s in sj.prefetch()] and [g[0] for g in got] == [0, 1, 2]


def test_prefetch_propagates_errors():
    def gen():
        yield 0
        raise KeyError("boom")

    it = tk.prefetch_iter(gen(), depth=1)
    assert next(it) == 0
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_files_are_byte_identical_to_jax(tmp_path, rng):
    xyz = f32(rng.normal(size=(100, 3)))
    inten = f32(rng.uniform(size=100))
    normals = f32(rng.normal(size=(128, 3)))
    jc = JCloud.from_numpy(xyz, inten, capacity=128).paint_uniform_color(jnp.asarray([0.2, 0.4, 0.8]))
    tc = TCloud.from_numpy(xyz, inten, capacity=128, device="cpu").paint_uniform_color(tt(f32([0.2, 0.4, 0.8])))
    jc_n = dataclasses.replace(jc, normals=jnp.asarray(normals))
    tc_n = dataclasses.replace(tc, normals=tt(normals))
    for name, fj, ft, cj, ct in (
        ("c.pcd", jio.write_pcd, tio.write_pcd, jc, tc),
        ("c.bin", jio.write_kitti_bin, tio.write_kitti_bin, jc, tc),
        ("c.ply", jio.write_ply, tio.write_ply, jc_n, tc_n),
        ("plain.ply", jio.write_ply, tio.write_ply, JCloud.from_numpy(xyz, inten, capacity=128),
         TCloud.from_numpy(xyz, inten, capacity=128, device="cpu")),
    ):
        assert fj(tmp_path / f"j_{name}", cj) == ft(tmp_path / f"t_{name}", ct) == 100
        assert (tmp_path / f"j_{name}").read_bytes() == (tmp_path / f"t_{name}").read_bytes(), name
    for a, b in zip(tio.read_pcd(tmp_path / "t_c.pcd"), jio.read_pcd(tmp_path / "t_c.pcd")):
        assert np.array_equal(a, b)
    x2, i2 = tio.read_pcd(tmp_path / "t_c.pcd")
    assert np.array_equal(x2, xyz) and np.array_equal(i2, inten)
    x3, i3 = tk.read_velodyne(tmp_path / "t_c.bin")
    assert np.array_equal(x3, xyz) and np.array_equal(i3, inten)
    head = (tmp_path / "t_c.ply").read_text().splitlines()[:14]
    assert "property float nx" in head and "property uchar red" in head
