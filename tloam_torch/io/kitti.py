"""KITTI odometry dataset reader.

Port of ``tloam_tpu/io/kitti.py`` (the reference's ``KittiReader``,
src/models/io/kitti_reader.cpp:13-417 and read_file.hpp:307-327): host-side
file I/O, numpy arrays out. A scan is read by the native loader
(``csrc/kitti_loader.cpp``, built by ``tloam_torch.build`` with g++ at first
use and loaded with ctypes) or, when that cannot be built or loaded, by one
``np.fromfile``; both give the same arrays.

Conventions reproduced:
  * velodyne .bin = float32 x,y,z,intensity records; non-finite points
    dropped (read_file.hpp:307-327).
  * calib.txt: the LAST line starting with 'T' (i.e. "Tr:") is the
    camera<-laser extrinsic (kitti_reader.cpp:258-277).
  * ground truth NN.txt: 3x4 row-major camera poses; the velodyne-frame GT
    used by the system is T_map_velo = Tr^-1 * T_0 * T_t * Tr
    (kitti_reader.cpp:93-97).
"""
from __future__ import annotations

import ctypes
import functools
import queue
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tloam_torch import build


@functools.cache
def native_loader():
    """The native loader library, built at first use; None when it cannot
    be built or loaded (no compiler, a failed build): the NumPy reader then
    reads every scan."""
    try:
        lib = build.load("kitti_loader")
    except (OSError, RuntimeError):
        return None
    lib.kitti_read_bin.restype = ctypes.c_long
    lib.kitti_read_bin.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    return lib


def read_velodyne_numpy(path: str | Path, max_points: int | None = None):
    """The NumPy reader of read_velodyne."""
    raw = np.fromfile(str(path), dtype=np.float32)
    raw = raw[: (raw.size // 4) * 4].reshape(-1, 4)
    raw = raw[np.all(np.isfinite(raw), axis=1)]
    if max_points is not None:
        raw = raw[:max_points]
    return np.ascontiguousarray(raw[:, :3]), np.ascontiguousarray(raw[:, 3])


def read_velodyne(path: str | Path, max_points: int | None = None):
    """Read a KITTI velodyne .bin. Returns (xyz (N,3) f32, intensity (N,) f32)
    with non-finite points removed (read_file.hpp:314-324), then the first
    max_points of them. The native loader reads the whole file, so both
    readers give the same arrays for any file and any max_points."""
    lib = native_loader()
    if lib is not None:
        cap = max(Path(path).stat().st_size // 16, 1)
        buf = np.empty((cap, 4), np.float32)
        n = lib.kitti_read_bin(str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
        if n >= 0:
            data = buf[:n] if max_points is None else buf[:min(n, max_points)]
            return np.ascontiguousarray(data[:, :3]), np.ascontiguousarray(data[:, 3])
    return read_velodyne_numpy(path, max_points)


def read_image(path: str | Path, gray: bool) -> np.ndarray:
    """Read one KITTI camera frame (PNG). Returns (H,W) uint8 for grayscale
    or (H,W,3) uint8 for color — the counterpart of readImageGray/
    readImageColor (kitti_reader.cpp:63-88, cv::imread wrappers)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L" if gray else "RGB"))


def parse_calib(path: str | Path) -> np.ndarray:
    """camera<-laser extrinsic Tr as 4x4 (kitti_reader.cpp:258-277)."""
    T = np.eye(4)
    with open(path) as f:
        for line in f:
            if line.startswith("T"):
                vals = [float(v) for v in line.split()[1:13]]
                T[:3, :4] = np.asarray(vals).reshape(3, 4)
    return T


def parse_poses(path: str | Path) -> np.ndarray:
    """KITTI-format pose file -> (M,4,4) (kitti_reader.cpp:318-346)."""
    rows = np.loadtxt(str(path)).reshape(-1, 12)
    M = rows.shape[0]
    out = np.tile(np.eye(4), (M, 1, 1))
    out[:, :3, :4] = rows.reshape(M, 3, 4)
    return out


def gt_velo_poses(cam_poses: np.ndarray, T_cam_laser: np.ndarray) -> np.ndarray:
    """Velodyne-frame GT: T_map_velo = Tr^-1 * T_0 * T_t * Tr
    (kitti_reader.cpp:93-97)."""
    Tr_inv = np.linalg.inv(T_cam_laser)
    T0 = cam_poses[0]
    return np.einsum(
        "ij,njk,kl->nil", Tr_inv @ T0, cam_poses, T_cam_laser
    )


@dataclass
class KittiSequence:
    """A KITTI odometry sequence: sorted scan list + calib + optional GT."""

    root: Path
    sequence: str
    scan_files: list
    calib: np.ndarray | None
    gt_cam: np.ndarray | None

    @staticmethod
    def open(data_path: str | Path, sequence: str = "00") -> "KittiSequence":
        root = Path(data_path)
        seq_dir = root / "sequences" / sequence
        velo = seq_dir / "velodyne"
        scan_files = sorted(velo.glob("*.bin"), key=lambda p: int(p.stem))
        calib_path = seq_dir / "calib.txt"
        calib = parse_calib(calib_path) if calib_path.exists() else None
        gt_path = seq_dir / f"{sequence}.txt"
        gt = parse_poses(gt_path) if gt_path.exists() else None
        return KittiSequence(root, sequence, scan_files, calib, gt)

    def __len__(self) -> int:
        return len(self.scan_files)

    def scan(self, i: int, max_points: int | None = None):
        return read_velodyne(self.scan_files[i], max_points)

    def images(self, i: int, kinds: int = 2) -> list:
        """Camera frames for scan i: image_0/1 are grayscale, image_2/3 color
        (kitti_reader.cpp:63-88 reads `kinds` of them per tick). Missing
        directories yield None entries."""
        out = []
        seq_dir = self.root / "sequences" / self.sequence
        for k in range(min(kinds, 4)):
            p = seq_dir / f"image_{k}" / f"{self.scan_files[i].stem}.png"
            out.append(read_image(p, gray=k < 2) if p.exists() else None)
        return out

    def gt_velo(self) -> np.ndarray | None:
        if self.gt_cam is None or self.calib is None:
            return None
        return gt_velo_poses(self.gt_cam, self.calib)

    def prefetch(self, max_points: int | None = None, depth: int = 4):
        """Iterator with a background prefetch thread, the counterpart of
        the reference's dedicated reader nodelet thread
        (kitti_reader_nodelet.cpp:60-70): disk I/O overlaps device work."""
        return prefetch_iter(
            ((i, self.scan(i, max_points)) for i in range(len(self))),
            depth=depth,
        )


def prefetch_iter(it, depth: int = 4):
    """Run any scan iterator on a background thread with a bounded queue, so
    producing the next item (disk read, raycast synthesis, decompression)
    overlaps the consumer's device step. Exceptions propagate to the
    consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def worker():
        try:
            for item in it:
                if stop.is_set():
                    return
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            q.put((_ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
