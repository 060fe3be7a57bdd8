"""Build and load the port's CUDA kernels and host libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into a shared library loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The host library ``csrc/kitti_loader.cpp`` (the KITTI
scan reader, a copy of native/kitti_loader.cpp) is compiled by ``g++`` with
the flags of native/Makefile. Libraries land in ``build/tloam_torch/``
beside the package (override with ``TLOAM_TORCH_BUILD_DIR``), named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. A failed build raises; nothing falls back here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
KERNELS = ("edge_pick", "window_moments")
HOST_LIBRARIES = ("kitti_loader",)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("TLOAM_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent.parent / "build" / "tloam_torch"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("tloam_torch: nvcc not found (set CUDA_HOME)")
    return found


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_LIBRARIES else f"{name}.cu")


def library_path(name: str) -> Path:
    flags = GXX_FLAGS if name in HOST_LIBRARIES else NVCC_FLAGS
    tag = hashlib.sha256(_source(name).read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{tag}.so"


def compile_command(name: str, out: Path, verbose: bool = False) -> list[str]:
    if name in HOST_LIBRARIES:
        return [os.environ.get("CXX", "g++"), *GXX_FLAGS, "-o", str(out), str(_source(name)), "-lpthread"]
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]
    return cmd + (["-Xptxas", "-v"] if verbose else [])


def build(names=KERNELS, verbose: bool = False) -> dict[str, str]:
    """Compile every named library that is not built yet, all compiler
    processes at once. Returns {name: compiler output} for the ones
    compiled."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        procs[name] = (
            subprocess.Popen(
                compile_command(name, Path(tmp), verbose),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            Path(tmp),
            out,
        )
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"tloam_torch: the build of {_source(name).name} failed:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
