"""Build and load the port's CUDA kernels and host libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into a shared library loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The host library ``csrc/kitti_loader.cpp`` (the KITTI
scan reader, a copy of native/kitti_loader.cpp) is compiled by ``g++`` with
the flags of native/Makefile. Libraries land in ``build/tloam_torch/``
beside the package (override with ``TLOAM_TORCH_BUILD_DIR``), named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. A failed build raises; nothing falls back here.

Every path from Python into a kernel goes through here. The C entry
convention: each ``csrc/*.cu`` entry point (``KERNEL_ENTRIES``) returns its
``cudaError_t`` as ``int`` and takes the ``cudaStream_t`` last. ``load``
binds it, ``launch`` calls it, ``check`` validates a wrapper's inputs and
``on_card`` picks the kernel or its plain PyTorch version by device.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from tloam_torch.utils.timing import STAGES

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]


class Entry(NamedTuple):
    """A kernel library's C entry point."""

    symbol: str
    args: tuple  # ctypes types of its arguments before the stream
    counter: str  # the tracer's counter of its launches (stable names, PERF.md §3)


_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
KERNEL_ENTRIES = {
    "edge_pick": Entry("tloam_edge_pick", (_P,) * 8 + (_I,) * 4 + (_F,) * 2 + (_I,), "edge_pick.launch"),
    "window_moments": Entry("tloam_window_moments", (_P,) * 7 + (_I64,) * 2 + (_P,) * 3 + (_I,) * 3 + (_F,),
                            "window_moments.launch"),
    "knn_window": Entry("tloam_knn_window", (_P,) * 10 + (_I,) * 6 + (_F,), "knn.launch"),
}
KERNELS = tuple(KERNEL_ENTRIES)
HOST_LIBRARIES = ("kitti_loader",)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict = {}  # kernel -> its bound C entry point


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
    """The library `name`, built at first use; a kernel's entry point is
    bound with its signature then."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            if name in KERNEL_ENTRIES:
                entry = KERNEL_ENTRIES[name]
                fn = getattr(lib, entry.symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = [*entry.args, ctypes.c_void_p]
                _entries[name] = fn
            _loaded[name] = lib
        return lib


def launch(kernel: str, device: torch.device, *args) -> None:
    """Call `kernel`'s entry point with `args` (tensors as their data
    pointers) and the current stream of `device`, switching to that device
    only when it is not current. A nonzero return raises; each launch that
    returns 0 adds one to the kernel's counter."""
    fn = _entries.get(kernel)
    if fn is None:
        load(kernel)
        fn = _entries[kernel]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    on_dev = contextlib.nullcontext() if device.index == torch.cuda.current_device() else torch.cuda.device(device)
    with on_dev:
        # the raw cudaStream_t (torch.cuda.current_stream() builds a Stream
        # object, several microseconds a call)
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {rc}")
    STAGES.count(KERNEL_ENTRIES[kernel].counter)


def check(kernel: str, *inputs) -> torch.device:
    """Each (name, tensor, dtype, shape) of `inputs` must be a contiguous
    tensor of that dtype and shape on the first one's device, and that
    device a CUDA device; raises ValueError naming the first that is not.
    Returns the device."""
    device = inputs[0][1].device
    fits = [t.dtype is dtype and t.shape == shape and t.is_contiguous() and t.device == device
            for _, t, dtype, shape in inputs]
    if all(fits) and device.type == "cuda":
        return device
    name, _, dtype, shape = inputs[fits.index(False) if False in fits else 0]
    raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} CUDA tensor of shape {tuple(shape)}")


def on_card(kernel: str, device: torch.device) -> bool:
    """Dispatch by device: True where `kernel` runs (a CUDA tensor), False
    where its plain PyTorch version does (a CPU tensor); any other device
    raises ValueError."""
    if device.type in ("cuda", "cpu"):
        return device.type == "cuda"
    raise ValueError(f"{kernel}: unsupported device {device}")
