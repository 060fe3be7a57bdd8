"""The one launcher of the port's CUDA kernels (tloam_torch/build.py), with
a fake in place of each bound C entry point, so it runs without a card.

This file imports neither JAX nor the JAX package."""
import ctypes
import re

import pytest
import torch

from tloam_torch import build
from tloam_torch.utils.timing import STAGES


@pytest.mark.parametrize("kernel", build.KERNELS)
def test_launch_raises_on_an_error_and_counts_each_launch(kernel, monkeypatch):
    """A nonzero return raises a RuntimeError naming the kernel and counts
    nothing; a zero return counts one. Tensors reach the entry point as
    their data pointers, the stream of the tensor's device last."""
    calls, rc = [], [700]  # cudaErrorIllegalAddress

    def entry(*args):
        calls.append(args)
        return rc[0]

    monkeypatch.setitem(build._entries, kernel, entry)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    counter = build.KERNEL_ENTRIES[kernel].counter
    assert counter == {"edge_pick": "edge_pick.launch", "window_moments": "window_moments.launch",
                       "knn_window": "knn.launch"}[kernel]  # stable names (PERF.md §3)
    t = torch.zeros(4)
    before = STAGES.counts[counter]
    with pytest.raises(RuntimeError, match=f"^{kernel}: kernel launch failed with CUDA error 700$"):
        build.launch(kernel, torch.device("cuda", 0), t, 3, 0.5)
    assert STAGES.counts[counter] == before
    rc[0] = 0
    build.launch(kernel, torch.device("cuda", 0), t, 3, 0.5)
    assert STAGES.counts[counter] == before + 1
    assert calls == [(t.data_ptr(), 3, 0.5, 1000)] * 2


C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.mark.parametrize("kernel", build.KERNELS)
def test_entry_signature_is_the_c_prototype(kernel):
    """The bound signature is the .cu entry's, which follows the
    convention: returns int (a cudaError_t), takes the stream last."""
    entry = build.KERNEL_ENTRIES[kernel]
    src = (build.CSRC / f"{kernel}.cu").read_text()
    proto = re.search(rf'extern "C" int {entry.symbol}\(([^)]*)\)', src)
    params = [re.fullmatch(r"(.+?)\s*(\w+)", p.strip()).groups() for p in proto.group(1).split(",")]
    assert params[-1] == ("void*", "stream")
    assert [C_TYPES[t] for t, _ in params[:-1]] == list(entry.args)
