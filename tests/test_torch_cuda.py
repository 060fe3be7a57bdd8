"""The CUDA edge-pick kernel against its plain PyTorch version.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with a card, from the repo root:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which imports JAX.) The tests
marked `cuda` skip without a card: a CUDA kernel has no CPU mode. The
wrapper's input checks run everywhere."""
import numpy as np
import pytest
import torch

from tloam_torch.models import edge

KW = dict(num_sectors=6, picks_per_sector=20, curv_thres=0.1, suppress_gap_sq=0.05, ring_min_num=131)
R, W = 64, 2304


def rings(device, seed: int = 0):
    """Dense ring planes: short rings, rings longer than W (cyclic taps),
    dyadic straight rows with identical spikes (exact curvature ties)."""
    rng = np.random.default_rng(seed)
    xs, ys, zs, val = (np.zeros((R, W), np.float32) for _ in range(4))
    lens = np.zeros(R, np.int32)
    for r in range(R):
        n = (int(rng.integers(20, 131)), int(rng.integers(W - 3, W + 200)), int(rng.integers(131, W)))[r % 3]
        m = min(n, W)
        if r % 2:
            x = np.arange(m) * 0.25
            x[rng.choice(np.arange(10, max(m - 10, 11)), size=min(12, max(m - 20, 1)), replace=False)] += 1.0
            y = np.full(m, 3.0)
        else:
            az = np.linspace(0, 2 * np.pi, m, endpoint=False)
            rad = 7.0 + rng.normal(size=m) * 0.03
            rad[rng.choice(m, size=min(15, m), replace=False)] -= 1.5
            x, y = rad * np.cos(az), rad * np.sin(az)
        xs[r, :m], ys[r, :m], zs[r, :m], val[r, :m], lens[r] = x, y, 0.1 * r, 1.0, n
    return [torch.from_numpy(a).to(device) for a in (xs, ys, zs, val, lens)]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    planes = rings("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        edge._pick_rounds_cuda(*planes, **KW)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="unsupported device"):
        edge.pick_rounds(*(p.to("meta") for p in planes), **KW)


def test_plain_version_runs_on_cpu():
    before = edge.LAUNCHES
    e, p, c = edge.pick_rounds(*rings("cpu"), **KW)
    assert edge.LAUNCHES == before  # the CPU path launches no kernel
    assert e.dtype == p.dtype == torch.bool and c.shape == (R, W)
    assert int(e.sum()) > 100 and bool((p | ~e).all())  # every edge is picked


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """Bit for bit: edge and picked masks and the curvature plane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    planes = rings("cuda")
    before = edge.LAUNCHES
    got = edge.pick_rounds(*planes, **KW)
    torch.cuda.synchronize()
    assert edge.LAUNCHES == before + 1
    want = edge._pick_rounds_plain(*planes, **KW)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[0].sum()) > 100
