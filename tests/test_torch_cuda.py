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
from tloam_torch.utils.timing import STAGES

KW = dict(num_sectors=6, picks_per_sector=20, curv_thres=0.1, suppress_gap_sq=0.05, ring_min_num=131)
R, W = 64, 2304
# (num_sectors, picks_per_sector): the main path's, one sector over every
# warp, sectors of two warps, and a warp per sector with every warp busy
SETTINGS = [(6, 20), (1, 20), (3, 7), (8, 40)]


def boundary_rows(rng: np.random.Generator, lens, width: int, num_sectors: int):
    """Straight rows (gap 0.01, inside the 0.05 chain gate) with small z
    spikes, several within 5 columns of every sector boundary: suppression
    chains cross into the next sector, and a column one sector suppresses
    may be the other sector's pick in the same round."""
    planes = [np.zeros((len(lens), width), np.float32) for _ in range(4)]
    for i, n in enumerate(lens):
        m = min(n, width)
        end = min(n - 5, m)  # interior columns are [5, end)
        z = np.zeros(m)
        spots = list(rng.choice(np.arange(5, end), size=max(m // 60, 1), replace=False))
        total = max(n - 10, 1)
        for s in range(1, num_sectors):
            first = 5 + -(-s * total // num_sectors)  # first column of sector s
            spots += [first + o for o in rng.choice(np.arange(-5, 5), size=4, replace=False) if 5 <= first + o < end]
        z[spots] += rng.uniform(0.05, 0.2, size=len(spots))
        for p, row in zip(planes, (np.arange(m) * 0.1, np.full(m, 2.0), z, np.ones(m))):
            p[i, :m] = row
    return planes


def rings(device, seed: int = 0, width: int = W, num_sectors: int = 6):
    """Dense ring planes (R, width): short rings, rings longer than width
    (cyclic taps), dyadic straight rows with identical spikes (exact
    curvature ties), and 16 rows with picks at the sector boundaries."""
    rng = np.random.default_rng(seed)
    xs, ys, zs, val = (np.zeros((R, width), np.float32) for _ in range(4))
    lens = np.zeros(R, np.int32)
    for r in range(R - 16):
        n = (int(rng.integers(20, 131)), int(rng.integers(width - 3, width + 200)), int(rng.integers(131, width)))[r % 3]
        m = min(n, width)
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
    lens[R - 16:] = rng.integers(131, width + 200, size=16)
    for p, b in zip((xs, ys, zs, val), boundary_rows(rng, lens[R - 16:], width, num_sectors)):
        p[R - 16:] = b
    return [torch.from_numpy(a).to(device) for a in (xs, ys, zs, val, lens)]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    planes = rings("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        edge._pick_rounds_cuda(*planes, **KW)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="unsupported device"):
        edge.pick_rounds(*(p.to("meta") for p in planes), **KW)


def test_plain_version_runs_on_cpu():
    before = STAGES.counts["edge_pick.launch"]
    e, p, c = edge.pick_rounds(*rings("cpu"), **KW)
    assert STAGES.counts["edge_pick.launch"] == before  # the CPU path launches no kernel
    assert e.dtype == p.dtype == torch.bool and c.shape == (R, W)
    assert int(e.sum()) > 100 and bool((p | ~e).all())  # every edge is picked


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2304, 4096, 1000])
@pytest.mark.parametrize("num_sectors,picks", SETTINGS)
def test_kernel_matches_plain_on_gpu(num_sectors, picks, width):
    """Bit for bit: edge and picked masks (torch.bool) and the curvature
    plane. 1000 is no multiple of 32 or 128; 4096 needs more than 48 KB of
    shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw = dict(KW, num_sectors=num_sectors, picks_per_sector=picks)
    planes = rings("cuda", width=width, num_sectors=num_sectors)
    before = STAGES.counts["edge_pick.launch"]
    got = edge.pick_rounds(*planes, **kw)
    torch.cuda.synchronize()
    assert STAGES.counts["edge_pick.launch"] == before + 1
    want = edge._pick_rounds_plain(*planes, **kw)
    assert got[0].dtype == got[1].dtype == torch.bool
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[0].sum()) > 100
