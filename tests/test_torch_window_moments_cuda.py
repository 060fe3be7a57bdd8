"""The CUDA window-moment kernel against its plain PyTorch version.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with a card, from the repo root:

    python -m pytest --noconftest tests/test_torch_window_moments_cuda.py -q

The tests marked `cuda` skip without a card: a CUDA kernel has no CPU mode.
The wrapper's input checks, the plain version and the table's point order
run everywhere."""
import numpy as np
import pytest
import torch

from tloam_torch.ops import voxel as tv
from tloam_torch.utils.timing import STAGES

# two cells with one cell key (voxel._hash_coords): their points share a
# key group and interleave in it, so each cell splits into several runs
COLLIDE = (np.array([-58, 554, -562]), np.array([465, -479, 758]))
# a cell whose key is 0x7fffffff, the key of a slot that is not valid
NO_CELL_KEY = np.array([513, 277, 2337])
# (frames, slots a frame, max_cells, cell size): the batch's edge, planar and
# ground tables (capacities 8192, 12288, 8192), one frame of each, cells
# past max_cells, and the front end's cell PCA of one scan
CASES = [
    (1, 8192, 4096, 1.0), (1, 12288, 6144, 0.5), (64, 8192, 4096, 1.0), (64, 12288, 6144, 0.5),
    (64, 8192, 8192, 0.5), (1, 8192, 256, 0.5), (1, 131072, 65536, 0.2),
]


def in_cell(rng, cell, count: int, cs: float) -> np.ndarray:
    """`count` points inside the cell with integer coords `cell`, clear of
    its faces, so every device floors them into it."""
    return (cell + rng.uniform(0.05, 0.95, size=(count, 3))) * cs


def clouds(F: int, n: int, cs: float, seed: int = 0):
    """F frames of n slots, about 40% of them not valid: cells of one
    point, of 2-8 and of 60 points, the colliding pair (7 points each,
    alternating in input order) and the cell keyed 0x7fffffff (5 points).
    Frames alternate between invalid slots spread among the points and
    trailing padding; the other points come in shuffled order."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-500, 500, size=(F, n, 3)).astype(np.float32)  # what no-cell slots hold
    valid = np.zeros((F, n), bool)
    m = int(n * 0.6)
    for f in range(F):
        shift = rng.integers(-50, 50, size=3)  # the key is linear: shifted cells still collide
        pair = np.stack([in_cell(rng, c + shift, 7, cs) for c in COLLIDE], axis=1).reshape(14, 3)
        parts = [in_cell(rng, NO_CELL_KEY, 5, cs)]
        for _ in range(max(m // 600, 1)):
            parts.append(in_cell(rng, rng.integers(-40, 40, size=3), 60, cs))
        for _ in range(m // 20):
            parts.append(in_cell(rng, rng.integers(-60, 60, size=3), int(rng.integers(2, 9)), cs))
        rest = np.concatenate(parts)
        rest = np.concatenate([rest, rng.uniform(-150, 150, size=(m - 14 - len(rest), 3))])[rng.permutation(m - 14)]
        at = np.zeros(m, bool)
        at[rng.choice(m, size=14, replace=False)] = True
        pts = np.empty((m, 3))
        pts[at], pts[~at] = pair, rest
        slots = np.sort(rng.choice(n, size=m, replace=False)) if f % 2 == 0 else np.arange(m)
        xyz[f, slots] = pts
        valid[f, slots] = True
    return torch.from_numpy(xyz), torch.from_numpy(valid)


def table(F: int, n: int, V: int, cs: float, device):
    xyz, valid = clouds(F, n, cs)
    xyz, valid = xyz.to(device), valid.to(device)
    return xyz, valid, tv.build_block_table(xyz, valid, cs, V)


def leaves(x):
    return [v for item in x for v in leaves(item)] if isinstance(x, tuple) else [x]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype is torch.float32 else t


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xyz, valid, bt = table(2, 600, 512, 0.5, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tv._window_store_cuda(xyz, valid, bt, 0.5)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="float32"):
        tv._window_store_cuda(xyz.double(), valid, bt, 0.5)
    with pytest.raises(ValueError, match="valid must be"):
        tv._window_store_cuda(xyz, valid.to(torch.uint8), bt, 0.5)
    strided = torch.stack([bt.point_order, bt.point_order], dim=-1)[..., 0]
    with pytest.raises(ValueError, match="point_order must be a contiguous"):
        tv._window_store_cuda(xyz, valid, bt._replace(point_order=strided), 0.5)
    with pytest.raises(ValueError, match="xyz must be a contiguous"):  # _window_store makes them contiguous
        tv._window_store_cuda(torch.cat([xyz, xyz], dim=-1)[..., 1:4], valid, bt, 0.5)
    with pytest.raises(ValueError, match="valid must be a contiguous"):
        tv._window_store_cuda(xyz, torch.stack([valid, valid], dim=-1)[..., 0], bt, 0.5)
    x3, v3 = clouds(3, 600, 0.5)
    with pytest.raises(ValueError, match="point_cell"):  # a table of 2 frames for 3 frames of points
        tv._window_store_cuda(x3, v3, bt, 0.5)
    with pytest.raises(ValueError, match="cx, cy, cz"):
        tv._window_store_cuda(xyz, valid, bt._replace(cx=bt.cx.long()), 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        tv._window_store(xyz.to("meta"), valid, bt, 0.5)


@pytest.mark.parametrize("F", [1, 3])
def test_plain_version_runs_on_cpu(F):
    """The plain version launches nothing and holds each cell's moments
    about its anchor (float64 sums of the same points); the colliding cells
    take several rows of one store row, which holds all their points."""
    cs = 0.5
    xyz, valid, bt = table(F, 2000, 1024, cs, "cpu")
    before = STAGES.counts["window_moments.launch"]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)  # index_put_ then adds in input order on the CPU too
    try:
        store = tv._window_store(xyz, valid, bt, cs)
        outs = tv.block_window_moments(xyz, valid, bt, cs, return_cell=True)
    finally:
        torch.use_deterministic_algorithms(was)
    assert STAGES.counts["window_moments.launch"] == before  # the CPU path launches no kernel
    V = bt.cx.shape[1]
    assert store.shape == (F * V * 8 + 8, 16) and not store[F * V * 8:].any() and not store[:, 10:].any()
    cells = np.stack([bt.cx.numpy(), bt.cy.numpy(), bt.cz.numpy()], -1)
    for f in range(F):
        rows = bt.cell_store[f].numpy()
        cv = bt.cell_valid[f].numpy()
        shared = [r for r in np.unique(rows[cv]) if (rows[cv] == r).sum() > 1]
        assert len(shared) >= 1  # the colliding pair split a cell
        pc = bt.point_cell[f].numpy()
        for v in np.flatnonzero(cv)[:200].tolist() + [int(np.flatnonzero(cv & (rows == shared[0]))[0])]:
            same = cv & (rows == rows[v])
            pts = xyz[f].numpy()[np.isin(pc, np.flatnonzero(same)) & valid[f].numpy()].astype(np.float64)
            q = pts - cells[f, v] * np.float64(np.float32(cs))
            want = np.concatenate([[len(q)], q.sum(0), [(q[:, a] * q[:, b]).sum() for a, b in
                                                       ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]])
            got = store[f * V * 8 + rows[v], :10].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * cs * cs * len(q))
            np.testing.assert_array_equal(outs[3][f, v].numpy(), got)


def test_point_order_holds_each_cell_row_as_one_run():
    """Cell row v is the v-th run of point_order, in input order; a row
    that is not valid (slots not valid, or past max_cells) holds no point."""
    F, n = 3, 2000
    xyz, valid, bt = table(F, n, 1024, 0.5, "cpu")
    for f in range(F):
        order = bt.point_order[f].numpy()
        assert np.array_equal(np.sort(order), np.arange(n))
        pc = bt.point_cell[f].numpy()[order]
        live = pc >= 0
        assert np.all(np.diff(pc[live]) >= 0)  # rows appear in order
        starts = np.flatnonzero(live & np.r_[True, pc[1:] != pc[:-1]])
        rows = pc[starts]
        assert len(np.unique(rows)) == len(rows)  # each row one run
        cv = bt.cell_valid[f].numpy()
        assert cv[rows].all() and cv.sum() == len(rows)
        for s in starts[:300]:
            e = s
            while e < n and pc[e] == pc[s]:
                e += 1
            assert np.all(np.diff(order[s:e]) > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("F,n,V,cs", CASES)
def test_kernel_matches_plain_on_gpu(F, n, V, cs, monkeypatch):
    """Bit for bit: the store and all four outputs of block_window_moments;
    two launches give the same store; each launch counts once. One frame
    goes through the unframed (2-D) call, with its points and flags as
    strided views, as the unpacked frame path hands them over (the
    dispatch makes them contiguous)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    xyz, valid, bt = table(F, n, V, cs, "cuda")
    if F == 1:
        xyz = torch.cat([xyz[0], valid[0, :, None].float()], dim=-1)[:, :3]
        valid = torch.stack([valid[0], valid[0]], dim=-1)[:, 1]
        assert not (xyz.is_contiguous() or valid.is_contiguous())
        bt = tv.build_block_table(xyz, valid, cs, V)
    framed = (xyz[None], valid[None], tv._enframe(bt)) if F == 1 else (xyz, valid, bt)
    before = STAGES.counts["window_moments.launch"]
    got = tv._window_store(*framed, cs)
    torch.cuda.synchronize()
    assert STAGES.counts["window_moments.launch"] == before + 1
    want = tv._window_store_plain(*framed, cs)
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(tv._window_store(*framed, cs)), bits(got))
    assert int(got[:, 0].sum()) == int((framed[1] & (framed[2].point_cell >= 0)).sum())
    t = framed[2]
    for f in range(t.cx.shape[0]):
        if bool((t.point_cell[f] >= 0)[framed[1][f]].all()):  # no cell past max_cells: the pair split a cell
            rows = t.cell_store[f][t.cell_valid[f]]
            assert len(rows) > len(torch.unique(rows))

    outs = tv.block_window_moments(xyz, valid, bt, cs, return_cell=True)
    monkeypatch.setattr(tv, "_window_store", tv._window_store_plain)
    plain = tv.block_window_moments(xyz, valid, bt, cs, return_cell=True)
    torch.cuda.synchronize()
    assert STAGES.counts["window_moments.launch"] == before + 3
    assert len(leaves(outs)) == len(leaves(plain)) == 17
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(leaves(outs), leaves(plain)))
