"""The reference piece of kitti-hdl64.gicp (lidar_bench/gicp_reference/)
against the port's GICP path, and against a dense witness, on the CPU.

The piece and the port run the same float32 operations in the same order
on one device, so where both are given the same inputs they must agree bit
for bit: every comparison with the port is `torch.equal`. A drift in
either (a reordered sum, another regularization) breaks that, and the
check on the card, which allows for reordered sums, is where a tolerance
belongs. The dense witness computes in float64 from all pairs, with no
hash grid; its tolerance is float32's (below). Last, a piece whose
covariances are the identity (GICP turned into point-to-point) must make
a sound run come out not correct through cell.run.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from lidar_bench.gicp_reference import registration as piece_reg
from lidar_bench.harness import cell, programs, scans as scans_mod, spec
from lidar_bench.reference import cloud as ref_cloud, voxel as ref_voxel
from lidar_bench.tests.conftest import SEED, write_piece
from tloam_torch.cloud import Cloud
from tloam_torch.models import registration as port_reg
from tloam_torch.ops import se3, voxel as port_voxel

CELL, CONFIG = "gicp.batch64-urban", "kitti-hdl64.gicp"
K_CORR = 10


@pytest.fixture(scope="module")
def deterministic():
    """The CPU's accumulating index_put_ adds in a thread-dependent order
    otherwise (the solver's cell tables)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.fixture(scope="module")
def captured(tiny_bench, deterministic):
    """The tiny batch's problems (frames 4-5 of the fixed drive, one replica)
    as each side captures them through its own frame path: {side: (program,
    PipelineConfig, (scans, submaps, predictions))}."""
    config, traffic = spec.config(CONFIG, tiny_bench), spec.traffic("batch64-urban", tiny_bench)
    traffic.update(problem_frames=[4, 5], replicas=1)
    scans = scans_mod.drive_scans(traffic["drive"], config["sensor"], int(traffic["drive_seed"]), 1,
                                  tiny_bench / ".scan_cache")
    out = {}
    for side, prog in (("port", programs.port("cpu")), ("piece", programs.reference(config))):
        drv = cell.driver(prog, config, traffic, scans, "cpu", SEED)
        out[side] = (prog, drv.cfg, drv.problems())
    return out


def _flat(tree) -> list[torch.Tensor]:
    """The tensors of a tree of tuples and clouds, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _flat(x)]
    if tree is None:
        return []
    return [t for t in (tree.xyz, tree.intensity, tree.valid) if t is not None]


def _equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) > 0 and all(torch.equal(x, y) for x, y in zip(fa, fb))


def _clouds(rng, frames: int, n: int, fill: float):
    """Seeded points on two planes and a box corner, with noise; a share
    `fill` of the slots valid. (port Cloud, reference Cloud) of the same
    tensors, ([frames,] n, 3)."""
    u = rng.uniform(-4.0, 4.0, (frames, n, 2))
    side = rng.integers(0, 3, (frames, n))
    xyz = np.where(side[..., None] == 0, np.stack([u[..., 0], u[..., 1], np.zeros_like(u[..., 0])], -1),
                   np.where(side[..., None] == 1, np.stack([u[..., 0], np.full_like(u[..., 0], 2.0), u[..., 1]], -1),
                            np.stack([np.full_like(u[..., 0], -3.0), u[..., 0], u[..., 1]], -1)))
    xyz = torch.as_tensor(xyz + rng.normal(0.0, 0.02, xyz.shape) + [30.0, -12.0, 1.5], dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=(frames, n)) < fill)
    inten = torch.zeros((frames, n))
    return Cloud(xyz, inten, valid), ref_cloud.Cloud(xyz, inten, valid)


@pytest.mark.parametrize("frames,n,fill", [(1, 3000, 1.0), (3, 2048, 0.7)])
def test_the_covariances_agree_bit_for_bit(frames, n, fill):
    port_c, ref_c = _clouds(np.random.default_rng(frames * 1000 + n), frames, n, fill)
    if frames == 1:
        port_c, ref_c = (Cloud(port_c.xyz[0], port_c.intensity[0], port_c.valid[0]),
                         ref_cloud.Cloud(ref_c.xyz[0], ref_c.intensity[0], ref_c.valid[0]))
    want = port_reg.calculate_covariances(port_c, K_CORR, max_per_cell=8)
    got = piece_reg.calculate_covariances(ref_c, K_CORR, max_per_cell=8)
    assert got.shape == port_c.xyz.shape + (3,)
    assert torch.equal(got, want)
    # slots that are not valid fall back to the identity; valid ones on the planes do not
    ident = (want == torch.eye(3)).all(-1).all(-1)
    assert torch.equal(ident | port_c.valid, torch.ones_like(ident))
    assert int((ident & port_c.valid).sum()) < 0.01 * int(port_c.valid.sum())


def _witness(xyz: torch.Tensor, valid: torch.Tensor, k: int, radius: float) -> torch.Tensor:
    """calculateCov from a dense all-pairs kNN in float64: the k nearest
    other valid points within `radius`, their covariance, eigenvalues over
    the largest clamped at 1e-3, the middle one floored at 0.1; the identity
    with fewer than 3 neighbours. Also returns the smallest gap between the
    k-th and the (k+1)-th distance, so a near tie can be told apart."""
    p = xyz.double()
    d = torch.cdist(p, p)
    d = torch.where(valid[None, :] & ~torch.eye(len(p), dtype=torch.bool), d, torch.inf)
    dk, idx = torch.topk(d, k + 1, largest=False)
    ok = dk[:, :k] <= radius
    nb = p[idx[:, :k]]
    m = ok.double()[..., None]
    cnt = m.sum(1).clamp(min=1.0)
    mean = (nb * m).sum(1) / cnt
    c = nb - mean[:, None]
    cov = torch.einsum("nki,nkj->nij", c * m, c) / cnt[..., None]
    w, V = torch.linalg.eigh(cov)
    w_reg = (w / w[:, 2:3].clamp(min=1e-12)).clamp(min=1e-3)
    w_reg[:, 1] = w_reg[:, 1].clamp(min=0.1)
    out = V @ torch.diag_embed(w_reg) @ V.transpose(-1, -2)
    out = torch.where((ok.sum(1) < 3)[:, None, None], torch.eye(3, dtype=torch.float64), out)
    inside = dk[:, k] <= radius
    gap = torch.where(inside, dk[:, k] - dk[:, k - 1], torch.inf)
    return out[valid], float(gap[valid].min())


def test_both_covariances_equal_a_dense_knn_witness():
    """On a jittered 0.5 m lattice every 1 m hash cell holds 8 points (the
    max_per_cell cap), so the hash window sees every neighbour within 1 m.
    Tolerance 2e-4 on covariances normalized to a unit largest eigenvalue:
    the closed-form float32 eigen solve (eig3.eigh3) loses about 1e-5 of
    its eigenvectors where two eigenvalues lie close; a neighbour set that
    differed by one point moves entries by 1e-2 and more."""
    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(*(np.arange(8) * 0.5 + 0.25,) * 3, indexing="ij"), -1).reshape(-1, 3)
    xyz = torch.as_tensor(g + rng.uniform(-0.08, 0.08, g.shape) + [2.0, -3.0, 1.0], dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=len(g)) < 0.9)
    cells = torch.floor(xyz.double()).to(torch.int64)
    _, per_cell = torch.unique(cells, dim=0, return_counts=True)
    assert int(per_cell.max()) <= 8
    want, gap = _witness(xyz, valid, K_CORR, 1.0)
    # no near tie at the k-th neighbour: float32 distances within 5 m of the origin err by about 1e-6
    assert gap > 1e-5
    inten = torch.zeros(len(g))
    port = port_reg.calculate_covariances(Cloud(xyz, inten, valid), K_CORR, max_per_cell=8)
    piece = piece_reg.calculate_covariances(ref_cloud.Cloud(xyz, inten, valid), K_CORR, max_per_cell=8)
    for got in (port, piece):
        assert torch.allclose(got[valid].double(), want, atol=2e-4, rtol=0.0), (got[valid].double() - want).abs().max()


def test_the_piece_captures_the_ports_problems(captured):
    assert _equal(captured["port"][2], captured["piece"][2])


def _hash_grids(mod, submap, tls):
    grid = lambda c, pitch: mod.build_hash_grid(c.xyz, c.valid, pitch)  # noqa: E731
    return {"edge": grid(submap.edge, tls.edge_dist_thres), "sphere": grid(submap.sphere, tls.sphere_dist_thres),
            "planar": grid(submap.planar, tls.gicp_dist_thres), "ground": grid(submap.ground, tls.gicp_dist_thres)}


def _covs(fn, scan, submap, tls):
    return {name: fn(c, tls.k_corr, max_per_cell=tls.max_per_cell)
            for name, c in (("scan_planar", scan.planar), ("scan_ground", scan.ground),
                            ("submap_planar", submap.planar), ("submap_ground", submap.ground))}


@pytest.mark.parametrize("coarse", [False, True, "mixed"])
def test_the_correspondences_and_normal_equations_agree(captured, coarse):
    """At each problem's predicted pose moved by 5 cm and 0.01 rad: the GICP
    matches (fine, coarse, or per frame), their covariances, and the
    evaluated H, g and per-point costs under seeded GNC weights."""
    (_, cfg, (scan, submap, predict)), (_, rcfg, (rscan, rsubmap, _)) = captured["port"], captured["piece"]
    tls, rtls = cfg.odometry.tls, rcfg.odometry.tls
    B = predict.shape[0]
    xi = se3.log(predict) + torch.tensor([0.05, -0.03, 0.0, 0.0, 0.0, 0.01])
    grids, rgrids = _hash_grids(port_voxel, submap, tls), _hash_grids(ref_voxel, rsubmap, rtls)
    covs = _covs(port_reg.calculate_covariances, scan, submap, tls)
    rcovs = _covs(piece_reg.calculate_covariances, rscan, rsubmap, rtls)
    assert _equal(tuple(covs.values()), tuple(rcovs.values()))
    use = torch.arange(B) % 2 == 0 if coarse == "mixed" else coarse
    if coarse:
        pitch, cap = tls.planar_dist_thres * tls.coarse_scale, port_reg._cells_cap(submap.planar, 2)
        grids["planar_coarse"] = port_reg._build_surf_cells(submap.planar, pitch, cap, precise_thres=0.6)
        rgrids["planar_coarse"] = piece_reg._build_surf_cells(rsubmap.planar, pitch, cap, precise_thres=0.6)
    corr = port_reg._build_correspondences(xi, scan, submap, grids, tls, use, covs)
    rcorr = piece_reg._build_correspondences(xi, rscan, rsubmap, rgrids, rcovs, rtls, use)
    pairs = [(corr.plane_n, rcorr.plane_t), (corr.plane_valid, rcorr.plane_valid), (corr.ground_n, rcorr.ground_t),
             (corr.ground_valid, rcorr.ground_valid), (corr.plane_tgt_cov, rcorr.plane_tgt_cov),
             (corr.ground_tgt_cov, rcorr.ground_tgt_cov), (corr.edge_a, rcorr.edge_a), (corr.edge_b, rcorr.edge_b),
             (corr.edge_valid, rcorr.edge_valid), (corr.sphere_t, rcorr.sphere_t),
             (corr.sphere_valid, rcorr.sphere_valid)]
    assert all(torch.equal(a, b) for a, b in pairs)
    assert int(corr.plane_valid.sum()) > 0 and int(corr.ground_valid.sum()) > 0
    gen = torch.Generator().manual_seed(SEED)
    w = port_reg._Weights(*(torch.rand(c.valid.shape, generator=gen)
                            for c in (scan.planar, scan.ground, scan.edge, scan.sphere)))
    H, g, costs = port_reg._evaluate(xi, scan, corr, w, tls.gicp_noise_bound)
    rH, rg, rcosts = piece_reg._evaluate(xi, rscan, rcorr, piece_reg._Weights(*w), rtls.gicp_noise_bound)
    assert torch.equal(H, rH) and torch.equal(g, rg) and _equal(tuple(costs), tuple(rcosts))
    assert bool(torch.isfinite(H).all()) and float(costs.planar.sum()) > 0.0


def test_the_batched_solve_agrees(captured):
    (port, cfg, problems), (piece, rcfg, rproblems) = captured["port"], captured["piece"]
    pose, diag = port.solve(*problems, cfg.odometry.tls)
    rpose, rdiag = piece.solve(*rproblems, rcfg.odometry.tls)
    assert torch.equal(pose, rpose)
    for name in ("iterations", "mu", "costs", "num_corr", "degenerate", "misaligned", "never_aligned", "corr_trace",
                 "cost_trace", "coarse_trace", "aligned_trace"):
        assert torch.equal(getattr(diag, name), getattr(rdiag, name)), name
    assert int(diag.iterations.min()) >= 2 and int(diag.num_corr[:, 0].min()) > 0


# the piece with every covariance the identity: M = (I + R I R^T)^-1 = I / 2,
# GICP's planar and ground families become point-to-point
IDENTITY_COVS = (
    "\n\ndef calculate_covariances(cloud, k_corr, radius=1.0, max_per_cell=8):\n"
    "    return torch.eye(3, dtype=cloud.xyz.dtype).expand(cloud.xyz.shape + (3,))\n"
)


def test_a_piece_with_identity_covariances_comes_out_not_correct(cpu_run, tiny_bench, pieces):
    """The tiny drive's frames 4-5 in one replica and one warm-up solve, in
    two cells of kitti-hdl64.gicp's limits: one checked against the planted
    piece, one against gicp_reference."""
    src = spec.BENCH_DIR / "gicp_reference"
    files = {f.name: f.read_text() for f in src.glob("*.py")}
    files["registration.py"] += IDENTITY_COVS
    write_piece(tiny_bench, "gicp_identity_covs", files)
    pieces(tiny_bench)
    c = spec.config(CONFIG, tiny_bench)
    c.update(name="kitti-hdl64.gicp_identity", reference="gicp_identity_covs")
    (tiny_bench / "configs" / "kitti-hdl64.gicp_identity.json").write_text(json.dumps(c))
    t = spec.traffic("batch64-urban", tiny_bench)
    t.update(name="batch2-urban", problem_frames=[4, 5], replicas=1, warmup_solves=1)
    (tiny_bench / "traffic" / "batch2-urban.json").write_text(json.dumps(t))
    bench = spec.benchmark()
    for name, config in (("identity.batch2-urban", c["name"]), ("gicp.batch2-urban", CONFIG)):
        (tiny_bench / "limits" / f"{name}.json").write_text(json.dumps(spec.limits(CELL, tiny_bench)))
        bench["workloads"].append({"name": name, "config": config, "traffic": "batch2-urban", "chips": 1,
                                   "why": "a test's cell"})
    planted = cpu_run("identity.batch2-urban", bench=bench)
    assert not planted["correct"] and planted["failed"] >= 1, planted["check"]
    sound = cpu_run("gicp.batch2-urban", bench=bench)
    assert sound["correct"] and sound["failed"] == 0, sound["check"]
    assert sound["check"]["pose_gap_m"]["value"] < 1e-9
