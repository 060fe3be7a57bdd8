"""Extended point-cloud op family: the reference's PointCloud2 method set.

Port of ``tloam_tpu/ops/cloud_ops.py`` (reference: src/open3d/PointCloud2.cpp).
Each op notes its counterpart:

  uniform_downsample            UniformDownSample        (:478-488)
  random_downsample_ratio       RandomDownSample(ratio)  (:490-504)
  random_downsample_count       RandomDownSample(count)  (:506-549, Vitter A)
  voxel_downsample_and_trace    VoxelDownSampleAndTrace  (:405-476)
  remove_radius_outliers        RemoveRadiusOutliers     (:571-597)
  remove_statistical_outliers   RemoveStatisticalOutliers(:598-654)
  estimate_normals              EstimateNormals          (:1086-1117)
  orient_normals_towards        OrientNormalsTowardsCameraLocation (:1145-1160)
  orient_normals_direction      OrientNormalsToAlignWithDirection  (:1118-1132)
  orient_normals_consistent     OrientNormalsConsistentTangentPlane (Kruskal
                                MST, :1019-1270), host-side numpy
  cluster_dbscan                ClusterDBSCAN            (:1271-1350)
  segment_plane_ransac          SegmentPlane RANSAC      (:1398-1477)
  point_cloud_distance          ComputePointCloudDistance
  mahalanobis_distance          ComputeMahalanobisDistance
  nearest_neighbor_distance     ComputeNearestNeighborDistance
  convex_hull, hidden_point_removal   (:703-768), host-side scipy

The random ops take a ``torch.Generator`` on the cloud's device where the
JAX package takes a ``jax.random`` key. Each is a draw followed by a
deterministic part that takes the draw (``_keep_count_from_uniform``,
``_ransac_from_triples``), so the same draw gives the JAX package's answer.
Per-cell sums use an accumulating ``index_put_``, which adds in input order
on every device (``index_add_``'s CUDA atomics do not).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tloam_torch.cloud import Cloud
from tloam_torch.ops import eig3, voxel

_INT32_MAX = 2**31 - 1
DBSCAN_CHECK_EVERY = 8  # label rounds between the host's convergence reads


# ---------------------------------------------------------------------------
# Downsampling
# ---------------------------------------------------------------------------


def uniform_downsample(cloud: Cloud, every_k: int) -> Cloud:
    """Keep every k-th VALID point (by valid rank), like the reference's
    index stride over the compacted cloud."""
    rank = torch.cumsum(cloud.valid, dim=-1) - 1
    return cloud.mask(cloud.valid & (rank % every_k == 0))


def _uniform(cloud: Cloud, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(cloud.capacity, generator=generator, device=cloud.device, dtype=cloud.xyz.dtype)


def random_downsample_ratio(cloud: Cloud, ratio: float, generator: torch.Generator) -> Cloud:
    """Bernoulli subsample at `ratio`."""
    return cloud.mask(_uniform(cloud, generator) < ratio)


def _keep_count_from_uniform(u: torch.Tensor, valid: torch.Tensor, count: int) -> torch.Tensor:
    """The `count` valid slots with the largest draws u. Invalid slots score
    -1 and are masked out after the top-k, so ties among them never matter;
    valid draws from a continuous uniform do not tie."""
    _, idx = torch.topk(torch.where(valid, u, -1.0), count)
    keep = torch.zeros_like(valid)
    keep[idx] = True
    return keep & valid


def random_downsample_count(cloud: Cloud, count: int, generator: torch.Generator) -> Cloud:
    """Exactly `count` uniformly random valid points (a masked top-k over
    random keys: the batched equivalent of Vitter's Algorithm A)."""
    return cloud.mask(_keep_count_from_uniform(_uniform(cloud, generator), cloud.valid, count))


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_put_((seg,), vals, accumulate=True)


def voxel_downsample_and_trace(cloud: Cloud, voxel_size: float, max_out: int) -> tuple[Cloud, torch.Tensor]:
    """Voxel average plus each input slot's voxel: (downsampled Cloud,
    trace (N,) int32 index into the output, -1 for invalid slots). Voxels
    come in lexicographic (x, y, z) cell order."""
    xyz, inten, valid = cloud.xyz, cloud.intensity, cloud.valid
    coords = torch.floor(xyz / voxel_size).to(torch.int32)
    coords = torch.where(valid[:, None], coords, _INT32_MAX)
    # jnp.lexsort((z, y, x)) as three stable sorts, the last key first
    order = torch.arange(coords.shape[0], device=xyz.device)
    for a in (2, 1, 0):
        order = order[torch.sort(coords[order, a], stable=True).indices]
    cs = coords[order]
    valid_s = valid[order]
    first = voxel._first_of_runs(cs[:, 0], cs[:, 1], cs[:, 2])
    seg = torch.cumsum(first, 0) - 1
    seg = torch.where(valid_s & (seg < max_out), seg, max_out)
    ones = (seg < max_out).to(xyz.dtype)
    cnt = _segment_sum(ones, seg, max_out + 1)[:max_out]
    sx = _segment_sum(xyz[order] * ones[:, None], seg, max_out + 1)[:max_out]
    si = _segment_sum(inten[order] * ones, seg, max_out + 1)[:max_out]
    denom = torch.clamp(cnt, min=1.0)
    out = Cloud(xyz=sx / denom[:, None], intensity=si / denom, valid=cnt > 0)
    trace = torch.full((cloud.capacity,), -1, dtype=torch.int32, device=xyz.device)
    trace[order] = torch.where(seg < max_out, seg, -1).to(torch.int32)
    return out, trace


# ---------------------------------------------------------------------------
# Outlier removal
# ---------------------------------------------------------------------------


def remove_radius_outliers(cloud: Cloud, nb_points: int, radius: float, max_per_cell: int = 16) -> Cloud:
    """Drop points with fewer than nb_points neighbours within radius; the
    count includes the point itself, like the KD query."""
    grid = voxel.build_hash_grid(cloud.xyz, cloud.valid, radius)
    _, _, ok = voxel.query_knn(grid, cloud.xyz, cloud.valid, k=max(nb_points + 1, 8), radius=radius,
                               max_per_cell=max_per_cell)
    return cloud.mask(torch.sum(ok, dim=-1) >= nb_points)


def statistical_radius(cloud: Cloud) -> torch.Tensor:
    """The search radius of remove_statistical_outliers, 4 cbrt(vol / n)
    over the bounding box, in float32: the cube root is taken in float64
    and rounded once."""
    span = cloud.max_bound() - cloud.min_bound()
    vol = torch.clamp(span[0] * span[1] * span[2], min=1e-9)
    n = torch.clamp(cloud.count(), min=1)
    return 4.0 * torch.pow((vol / n).double(), 1.0 / 3.0).to(cloud.xyz.dtype)


def remove_statistical_outliers(cloud: Cloud, nb_neighbors: int, std_ratio: float, max_per_cell: int = 16) -> Cloud:
    """Drop points whose mean kNN distance exceeds the global mean +
    std_ratio * std. The search is bounded to statistical_radius, read once
    by the host (the hash grid's cell size is a host number)."""
    r = float(statistical_radius(cloud))
    grid = voxel.build_hash_grid(cloud.xyz, cloud.valid, r)
    _, dist_sq, ok = voxel.query_knn(grid, cloud.xyz, cloud.valid, k=nb_neighbors + 1, radius=r,
                                     max_per_cell=max_per_cell)
    d = torch.sqrt(torch.where(ok, dist_sq, 0.0))  # the self slot adds 0
    found = torch.sum(ok, dim=-1) - 1
    mean_d = torch.sum(d, dim=-1) / torch.clamp(found, min=1)
    # a point that cannot FIND nb_neighbors within the radius is an outlier
    # (the reference's unbounded kNN would measure a huge distance) and must
    # not pollute the statistics
    measurable = cloud.valid & (found >= nb_neighbors)
    n_meas = torch.sum(measurable)
    mu = torch.sum(torch.where(measurable, mean_d, 0.0)) / torch.clamp(n_meas, min=1)
    var = torch.sum(torch.where(measurable, (mean_d - mu) ** 2, 0.0)) / torch.clamp(n_meas - 1, min=1)
    return cloud.mask(measurable & (mean_d <= mu + std_ratio * torch.sqrt(var)))


# ---------------------------------------------------------------------------
# Normals
# ---------------------------------------------------------------------------


def estimate_normals(cloud: Cloud, radius: float = 0.1, max_nn: int = 30, max_per_cell: int = 16) -> Cloud:
    """PCA normals over hybrid-search neighbourhoods."""
    grid = voxel.build_hash_grid(cloud.xyz, cloud.valid, radius)
    idx, _, ok = voxel.query_knn(grid, cloud.xyz, cloud.valid, k=max_nn, radius=radius, max_per_cell=max_per_cell)
    n, _, _ = eig3.plane_from_points(cloud.xyz[idx], ok)
    return dataclasses.replace(cloud, normals=n)


def _flip_towards(cloud: Cloud, toward: torch.Tensor) -> Cloud:
    if cloud.normals is None:
        raise ValueError("the cloud has no normals")
    sign = torch.sign(torch.sum(cloud.normals * toward, dim=-1, keepdim=True))
    return dataclasses.replace(cloud, normals=cloud.normals * torch.where(sign == 0, 1.0, sign))


def orient_normals_towards(cloud: Cloud, reference_point: torch.Tensor) -> Cloud:
    """Flip normals to face a viewpoint."""
    return _flip_towards(cloud, reference_point - cloud.xyz)


def orient_normals_direction(cloud: Cloud, direction: torch.Tensor) -> Cloud:
    """Flip normals to align with a direction."""
    return _flip_towards(cloud, direction)


def orient_normals_consistent(cloud_np_xyz: np.ndarray, normals: np.ndarray, k: int = 10):
    """Consistent tangent-plane orientation via a minimum spanning tree
    (reference Kruskal/DisjointSet, :773-1270). Host-side numpy: MST over
    kNN graph weighted by 1-|n_i . n_j|, BFS sign propagation from the
    highest point. Returns oriented normals (numpy)."""
    from scipy.spatial import cKDTree

    n_pts = len(cloud_np_xyz)
    tree = cKDTree(cloud_np_xyz)
    _, nbrs = tree.query(cloud_np_xyz, k=min(k + 1, n_pts))
    edges = []
    for i in range(n_pts):
        for j in nbrs[i][1:]:
            w = 1.0 - abs(float(normals[i] @ normals[j]))
            edges.append((w, i, int(j)))
    edges.sort()
    parent = list(range(n_pts))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    mst = [[] for _ in range(n_pts)]
    for w, i, j in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            mst[i].append(j)
            mst[j].append(i)
    out = normals.copy()
    root = int(np.argmax(cloud_np_xyz[:, 2]))
    if out[root, 2] < 0:
        out[root] = -out[root]
    seen = np.zeros(n_pts, bool)
    stack = [root]
    seen[root] = True
    while stack:
        i = stack.pop()
        for j in mst[i]:
            if not seen[j]:
                seen[j] = True
                if out[i] @ out[j] < 0:
                    out[j] = -out[j]
                stack.append(j)
    return out


# ---------------------------------------------------------------------------
# Clustering / model fitting
# ---------------------------------------------------------------------------


def cluster_dbscan(cloud: Cloud, eps: float, min_points: int, max_per_cell: int = 16, cc_iters: int = 64) -> torch.Tensor:
    """DBSCAN labels: core points have >= min_points neighbours within eps
    (self included, like Open3D); clusters are connected components of core
    points; a border point adopts its smallest neighbouring core label;
    noise = -1. Returns (N,) int32 labels numbered in order of each
    cluster's smallest point index.

    Components come from min-label propagation with pointer jumping, at
    most cc_iters rounds. A round at the fixed point changes nothing, so
    the host reads the convergence flag only every DBSCAN_CHECK_EVERY
    rounds: at most cc_iters / DBSCAN_CHECK_EVERY syncs, the same labels as
    the JAX package's early-exit loop."""
    n = cloud.capacity
    dev = cloud.device
    grid = voxel.build_hash_grid(cloud.xyz, cloud.valid, eps)
    idx, _, ok = voxel.query_knn(grid, cloud.xyz, cloud.valid, k=max(min_points + 4, 16), radius=eps,
                                 max_per_cell=max_per_cell)
    idx = idx.long()
    core = cloud.valid & (torch.sum(ok, dim=-1) >= min_points)
    nbr = torch.where(ok & core[idx] & core[:, None], idx, n)
    flat_tgt = nbr.reshape(-1)
    ar = torch.arange(n, device=dev)
    lab = torch.where(core, ar, n - 1)
    big = torch.full((n + 1,), _INT32_MAX, dtype=lab.dtype, device=dev)
    for it in range(1, cc_iters + 1):
        gmin = torch.amin(torch.where(nbr < n, lab[torch.clamp(nbr, max=n - 1)], n), dim=-1)
        # for each target, the least label of the sources that point at it
        push = big.scatter_reduce(0, flat_tgt, lab[:, None].expand_as(nbr).reshape(-1), "amin")[:n]
        best = torch.where(core, torch.minimum(torch.minimum(gmin, push), lab), lab)
        best = best[best]
        best = best[best]
        converged = it % DBSCAN_CHECK_EVERY == 0 and torch.equal(best, lab)
        lab = best
        if converged:
            break

    core_nbr = torch.where(ok & core[idx], lab[idx], n)
    border_lab = torch.amin(core_nbr, dim=-1)
    pt_root = torch.where(core, lab, torch.where(border_lab < n, border_lab, -1))
    pt_root = torch.where(cloud.valid, pt_root, -1)
    root_rank = torch.cumsum(core & (lab == ar), 0) - 1
    return torch.where(pt_root >= 0, root_rank[torch.clamp(pt_root, min=0)], -1).to(torch.int32)


def _ransac_from_triples(cloud: Cloud, tri: torch.Tensor, distance_threshold: float):
    """RANSAC on given samples tri (H, 3) of point indices: every hypothesis
    scored in one batch, the best (first on a tie) refined by a least-squares
    plane on its inliers. Returns (plane (4,) [n, d], inlier mask (N,))."""
    xyz = cloud.xyz
    p0, p1, p2 = (xyz[tri[:, i]] for i in range(3))
    nrm = torch.linalg.cross(p1 - p0, p2 - p0)
    nn = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.clamp(nn, min=1e-12)
    d = -torch.sum(nrm * p0, dim=-1)
    dist = torch.abs(nrm @ xyz.T + d[:, None])  # (H, N)
    inl = (dist < distance_threshold) & cloud.valid[None, :] & (nn[:, 0] > 1e-9)[:, None]
    best = torch.argmax(torch.sum(inl, dim=-1))
    nr, dr, _ = eig3.plane_from_points(xyz, inl[best])
    inlier_mask = (torch.abs(torch.sum(nr * xyz, dim=-1) + dr) < distance_threshold) & cloud.valid
    return torch.cat([nr, dr[None]]), inlier_mask


def segment_plane_ransac(cloud: Cloud, distance_threshold: float, ransac_n: int, num_iterations: int,
                         generator: torch.Generator):
    """RANSAC plane fit: num_iterations triples of valid points drawn with
    replacement (ransac_n is 3, the minimal sample, as in the reference).
    Returns (plane (4,) [n, d], inlier mask (N,))."""
    del ransac_n
    p = cloud.valid.to(cloud.xyz.dtype)
    tri = torch.multinomial(p / torch.clamp(p.sum(), min=1.0), num_iterations * 3, replacement=True,
                            generator=generator).view(num_iterations, 3)
    return _ransac_from_triples(cloud, tri, distance_threshold)


# ---------------------------------------------------------------------------
# Distances
# ---------------------------------------------------------------------------


def point_cloud_distance(source: Cloud, target: Cloud, radius: float = 2.0, max_per_cell: int = 16) -> torch.Tensor:
    """Per-source-point distance to the nearest target point; +inf where no
    target point lies within `radius`."""
    grid = voxel.build_hash_grid(target.xyz, target.valid, radius)
    _, dist_sq, ok = voxel.query_knn(grid, source.xyz, source.valid, k=1, radius=radius, max_per_cell=max_per_cell)
    return torch.where(ok[:, 0], torch.sqrt(dist_sq[:, 0]), torch.inf)


def mahalanobis_distance(cloud: Cloud) -> torch.Tensor:
    """Per-point Mahalanobis distance to the cloud's own distribution."""
    mean, cov = cloud.mean_and_covariance()
    prec = torch.linalg.inv(cov + 1e-12 * torch.eye(3, dtype=cov.dtype, device=cov.device))
    diff = cloud.xyz - mean
    d2 = torch.sum((diff @ prec) * diff, dim=-1)
    return torch.where(cloud.valid, torch.sqrt(torch.clamp(d2, min=0.0)), 0.0)


def nearest_neighbor_distance(cloud: Cloud, radius: float = 2.0, max_per_cell: int = 16) -> torch.Tensor:
    """Distance to each point's nearest OTHER point (slot 0 is the point
    itself); +inf where none lies within `radius`."""
    grid = voxel.build_hash_grid(cloud.xyz, cloud.valid, radius)
    _, dist_sq, ok = voxel.query_knn(grid, cloud.xyz, cloud.valid, k=2, radius=radius, max_per_cell=max_per_cell)
    return torch.where(ok[:, 1], torch.sqrt(dist_sq[:, 1]), torch.inf)


# ---------------------------------------------------------------------------
# Host-side hull utilities
# ---------------------------------------------------------------------------


def convex_hull(xyz: np.ndarray):
    """ConvexHull (:703-720), host scipy: (vertex indices, simplices)."""
    from scipy.spatial import ConvexHull as _CH

    hull = _CH(xyz)
    return hull.vertices, hull.simplices


def hidden_point_removal(xyz: np.ndarray, camera: np.ndarray, radius: float):
    """Katz spherical-flip hidden point removal (:721-768), host scipy:
    sorted indices of the visible points."""
    p = xyz - camera
    norm = np.linalg.norm(p, axis=1, keepdims=True)
    flipped = p + 2 * (radius - norm) * (p / np.maximum(norm, 1e-12))
    pts = np.vstack([flipped, np.zeros(3)])
    verts, _ = convex_hull(pts)
    visible = verts[verts < len(xyz)]
    return np.sort(visible)
