"""LOAM-style per-ring edge extraction with sector picks + neighbour
suppression.

Port of ``tloam_tpu/models/edge.py`` (the reference's extractEdgePoint /
extractFromSection, segmentation.cpp:1144-1302). Points are ordered
ring-major (cluster-major within a ring), scattered ONCE into a dense
(ring, position) layout, and the ring geometry plus all greedy pick rounds
run on that layout:

  * on a CUDA tensor, in the hand-written kernel ``csrc/edge_pick.cu``
    (the port of the TPU kernel ``_pick_rounds_pallas``); a build or launch
    failure raises;
  * on a CPU tensor, in ``_pick_rounds_plain`` — the JAX module's XLA branch
    (edge.py:316-365) in separate torch ops, which the tests hold against
    JAX and ``chip_smoke.py`` holds against the kernel, bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tloam_torch import build
from tloam_torch.cloud import Cloud

# launches of the CUDA kernel (a plain counter: chip_smoke.py reads it to
# show that the main path went through the kernel)
LAUNCHES = 0


def _roll_cols(a: torch.Tensor, k: int) -> torch.Tensor:
    """a[:, (j + k) mod W] — jnp.roll(a, -k, axis=1)."""
    return torch.roll(a, shifts=-k, dims=1)


def _dense_geometry(xs, ys, zs, vmask, lenr, *, num_sectors: int, ring_min_num: int):
    """Per-ring geometry on the dense (R, W) layout: (dcurv with -1 at
    non-candidates, squared gap to the next column, sector id or -1). Same
    summation order as the reference loop (k = -5..5 skipping 0), every op
    separate, so no FMA contraction changes a bit."""
    R, W = xs.shape
    col = torch.arange(W, device=xs.device, dtype=torch.int64)[None, :]
    leni = lenr.to(torch.int64)[:, None]
    interior = (vmask > 0.5) & (col >= 5) & (col < leni - 5) & (leni >= ring_min_num)
    accx, accy, accz = -10.0 * xs, -10.0 * ys, -10.0 * zs
    for k in range(-5, 6):
        if k != 0:
            accx = accx + _roll_cols(xs, k)
            accy = accy + _roll_cols(ys, k)
            accz = accz + _roll_cols(zs, k)
    curv = accx * accx + accy * accy + accz * accz
    dcurv = torch.where(interior, curv, -1.0)
    gx = _roll_cols(xs, 1) - xs
    gy = _roll_cols(ys, 1) - ys
    gz = _roll_cols(zs, 1) - zs
    gap = gx * gx + gy * gy + gz * gz
    total = torch.clamp(leni - 10, min=1)
    dsec = torch.where(
        interior,
        torch.clamp(torch.div(num_sectors * (col - 5), total, rounding_mode="floor"), 0, num_sectors - 1),
        -1,
    )
    return dcurv, gap, dsec


def _pick_rounds_plain(
    dx, dy, dz, dval, lenr, num_sectors: int, picks_per_sector: int,
    curv_thres: float, suppress_gap_sq: float, ring_min_num: int,
):
    """Plain PyTorch version of the pick kernel: (edge (R,W) bool, picked
    (R,W) bool, dcurv (R,W) f32)."""
    dcurv, gap, dsec = _dense_geometry(
        dx, dy, dz, dval, lenr, num_sectors=num_sectors, ring_min_num=ring_min_num
    )
    R, W = dx.shape
    gap_ok = gap <= suppress_gap_sq
    col = torch.arange(W, device=dx.device)[None, :]
    avail = dcurv > -1.0
    edge_d = torch.zeros((R, W), dtype=torch.bool, device=dx.device)
    picked_d = torch.zeros_like(edge_d)
    false_col = torch.zeros((R, 1), dtype=torch.bool, device=dx.device)
    neg = torch.full_like(dcurv, -1.0)
    for _ in range(picks_per_sector):
        cand = torch.where(avail & (dcurv > curv_thres), dcurv, neg)
        onehot = torch.zeros_like(edge_d)
        for s in range(num_sectors):
            cand_s = torch.where(dsec == s, cand, neg)
            mx, arg = torch.max(cand_s, dim=1, keepdim=True)  # first max = scan order
            onehot = onehot | ((col == arg) & (mx > 0))
        edge_d = edge_d | onehot
        sup, chain_r, chain_l = onehot, onehot, onehot
        for _k in range(5):
            # column j+1 suppressed if the chain is alive at j AND gap j holds
            chain_r = torch.cat([false_col, (chain_r & gap_ok)[:, :-1]], dim=1)
            chain_l = torch.cat([chain_l[:, 1:], false_col], dim=1) & gap_ok
            sup = sup | chain_r | chain_l
        picked_d = picked_d | sup
        avail = avail & ~picked_d
    return edge_d, picked_d, dcurv


def _pick_rounds_cuda(
    dx, dy, dz, dval, lenr, num_sectors: int, picks_per_sector: int,
    curv_thres: float, suppress_gap_sq: float, ring_min_num: int,
):
    """Launch csrc/edge_pick.cu: one CTA per ring. Same outputs as
    `_pick_rounds_plain`."""
    global LAUNCHES
    R, W = dx.shape
    for name, t in (("dx", dx), ("dy", dy), ("dz", dz), ("dval", dval)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous() or t.shape != (R, W):
            raise ValueError(f"edge_pick: {name} must be a contiguous float32 CUDA tensor of shape {(R, W)}")
    if lenr.device != dx.device or lenr.dtype != torch.int32 or lenr.shape != (R,) or not lenr.is_contiguous():
        raise ValueError("edge_pick: ring lengths must be a contiguous int32 CUDA tensor of shape (R,)")
    if not (0 < W <= 4096) or not (1 <= num_sectors <= 8):
        raise ValueError(f"edge_pick: needs 0 < W <= 4096 and 1 <= num_sectors <= 8, got {W}, {num_sectors}")
    lib = build.load("edge_pick")
    fn = lib.tloam_edge_pick
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    edge = torch.empty((R, W), dtype=torch.uint8, device=dx.device)
    picked = torch.empty_like(edge)
    dcurv = torch.empty((R, W), dtype=torch.float32, device=dx.device)
    with torch.cuda.device(dx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), dval.data_ptr(), lenr.data_ptr(),
            edge.data_ptr(), picked.data_ptr(), dcurv.data_ptr(), R, W, num_sectors,
            picks_per_sector, curv_thres, suppress_gap_sq, ring_min_num, stream,
        )
    if rc != 0:
        raise RuntimeError(f"edge_pick: kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return edge.bool(), picked.bool(), dcurv


def pick_rounds(dx, dy, dz, dval, lenr, **kw):
    """Dispatch by device: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if dx.device.type == "cuda":
        return _pick_rounds_cuda(dx, dy, dz, dval, lenr, **kw)
    if dx.device.type == "cpu":
        return _pick_rounds_plain(dx, dy, dz, dval, lenr, **kw)
    raise ValueError(f"edge_pick: unsupported device {dx.device}")


class DenseRings(NamedTuple):
    """The dense (ring, position) layout of a cloud and how to map back."""

    dx: torch.Tensor  # (R, W) f32 coords at column = position-in-ring
    dy: torch.Tensor
    dz: torch.Tensor
    dval: torch.Tensor  # (R, W) f32 1.0 where a real point
    ring_len: torch.Tensor  # (R,) int32 (not capped at W)
    order: torch.Tensor  # (N,) ring-major sort order
    dslot: torch.Tensor  # (N,) dense slot of each sorted point (R*W = none)
    interior: torch.Tensor  # (N,) sorted points that carry a curvature


def dense_rings(cloud: Cloud, ring, order_key, sensor_model: int, ring_min_num: int, ring_width: int) -> DenseRings:
    """Ring-major stable order (invalid slots last), position in ring, ring
    lengths, and ONE scatter of [x, y, z, occupied] into (R, W)
    (tloam_tpu/models/edge.py:226-302)."""
    n = cloud.capacity
    dev = cloud.device
    dtype = cloud.xyz.dtype
    valid = cloud.valid
    ring_k = torch.where(valid, ring.long(), sensor_model + 1)
    # jnp.lexsort((order_key, ring_k)): ring primary, order_key secondary
    _, o1 = torch.sort(order_key.long(), stable=True)
    _, o2 = torch.sort(ring_k[o1], stable=True)
    order = o1[o2]
    xyz_s = cloud.xyz[order]
    valid_s = valid[order]
    ring_s = ring_k[order]

    same = torch.cat(
        [torch.zeros(1, dtype=torch.bool, device=dev), (ring_s[1:] == ring_s[:-1]) & valid_s[1:]]
    )
    idx = torch.arange(n, device=dev)
    ring_start = torch.cummax(torch.where(~same, idx, 0), 0).values
    pos = idx - ring_start
    seg = torch.clamp(ring_s, max=sensor_model)
    ring_len = torch.zeros(sensor_model + 1, dtype=torch.int64, device=dev).index_add_(
        0, seg, valid_s.to(torch.int64)
    )
    my_len = ring_len[seg]
    interior = valid_s & (ring_s < sensor_model) & (my_len >= ring_min_num) & (pos >= 5) & (pos < my_len - 5)

    W, R = ring_width, sensor_model
    in_dense = valid_s & (ring_s < R) & (pos < W)
    dslot = torch.where(in_dense, ring_s * W + torch.clamp(pos, max=W - 1), R * W)
    dense4 = torch.zeros((R * W + 1, 4), dtype=dtype, device=dev)
    dense4[dslot] = torch.where(
        in_dense[:, None], torch.cat([xyz_s, torch.ones((n, 1), dtype=dtype, device=dev)], dim=1), 0.0
    )
    dense4 = dense4[: R * W]
    planes = [dense4[:, i].reshape(R, W).contiguous() for i in range(4)]
    return DenseRings(*planes, ring_len[:R].to(torch.int32), order, dslot, interior)


class EdgeResult(NamedTuple):
    edge_mask: torch.Tensor  # (N,) picked edge points (input slot order)
    general_mask: torch.Tensor  # (N,) non-edge curvature-carrying points
    curvature: torch.Tensor  # (N,) smoothness value (0 where undefined)


def extract_edges(
    cloud: Cloud,
    ring: torch.Tensor,
    order_key: torch.Tensor,
    sensor_model: int = 64,
    ring_min_num: int = 131,
    num_sectors: int = 6,
    picks_per_sector: int = 20,
    curv_thres: float = 0.1,
    suppress_gap_sq: float = 0.05,
    ring_width: int = 4096,
) -> EdgeResult:
    """Extract edge features (ring: (N,) ring id per slot; order_key: (N,)
    secondary key reproducing the reference's per-ring point order)."""
    n = cloud.capacity
    dev = cloud.device
    d = dense_rings(cloud, ring, order_key, sensor_model, ring_min_num, ring_width)
    edge_d, picked_d, dcurv = pick_rounds(
        d.dx, d.dy, d.dz, d.dval, d.ring_len,
        num_sectors=num_sectors, picks_per_sector=picks_per_sector,
        curv_thres=curv_thres, suppress_gap_sq=suppress_gap_sq, ring_min_num=ring_min_num,
    )
    R, W = sensor_model, ring_width
    safe_slot = torch.clamp(d.dslot, max=R * W - 1)
    edge_s = d.interior & edge_d.reshape(-1)[safe_slot]
    picked_s = d.interior & picked_d.reshape(-1)[safe_slot]
    general_s = d.interior & ~picked_s
    curv_s = torch.clamp(dcurv.reshape(-1)[safe_slot], min=0.0) * d.interior
    edge_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    general_mask = torch.zeros_like(edge_mask)
    curvature = torch.zeros(n, dtype=cloud.xyz.dtype, device=dev)
    edge_mask[d.order] = edge_s
    general_mask[d.order] = general_s
    curvature[d.order] = curv_s
    return EdgeResult(edge_mask, general_mask, curvature)
