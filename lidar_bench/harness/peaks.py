"""The card's peaks and the kernels' least times, from shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full 700 W
power limit): HBM bytes/s and float32 FLOP/s outside the tensor cores.
A run records the card's power limit beside every share it reports.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def edge_pick_bound_s(rings: int, width: int, picks: int) -> float:
    """Least time of one launch of csrc/edge_pick.cu over a (rings, width)
    dense layout (a copy of chip_smoke.edge_bound_ms): each input read once
    (x, y, z, occupancy f32 and the int32 ring lengths), each output written
    once (edge and picked bytes, curvature f32); about 50 f32 operations an
    element for the geometry and 3 a pick round."""
    nbytes = rings * width * 16 + rings * 4 + rings * width * 6
    ops = rings * width * (50 + 3 * picks)
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS)
