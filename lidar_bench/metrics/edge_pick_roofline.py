"""Share of its roofline that csrc/edge_pick.cu's edge_pick_kernel reaches:
the least time of one launch at the call's shapes (peaks.edge_pick_bound_s,
H100 SXM peaks) over the profiler's device time per launch."""
from lidar_bench.harness import peaks


def read(rec):
    k = [v for name, v in rec.get("profile", {}).get("kernels", {}).items() if "edge_pick" in name]
    seconds, launches = sum(v[0] for v in k), sum(v[1] for v in k)
    if not launches or seconds <= 0:
        return None
    shape = rec["edge_shape"]
    bound = peaks.edge_pick_bound_s(shape["rings"], shape["width"], shape["picks"])
    return 100.0 * bound / (seconds / launches)
