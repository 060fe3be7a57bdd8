"""Device milliseconds a batched solve spends fitting GICP's covariances
(kNN(k_corr + 1) and a 3x3 eigen solve a slot, over the scan's and the
submap's planar and ground clouds): the program's `solve.grids.cov` spans
(tloam_torch/utils/timing.STAGES, inside `solve.grids`) over the window,
over its solves. None where the program has no such span."""


def read(rec):
    if rec.get("kind") != "batch" or "solve.grids.cov" not in rec.get("stage_ms", {}):
        return None
    return rec["stage_ms"]["solve.grids.cov"] / rec["solves"]
