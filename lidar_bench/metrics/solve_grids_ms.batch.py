"""Device milliseconds a batched solve spends building the solver's cell
tables and hash grids (before the rounds, and the lazy coarse grid): the
program's `solve.grids` spans (tloam_torch/utils/timing.STAGES) over the
window, over its solves."""


def read(rec):
    if rec.get("kind") != "batch" or "solve.grids" not in rec.get("stage_ms", {}):
        return None
    return rec["stage_ms"]["solve.grids"] / rec["solves"]
