"""Device milliseconds a frame spends building the solver's cell tables and
hash grids (before the rounds, and the lazy coarse grid): the program's
`solve.grids` spans (tloam_torch/utils/timing.STAGES) over the window, over
all its frames (frame 0 of a pass solves nothing)."""


def read(rec):
    if rec.get("kind") != "stream" or "solve.grids" not in rec["stage_ms"]:
        return None
    return rec["stage_ms"]["solve.grids"] / rec["frames"]
