"""Device milliseconds a batched solve spends in the solver's
correspondence queries (each round's, with the yaw fan): the program's
`solve.correspond` spans (tloam_torch/utils/timing.STAGES) over the
window, over its solves."""


def read(rec):
    if rec.get("kind") != "batch" or "solve.correspond" not in rec.get("stage_ms", {}):
        return None
    return rec["stage_ms"]["solve.correspond"] / rec["solves"]
