"""Device milliseconds a frame spends in the solver's correspondence
queries (each round's, with the yaw fan): the program's `solve.correspond`
spans (tloam_torch/utils/timing.STAGES) over the window, over all its
frames (frame 0 of a pass solves nothing)."""


def read(rec):
    if rec.get("kind") != "stream" or "solve.correspond" not in rec["stage_ms"]:
        return None
    return rec["stage_ms"]["solve.correspond"] / rec["frames"]
