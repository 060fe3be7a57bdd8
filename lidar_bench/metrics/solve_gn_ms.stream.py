"""Device milliseconds a frame spends in the solver's Gauss-Newton inner
loops (each round's, with its 6x6 eigen solves): the program's `solve.gn`
spans (tloam_torch/utils/timing.STAGES) over the window, over all its
frames (frame 0 of a pass solves nothing)."""


def read(rec):
    if rec.get("kind") != "stream" or "solve.gn" not in rec["stage_ms"]:
        return None
    return rec["stage_ms"]["solve.gn"] / rec["frames"]
