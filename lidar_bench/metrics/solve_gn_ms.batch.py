"""Device milliseconds a batched solve spends in the solver's Gauss-Newton
inner loops (each round's, with its 6x6 eigen solves): the program's
`solve.gn` spans (tloam_torch/utils/timing.STAGES) over the window, over
its solves."""


def read(rec):
    if rec.get("kind") != "batch" or "solve.gn" not in rec.get("stage_ms", {}):
        return None
    return rec["stage_ms"]["solve.gn"] / rec["solves"]
