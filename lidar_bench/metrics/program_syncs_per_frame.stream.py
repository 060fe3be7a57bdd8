"""Host syncs a frame makes by the program's own count: its `sync.*`
counters (tloam_torch/utils/timing.STAGES) over the window, over all its
frames. Frame 0 of a pass solves nothing and makes none, so this reads
about 2% under a steady frame's count."""


def read(rec):
    if rec.get("kind") != "stream":
        return None
    syncs = [v for k, v in rec["stage_ms"].items() if k.startswith("count:sync.")]
    return sum(syncs) / rec["frames"] if syncs else None
