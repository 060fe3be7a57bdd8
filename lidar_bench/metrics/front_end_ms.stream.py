"""Device milliseconds a frame spends in the front end: the program's
ground, dcvc, edge, features and voxel stage events (tloam_torch's
utils/timing.STAGES), totalled over the window's frames, over frames."""

STAGES = ("ground", "dcvc", "edge", "features", "voxel")


def read(rec):
    if rec.get("kind") != "stream" or not all(s in rec["stage_ms"] for s in STAGES):
        return None
    return sum(rec["stage_ms"][s] for s in STAGES) / rec["frames"]
