"""Device milliseconds a frame spends in the scan-to-map solve: the
program's solve stage events over the window, over all its frames (frame 0
of a pass solves nothing)."""


def read(rec):
    if rec.get("kind") != "stream" or "solve" not in rec["stage_ms"]:
        return None
    return rec["stage_ms"]["solve"] / rec["frames"]
