"""Host syncs a steady frame makes inside odometry_step_packed (CUDA sync
debug warnings over the traffic's sync frames; the harness's pose read is
outside the count)."""


def read(rec):
    if rec.get("kind") != "stream":
        return None
    return rec["syncs"]["count"] / rec["syncs"]["frames"]
