"""Share of the profiled frames' wall time in which no kernel, copy or set
ran on the device (the union of the device intervals)."""


def read(rec):
    if rec.get("kind") != "stream":
        return None
    p = rec["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
