"""Host milliseconds a frame waits at the program's own host syncs: the host
time of its `sync.*` spans (tloam_torch/utils/timing.STAGES) over the
window, over all its frames. Near 0, the device had drained its queue and
was waiting for the host."""


def read(rec):
    if rec.get("kind") != "stream":
        return None
    waits = [v for k, v in rec["stage_ms"].items() if k.startswith("host:sync.")]
    return sum(waits) / rec["frames"] if waits else None
