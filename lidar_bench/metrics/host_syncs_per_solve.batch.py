"""Host syncs one batched solve makes (CUDA sync debug warnings over the
traffic's sync solves)."""


def read(rec):
    if rec.get("kind") != "batch":
        return None
    return rec["syncs"]["count"] / rec["syncs"]["solves"]
