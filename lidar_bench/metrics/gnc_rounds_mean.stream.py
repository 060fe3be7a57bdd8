"""Outer GNC rounds a frame ran (Diagnostics.iterations), mean over the
window's frames that solved."""


def read(rec):
    if rec.get("kind") != "stream":
        return None
    solved = [r for r in rec["rounds"] if r > 0]
    return sum(solved) / len(solved) if solved else None
