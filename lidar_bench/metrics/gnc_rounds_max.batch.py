"""Outer GNC rounds a batched solve ran: the most over its entries, mean
over the window's solves."""


def read(rec):
    if rec.get("kind") != "batch" or not rec["rounds_max"]:
        return None
    return sum(rec["rounds_max"]) / len(rec["rounds_max"])
