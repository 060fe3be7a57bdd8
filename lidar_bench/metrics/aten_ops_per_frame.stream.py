"""Operations one steady frame issues to PyTorch's dispatcher: the host's
program, whatever the sizes."""


def read(rec):
    if rec.get("kind") != "stream":
        return None
    return rec["ops"]["count"] / rec["ops"]["frames"]
