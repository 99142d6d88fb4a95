"""All seconds of the window over the whole trainings it completed."""


def read(rec):
    n = len(rec.get("trainings", []))
    return rec["window_s"] / n if n else None
