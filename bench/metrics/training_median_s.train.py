"""The median seconds of one whole training in the traced window: the
steadier statistic beside ``train_s`` (one slow training moves it less)."""
import statistics


def read(rec):
    secs = [t["seconds"] for t in rec.get("trainings", [])]
    return statistics.median(secs) if secs else None
