"""Mean milliseconds of a call's encode stage, by the harness's clock
(with a device sync at its end) in the traced window."""


def read(rec):
    s = rec.get("stages", {}).get("encode")
    return 1e3 * sum(s) / len(s) if s else None
