"""Mean milliseconds of a call's finalize stage, by the harness's clock
(with a device sync at its end) in the traced window."""


def read(rec):
    s = rec.get("stages", {}).get("finalize")
    return 1e3 * sum(s) / len(s) if s else None
