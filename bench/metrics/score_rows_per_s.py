"""Rows ``Model.predict`` returned over all the window's seconds."""


def read(rec):
    return rec["rows"] / rec["window_s"] if rec.get("rows") else None
