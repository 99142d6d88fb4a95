"""Share of the rows the server dispatched that were padding to its bucket
ladder (``ServerMetrics.rows_padded`` over real and padded rows)."""


def read(rec):
    s = rec.get("server")
    if not s or not s["rows_dispatched"]:
        return None
    return 100.0 * s["rows_padded"] / (s["rows_dispatched"] + s["rows_padded"])
