"""95th percentile of every completed request's milliseconds from submit
to result, by the harness's clock."""
import statistics


def read(rec):
    lat = rec.get("latencies") or []
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[18]
