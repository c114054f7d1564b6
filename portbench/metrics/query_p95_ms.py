"""query_p95_ms: the 95th percentile (nearest rank) of the time from when a
live query was due to its answer, over every request of the window; one shed
or failed counts as later than any answered."""

from portbench.stats import percentile


def read(run):
    lat = run.records.get("latencies")
    return 1e3 * percentile(lat, 95) if lat else None
