"""The 95th percentile (nearest rank) of the window's requests' waits from
submit to the close of their rigid batch (serve.admit spans), in ms."""

from portbench.metrics import _spans
from portbench.stats import percentile


def read(run):
    w = _spans.live(run)
    waits = [(s.t1 - s.t0) / 1e6 for s in w.requests("serve.admit")] if w else []
    return percentile(waits, 95) if waits else None
