"""The median of the window's escalated requests' waits from their queueing
for the rendition scan to the close of their scan batch (serve.scan_admit
spans), in ms."""

from portbench.metrics import _spans
from portbench.stats import percentile


def read(run):
    w = _spans.live(run)
    waits = [(s.t1 - s.t0) / 1e6 for s in w.requests("serve.scan_admit")] if w else []
    return percentile(waits, 50) if waits else None
