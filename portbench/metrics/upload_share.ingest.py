"""The share of the window that fingerprint_stream's caller spent staging
batches into pinned memory and queueing their uploads (extract.upload)."""

from portbench.metrics import _spans


def read(run):
    got = _spans.closed_spans(run, "extract.upload")
    if got is None:
        return None
    spans, (lo, hi) = got
    return sum(b - a for a, b in spans) / (hi - lo)
