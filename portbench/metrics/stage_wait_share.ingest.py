"""The share of the window that fingerprint_stream's caller waited for its
next staged batch (extract.stage_wait): near 0 while the staging thread runs
ahead of the caller's launches, the whole staging time where it does not."""

from portbench.metrics import _spans


def read(run):
    got = _spans.closed_spans(run, "extract.stage_wait")
    if got is None:
        return None
    spans, (lo, hi) = got
    return sum(b - a for a, b in spans) / (hi - lo)
