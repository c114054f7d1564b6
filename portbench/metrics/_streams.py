"""Readings of a streaming pool's spans over a closed loop's window (not
itself a metric)."""

from portbench.metrics import _spans


def share(run, name: str):
    """Σ of the spans `name` in the window / the window; None without them."""
    got = _spans.closed_spans(run, name)
    if got is None:
        return None
    spans, (lo, hi) = got
    return sum(b - a for a, b in spans) / (hi - lo)
