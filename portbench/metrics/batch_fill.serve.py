"""Queries over bucket rows of the batches that hold the window's requests,
both classes (the rows and padded of their serve.dispatch spans)."""

from portbench.metrics import _spans


def read(run):
    w = _spans.live(run)
    d = w.batch_spans("serve.dispatch") if w else []
    padded = sum(s.attrs["padded"] for s in d)
    return sum(s.attrs["rows"] for s in d) / padded if padded else None
