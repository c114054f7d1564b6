"""The mean host time a batch spends queueing its two-stage match and the copy
of its result (serve.dispatch), over the batches that hold the window's
requests, in ms."""

from portbench.metrics import _spans


def read(run):
    w = _spans.live(run)
    return _spans.mean_ms(w.batch_spans("serve.dispatch")) if w else None
