"""The mean time a rank worker spends on a batch once its result has landed
(serve.rank: ranking, the gate, resolving or queueing each query for the
scan), over the batches that hold the window's requests, in ms."""

from portbench.metrics import _spans


def read(run):
    w = _spans.live(run)
    return _spans.mean_ms(w.batch_spans("serve.rank")) if w else None
