"""The mean host time a batch spends queueing its extraction (serve.extract:
the upload, K1 and K2 a row of a rigid batch; the variants' K2 of a scan
batch), over the batches that hold the window's requests, in ms."""

from portbench.metrics import _spans


def read(run):
    w = _spans.live(run)
    return _spans.mean_ms(w.batch_spans("serve.extract")) if w else None
