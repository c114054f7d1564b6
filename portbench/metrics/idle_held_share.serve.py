"""The share of the traced window in which no device operation (kernel, copy
or memset) ran while at least one request was in the server, between the
start and end of its serve.request span. The ring's times are put on the
trace's clock through the serve.submit spans, which the trace also holds as
annotations of the submitting thread (_spans.offset_us)."""

from portbench import stats
from portbench.metrics import _spans


def read(run):
    t, w = run.trace, _spans.live(run)
    if t is None or w is None:
        return None
    off = _spans.offset_us(t, w.spans, _spans.ns(run.t_window))
    if off is None:
        return None
    held = stats.merge((s.t0 / 1e3 + off, s.t1 / 1e3 + off) for s in w.by["serve.request"])
    idle = stats.gaps(((e["ts"], e["ts"] + e["dur"]) for e in t.device), t.lo, t.hi)
    return _spans.overlap(idle, held) / (t.hi - t.lo)
