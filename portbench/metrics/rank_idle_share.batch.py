"""The share of the traced window in which no device operation (kernel, copy
or memset) ran while the main thread was inside a match.rank annotation
(TwoStageDB.match_batch's host ranking), read from the trace alone."""

from portbench import stats
from portbench.metrics import _spans


def read(run):
    t = run.trace
    if t is None:
        return None
    ranks = [(e["ts"], e["ts"] + e["dur"]) for e in t.events if e.get("name") == "match.rank"
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not ranks:
        return None
    idle = stats.gaps(((e["ts"], e["ts"] + e["dur"]) for e in t.device), t.lo, t.hi)
    return _spans.overlap(idle, stats.merge(ranks)) / (t.hi - t.lo)
