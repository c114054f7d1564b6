"""The share of the two-stage dispatches that replayed a CUDA graph: the
match.dispatch spans (TwoStageDB.dispatch_batch, one a match_batch call)
whose graphed is true, over those inside the closed loop's window."""

from portbench.metrics import _spans


def read(run):
    if run.t_window is None or "window_s" not in run.records:
        return None
    lo = _spans.ns(run.t_window)
    hi = lo + _spans.ns(run.records["window_s"])
    spans = _spans.ring(lo)
    mine = [s for s in spans or () if s.name == "match.dispatch" and lo <= s.t0 and s.t1 <= hi]
    return sum(bool(s.attrs.get("graphed")) for s in mine) / len(mine) if mine else None
