"""The program's spans of a run's set-up: from the process's start to the
window's (not itself a metric)."""

from __future__ import annotations

from portbench.metrics import _spans

MARK = "index.derive"


def spans(run):
    """The ring's spans that lie inside set-up, or None: without a ring, where
    it lost records of set-up, or where set-up holds no MARK span (a program
    that records no spans of its index build or of its print copies)."""
    if run.t_window is None:
        return None
    lo, hi = _spans.ns(run.t_process), _spans.ns(run.t_window)
    ring = _spans.ring(lo)
    got = [s for s in ring or () if lo <= s.t0 and s.t1 <= hi]
    return got if any(s.name == MARK for s in got) else None
