"""Readings of the program's span ring (hpfw_tpu_torch.utils.profiling) over a
run's window, and their mapping onto the device trace's clock (not itself a
metric).

The ring's times are time.perf_counter_ns(), the clock of Run.t_window. The
window of a live cell is [t_window, t_window + seconds], taken by submit
time: the requests whose serve.submit span starts in it, and the batches
that hold them. The window of a closed loop is [t_window, t_window +
records["window_s"]]. Each reading is None where the program records no
spans (a version without the ring), where the window holds none, or where
the ring lost records inside the window (it is full and its oldest record
is newer than the window's start).
"""

from __future__ import annotations

import statistics
from collections import defaultdict

ANCHOR = "serve.submit"
# Anchors that one clock may hold and the other not, at the window's edges.
MAX_UNPAIRED = 3
# The widest spread (interquartile range, us) of the paired anchors' offsets.
MAX_SPREAD_US = 200.0


def ns(t: float) -> int:
    return int(round(t * 1e9))


def ring(lo_ns: int):
    """The ring's spans, oldest first; None without a ring, with no spans, or
    when the ring lost records after lo_ns."""
    try:
        from hpfw_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    spans = read() if read is not None else []
    if not spans or (len(spans) >= profiling.CAPACITY and spans[0].t0 > lo_ns):
        return None
    return spans


def closed_spans(run, name: str):
    """(the spans `name` clipped to a closed loop's window, as (t0, t1) in
    ns, and the window) or None."""
    if run.t_window is None or "window_s" not in run.records:
        return None
    lo = ns(run.t_window)
    hi = lo + ns(run.records["window_s"])
    spans = ring(lo)
    if spans is None:
        return None
    got = [(max(s.t0, lo), min(s.t1, hi)) for s in spans
           if s.name == name and s.t1 > lo and s.t0 < hi]
    return (got, (lo, hi)) if got else None


class Live:
    """A live window's spans by name, its requests' ids and its batches' ids."""

    def __init__(self, spans, reqs, batches):
        self.by = defaultdict(list)
        for s in spans:
            self.by[s.name].append(s)
        self.spans, self.reqs, self.batches = spans, reqs, batches

    def requests(self, name: str) -> list:
        """The window's requests' spans `name`."""
        return [s for s in self.by[name] if s.attrs.get("req") in self.reqs]

    def batch_spans(self, name: str) -> list:
        """The spans `name` of the batches that hold the window's requests."""
        if name == "serve.dispatch":
            return [s for s in self.by[name] if s.sid in self.batches]
        return [s for s in self.by[name] if s.parent in self.batches]


def live(run):
    """The live window's Live, or None."""
    if run.t_window is None:
        return None
    lo = ns(run.t_window)
    hi = lo + ns(run.seconds)
    spans = ring(lo)
    if spans is None:
        return None
    reqs = {s.sid for s in spans if s.name == ANCHOR and lo <= s.t0 <= hi}
    if not reqs:
        return None
    batches = {s.parent for s in spans if s.name in ("serve.admit", "serve.scan_admit")
               and s.attrs.get("req") in reqs}
    return Live(spans, reqs, batches)


def mean_ms(spans) -> float | None:
    return sum(s.t1 - s.t0 for s in spans) / len(spans) / 1e6 if spans else None


def offset_us(trace, spans, lo_ns: int):
    """The trace's clock minus the ring's (us), from the ANCHOR spans that
    start after lo_ns, which the trace also holds as user annotations: the
    two lists paired in order (where their counts differ by at most
    MAX_UNPAIRED, at the alignment whose offsets spread least), the median
    of the start differences. None where the counts differ by more, or the
    offsets' interquartile range is over MAX_SPREAD_US."""
    marks = sorted(e["ts"] for e in trace.events if e.get("name") == ANCHOR
                   and e.get("ph") == "X" and e.get("cat") == "user_annotation")
    ours = sorted(s.t0 / 1e3 for s in spans if s.name == ANCHOR and s.t0 >= lo_ns)
    extra = len(ours) - len(marks)
    if abs(extra) > MAX_UNPAIRED or min(len(ours), len(marks)) < 2:
        return None
    best = None
    for k in range(abs(extra) + 1):
        a, b = (ours[k:k + len(marks)], marks) if extra >= 0 else (ours, marks[k:k + len(ours)])
        q1, med, q3 = statistics.quantiles([m - o for o, m in zip(a, b)], n=4)
        if best is None or q3 - q1 < best[0]:
            best = (q3 - q1, med)
    return best[1] if best[0] <= MAX_SPREAD_US else None


def overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
