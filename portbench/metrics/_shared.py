"""Readings shared by per-layer metrics of several cells (not itself a metric)."""


def idle_share(run):
    """1 - (the union of device operations in the window / the window)."""
    t = run.trace
    return None if t is None or not t.device else 1.0 - t.busy_s() / t.window_s


def kernels_per_query(run):
    """Kernel events in the traced window over queries answered in it."""
    t, n = run.trace, run.records.get("answered_in_window", 0)
    return None if t is None or not t.kernels or not n else len(t.kernels) / n


def roofline(run, pattern, launch_pattern, bound_s):
    """100 x (launches x each one's bound) / their traced time, in %."""
    t = run.trace
    if t is None:
        return None
    events = t.kernels_named(pattern)
    launches = len(t.kernels_named(launch_pattern))
    spent = sum(e["dur"] for e in events) / 1e6
    return 100.0 * launches * bound_s / spent if launches and spent > 0 else None
