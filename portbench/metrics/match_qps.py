"""match_qps: queries answered in the window over the window's seconds."""

from portbench.stats import rate


def read(run):
    r = run.records
    return rate(r["answered_in_window"], r["window_s"]) if "window_s" in r else None
