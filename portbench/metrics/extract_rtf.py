"""extract_rtf: audio seconds whose prints came back to the host in the window,
over the window's seconds."""

from portbench.stats import rate


def read(run):
    r = run.records
    return rate(r["audio_s"], r["window_s"]) if "audio_s" in r else None
