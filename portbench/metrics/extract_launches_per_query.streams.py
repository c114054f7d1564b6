"""K1 and K2 launches in the traced window over the stream-queries answered
in it (K2 counted once a launch, by its encoder kernel)."""

from portbench.roofline import k1_cqt, k2_hashprint


def read(run):
    t, n = run.trace, run.records.get("answered_in_window", 0)
    if t is None or not n:
        return None
    launches = (len(t.kernels_named(k1_cqt.PATTERN))
                + len(t.kernels_named(k2_hashprint.LAUNCH_PATTERN)))
    return launches / n if launches else None
