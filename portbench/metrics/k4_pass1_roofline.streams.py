"""K4's pass 1 over the nibble-packed catalog, in % of its roofline bound, over
every pass-1 launch of the traced window: each a feed's batch of the pool's
capacity of query_prints-print rings (the pool pads a batch to capacity)."""

from portbench.metrics._shared import roofline
from portbench.roofline import k4_pass1


def read(run):
    c, w = run.config, run.workload
    s = k4_pass1.shape(c["hpfw"], w["query_prints"], c["pool"]["capacity"], c["n_tracks"],
                       c["prints_per_track"])
    return roofline(run, k4_pass1.PATTERN, k4_pass1.PATTERN, k4_pass1.bound(s))
