"""K2 (its split pass and encoder together) on whole tracks of track_seconds,
in % of its roofline bound."""

from portbench.metrics._shared import roofline
from portbench.roofline import k2_hashprint


def read(run):
    c = run.config
    n = int(round(c["track_seconds"] * c["hpfw"]["sample_rate"]))
    return roofline(run, k2_hashprint.PATTERN, k2_hashprint.LAUNCH_PATTERN,
                    k2_hashprint.bound(c["hpfw"], n))
