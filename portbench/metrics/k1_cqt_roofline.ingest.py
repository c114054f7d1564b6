"""K1 on whole tracks of track_seconds, in % of its roofline bound."""

from portbench.metrics._shared import roofline
from portbench.roofline import k1_cqt


def read(run):
    c = run.config
    n = int(round(c["track_seconds"] * c["hpfw"]["sample_rate"]))
    return roofline(run, k1_cqt.PATTERN, k1_cqt.PATTERN, k1_cqt.bound(c["hpfw"], n))
