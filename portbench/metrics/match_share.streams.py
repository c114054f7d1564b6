"""The share of a streaming pool's window spent in the pool's matches (stream.match: a bucket's batch padded to capacity, TwoStageDB.match_batch and its host ranking)."""

from portbench.metrics._streams import share


def read(run):
    return share(run, "stream.match")
