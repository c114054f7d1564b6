"""The share of a streaming pool's window spent in the pool's vote integration (stream.vote: every matched stream's vote cast into its decayed tally)."""

from portbench.metrics._streams import share


def read(run):
    return share(run, "stream.vote")
