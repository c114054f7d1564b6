"""The share of a streaming pool's window spent in the pool's batched extractions (stream.extract: the windows stacked and uploaded, K1 and K2 a row, the prints back on the host, the rings updated)."""

from portbench.metrics._streams import share


def read(run):
    return share(run, "stream.extract")
