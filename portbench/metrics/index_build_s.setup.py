"""The seconds TwoStageDB took to derive its index in set-up: the summed
index.derive spans (coarse rows and packed pass-1 rows, one span a shard,
ending when the card has finished them), from the process's start to the
window's."""

from portbench.metrics import _setup


def read(run):
    got = _setup.spans(run)
    if got is None:
        return None
    return sum(s.t1 - s.t0 for s in got if s.name == _setup.MARK) / 1e9
