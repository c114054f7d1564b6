"""Plain vote integration of a monitored stream, as the method states it.

A stream is matched once a feed; each match's top hit (track, score,
offset) over a query of n prints casts one vote. Before the vote every
track's tally decays by `decay`; the hit's track then gains the score's
excess over the imposter floor, floor * 64 * n (nothing below it), and
remembers (score, offset) as its latest. The hypothesis is the track with
the largest tally, the track voted first on ties, with its latest (score,
offset) and confidence (top - runner-up) / top, the runner-up the largest
other tally (0 with none). While every tally is 0 the hypothesis is the hit
itself, with confidence 0.

Plain Python floats, summed in the order a stream's votes came.
"""

from __future__ import annotations


class Votes:
    """One stream's decayed tally, in the order tracks were first voted."""

    def __init__(self, decay: float, floor: float):
        self.decay, self.floor = decay, floor
        self.tally: dict = {}
        self.latest: dict = {}

    def cast(self, track, score: int, offset: int, n: int) -> tuple:
        """Cast one hit over a query of n prints: the hypothesis (track,
        score, offset, confidence) after it."""
        for k in self.tally:
            self.tally[k] *= self.decay
        gain = max(0.0, float(score) - self.floor * 64.0 * n)
        self.tally[track] = self.tally.get(track, 0.0) + gain
        self.latest[track] = (int(score), int(offset))
        top = None
        for k, v in self.tally.items():          # the first of the largest
            if top is None or v > self.tally[top]:
                top = k
        v_top = self.tally[top]
        if v_top <= 0:
            return (track, int(score), int(offset), 0.0)
        v_second = max((v for k, v in self.tally.items() if k != top), default=0.0)
        return (top, *self.latest[top], (v_top - v_second) / v_top)


def replay(hits, decay: float, floor: float) -> list[tuple]:
    """The hypotheses after each of a stream's hits, (track, score, offset,
    n prints) in the order cast."""
    votes = Votes(decay, floor)
    return [votes.cast(t, s, o, n) for t, s, o, n in hits]
