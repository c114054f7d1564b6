"""The readers of the match.dispatch spans' graphed attribute, on hand-made
rings, their None paths, and a traced run of each matcher cell at its tiny
size on the CPU (where no dispatch replays a graph)."""

import types

import pytest

from hpfw_tpu_torch.utils import profiling
from portbench import harness
from portbench_tiny import tiny_run
from test_portbench_spans import T_WINDOW, hand_ring, live_run, span


def read(name, run):
    return harness.load_module("metrics", name + ".py").read(run)


def test_serve_share_counts_dispatches_inside_the_window_batches(monkeypatch):
    # hand_ring's batches: 13 (before the window), 10 and 11 (rigid), 12 (scan).
    ring = hand_ring() + [
        span("match.dispatch", -888, -882, 30, graphed=False),      # batch 13
        span("match.dispatch", 231, 233, 31, graphed=True),         # batch 10
        span("match.dispatch", 711, 712, 32, graphed=False),        # batch 11
        span("match.dispatch", 778, 779, 33, graphed=True),         # batch 12
        span("match.dispatch", 900, 950, 34, graphed=False),        # in no batch
    ]
    monkeypatch.setattr(profiling, "spans", lambda: ring)
    assert read("graphed_share.serve", live_run()) == pytest.approx(2 / 3)
    other = [s._replace(thread=2) if s.name == "match.dispatch" else s for s in ring]
    monkeypatch.setattr(profiling, "spans", lambda: other)
    assert read("graphed_share.serve", live_run()) is None


def test_batch_share_clips_to_the_window(monkeypatch):
    ring = [span("match.dispatch", -50, -10, 1, graphed=False),
            span("match.dispatch", 10, 20, 2, graphed=True),
            span("match.dispatch", 300, 400, 3, graphed=True),
            span("match.dispatch", 500, 600, 4, graphed=False),
            span("match.rank", 600, 700, 5),
            span("match.dispatch", 990, 1100, 6, graphed=False)]
    monkeypatch.setattr(profiling, "spans", lambda: ring)
    run = types.SimpleNamespace(t_window=T_WINDOW, records={"window_s": 1e-3})
    assert read("graphed_share.batch", run) == pytest.approx(2 / 3)


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: hand_ring())    # no match.dispatch
    closed = types.SimpleNamespace(t_window=T_WINDOW, records={"window_s": 1e-3})
    assert read("graphed_share.serve", live_run()) is None
    assert read("graphed_share.batch", closed) is None
    assert read("graphed_share.batch", types.SimpleNamespace(t_window=None, records={})) is None
    # A program without the ring (no spans()) gives nothing and raises nothing.
    monkeypatch.delattr(profiling, "spans")
    assert read("graphed_share.serve", live_run()) is None
    assert read("graphed_share.batch", closed) is None


@pytest.mark.parametrize("cell,name", [("catalog100k.batch16", "graphed_share.batch"),
                                       ("catalog100k.live", "graphed_share.serve")])
def test_traced_tiny_run_reads_the_share(cell, name):
    out = harness.execute(tiny_run(cell, seconds=2.0, traced=True))
    assert out["correct"], out["checks"]
    assert out["metrics"][name]["value"] == 0.0      # the CPU never replays a graph
