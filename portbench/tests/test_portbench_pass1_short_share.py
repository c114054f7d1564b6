"""pass1_short_share.streams: the short packed body's launches over every
pass-1 launch of a hand-made trace's window, and nothing read without a
trace or without a pass-1 launch."""

import types

import pytest

from portbench import harness
from portbench import trace as tracing

NAME = "pass1_short_share.streams"
SHORT = "void (anonymous namespace)::coarse_kernel<8, true>(signed char const*, int)"
LONG = "void (anonymous namespace)::coarse_kernel<4, true>(signed char const*, int)"
RESCAN = "void (anonymous namespace)::coarse_kernel<1, false>(signed char const*, int)"


def read(run):
    return harness.load_module("metrics", NAME + ".py").read(run)


def window_run(names, outside=()):
    """A run whose 1 ms window holds a 10 us kernel of each name, and whose
    trace holds the kernels `outside` after the window."""
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 1000,
               "dur": 1000}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": 1000 + 20 * i, "dur": 10}
               for i, n in enumerate(names)]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": 5000 + 20 * i, "dur": 10}
               for i, n in enumerate(outside)]
    return types.SimpleNamespace(trace=tracing.Trace.from_events(events), records={})


def test_share_counts_the_short_body_among_pass1_launches():
    run = window_run([SHORT, RESCAN, SHORT, LONG, "cqt_kernel<1>", SHORT],
                     outside=[LONG, LONG, LONG])
    assert read(run) == pytest.approx(3 / 4)
    assert read(window_run([SHORT, RESCAN] * 3)) == 1.0
    assert read(window_run([LONG, RESCAN, LONG])) == 0.0      # the parent's body alone


def test_nothing_to_read_without_a_pass1_launch():
    assert read(window_run([RESCAN, "cqt_kernel<1>"], outside=[SHORT])) is None
    assert read(types.SimpleNamespace(trace=None, records={})) is None


def test_declared_for_the_monitor_cell_alone():
    bench = harness.benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["monitor1m.streams256"] and entry["moves"] == "match_qps"
    assert entry["layer"] == "kernels" and entry["unit"] == "share"
    per = [m["name"] for m in harness.cell_metrics(bench, "monitor1m.streams256")[1]]
    assert NAME in per
    assert NAME not in [m["name"] for m in harness.cell_metrics(bench, "catalog1m.batch16")[1]]
