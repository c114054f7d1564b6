"""The arithmetic of the end-to-end numbers and of the trace readings, on
hand-made samples and a hand-made trace."""

import math
import types

import pytest

from portbench import stats
from portbench import trace as tracing
from portbench.metrics import _shared


def test_percentile_nearest_rank():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == 5.0
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([1.0, math.inf], 95) == math.inf
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_latencies_from_due_with_a_stall_and_a_failure():
    # Requests due at 0, 1, 2 and 3 s; a stall holds the second and third
    # answers until 5 s; the fourth never comes, and the run waited until 9 s.
    due = [0.0, 1.0, 2.0, 3.0]
    done = [0.5, 5.0, 5.0, None]
    lat = stats.request_latencies(due, done, closed_at=9.0)
    assert lat[:3] == [0.5, 4.0, 3.0]
    assert lat[3] == 6.0 and lat[3] > max(lat[:3])
    assert stats.percentile(lat, 50) == 3.0
    assert stats.percentile(lat, 95) == 6.0


def test_failed_request_is_later_than_any_answer_even_after_an_early_close():
    lat = stats.request_latencies([0.0, 0.0], [8.0, None], closed_at=1.0)
    assert lat[1] >= lat[0]


def test_rate():
    assert stats.rate(300, 10.0) == 30.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_busy_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert stats.merge(iv) == [(0, 3), (5, 6), (8, 12)]
    assert stats.busy(iv, 1, 10) == 2 + 1 + 2
    assert stats.gaps(iv, 1, 10) == [(3, 5), (6, 8)]
    assert stats.gaps([], 0, 4) == [(0, 4)]


def test_quartile_spread():
    assert stats.quartile_spread([1.0] * 6) == 0.0
    assert stats.quartile_spread([98, 99, 100, 100, 101, 102]) == pytest.approx(
        (101.25 - 98.75) / 100)


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def hand_trace():
    # A window of 1000 us: two K4 pass-1 launches of 100 us, an overlapping
    # copy, a rescan, and a gap while the host ranks (no torch op) and one
    # while it runs aten::topk.
    events = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 1000, "dur": 1000},
        kernel("void (anonymous namespace)::coarse_kernel<2, true>(signed char const*, int)",
               1000, 100),
        kernel("void (anonymous namespace)::coarse_kernel<2, true>(signed char const*, int)",
               1500, 100),
        kernel("void (anonymous namespace)::coarse_kernel<1, false>(signed char const*, int)",
               1600, 50),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "ts": 1050, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::topk", "ts": 1700, "dur": 200},
        kernel("outside", 5000, 10),
    ]
    return tracing.Trace.from_events(events)


def test_trace_window_busy_and_kernels():
    t = hand_trace()
    assert t.window_s == pytest.approx(1e-3)
    assert len(t.kernels) == 3
    assert t.busy_s() == pytest.approx(300e-6)       # [1000,1150] + [1500,1650]
    assert len(t.kernels_named(r"\bcoarse_kernel<\d+, true>")) == 2


def test_breakdown_names_gaps_by_the_host():
    b = hand_trace().breakdown()
    ops = dict(b["device_ops"])
    assert ops["coarse_kernel<2, true>"] == pytest.approx(200e-6)
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::topk"] == pytest.approx(350e-6)              # 1650-2000
    assert gaps["no torch or CUDA call (Python)"] == pytest.approx(350e-6)  # 1150-1500


def test_readers_on_the_hand_trace():
    run = types.SimpleNamespace(trace=hand_trace(), records={"answered_in_window": 4})
    assert _shared.idle_share(run) == pytest.approx(0.7)
    assert _shared.kernels_per_query(run) == pytest.approx(3 / 4)
    pattern = r"\bcoarse_kernel<\d+, true>"
    assert _shared.roofline(run, pattern, pattern, 50e-6) == pytest.approx(50.0)


def test_readers_find_nothing_without_a_trace():
    run = types.SimpleNamespace(trace=None, records={"answered_in_window": 4})
    assert _shared.idle_share(run) is None
    assert _shared.kernels_per_query(run) is None
    assert _shared.roofline(run, "x", "x", 1.0) is None
    empty = tracing.Trace([], 0, 10)
    run = types.SimpleNamespace(trace=empty, records={"answered_in_window": 4})
    assert _shared.idle_share(run) is None
    assert _shared.roofline(run, "x", "x", 1.0) is None


def test_window_annotation_must_be_unique():
    with pytest.raises(RuntimeError):
        tracing.Trace.from_events([])


def test_short_names():
    assert tracing.short("void (anonymous namespace)::cqt_kernel<2>(float const*, long)") \
        == "cqt_kernel<2>"
    assert tracing.short("aten::topk") == "aten::topk"
