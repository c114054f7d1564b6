"""The readers of the program's spans, on a hand-made ring and trace whose
idle gaps, request lifetimes and clock offset are known, their None paths,
and a traced run of each cell at its tiny size on the CPU."""

import types

import pytest

from hpfw_tpu_torch.utils import profiling
from hpfw_tpu_torch.utils.profiling import Span
from portbench import harness
from portbench import trace as tracing
from portbench_tiny import tiny_run

SERVE = ["admit_wait_p95_ms.serve", "scan_wait_p50_ms.serve", "batch_fill.serve",
         "extract_host_ms.serve", "dispatch_host_ms.serve", "rank_ms.serve",
         "idle_held_share.serve"]
# The trace's clock minus the ring's, us.
OFFSET = 123_456.0
T_WINDOW = 1.0                       # s, on the ring's clock
LO = T_WINDOW * 1e6                  # us


def read(name, run):
    return harness.load_module("metrics", name + ".py").read(run)


def us(t):
    """A ring time (ns) of t us after the window's start."""
    return int(round((LO + t) * 1e3))


def span(name, t0, t1, sid, parent=None, **attrs):
    return Span(name, us(t0), us(t1), 1, sid, parent, attrs)


def hand_ring():
    """Three requests in a window of 1000 us: r1 (id 1) 0-300 us and r2 (id 2)
    200-500 in rigid batch 10, r3 (id 3) 700-800 in rigid batch 11, escalated
    at 760 into scan batch 12. A request submitted before the window (id 4)
    and its batch (13) count in no reading but the held time."""
    return [
        span("serve.submit", -900, -899, 4), span("serve.admit", -900, -890, 4, 13, req=4),
        span("serve.dispatch", -889, -880, 13, cls="rigid", rows=1, padded=1),
        span("serve.request", -900, -700, 5, req=4, escalated=False),
        span("serve.submit", 0, 1, 1), span("serve.submit", 200, 201, 2),
        span("serve.submit", 700, 701, 3),
        span("serve.admit", 0, 220, 6, 10, req=1), span("serve.admit", 200, 220, 7, 10, req=2),
        span("serve.extract", 220, 230, 8, 10, cls="rigid"),
        span("serve.dispatch", 230, 234, 10, cls="rigid", rows=2, padded=4),
        span("serve.rank", 280, 290, 9, 10, cls="rigid"),
        span("serve.admit", 700, 705, 14, 11, req=3),
        span("serve.extract", 705, 711, 15, 11, cls="rigid"),
        span("serve.dispatch", 711, 713, 11, cls="rigid", rows=1, padded=1),
        span("serve.rank", 750, 760, 16, 11, cls="rigid"),
        span("serve.scan_admit", 760, 770, 17, 12, req=3),
        span("serve.extract", 770, 778, 18, 12, cls="scan"),
        span("serve.dispatch", 778, 780, 12, cls="scan", rows=1, padded=1),
        span("serve.rank", 790, 796, 19, 12, cls="scan"),
        span("serve.request", 0, 300, 20, req=1, escalated=False),
        span("serve.request", 200, 500, 21, req=2, escalated=False),
        span("serve.request", 700, 800, 22, req=3, escalated=True),
    ]


def x(cat, name, t, dur):
    """A complete trace event t us after the window's start, on the trace's clock."""
    return {"ph": "X", "cat": cat, "name": name, "ts": LO + OFFSET + t, "dur": dur}


def hand_trace(anchors=((0, 2.0), (200, 3.0), (700, 1.0)), ranks=()):
    """Kernels at 100-150, 400-600 and 750-760 us of a 1000 us window: idle
    100 + 250 + 150 + 240 = 740 us. The anchors: serve.submit annotations at
    (ring time, lag us)."""
    events = [x("user_annotation", tracing.WINDOW, 0, 1000),
              x("kernel", "k", 100, 50), x("kernel", "k", 400, 200),
              x("gpu_memcpy", "Memcpy HtoD", 750, 10)]
    events += [x("user_annotation", "serve.submit", t + lag, 1) for t, lag in anchors]
    events += [x("user_annotation", "match.rank", a, b - a) for a, b in ranks]
    return tracing.Trace.from_events(events)


def live_run(trace=None):
    return types.SimpleNamespace(t_window=T_WINDOW, seconds=1e-3, trace=trace, records={})


@pytest.fixture
def ring(monkeypatch):
    spans = hand_ring()
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return spans


def test_serve_readers_on_the_hand_ring(ring):
    run = live_run(hand_trace())
    assert read("admit_wait_p95_ms.serve", run) == pytest.approx(0.220)
    assert read("scan_wait_p50_ms.serve", run) == pytest.approx(0.010)
    assert read("batch_fill.serve", run) == pytest.approx(4 / 6)
    assert read("extract_host_ms.serve", run) == pytest.approx((10 + 6 + 8) / 3 / 1e3)
    assert read("dispatch_host_ms.serve", run) == pytest.approx((4 + 2 + 2) / 3 / 1e3)
    assert read("rank_ms.serve", run) == pytest.approx((10 + 10 + 6) / 3 / 1e3)


def test_idle_held_share_through_a_clock_offset(ring):
    # Held 0-500 and 700-800 us; idle and held: 100 + 250 (0-500) and
    # 50 + 40 (700-800) of 1000 us.
    run = live_run(hand_trace())
    from portbench.metrics import _shared

    assert _shared.idle_share(run) == pytest.approx(0.74)
    assert read("idle_held_share.serve", run) == pytest.approx(0.44, abs=3e-3)
    # One anchor missing from the trace at the window's edge pairs the rest.
    run = live_run(hand_trace(anchors=((200, 3.0), (700, 1.0))))
    assert read("idle_held_share.serve", run) == pytest.approx(0.44, abs=3e-3)


def test_rank_idle_share_reads_the_trace_alone(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    # match.rank 0-120 and 500-800 us: idle in 0-100 and 600-750, 760-800.
    run = live_run(hand_trace(ranks=((0, 120), (500, 800))))
    assert read("rank_idle_share.batch", run) == pytest.approx((100 + 150 + 40) / 1000)
    assert read("rank_idle_share.batch", live_run(hand_trace())) is None
    assert read("rank_idle_share.batch", live_run()) is None


def test_upload_share_clips_to_the_window(monkeypatch):
    spans = [span("extract.upload", -50, 100, 1), span("extract.upload", 300, 400, 2),
             span("extract.upload", 950, 1200, 3), span("extract.upload", 2000, 2100, 4)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    run = types.SimpleNamespace(t_window=T_WINDOW, records={"window_s": 1e-3})
    assert read("upload_share.ingest", run) == pytest.approx((100 + 100 + 50) / 1000)


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    run = live_run(hand_trace())
    for name in SERVE:
        assert read(name, run) is None, name
    assert read("upload_share.ingest", types.SimpleNamespace(
        t_window=T_WINDOW, records={"window_s": 1e-3})) is None
    # A program without the ring (no spans()) gives nothing and raises nothing.
    monkeypatch.delattr(profiling, "spans")
    for name in SERVE:
        assert read(name, run) is None, name


def test_ring_that_lost_the_window_start(monkeypatch, ring):
    monkeypatch.setattr(profiling, "CAPACITY", len(ring))
    run = live_run(hand_trace())
    assert read("admit_wait_p95_ms.serve", run) is not None     # the oldest is before it
    monkeypatch.setattr(profiling, "spans", lambda: ring[5:])     # from r2's submit on
    monkeypatch.setattr(profiling, "CAPACITY", len(ring) - 5)
    for name in SERVE:
        assert read(name, run) is None, name


@pytest.mark.parametrize("anchors", [
    ((0, 2.0),),                                          # too few to pair
    ((0, 2.0), (200, 900.0), (700, -400.0)),              # offsets spread over 200 us
    tuple((t, 1.0) for t in (0, 50, 100, 150, 200, 250, 300, 700)),   # 5 more than the ring
], ids=["one", "spread", "counts"])
def test_anchors_that_do_not_pair(ring, anchors):
    assert read("idle_held_share.serve", live_run(hand_trace(anchors=anchors))) is None


CELL_METRICS = {cell: [m["name"] for m in harness.cell_metrics(harness.benchmark(), cell)[1]]
                for cell in ("catalog100k.live_renditions", "catalog100k.batch16",
                             "ingest240.stream")}
NEW = set(SERVE) | {"rank_idle_share.batch", "upload_share.ingest"}


@pytest.mark.parametrize("cell", list(CELL_METRICS))
def test_traced_tiny_run_reads_every_new_metric(cell):
    out = harness.execute(tiny_run(cell, seconds=2.0, traced=True))
    assert out["correct"], out["checks"]
    want = NEW & set(CELL_METRICS[cell])
    assert want and want <= set(out["metrics"]), sorted(want - set(out["metrics"]))
    for name in want:
        assert out["metrics"][name]["value"] >= 0, name
    shares = {k: v["value"] for k, v in out["metrics"].items() if "share" in k}
    assert all(v <= 1.0 for v in shares.values()), shares
