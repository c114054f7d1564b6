"""stage_wait_share.ingest: its clipping to the window on a hand-made ring,
nothing read where the program records no `extract.stage_wait` span, and a
traced tiny ingest run on the CPU that reads it."""

import types

import pytest

from hpfw_tpu_torch.utils import profiling
from hpfw_tpu_torch.utils.profiling import Span
from portbench import harness
from portbench_tiny import tiny_run

T_WINDOW = 1.0                       # s, on the ring's clock
NAME = "stage_wait_share.ingest"


def read(run):
    return harness.load_module("metrics", NAME + ".py").read(run)


def span(name, t0, t1, sid):
    """A span t0-t1 us after the window's start."""
    return Span(name, int((T_WINDOW * 1e6 + t0) * 1e3), int((T_WINDOW * 1e6 + t1) * 1e3),
                1, sid, None, {})


def window_run():
    return types.SimpleNamespace(t_window=T_WINDOW, records={"window_s": 1e-3})


def test_stage_wait_share_clips_to_the_window(monkeypatch):
    spans = [span("extract.stage_wait", -50, 20, 1), span("extract.upload", 100, 600, 2),
             span("extract.stage_wait", 300, 330, 3), span("extract.stage_wait", 990, 1100, 4),
             span("extract.stage_wait", 1500, 1600, 5)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert read(window_run()) == pytest.approx((20 + 30 + 10) / 1000)


def test_a_program_without_the_span_reads_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [span("extract.upload", 100, 600, 1)])
    assert read(window_run()) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(window_run()) is None


def test_traced_tiny_ingest_reads_the_stage_wait():
    cell = "ingest240.stream"
    per = [m["name"] for m in harness.cell_metrics(harness.benchmark(), cell)[1]]
    assert NAME in per
    out = harness.execute(tiny_run(cell, seconds=2.0, traced=True))
    assert out["correct"], out["checks"]
    assert 0.0 <= out["metrics"][NAME]["value"] <= 1.0
    assert out["metrics"][NAME]["unit"] == "share"
