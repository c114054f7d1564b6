"""utils/profiling.py on the CPU: the wall-clock scopes and their stats, a
torch.profiler trace around a port match naming the scope, and no trace
without a device when torch sees no card; the span ring (bounded, fed from
any thread, a profiler annotation only where a profiler records the thread)
and the spans of match_batch and fingerprint_stream."""

import json
import threading

import numpy as np
import pytest
import torch

from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.io import synth
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.oracle import fix_eigenvector_signs
from hpfw_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_scopes():
    profiling.reset_scopes()
    yield
    profiling.reset_scopes()


def test_trace_records_scope_stats(tmp_path):
    for _ in range(3):
        with profiling.trace("a"):
            torch.ones(8).sum()
    with profiling.trace("b"):
        pass
    stats = profiling.scope_stats()
    assert set(stats) == {"a", "b"}
    assert stats["a"]["count"] == 3 and stats["b"]["count"] == 1
    assert 0 <= stats["a"]["p50_ms"] <= stats["a"]["max_ms"] <= stats["a"]["total_ms"]
    path = tmp_path / "m.json"
    profiling.dump_metrics(str(path), extra={"run": 1})
    payload = json.loads(path.read_text())
    assert payload["run"] == 1 and payload["scopes"] == stats
    profiling.reset_scopes()
    assert profiling.scope_stats() == {}


SMALL = HpfwConfig(frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8, delta_lag=4)


def small_filters(cfg=SMALL):
    rng = np.random.default_rng(0)
    return fix_eigenvector_signs(
        rng.standard_normal((cfg.context_dim, 64)) / 50).astype(np.float32)


def since(first_sid: int, name: str) -> list:
    return [s for s in profiling.spans() if s.name == name and s.sid > first_sid]


def test_trace_json_names_the_scope(tmp_path):
    cfg = SMALL
    filters = small_filters()
    tracks = synth.synth_catalog(3, 2.0, cfg)
    db = api.build_db(tracks, filters, cfg, device="cpu")
    q = api.fingerprint(tracks[1][2000:30000], filters, cfg, device="cpu")
    profiling.start_trace(str(tmp_path / "tr"), device="cpu")
    with pytest.raises(RuntimeError, match="already running"):
        profiling.start_trace(str(tmp_path / "tr2"), device="cpu")
    with profiling.trace("match"):
        ids, _, _ = api.match(q, db, top_k=2)
    profiling.stop_trace()
    assert ids[0] == "1"
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    scopes = [e for e in events if e.get("name") == "match" and e.get("ph") == "X"]
    assert len(scopes) == 1 and scopes[0]["dur"] > 0
    assert profiling.scope_stats()["match"]["count"] == 1
    with pytest.raises(RuntimeError, match="no trace is running"):
        profiling.stop_trace()


def test_start_trace_without_device_needs_a_card(tmp_path):
    """With no device named the card is traced; with none visible, it raises."""
    if torch.cuda.is_available():
        profiling.start_trace(str(tmp_path))
        profiling.stop_trace()
        assert (tmp_path / "trace.json").exists()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.start_trace(str(tmp_path))
    profiling.start_trace(str(tmp_path), device="cpu")   # nothing left running
    profiling.stop_trace()


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.new_id()
    with profiling.trace("quiet", cls="rigid", rows=3) as span:
        pass
    (got,) = since(first, "quiet")
    assert got.sid == span.sid and got.t0 == span.t0 <= got.t1
    assert got.parent is None and got.attrs == {"cls": "rigid", "rows": 3}
    assert got.thread == threading.get_ident()
    assert profiling.scope_stats()["quiet"]["count"] == 1


def test_ring_and_scopes_stay_bounded():
    first = profiling.new_id()
    n = profiling.CAPACITY + 10
    for i in range(n):
        profiling.record("flood", i, i + 1)
    ring = profiling.spans()
    assert len(ring) == profiling.CAPACITY
    assert [s.t0 for s in ring[-3:]] == [n - 3, n - 2, n - 1]
    assert ring[0].t0 == 10 and ring[0].sid > first      # the oldest went first
    assert profiling.scope_stats()["flood"]["count"] == profiling.SCOPE_CAPACITY
    assert len(profiling._SCOPES["flood"]) == profiling.SCOPE_CAPACITY


def test_record_from_a_second_thread_keeps_its_thread_and_parent():
    first, done = profiling.new_id(), {}
    parent = profiling.new_id()

    def worker():
        done["tid"] = threading.get_ident()
        profiling.record("elsewhere", 5, 9, parent=parent, req=7)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    (got,) = since(first, "elsewhere")
    assert got.thread == done["tid"] != threading.get_ident()
    assert (got.t0, got.t1, got.parent, got.attrs) == (5, 9, parent, {"req": 7})


def test_concurrent_spans_lose_no_record():
    """Threads past the core count record into one new scope at once, with
    a short switch interval: every span lands in the ring and the scope."""
    import os
    import sys

    n_threads, per = 2 * (os.cpu_count() or 4), 100
    first, name = profiling.new_id(), f"race.{profiling.new_id()}"
    start = threading.Barrier(n_threads)

    def worker():
        start.wait(timeout=30)
        for i in range(per):
            with profiling.trace(name, i=i):
                pass
            profiling.record(name, i, i + 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = since(first, name)
    assert len(got) == 2 * n_threads * per
    assert len({s.sid for s in got}) == len(got)
    assert len({s.thread for s in got}) == n_threads
    assert profiling.scope_stats()[name]["count"] == min(2 * n_threads * per,
                                                         profiling.SCOPE_CAPACITY)


def test_span_under_a_profiler_is_an_annotation_on_its_thread_only(tmp_path):
    """Under start_trace the main thread's span is a user_annotation of the
    exported trace; a span on a thread the profiler does not record is in
    the ring only."""
    first = profiling.new_id()

    def worker():
        with profiling.trace("side"):
            torch.ones(4).sum()

    profiling.start_trace(str(tmp_path), device="cpu")
    with profiling.trace("main.span"):
        torch.ones(4).sum()
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    profiling.stop_trace()
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    assert [e["name"] for e in marks if e["name"] in ("main.span", "side")] == ["main.span"]
    assert len(since(first, "main.span")) == len(since(first, "side")) == 1


def test_match_batch_makes_one_rank_span_a_call():
    cfg = SMALL
    tracks = synth.synth_catalog(4, 3.0, cfg)
    db = api.build_db(tracks, small_filters(), cfg, device="cpu")
    ts = TwoStageDB(db, stride=4)
    n = 60
    batch = np.stack([db.prints[i][10:10 + n] for i in (1, 2, 3)])
    first = profiling.new_id()
    for _ in range(2):
        got = ts.match_batch(batch, top_k=2)
    assert [r[0][0] for r in got] == ["1", "2", "3"]
    spans = since(first, "match.rank")
    assert len(spans) == 2 and all(s.t0 <= s.t1 for s in spans)


def test_fingerprint_stream_makes_one_upload_span_a_batch():
    cfg = SMALL
    batches = [np.stack(synth.synth_catalog(2, 1.0, cfg)) for _ in range(3)]
    first = profiling.new_id()
    out = list(api.fingerprint_stream(iter(batches), small_filters(), cfg, device="cpu"))
    assert len(out) == 3
    assert len(since(first, "extract.upload")) == 3


def test_fingerprint_stream_spans_a_batch():
    """One `extract.upload` span (staging thread) and one `extract.stage_wait`
    span (the caller's thread) a batch: the input's end makes none."""
    cfg = SMALL
    batches = [np.stack(synth.synth_catalog(1 + i % 2, 1.0, cfg)) for i in range(4)]
    first = profiling.new_id()
    out = list(api.fingerprint_stream(iter(batches), small_filters(), cfg, device="cpu"))
    assert len(out) == 4
    uploads, waits = since(first, "extract.upload"), since(first, "extract.stage_wait")
    assert len(uploads) == len(waits) == 4
    assert {s.thread for s in waits} == {threading.get_ident()}
    assert threading.get_ident() not in {s.thread for s in uploads}
    assert all(s.t0 <= s.t1 for s in uploads + waits)
