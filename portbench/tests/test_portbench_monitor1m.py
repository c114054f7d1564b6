"""monitor1m.streams256 and catalog1m.live at tiny sizes on the CPU: a whole
run of each new kind is correct; an altered hit, a replay at another decay
and an altered served answer fail it; streams_resident's catalog is
batch_resident's bit for bit; the five stream metrics read None without
spans or a trace and sum a synthetic ring and trace; and the existing
readers to which the new cells were appended read them."""

import time

import numpy as np
import pytest
import torch

from hpfw_tpu_torch.utils import profiling
from hpfw_tpu_torch.utils.profiling import Span
from portbench import harness
from portbench import trace as tracing
from portbench.reference import streams as vote_reference
from portbench.roofline import k4_pass1
from portbench.traffic import batch_resident, streams_resident

MONITOR, LIVE = "monitor1m.streams256", "catalog1m.live"
CATALOG = dict(n_tracks=48, planted_tracks=4, track_seconds=12, prints_per_track=516)
POOL = dict(capacity=4, chunk_prints=32, query_prints=128, vote_decay=0.8, vote_floor=0.55,
            query_buckets=[32, 64, 128])
TINY = {MONITOR: dict(CATALOG, pool=POOL, streams=4, check_streams=4, vote_streams=2,
                      check_feeds=2),
        LIVE: dict(CATALOG, query_pool=8, rate_qps=4.0, check_requests=4)}
SEED = 2 ** 31 + 22
STREAM_METRICS = ["extract_share.streams", "match_share.streams", "vote_share.streams",
                  "extract_launches_per_query.streams", "k4_pass1_roofline.streams"]


def tiny(cell, seed=SEED, seconds=1.5, traced=False, **extra):
    return harness.Run(cell, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                       dict(TINY[cell], **extra))


def read(name, run):
    return harness.load_module("metrics", name + ".py").read(run)


def alter_offsets(monkeypatch):
    from hpfw_tpu_torch.match.scaled import TwoStageDB

    orig = TwoStageDB.dispatch_batch

    def dispatch(self, queries, **kw):
        out = orig(self, queries, **kw).clone()
        out[:, 2] += 3
        return out
    monkeypatch.setattr(TwoStageDB, "dispatch_batch", dispatch)


@pytest.fixture(scope="module")
def monitor_run():
    run = tiny(MONITOR, seconds=3.0, traced=True)
    return run, harness.execute(run)


def test_monitor_config_is_catalog1m_with_a_pool():
    mine = harness.load_json("configs", "monitor1m.json")
    theirs = harness.load_json("configs", "catalog1m.json")
    for key in ("n_tracks", "track_seconds", "prints_per_track", "planted_tracks", "hpfw",
                "noise_db", "reduced_from_source", "on_device_bytes"):
        assert mine[key] == theirs[key], key
    assert mine["pool"] == dict(POOL, capacity=256)


def test_monitor_catalog_is_batch_residents():
    """A monitor run's set-up holds batch_resident.build's catalog of a
    catalog1m run at the same seed and sizes."""
    run = tiny(MONITOR)
    streams_resident.setup(run)
    mine = run.state["catalog"]
    other = harness.Run("catalog1m.batch16", SEED, 1.0, False, torch.device("cpu"),
                        time.perf_counter(), CATALOG)
    theirs = batch_resident.build(other)
    for key in ("prints", "lengths", "filters", "params"):
        assert torch.equal(mine[key], theirs[key]), key
    assert np.array_equal(mine["rows"], theirs["rows"])
    assert run.state["ts"].db.host_bytes == 0
    assert run.state["ts"].db.device_arrays()[0].data_ptr() == mine["prints"].data_ptr()


def test_monitor_run_is_correct(monitor_run):
    run, out = monitor_run
    assert out["correct"] is True, out["checks"]
    assert {k: v["value"] for k, v in out["checks"].items()} == {
        "mismatches": 0.0, "bit_diff_share": 0.0, "worst_print_bits": 0.0,
        "vote_mismatches": 0.0}
    assert out["attempted"] == run.records["feeds"] * TINY[MONITOR]["streams"] > 0
    assert run.records["checked"] == 2 * 4
    # The streams change track in the run, and the votes follow.
    tracks = {h.track_id for seq in run.state["votes"].values() for *_, h in seq}
    assert len(tracks) > 2


def test_monitor_stream_plan_moves_along_the_cycle():
    run = tiny(MONITOR)
    plan = streams_resident.Plan(run, 4, 1000)
    assert sorted(plan.next.tolist()) == [0, 1, 2, 3]
    t = 0
    for _ in range(4):                                  # one cycle through all four
        t = plan.next[t]
    assert t == 0 and (plan.start < 500).all()
    pcm = np.arange(4000, dtype=np.float32).reshape(4, 1000)
    s = 1
    x = plan.samples(pcm, s, 0, 2000)
    first, start = int(plan.first[s]), int(plan.start[s])
    np.testing.assert_array_equal(x[:1000 - start], pcm[first, start:])
    np.testing.assert_array_equal(x[1000 - start:2000 - start], pcm[plan.next[first]])
    np.testing.assert_array_equal(plan.samples(pcm, s, 700, 1700), x[700:1700])


def test_an_altered_hit_fails_the_monitor(monkeypatch):
    alter_offsets(monkeypatch)
    out = harness.execute(tiny(MONITOR))
    assert out["correct"] is False and out["checks"]["mismatches"]["value"] > 0


def test_another_decay_fails_the_vote_check(monitor_run):
    run, _ = monitor_run
    assert streams_resident.vote_mismatches(run) == 0
    assert streams_resident.vote_mismatches(run, decay=0.79) > 0


def test_vote_reference_breaks_ties_toward_the_first_voted():
    floor_n = 0.5 * 64.0 * 1
    hyps = vote_reference.replay([("x", 40, 1, 1), ("y", 40, 2, 1)], 1.0, 0.5)
    assert hyps[0] == ("x", 40, 1, 1.0)
    assert hyps[1] == ("x", 40, 1, 0.0)                 # a tie: x, voted first
    assert vote_reference.replay([("z", int(floor_n), 5, 1)], 0.8, 0.5) == [("z", 32, 5, 0.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tf32_control_fails_the_monitor(cuda):
    from portbench import control

    lim = harness.load_json("workloads", MONITOR + ".json")["limits"]
    for seed in (1, 2, 3):
        got = control.readings(MONITOR, seed, cuda, TINY[MONITOR])
        assert (got["bit_diff_share"] > lim["bit_diff_share"]
                or got["worst_print_bits"] > lim["worst_print_bits"]), got


@pytest.mark.cuda
def test_tf32_control_fails_catalog1m_live(cuda):
    from portbench import control

    lim = harness.load_json("workloads", LIVE + ".json")["limits"]
    for seed in (1, 2, 3):
        got = control.readings(LIVE, seed, cuda, dict(CATALOG, n_tracks=8192, planted_tracks=64,
                                                      query_pool=64, check_requests=32))
        assert got["score_gap"] > lim["score_gap"], got


def test_live_run_is_correct_and_resident():
    """A whole catalog1m.live run is correct, its DB holds the catalog's own
    tensor and no host copy; the set-up readers and the serve readers read
    the run."""
    from hpfw_tpu_torch.match.scaled import TwoStageDB

    held = []
    orig = TwoStageDB.__init__

    def init(self, db, **kw):
        orig(self, db, **kw)
        held.append(db)
    # Every query escalates, so the scan's readers have spans to read.
    server = dict(harness.load_json("configs", "catalog1m.json")["server"], threshold=0.99,
                  hi_sim=0.999, max_wait_ms=200.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TwoStageDB, "__init__", init)
        run = tiny(LIVE, traced=True, server=server, rate_qps=6.0)
        out = harness.execute(run)
    assert out["correct"] is True, out["checks"]
    (db,) = held
    assert db.host_bytes == 0
    assert db.device_arrays()[0].data_ptr() == run.state["catalog"]["prints"].data_ptr()
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["host_copy_gb.setup"] == 0.0 and m["index_build_s.setup"] > 0
    assert m["escalated_share.serve"] > 0.5
    for name in ("admit_wait_p95_ms.serve", "scan_wait_p50_ms.serve", "batch_fill.serve",
                 "extract_host_ms.serve", "dispatch_host_ms.serve", "rank_ms.serve",
                 "graphed_share.serve", "idle_held_share.serve"):
        assert name in m, name
    # The device-trace readers, on a trace with device work.
    run.trace = synthetic_trace(run)
    run.records["answered_in_window"] = 5
    assert read("kernels_per_query.serve", run) == pytest.approx(10 / 5)
    assert 0 < read("idle_share.serve", run) < 1


def test_an_altered_answer_fails_live():
    with pytest.MonkeyPatch.context() as mp:
        alter_offsets(mp)
        out = harness.execute(tiny(LIVE))
    assert out["correct"] is False and out["checks"]["score_gap"]["value"] > 0


def test_live_queries_read_only_the_planted_rows():
    from portbench.traffic import live_resident

    run = tiny(LIVE)
    cat = batch_resident.build(run)
    view = live_resident.PlantedRows(cat["prints"], cat["rows"])
    rows = cat["rows"][::-1].copy()
    np.testing.assert_array_equal(view[rows], cat["prints"][rows].numpy().view(np.uint32))
    other = np.setdiff1d(np.arange(CATALOG["n_tracks"]), cat["rows"])[:1]
    with pytest.raises(KeyError):
        view[other]


def test_monitor_set_up_and_stream_readers_read_the_run(monitor_run):
    run, out = monitor_run
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["host_copy_gb.setup"] == 0.0 and m["index_build_s.setup"] > 0
    shares = [m[k] for k in ("extract_share.streams", "match_share.streams",
                             "vote_share.streams")]
    assert all(0 < s < 1 for s in shares) and sum(shares) < 1
    # On the CPU the trace has no kernels: the device readers are silent.
    assert "extract_launches_per_query.streams" not in m
    assert "k4_pass1_roofline.streams" not in m


def span(name, t0, t1, sid, **attrs):
    return Span(name, int(t0 * 1e9), int(t1 * 1e9), 1, sid, None, attrs)


def synthetic_trace(run, answered=None):
    """A trace of the run's window holding two K1 launches, two K2 launches
    (split and encoder kernels each) and four pass-1 launches of 1 ms."""
    lo = 1e6
    names = ["cqt_kernel<1>", "cqt_kernel<1>", "split_kernel", "encoder_kernel",
             "split_kernel", "encoder_kernel", "coarse_kernel<4, true>"]
    events = [{"name": tracing.WINDOW, "ph": "X", "cat": "user_annotation", "ts": lo,
               "dur": 1e6}]
    events += [{"name": n, "ph": "X", "cat": "kernel", "ts": lo + 1e4 * i, "dur": 1e3}
               for i, n in enumerate(names[:-1])]
    events += [{"name": names[-1], "ph": "X", "cat": "kernel", "ts": lo + 2e5 + 1e4 * i,
                "dur": 1e3} for i in range(4)]
    return tracing.Trace.from_events(events)


@pytest.fixture
def bare_run():
    run = harness.Run(MONITOR, SEED, 1.0, True, torch.device("cpu"), 0.0, TINY[MONITOR])
    run.t_window, run.records = 10.0, {"window_s": 2.0, "answered_in_window": 8}
    return run


def test_stream_readers_none_without_spans_or_trace(bare_run, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    for name in STREAM_METRICS:
        assert read(name, bare_run) is None, name
    ring = [span("match.dispatch", 10.5, 10.6, 1, graphed=False)]
    monkeypatch.setattr(profiling, "spans", lambda: ring)
    for name in STREAM_METRICS[:3]:
        assert read(name, bare_run) is None, name
    bare_run.trace = tracing.Trace.from_events([{"name": tracing.WINDOW, "ph": "X",
                                                 "cat": "user_annotation", "ts": 0.0,
                                                 "dur": 1e6}])
    for name in STREAM_METRICS[3:]:
        assert read(name, bare_run) is None, name


def test_stream_readers_sum_a_synthetic_ring_and_trace(bare_run, monkeypatch):
    ring = [span("stream.feed", 9.0, 9.5, 1, streams=4, ready=4),     # before the window
            span("stream.extract", 9.1, 9.2, 2, rows=4),
            span("stream.feed", 10.0, 11.0, 3, streams=4, ready=4),
            span("stream.extract", 10.0, 10.2, 4, rows=4),
            span("stream.match", 10.2, 10.8, 5, bucket=128, rows=4, padded=4),
            span("stream.vote", 10.8, 10.85, 6, streams=4),
            span("stream.feed", 11.0, 12.5, 7, streams=4, ready=4),
            span("stream.extract", 11.0, 11.3, 8, rows=4),
            span("stream.match", 11.3, 12.4, 9, bucket=128, rows=4, padded=4),  # clipped
            span("stream.vote", 12.4, 12.45, 10, streams=4)]                  # outside
    monkeypatch.setattr(profiling, "spans", lambda: ring)
    assert read("extract_share.streams", bare_run) == pytest.approx(0.5 / 2.0)
    assert read("match_share.streams", bare_run) == pytest.approx((0.6 + 0.7) / 2.0)
    assert read("vote_share.streams", bare_run) == pytest.approx(0.05 / 2.0)
    bare_run.trace = synthetic_trace(bare_run)
    assert read("extract_launches_per_query.streams", bare_run) == pytest.approx(4 / 8)
    c, w = bare_run.config, bare_run.workload
    bound = k4_pass1.bound(k4_pass1.shape(c["hpfw"], w["query_prints"], POOL["capacity"],
                                          c["n_tracks"], c["prints_per_track"]))
    assert read("k4_pass1_roofline.streams", bare_run) == pytest.approx(
        100.0 * 4 * bound / 4e-3)
