"""catalog1m.batch16 at a tiny size on the CPU: the batch_resident kind's
inputs are catalog.build's and batch.queries's bit for bit, a whole run is
correct, an altered answer and the reversed-tie control fail it, and the two
set-up metrics read the program's spans (None where there are none)."""

import time

import numpy as np
import pytest
import torch

from hpfw_tpu_torch.utils import profiling
from hpfw_tpu_torch.utils.profiling import Span
from portbench import catalog, control, harness
from portbench.traffic import batch, batch_resident

CELL = "catalog1m.batch16"
# The sizes of portbench_tiny's catalog and batch16 cell, for this cell too.
TINY = dict(n_tracks=48, planted_tracks=4, track_seconds=12, prints_per_track=516,
            query_batches=2, batch_size=4, check_batches=2)
SEED = 2 ** 31 + 17


def tiny(cell=CELL, seed=SEED, seconds=1.0, traced=False, **extra):
    return harness.Run(cell, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                       dict(TINY, **extra))


def read(name, run):
    return harness.load_module("metrics", name + ".py").read(run)


def test_inputs_are_the_host_catalogs():
    mine, theirs = tiny(), tiny("catalog100k.batch16")
    c1, c2 = batch_resident.build(mine), catalog.build(theirs)
    assert c1["prints"].dtype == torch.int32 and c1["prints"].device.type == "cpu"
    assert np.array_equal(c1["prints"].numpy().view(np.uint32), c2["prints"])
    assert np.array_equal(c1["lengths"].numpy(), c2["lengths"])
    assert np.array_equal(c1["rows"], c2["rows"])
    assert torch.equal(c1["filters"], c2["filters"])
    assert np.array_equal(batch_resident.queries(mine, c1), batch.queries(theirs, c2))
    assert not np.array_equal(batch_resident.build(tiny(seed=SEED + 1))["prints"].numpy(),
                              c1["prints"].numpy())


def test_tiny_run_is_correct_and_resident():
    """A whole run is correct; the system's DB holds the catalog's own tensor
    and no host copy; its traced set-up reads index.derive time and no copy."""
    from hpfw_tpu_torch.match.scaled import TwoStageDB

    held = []
    orig = TwoStageDB.__init__

    def init(self, db, **kw):
        orig(self, db, **kw)
        held.append(db)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TwoStageDB, "__init__", init)
        run = tiny(traced=True)
        out = harness.execute(run)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["mismatches"]["value"] == 0 and out["attempted"] > 0
    (db,) = held
    assert db.host_bytes == 0
    assert db.device_arrays()[0].data_ptr() == run.state["catalog"]["prints"].data_ptr()
    assert out["metrics"]["host_copy_gb.setup"]["value"] == 0.0
    assert out["metrics"]["index_build_s.setup"]["value"] > 0
    assert out["metrics"]["graphed_share.batch"]["value"] == 0.0     # no graphs on a CPU


def test_host_catalog_reads_its_upload():
    """catalog100k.batch16 uploads the host prints once in set-up."""
    run = tiny("catalog100k.batch16", traced=True)
    out = harness.execute(run)
    assert out["correct"] is True
    want = TINY["n_tracks"] * TINY["prints_per_track"] * 8 / 1e9
    assert out["metrics"]["host_copy_gb.setup"]["value"] == pytest.approx(want)


def test_an_altered_answer_is_not_correct(monkeypatch):
    from hpfw_tpu_torch.match.scaled import TwoStageDB

    orig = TwoStageDB.dispatch_batch

    def dispatch(self, queries, **kw):
        out = orig(self, queries, **kw).clone()
        out[:, 2] += 3
        return out
    monkeypatch.setattr(TwoStageDB, "dispatch_batch", dispatch)
    out = harness.execute(tiny())
    assert out["correct"] is False and out["checks"]["mismatches"]["value"] > 0


def test_tie_control_fails_the_cell():
    hp = dict(harness.load_json("configs", "catalog1m.json")["hpfw"],
              coarse_prefilter=16, fine_candidates=8)
    limit = harness.load_json("workloads", CELL + ".json")["limits"]["mismatches"]
    for seed in (1, 2, 3):
        got = control.readings(CELL, seed, torch.device("cpu"),
                               dict(TINY, hpfw=hp, batch_size=8))
        assert got["mismatches"] > limit, got


def span(name, t0, t1, sid, **attrs):
    """A span from t0 to t1 s on the ring's clock."""
    return Span(name, int(t0 * 1e9), int(t1 * 1e9), 1, sid, None, attrs)


@pytest.fixture
def setup_run():
    """A run whose process started at 1 s and whose window starts at 10 s."""
    run = harness.Run.__new__(harness.Run)
    run.t_process, run.t_window, run.records = 1.0, 10.0, {}
    return run


def test_setup_metrics_sum_the_setup_spans(setup_run, monkeypatch):
    ring = [span("index.derive", 0.5, 0.9, 1, rows=8, bytes=10),        # before the process
            span("db.upload", 2.0, 2.5, 2, bytes=2_000_000_000),
            span("index.derive", 3.0, 5.5, 3, rows=8, bytes=10),
            span("index.derive", 6.0, 6.25, 4, rows=8, bytes=10),
            span("db.host_copy", 7.0, 7.5, 5, bytes=500_000_000),
            span("match.dispatch", 8.0, 8.1, 6, graphed=False),
            span("db.upload", 11.0, 12.0, 7, bytes=9_000_000_000)]       # in the window
    monkeypatch.setattr(profiling, "spans", lambda: ring)
    assert read("index_build_s.setup", setup_run) == pytest.approx(2.75)
    assert read("host_copy_gb.setup", setup_run) == pytest.approx(2.5)
    no_copy = [s for s in ring if not s.name.startswith("db.")]
    monkeypatch.setattr(profiling, "spans", lambda: no_copy)
    assert read("host_copy_gb.setup", setup_run) == 0.0


@pytest.mark.parametrize("case", ["no_ring", "no_derive", "lost", "no_window"])
def test_setup_metrics_none_without_spans(setup_run, monkeypatch, case):
    ring = [span("db.upload", 2.0, 2.5, 1, bytes=10), span("index.derive", 3.0, 4.0, 2)]
    if case == "no_ring":
        ring = []
    elif case == "no_derive":
        ring = ring[:1] + [span("index.derive", 11.0, 12.0, 2)]          # not in set-up
    elif case == "lost":
        monkeypatch.setattr(profiling, "CAPACITY", 2)                  # full, oldest too new
    else:
        setup_run.t_window = None
    monkeypatch.setattr(profiling, "spans", lambda: ring)
    for name in ("index_build_s.setup", "host_copy_gb.setup"):
        assert read(name, setup_run) is None
