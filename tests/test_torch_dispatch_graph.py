"""TwoStageDB.dispatch_batch's CUDA-graph path (match/graphs.py) on the CPU.

No card here, so a "card" is a CPU DB whose device reads cuda, with the
module's three CUDA touch points (current_stream, new_pool, capture)
replaced and its registry of pools emptied: the fake graph reruns the
captured function on its static input at each replay, into its static
output, so the replay's data flow (copy in, replay, copy out) runs for
real. The card's own graphs are held to the eager dispatch in
tests/test_torch_cuda.py.
"""

import gc
import itertools
import sys
import threading
import types

import numpy as np
import pytest
import torch

from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.match import graphs
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.ops import _build
from hpfw_tpu_torch.parallel.mesh import Mesh
from hpfw_tpu_torch.utils import profiling

T, L, N = 24, 160, 64


@pytest.fixture(scope="module")
def catalog():
    """A catalog_scale() DB of random prints (one device and a 2-shard
    mesh, both on the CPU) and 4 excerpts of its tracks."""
    cfg = HpfwConfig.catalog_scale(db_downsample=8, coarse_prefilter=16)
    rng = np.random.default_rng(17)
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(T)], prints, np.full(T, L, np.int32),
                           device="cpu")
    qs = np.stack([prints[i, o:o + N] for i, o in ((3, 5), (9, 40), (17, 77), (20, 0))])
    return db, torch.from_numpy(qs.view(np.int32))


class FakeGraph:
    """A captured function rerun at each replay on the static input."""

    def __init__(self, fn, static_in):
        self.fn, self.static_in = fn, static_in
        self.out = fn(static_in)

    def replay(self):
        self.out.copy_(self.fn(self.static_in))


class FakeCard:
    """The CUDA touch points of match/graphs.py, on the CPU: the current
    stream is this thread's entry of `streams` (default 1), each new pool
    has a handle of its own, and capture counts its calls, checks that it
    holds its pool's lock, and raises when `fail` is set."""

    def __init__(self, monkeypatch):
        self.captures, self.fail = 0, False
        self.streams: dict = {}
        handles = itertools.count()
        monkeypatch.setattr(graphs, "_POOLS", {})
        monkeypatch.setattr(graphs, "current_stream", self.current_stream)
        monkeypatch.setattr(graphs, "new_pool", lambda device: (next(handles), "side stream"))
        monkeypatch.setattr(graphs, "capture", self.capture)

    def current_stream(self, device):
        return types.SimpleNamespace(cuda_stream=self.streams.get(threading.get_ident(), 1))

    def capture(self, fn, queries, device, pool):
        assert pool.side == "side stream" and pool.lock.locked()
        self.captures += 1
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        static_in = torch.empty_strided(queries.shape, queries.stride(), dtype=queries.dtype)
        with _build.captured_launches() as launches:
            g = FakeGraph(fn, static_in)
        return graphs.Graph(g, static_in, g.out, launches, pool.lock)


def on_card(db, monkeypatch, **kw):
    """A TwoStageDB over db whose device reads cuda, and its FakeCard."""
    card = FakeCard(monkeypatch)
    ts = TwoStageDB(db, **kw)
    ts.device = torch.device("cuda", 0)
    return ts, card


def dispatch_spans(first: int) -> list:
    return [s.attrs["graphed"] for s in profiling.spans()
            if s.name == "match.dispatch" and s.sid > first]


def test_cpu_db_never_builds_a_graph(catalog, monkeypatch):
    db, qs = catalog
    card = FakeCard(monkeypatch)
    ts = TwoStageDB(db)
    first = profiling.new_id()
    outs = [ts.dispatch_batch(qs, pool=8) for _ in range(3)]
    assert dispatch_spans(first) == [False] * 3
    assert card.captures == 0 and len(ts._graphs) == 0 and not ts._graphs._seen
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_mesh_db_stays_eager(catalog, monkeypatch):
    db, qs = catalog
    ts, card = on_card(db, monkeypatch, mesh=Mesh(["cpu"] * 2))
    want = TwoStageDB(db, mesh=Mesh(["cpu"] * 2)).dispatch_batch(qs, pool=8)
    first = profiling.new_id()
    for _ in range(3):
        assert torch.equal(ts.dispatch_batch(qs, pool=8), want)
    assert dispatch_spans(first) == [False] * 3
    assert card.captures == 0 and len(ts._graphs) == 0


def test_second_sighting_captures_then_replays(catalog, monkeypatch):
    db, qs = catalog
    want = TwoStageDB(db).dispatch_batch(qs, pool=8)
    ts, card = on_card(db, monkeypatch)
    first = profiling.new_id()
    for _ in range(4):
        assert torch.equal(ts.dispatch_batch(qs, pool=8), want)
    assert dispatch_spans(first) == [False, True, True, True]
    assert card.captures == 1 and len(ts._graphs) == 1
    # Another knob, another stream, another batch size: each a key of its own.
    card.streams[threading.get_ident()] = 2
    ts.dispatch_batch(qs, pool=8)
    ts.dispatch_batch(qs, pool=8)
    card.streams.clear()
    ts.dispatch_batch(qs, pool=16)
    ts.dispatch_batch(qs, pool=16)
    assert torch.equal(ts.dispatch_batch(qs[:2], pool=8), want[:2])
    assert card.captures == 3 and len(ts._graphs) == 3
    assert torch.equal(ts.dispatch_batch(qs[:2], pool=8), want[:2])
    assert card.captures == 4 and len(ts._graphs) == 4


def test_graph_cap_holds(catalog, monkeypatch):
    """Past CAP keys with a graph, new keys run eager and are not kept."""
    db, qs = catalog
    ts, card = on_card(db, monkeypatch)
    monkeypatch.setattr(graphs, "CAP", 3)
    for pool in (8, 16, 24, 32):
        for _ in range(3):
            ts.dispatch_batch(qs[:1], pool=pool)
    assert card.captures == 3 and len(ts._graphs) == 3
    first = profiling.new_id()
    ts.dispatch_batch(qs[:1], pool=32)
    ts.dispatch_batch(qs[:1], pool=8)
    assert dispatch_spans(first) == [False, True]
    assert not ts._graphs._seen


def test_results_held_across_replays(catalog, monkeypatch):
    """Each replay returns its own copy: two results held across a third
    replay of the same key keep their values."""
    db, qs = catalog
    eager = TwoStageDB(db)
    ts, _ = on_card(db, monkeypatch)
    batches = [qs[[0, 1]], qs[[2, 3]], qs[[1, 2]], qs[[3, 0]]]
    ts.dispatch_batch(batches[0], pool=8)                      # eager
    held = [ts.dispatch_batch(b, pool=8) for b in batches[1:3]]
    third = ts.dispatch_batch(batches[3], pool=8)
    for got, b in zip(held + [third], batches[1:]):
        assert torch.equal(got, eager.dispatch_batch(b, pool=8))
    assert not torch.equal(held[0], held[1])


def test_set_shards_empties_the_cache(catalog, monkeypatch):
    db, qs = catalog
    ts, card = on_card(db, monkeypatch)
    for _ in range(3):
        ts.dispatch_batch(qs, pool=8)
    assert len(ts._graphs) == 1
    ts._set_shards(ts.shards)
    assert len(ts._graphs) == 0 and not ts._graphs._seen
    first = profiling.new_id()
    ts.dispatch_batch(qs, pool=8)
    ts.dispatch_batch(qs, pool=8)
    assert dispatch_spans(first) == [False, True] and card.captures == 2


def test_failed_capture_leaves_the_key_eager(catalog, monkeypatch):
    db, qs = catalog
    want = TwoStageDB(db).dispatch_batch(qs, pool=8)
    ts, card = on_card(db, monkeypatch)
    card.fail = True
    first = profiling.new_id()
    ts.dispatch_batch(qs, pool=8)
    with pytest.warns(RuntimeWarning, match="capture failed"):
        assert torch.equal(ts.dispatch_batch(qs, pool=8), want)
    card.fail = False
    for _ in range(3):
        assert torch.equal(ts.dispatch_batch(qs, pool=8), want)
    assert dispatch_spans(first) == [False] * 5
    assert card.captures == 1 and len(ts._graphs) == 0


def test_replayed_launches_count_as_eager():
    """A graph's captured launches are added to LAUNCHES at each replay."""
    counts = {"coarse_rescan": 2, "fine_rescan": 1}
    g = graphs.Graph(types.SimpleNamespace(replay=lambda: None), torch.zeros(3),
                     torch.arange(3), counts, threading.Lock())
    before = dict(_build.LAUNCHES)
    for _ in range(3):
        assert torch.equal(g.replay(torch.ones(3)), torch.arange(3))
    assert _build.LAUNCHES["coarse_rescan"] - before["coarse_rescan"] == 6
    assert _build.LAUNCHES["fine_rescan"] - before["fine_rescan"] == 3
    with _build.captured_launches() as inside:
        assert _build._CAPTURING.counts is inside
    assert _build._CAPTURING.counts is None


def test_threads_share_the_cache(catalog, monkeypatch):
    """More threads than cores on two streams, with a short switch
    interval: every answer equals the eager one, and each (stream, batch)
    key is captured once."""
    db, qs = catalog
    eager = TwoStageDB(db)
    want = {b: eager.dispatch_batch(qs[:b], pool=8) for b in (1, 2)}
    ts, card = on_card(db, monkeypatch)
    bad, n_threads, calls = [], 10, 3
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work(k):
        card.streams[threading.get_ident()] = 1 + k % 2
        for j in range(calls):
            b = 1 + (k + j) % 2
            if not torch.equal(ts.dispatch_batch(qs[:b], pool=8), want[b]):
                bad.append((k, j))

    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    # A key whose every second sighting met its stream's pool capturing
    # another key ran eager throughout: one more call of each captures it.
    for stream, b in itertools.product((1, 2), (1, 2)):
        card.streams[threading.get_ident()] = stream
        assert torch.equal(ts.dispatch_batch(qs[:b], pool=8), want[b])
    assert card.captures == len(ts._graphs) == 4


def test_capture_in_progress_leaves_other_keys_eager(catalog, monkeypatch):
    """While one key of a stream captures, another key of that stream due
    to capture runs eager rather than capture on the busy capture stream,
    and captures at its next call."""
    db, qs = catalog
    want = TwoStageDB(db).dispatch_batch(qs[:2], pool=8)
    ts, card = on_card(db, monkeypatch)
    for b in (1, 2):
        ts.dispatch_batch(qs[:b], pool=8)                     # first sightings
    entered, release = threading.Event(), threading.Event()

    def slow(*args):
        entered.set()
        assert release.wait(60)
        return card.capture(*args)

    monkeypatch.setattr(graphs, "capture", slow)
    t = threading.Thread(target=ts.dispatch_batch, args=(qs[:1],), kwargs=dict(pool=8))
    t.start()
    try:
        assert entered.wait(60)
        first = profiling.new_id()
        assert torch.equal(ts.dispatch_batch(qs[:2], pool=8), want)
    finally:
        release.set()
        t.join(timeout=60)
    assert torch.equal(ts.dispatch_batch(qs[:2], pool=8), want)
    assert dispatch_spans(first) == [False, True]
    assert card.captures == len(ts._graphs) == 2


def test_drop_forgets_a_streams_graphs(catalog, monkeypatch):
    """A closing server's streams lose their graphs and sightings, and start
    again from a first sighting; another stream's graph stays."""
    db, qs = catalog
    ts, card = on_card(db, monkeypatch)
    for stream in (1, 2):
        card.streams[threading.get_ident()] = stream
        for _ in range(3):
            ts.dispatch_batch(qs, pool=8)
    ts.dispatch_batch(qs[:1], pool=8)                       # a sighting on stream 2
    assert len(ts._graphs) == 2 and len(ts._graphs._seen) == 1
    ts._drop_graphs([types.SimpleNamespace(cuda_stream=2), None])
    assert len(ts._graphs) == 1 and not ts._graphs._seen
    first = profiling.new_id()
    for _ in range(2):
        ts.dispatch_batch(qs, pool=8)
    card.streams.clear()
    ts.dispatch_batch(qs, pool=8)
    assert dispatch_spans(first) == [False, True, True]
    assert card.captures == 3 and len(ts._graphs) == 2


def test_a_streams_pool_is_shared_then_renewed(catalog, monkeypatch):
    """Two DBs' graphs on one stream share its pool (and its lock); once
    every graph of the pool has gone, the stream's next capture takes a
    fresh pool, never the freed one."""
    db, qs = catalog
    ts, card = on_card(db, monkeypatch)
    other = TwoStageDB(db)
    other.device = ts.device
    for which in (ts, other):
        for _ in range(2):
            which.dispatch_batch(qs, pool=8)
    (key, pool), = graphs._POOLS.items()
    held = [g for w in (ts, other) for g in w._graphs._graphs.values()]
    assert all(g.lock is pool.lock for g in held) and len(pool.graphs) == 2
    del held
    ts._set_shards(ts.shards)
    assert graphs.pool_of(*key)[0] is pool                   # other's graph holds it
    other._set_shards(other.shards)
    gc.collect()
    assert not pool.graphs
    for _ in range(2):
        ts.dispatch_batch(qs, pool=8)
    assert graphs._POOLS[key] is not pool and card.captures == 3
