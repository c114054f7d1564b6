"""The port's match servers on the CPU over the port's TwoStageDB.

MatchServer's answers are held against hpfw_tpu's TwoStageDB.match (Pallas
path in interpret mode): the three cases of tests/test_serve.py, the batch
buckets, warmup, and a concurrent-submit stress test. EscalatingMatchServer
is held against hpfw_tpu's EscalatingMatchServer on the same PCM (results,
escalation flags, stats) and against the port's match_scan_escalating, with
its buckets, refusals, load shedding and spans."""

import copy
import dataclasses
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from hpfw_tpu import api as jax_api
from hpfw_tpu import oracle
from hpfw_tpu import serve as jax_serve
from hpfw_tpu.io import synth, synth_jax
from hpfw_tpu.match import scaled as jax_scaled
from hpfw_tpu.parallel import mesh as jax_meshlib
from hpfw_tpu_torch import EscalatingMatchServer, MatchServer, ServerSaturated, api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.ops import fine
from hpfw_tpu_torch.parallel.mesh import Mesh
from hpfw_tpu_torch.utils import profiling
from tests.test_tpu_pipeline import assert_bits_match_with_margin_audit


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


@pytest.fixture(scope="module")
def served(cfg):
    """tests/test_serve.py's 16 x 4 s catalog: the reference TwoStageDB and
    the port's over the same prints, and six noisy 2 s queries."""
    tracks = synth.synth_catalog(16, 4.0, cfg)
    filters = _filters(cfg)
    jdb = jax_api.build_db(tracks, filters, cfg)
    ref = jax_scaled.TwoStageDB(jdb, stride=4, use_pallas_fine=True, coarse_tile=8,
                                pallas_interpret=True)
    pdb = api.FingerprintDB(HpfwConfig.from_json(cfg.to_json()), filters, jdb.track_ids,
                            jdb.prints, jdb.lengths, device="cpu")
    queries = [jax_api.fingerprint(synth.make_query(tracks[seed + 4], 0.5, 2.0, cfg,
                                                    noise_db=-15.0, seed=seed),
                                   filters, cfg) for seed in range(6)]
    n_q = min(q.shape[0] for q in queries)
    return ref, TwoStageDB(pdb, stride=4), [q[:n_q] for q in queries]


def _same(a, b):
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_server_results_equal_direct_match(served):
    ref, ts, queries = served
    with MatchServer(ts, queries[0].shape[0], max_batch=4, max_wait_ms=30.0,
                     pool=16) as srv:
        futs = [srv.submit(q) for q in queries]
        got = [f.result(timeout=120) for f in futs]
    for k, (q, res) in enumerate(zip(queries, got)):
        _same(res, ref.match(q, pool=16))
        _same(res, ts.match(q, pool=16))
        assert res[0][0] == str(k + 4)


def test_server_rejects_wrong_length_and_closes(served):
    _, ts, _ = served
    srv = MatchServer(ts, 40, max_batch=2, max_wait_ms=1.0, pool=16)
    bad = srv.submit(np.zeros((7, 2), np.uint32))
    with pytest.raises(ValueError):
        bad.result(timeout=10)
    srv.close()
    assert not srv._thread.is_alive()
    late = srv.submit(np.zeros((40, 2), np.uint32))
    with pytest.raises(RuntimeError):
        late.result(timeout=10)


def test_server_bounded_queue_sheds_load(served):
    """A full submit queue rejects with ServerSaturated; accepted queries
    still resolve to the reference's answer."""
    ref, ts, queries = served
    q = queries[1]
    with MatchServer(ts, q.shape[0], max_batch=1, max_wait_ms=0.1, depth=1,
                     max_queue=2, pool=16) as srv:
        futs = [srv.submit(q) for _ in range(40)]
        done = [f.result(timeout=300) if not f.exception(timeout=300) else None
                for f in futs]
    assert any(d is None for d in done), "a 2-deep queue must shed some of 40 submits"
    accepted = [d for d in done if d is not None]
    assert accepted, "some submissions must still be served"
    for f, d in zip(futs, done):
        if d is None:
            assert isinstance(f.exception(), ServerSaturated)
    want = ref.match(q, pool=16)
    for d in accepted:
        _same(d, want)


@pytest.mark.parametrize("max_batch", [1, 4, 16, 20])
def test_bucket_equals_reference(served, max_batch):
    _, ts, queries = served
    with MatchServer(ts, queries[0].shape[0], max_batch=max_batch) as srv:
        for n in range(1, 21):
            assert srv._bucket(n) == jax_serve.MatchServer._bucket(
                SimpleNamespace(max_batch=max_batch), n)


def test_warmup_runs_every_bucket(served, monkeypatch):
    _, ts, queries = served
    sizes = []
    dispatch = ts.dispatch_batch

    def spy(q, **kw):
        sizes.append(q.shape[0])
        return dispatch(q, **kw)

    monkeypatch.setattr(ts, "dispatch_batch", spy)
    with MatchServer(ts, queries[0].shape[0], max_batch=20, pool=16) as srv:
        srv.warmup(queries[0])
    assert sizes == [1, 4, 16, 20]


def test_concurrent_submitters_lose_no_future(served):
    """More submitting threads than cores, with a short switch interval:
    every future resolves, to the right answer or to ServerSaturated."""
    _, ts, queries = served
    want = {k: ts.match(q, pool=16) for k, q in enumerate(queries)}
    results, lock = [], threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with MatchServer(ts, queries[0].shape[0], max_batch=4, max_wait_ms=2.0,
                         max_queue=8, pool=16) as srv:
            def client(seed):
                for i in range(6):
                    k = (seed + i) % len(queries)
                    fut = srv.submit(queries[k])
                    with lock:
                        results.append((k, fut))

            threads = [threading.Thread(target=client, args=(s,)) for s in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            outcomes = [(k, f.exception(timeout=300), f) for k, f in results]
    finally:
        sys.setswitchinterval(old)
    assert len(outcomes) == 16 * 6
    served_n = 0
    for k, exc, fut in outcomes:
        if exc is None:
            _same(fut.result(), want[k])
            served_n += 1
        else:
            assert isinstance(exc, ServerSaturated)
    assert served_n > 0


# ---- EscalatingMatchServer against hpfw_tpu's, on the same PCM ----

def test_server_on_mesh(served):
    """tests/test_serve.py:87: MatchServer over a TwoStageDB sharded over 8
    logical cpu shards answers as its match and as hpfw_tpu's DB on mesh8
    (coarse_tile=8), for queries submitted together and alone."""
    ref, ts, queries = served
    jts = jax_scaled.TwoStageDB(ref.db, stride=4, mesh=jax_meshlib.db_mesh(8),
                                use_pallas_fine=True, coarse_tile=8, pallas_interpret=True)
    pts = TwoStageDB(ts.db, stride=4, mesh=Mesh(["cpu"] * 8))
    with MatchServer(pts, queries[0].shape[0], max_batch=4, max_wait_ms=10.0,
                     pool=16) as srv:
        got = [f.result(timeout=120) for f in [srv.submit(q) for q in queries]]
        alone = srv.match(queries[2])
    for k, (q, res) in enumerate(zip(queries, got)):
        _same(res, jts.match(q, pool=16))
        _same(res, pts.match(q, pool=16))
        assert res[0][0] == str(k + 4)
    _same(alone, got[2])


@pytest.fixture(scope="module")
def escalating(cfg):
    """tests/test_serve.py's escalation setup: 12 synth_jax tracks of 6 s in
    one DB built by hpfw_tpu (stretch_span 0.03), both packages' TwoStageDBs
    over its prints, and 4 s live queries: tracks 3 and 5 in tempo, track 9
    3% fast. bits: the most bits by which the port's query prints (rigid or
    a scan variant) differ from the reference's, each rigid print's bits
    within the margin audit."""
    cfg2 = dataclasses.replace(cfg, stretch_span=0.03, pitch_span_bins=0)
    tracks = np.asarray(synth_jax.synth_batch(np.arange(12), 6.0, cfg2))
    filters = _filters(cfg2)
    jdb = jax_api.build_db(list(tracks), filters, cfg2)
    ref = jax_scaled.TwoStageDB(jdb, stride=4, use_pallas_fine=True, coarse_tile=8,
                                pallas_interpret=True)
    pdb = api.FingerprintDB(_port(cfg2), filters, jdb.track_ids, jdb.prints, jdb.lengths,
                            device="cpu")
    pcms = np.stack([np.asarray(synth_jax.live_query_batch(
        [t], [int(start * cfg2.sample_rate)], 6.0, 4.0, cfg2, stretch=s,
        noise_db=-25.0))[0] for t, start, s in [(3, 0.5, 1.0), (9, 0.5, 1.03),
                                                 (5, 0.8, 1.0)]])
    ours = api.fingerprint_batch(pcms, filters, _port(cfg2), device="cpu")
    theirs = jax_api.fingerprint_batch(pcms, filters, cfg2)
    for pcm, g, w in zip(pcms, ours, theirs):
        assert_bits_match_with_margin_audit(g, w, oracle.delta_margins(pcm, filters, cfg2)[
            :g.shape[0]])
    bits = max(_bits(ours, theirs), max(_bits(a, b) for a, b in zip(
        api.fingerprint_scan_batch(pcms, filters, _port(cfg2), device="cpu"),
        jax_api.fingerprint_scan_batch(pcms, filters, cfg2))))
    return cfg2, filters, ref, TwoStageDB(pdb, stride=4), pcms, bits


def _bits(a, b):
    return int(np.bitwise_count(np.bitwise_xor(a, b)).sum())


# Server kwargs of each case (tests/test_serve.py:255 and :357).
ESCALATING_CASES = {
    "defaults": dict(top_k=2),
    "structure_gate": dict(top_k=1, threshold=1.01, hi_sim=1.01, structure_gate=0.75,
                           override=10.0, override_unstructured=0.0),
}


def _serve(make, ts, filters, pcms, n_samples, kw):
    with make(ts, filters, n_samples, max_batch=4, max_wait_ms=20.0, pool=16, **kw) as srv:
        srv.warmup(pcms[0])
        futs = [srv.submit(p) for p in pcms]
        got = [f.result(timeout=600) for f in futs]
        return got, dict(srv.stats)


@pytest.mark.parametrize("case", list(ESCALATING_CASES))
def test_escalating_server_equals_reference(escalating, case):
    """Results, escalation flags and stats equal hpfw_tpu's server on the same
    PCM (scores within the differing query bits, explained by the margin
    audit), and equal the port's match_scan_escalating bit for bit."""
    cfg2, filters, ref, ts, pcms, bits = escalating
    kw = ESCALATING_CASES[case]
    n_samples = pcms.shape[1]
    got, stats = _serve(EscalatingMatchServer, ts, filters, pcms, n_samples, kw)
    want, want_stats = _serve(jax_serve.EscalatingMatchServer, ref, filters, pcms,
                              n_samples, kw)
    assert stats == want_stats
    assert stats["submitted"] == len(pcms)
    assert stats["confident"] + stats["structure_kept"] + stats["escalated"] == len(pcms)
    for (g_ids, g_s, g_o, g_e), (w_ids, w_s, w_o, w_e) in zip(got, want):
        assert (list(g_ids), g_e) == (list(w_ids), w_e)
        np.testing.assert_array_equal(g_o, w_o)
        assert np.abs(np.asarray(g_s, np.int64) - np.asarray(w_s, np.int64)).max() <= bits
    assert [r[0][0] for r in got] == ["3", "9", "5"]
    assert got[1][3] is True
    # The batch API on the same PCM: the same answers and the same rungs.
    api_kw = {k: v for k, v in kw.items() if k != "top_k"}
    st: dict = {}
    direct = api.match_scan_escalating(pcms, filters, ts, _port(cfg2), top_k=kw["top_k"],
                                       pool=16, stats=st, **api_kw)
    for (g_ids, g_s, g_o, g_e), (d_ids, d_s, d_o) in zip(got, direct):
        assert list(g_ids) == list(d_ids)
        np.testing.assert_array_equal(g_s, d_s)
        np.testing.assert_array_equal(g_o, d_o)
    assert [i for i, r in enumerate(got) if r[3]] == st["escalated"]
    assert stats["structure_kept"] == len(st["structure_kept"])
    assert stats["overridden"] == len(st["overridden"])
    if case == "structure_gate":
        assert (stats["structure_kept"], stats["confident"]) == (2, 0)


def test_escalating_server_batches_equal_reference(escalating):
    """The power-of-4 buckets of both classes and the scan batch equal the
    reference's; warmup runs every bucket of each class once."""
    cfg2, filters, _, ts, pcms, _ = escalating
    sizes = []
    dispatch = ts.dispatch_batch

    def spy(q, **kw):
        sizes.append(q.shape[0])
        return dispatch(q, **kw)

    ts.dispatch_batch = spy
    try:
        with EscalatingMatchServer(ts, filters, pcms.shape[1], max_batch=5,
                                   scan_batch=6, pool=16) as srv:
            srv.warmup(pcms[0])
            v = len(srv.hyps)
    finally:
        del ts.dispatch_batch
    assert v == len(jax_api.scan_hypotheses(cfg2)) == 7
    assert sizes == [1, 4, 5, v, 4 * v, 6 * v]
    with EscalatingMatchServer(ts, filters, pcms.shape[1], pool=16) as srv:
        assert srv.scan_batch == 70 // v == 10
        assert srv.scan_wait == 2 * srv.max_wait


def test_escalating_server_splits_scan_dispatch(escalating, monkeypatch):
    """A scan batch whose V rows a query overrun K5's queries a launch goes
    through dispatch_batch in pieces of whole queries, with the same
    answers as one dispatch."""
    cfg2, filters, _, ts, pcms, _ = escalating
    kw = dict(max_batch=4, max_wait_ms=20.0, pool=16, top_k=2, threshold=1.01, hi_sim=1.01,
              scan_batch=3, scan_wait_ms=200.0)

    def serve():
        with EscalatingMatchServer(ts, filters, pcms.shape[1], **kw) as srv:
            return [f.result(timeout=600) for f in [srv.submit(p) for p in pcms]]

    whole = serve()
    sizes = []
    dispatch = ts.dispatch_batch

    def spy(q, **k):
        sizes.append(q.shape[0])
        return dispatch(q, **k)

    monkeypatch.setattr(fine, "MAX_QUERIES", 15)      # two queries of V = 7 a piece
    monkeypatch.setattr(ts, "dispatch_batch", spy)
    split = serve()
    assert [r[3] for r in whole] == [r[3] for r in split] == [True] * 3
    assert 14 in sizes and 7 in sizes and max(sizes) <= 15
    for a, b in zip(whole, split):
        assert list(a[0]) == list(b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def test_escalating_server_refusals(escalating):
    """A wrong length, a submit after close, and a structure gate without
    host print rows are refused as the reference refuses them."""
    cfg2, filters, ref, ts, pcms, _ = escalating
    n_samples = pcms.shape[1]
    for make, db in [(EscalatingMatchServer, ts), (jax_serve.EscalatingMatchServer, ref)]:
        srv = make(db, filters, n_samples, max_batch=2, max_wait_ms=1.0, pool=8)
        bad = srv.submit(np.zeros(100, np.float32))
        with pytest.raises(ValueError, match="pinned"):
            bad.result(timeout=10)
        srv.close()
        assert not srv._rigid_thread.is_alive() and not srv._scan_thread.is_alive()
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(np.zeros(n_samples, np.float32)).result(timeout=10)
        no_prints = copy.copy(db)
        no_prints.db = copy.copy(db.db)
        no_prints.db.prints = None
        with pytest.raises(ValueError, match="host print rows"):
            make(no_prints, filters, n_samples, structure_gate=0.75)
    with pytest.raises(ValueError, match="no hashprints"):
        EscalatingMatchServer(ts, filters, 100)


def test_escalating_server_sheds_load(escalating):
    """A full submit queue resolves with ServerSaturated and counts as shed;
    every accepted query still gets the answer a lone query gets."""
    cfg2, filters, _, ts, pcms, _ = escalating
    with EscalatingMatchServer(ts, filters, pcms.shape[1], max_batch=1, max_wait_ms=0.1,
                               depth=1, max_queue=2, pool=16, top_k=2) as srv:
        want = srv.match(pcms[1])
        futs = [srv.submit(pcms[1]) for _ in range(30)]
        outcomes = [(f.exception(timeout=600), f) for f in futs]
        stats = dict(srv.stats)
    shed = [f for exc, f in outcomes if exc is not None]
    assert shed and all(isinstance(f.exception(), ServerSaturated) for f in shed)
    assert stats["shed"] == len(shed) and stats["submitted"] == 31 - len(shed)
    served_n = 0
    for exc, f in outcomes:
        if exc is None:
            ids, sc, off, esc = f.result()
            assert (list(ids), esc) == (list(want[0]), want[3])
            np.testing.assert_array_equal(sc, want[1])
            np.testing.assert_array_equal(off, want[2])
            served_n += 1
    assert served_n > 0
    assert stats["confident"] + stats["structure_kept"] + stats["escalated"] == stats[
        "submitted"]


def test_escalating_server_on_mesh(escalating):
    """EscalatingMatchServer over the TwoStageDB sharded over 2 logical cpu
    shards: the answers, flags and rungs of match_scan_escalating over the
    same sharded DB. (No warmup: its 70-row scan bucket would dispatch to
    every shard for nothing.)"""
    cfg2, filters, _, ts, pcms, _ = escalating
    mts = TwoStageDB(ts.db, stride=4, mesh=Mesh(["cpu"] * 2))
    with EscalatingMatchServer(mts, filters, pcms.shape[1], max_batch=4, max_wait_ms=20.0,
                               scan_batch=3, pool=16, top_k=2) as srv:
        got = [f.result(timeout=600) for f in [srv.submit(p) for p in pcms]]
        stats = dict(srv.stats)
    st: dict = {}
    direct = api.match_scan_escalating(pcms, filters, mts, _port(cfg2), top_k=2, pool=16,
                                       stats=st)
    for (g_ids, g_s, g_o, _), want in zip(got, direct):
        _same((g_ids, g_s, g_o), want)
    assert [i for i, r in enumerate(got) if r[3]] == st["escalated"]
    assert stats["escalated"] == len(st["escalated"]) and stats["submitted"] == len(pcms)
    assert [r[0][0] for r in got] == ["3", "9", "5"]


def test_escalating_server_spans(escalating):
    """After warmup, each request makes one serve.submit, serve.admit and
    serve.request, each escalated one a serve.scan_admit; each batch one
    serve.extract, serve.dispatch and serve.rank of its class; a class's
    dispatches carry its queries as rows."""
    cfg2, filters, _, ts, pcms, _ = escalating
    with EscalatingMatchServer(ts, filters, pcms.shape[1], max_batch=4, max_wait_ms=20.0,
                               scan_batch=1, pool=16, top_k=2) as srv:
        srv.warmup(pcms[0])
        first = profiling.new_id()
        got = [f.result(timeout=600) for f in [srv.submit(p) for p in pcms]]
        stats = dict(srv.stats)
    spans: dict = {}
    for s in profiling.spans():
        if s.sid > first and s.name.startswith("serve."):
            spans.setdefault(s.name, []).append(s)
    n = len(got)
    submits = {s.sid: s for s in spans["serve.submit"]}
    requests = {s.attrs["req"]: s for s in spans["serve.request"]}
    admits = {s.attrs["req"]: s for s in spans["serve.admit"]}
    assert len(submits) == len(requests) == len(admits) == n == len(spans["serve.admit"])
    assert set(requests) == set(admits) == set(submits)
    for req, r in requests.items():
        a = admits[req]
        assert submits[req].t0 == r.t0 == a.t0 <= a.t1 <= r.t1
    escalated = {req for req, r in requests.items() if r.attrs["escalated"]}
    assert len(escalated) == sum(r[3] for r in got) == stats["escalated"] > 0
    scan_admits = spans["serve.scan_admit"]
    assert len(scan_admits) == stats["escalated"]
    assert {s.attrs["req"] for s in scan_admits} == escalated
    assert all(admits[s.attrs["req"]].t1 <= s.t0 <= s.t1 <= requests[s.attrs["req"]].t1
               for s in scan_admits)
    dispatch = {s.sid: s for s in spans["serve.dispatch"]}
    for cls, queries, waits in [("rigid", n, spans["serve.admit"]),
                                ("scan", stats["escalated"], scan_admits)]:
        mine = {sid: d for sid, d in dispatch.items() if d.attrs["cls"] == cls}
        assert sum(d.attrs["rows"] for d in mine.values()) == queries
        assert all(d.attrs["rows"] <= d.attrs["padded"] for d in mine.values())
        assert {w.parent for w in waits} == set(mine)
        for name in ("serve.extract", "serve.rank"):
            assert sorted(s.parent for s in spans[name] if s.attrs["cls"] == cls) == sorted(mine)


class _DeviceStepFailed(RuntimeError):
    pass


@pytest.mark.parametrize("case", ["match_server", "rigid", "scan"])
def test_failed_device_step_fails_its_batch_only(served, escalating, case, monkeypatch):
    """One batch's dispatch_batch raises (the rigid or the scan one of an
    escalating server, every query escalated): that batch's futures fail
    with that exception and its device slot frees (depth=1, so a lost slot
    would starve the next batch); the next submission is answered as the
    direct match, and close() returns."""
    if case == "match_server":
        _, ts, queries = served
        make = lambda: MatchServer(ts, queries[0].shape[0], max_batch=2, max_wait_ms=200.0,
                                   depth=1, pool=16)
        first, nxt = [queries[0], queries[1]], queries[2]
        want = ts.match(nxt, pool=16)
    else:
        cfg2, filters, _, ts, pcms, _ = escalating
        kw = dict(top_k=2, threshold=1.01, hi_sim=1.01)
        make = lambda: EscalatingMatchServer(ts, filters, pcms.shape[1], max_batch=2,
                                             max_wait_ms=200.0, scan_batch=2,
                                             scan_wait_ms=200.0, depth=1, pool=16, **kw)
        first, nxt = [pcms[0], pcms[2]], pcms[1]
        want = api.match_scan_escalating(nxt[None], filters, ts, _port(cfg2), pool=16,
                                         **kw)[0]
    boom, calls = _DeviceStepFailed("device step failed"), []
    dispatch = ts.dispatch_batch

    def flaky(q, **k):
        calls.append(q.shape[0])
        if len(calls) == (2 if case == "scan" else 1):
            raise boom
        return dispatch(q, **k)

    monkeypatch.setattr(ts, "dispatch_batch", flaky)
    srv = make()
    try:
        failed = [srv.submit(x) for x in first]
        assert all(f.exception(timeout=600) is boom for f in failed)
        got = srv.submit(nxt).result(timeout=120)
    finally:
        srv.close()
    threads = [srv._thread] if case == "match_server" else [srv._rigid_thread,
                                                            srv._scan_thread]
    assert not any(t.is_alive() for t in threads)
    _same(got, want)
    if case != "match_server":
        assert got[3] is True
        assert calls[:2] == ([2, 2 * len(srv.hyps)] if case == "scan" else [2, 1])
