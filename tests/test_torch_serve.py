"""The port's MatchServer on the CPU over the port's TwoStageDB, its answers
held against hpfw_tpu's TwoStageDB.match (Pallas path in interpret mode):
the three cases of tests/test_serve.py, the batch buckets, warmup, and a
concurrent-submit stress test."""

import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from hpfw_tpu import api as jax_api
from hpfw_tpu import oracle
from hpfw_tpu import serve as jax_serve
from hpfw_tpu.io import synth
from hpfw_tpu.match import scaled as jax_scaled
from hpfw_tpu_torch import MatchServer, ServerSaturated, api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.match.scaled import TwoStageDB


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
                            jdb.prints, jdb.lengths)
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
