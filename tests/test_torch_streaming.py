"""The port's streaming surfaces on the CPU vs hpfw_tpu's: ChunkedExtractor
(bit-identical to whole-track extraction within the port, and to hpfw_tpu's
up to the margin audit), StreamingSession on its rigid path and
StreamingPool, whose hypotheses equal hpfw_tpu's feed by feed on the same
PCM chunks (track, score and offset equal; confidence within 1e-9).

Both packages match against the same prints: the DB is built once by
hpfw_tpu and handed to the port, and a two-stage DB is hpfw_tpu's
single-device Pallas path in interpret mode."""

import dataclasses

import numpy as np
import pytest
import torch

from hpfw_tpu import api as jax_api
from hpfw_tpu import oracle
from hpfw_tpu.io import synth
from hpfw_tpu.match import scaled as jax_scaled
from hpfw_tpu.streaming import pool as jax_pool
from hpfw_tpu.streaming import session as jax_session
from hpfw_tpu_torch import ChunkedExtractor, StreamingPool, StreamingSession, api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.streaming.session import extract_chunked
from tests.test_tpu_pipeline import assert_bits_match_with_margin_audit


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


def _chunks(pcm, size):
    return [pcm[i:i + size] for i in range(0, len(pcm), size)]


@pytest.mark.parametrize("chunk", [8, 32, 57])
def test_chunked_extraction_bit_identical_to_whole_track(cfg, chunk):
    pcm = synth.synth_track(21, 4.0, cfg)
    filters = _filters(cfg)
    whole = api.fingerprint(pcm, filters, _port(cfg))
    np.testing.assert_array_equal(
        extract_chunked(pcm, filters, _port(cfg), chunk_prints=chunk), whole)


def test_chunked_extractor_incremental_feed(cfg):
    """Odd-sized pieces give the whole track's prints, and the same prints
    as hpfw_tpu's ChunkedExtractor up to the margin audit."""
    pcm = synth.synth_track(22, 3.0, cfg)
    filters = _filters(cfg)
    whole = api.fingerprint(pcm, filters, _port(cfg))
    ours = ChunkedExtractor(filters, _port(cfg), chunk_prints=16)
    ref = jax_session.ChunkedExtractor(filters, cfg, chunk_prints=16)
    got, want = [], []
    rng = np.random.default_rng(0)
    pos = 0
    while pos < len(pcm):
        n = int(rng.integers(100, 5000))
        got.append(ours.feed(pcm[pos:pos + n]))
        want.append(ref.feed(pcm[pos:pos + n]))
        assert got[-1].shape == want[-1].shape and got[-1].dtype == np.uint32
        pos += n
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape[0] > 0
    np.testing.assert_array_equal(got, whole[:got.shape[0]])
    margins = oracle.delta_margins(pcm, filters, cfg)[:got.shape[0]]
    assert_bits_match_with_margin_audit(got, want, margins)


def test_frame_ring_holds_the_newest_frames(cfg):
    """ring[-(n + halo):] are the CQT frames of the last n prints, as in
    hpfw_tpu's extractor."""
    pcm = synth.synth_track(23, 3.0, cfg)
    filters = _filters(cfg)
    ours = ChunkedExtractor(filters, _port(cfg), chunk_prints=16, frame_ring=40)
    ref = jax_session.ChunkedExtractor(filters, cfg, chunk_prints=16, frame_ring=40)
    for c in _chunks(pcm, 3000):
        ours.feed(c)
        ref.feed(c)
    assert len(ours.frame_ring) == len(ref.frame_ring) == 40
    np.testing.assert_allclose(np.asarray(ours.frame_ring), np.asarray(ref.frame_ring),
                               rtol=0, atol=1e-4)


def test_entry_points_default_to_the_card(cfg, monkeypatch):
    """With no device named, extraction and the DB go to the card whenever
    torch sees one; the CPU only when the caller names it."""
    filters = _filters(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = torch.device("cuda")
    assert api.default_device() == card
    assert api._resolve_device(None, filters) == card
    db = api.FingerprintDB(_port(cfg), filters, ["a"], np.zeros((1, 4, 2), np.uint32),
                           np.array([4], np.int32))
    assert db.device == card
    assert api._resolve_device(None, torch.from_numpy(filters)) == torch.device("cpu")
    assert ChunkedExtractor(filters, _port(cfg), device="cpu").device == torch.device("cpu")


@pytest.fixture(scope="module")
def catalog(cfg):
    """6 x 6 s tracks, a DB built by hpfw_tpu, the port's FingerprintDB over
    the same prints, and both packages' two-stage DBs over it."""
    tracks = synth.synth_catalog(6, 6.0, cfg)
    filters = _filters(cfg)
    jdb = jax_api.build_db(tracks, filters, cfg)
    pdb = api.FingerprintDB(_port(cfg), filters, jdb.track_ids, jdb.prints, jdb.lengths)
    jts = jax_scaled.TwoStageDB(jdb, stride=4, use_pallas_fine=True, coarse_tile=8,
                                pallas_interpret=True)
    return tracks, filters, {"dense": (jdb, pdb), "two_stage": (jts, TwoStageDB(pdb, stride=4))}


def _equal_hyp(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.track_id, a.score, a.offset) == (b.track_id, b.score, b.offset)
    assert abs(a.confidence - b.confidence) < 1e-9


@pytest.mark.parametrize("kind", ["dense", "two_stage"])
def test_session_equals_reference_per_feed(cfg, catalog, kind):
    tracks, filters, dbs = catalog
    jdb, pdb = dbs[kind]
    live = synth.make_query(tracks[4], 0.5, 4.0, cfg, noise_db=-15.0, seed=7)
    ours = StreamingSession(pdb, filters, _port(cfg), query_prints=64, chunk_prints=16)
    ref = jax_session.StreamingSession(jdb, filters, cfg, query_prints=64, chunk_prints=16)
    assert ours.query_buckets == ref.query_buckets == (16, 32, 64)
    for c in _chunks(live, cfg.sample_rate // 4):
        _equal_hyp(ours.feed(c), ref.feed(c))
        assert ours.last_match == ref.last_match
    assert ours.current_best.track_id == "4"
    stats = ours.latency_stats()
    assert stats["n_matches"] == ref.latency_stats()["n_matches"] > 0
    assert np.isfinite(stats["match_p50_ms"]) and np.isfinite(stats["step_p99_ms"])


@pytest.mark.parametrize("make", [
    lambda db, f, c: StreamingSession(db, f, c, spec_scan=True),
    lambda db, f, c: StreamingSession(db, f, dataclasses.replace(c, stretch_span=0.02)),
    lambda db, f, c: StreamingSession(db, f, dataclasses.replace(c, pitch_span_bins=1)),
], ids=["spec_scan", "stretch_span", "pitch_span_bins"])
def test_session_scan_not_ported(cfg, catalog, make):
    _, filters, dbs = catalog
    with pytest.raises(NotImplementedError, match="A8"):
        make(dbs["dense"][1], filters, _port(cfg))


def _noisy(tracks, cfg, rng, t):
    a = tracks[t][int(0.3 * cfg.sample_rate):]
    return a + 0.02 * rng.standard_normal(a.shape[0]).astype(np.float32)


def _pools(cfg, filters, dbs, kind, **kw):
    jdb, pdb = dbs[kind]
    kw = dict(dict(capacity=3, query_prints=64, chunk_prints=16), **kw)
    return (StreamingPool(pdb, filters, _port(cfg), **kw),
            jax_pool.StreamingPool(jdb, filters, cfg, **kw))


def _feed_both(ours, ref, chunks):
    got, want = ours.feed(chunks), ref.feed(chunks)
    assert list(got) == list(want)
    for sid in got:
        _equal_hyp(got[sid], want[sid])
    return got


@pytest.mark.parametrize("kind", ["dense", "two_stage"])
def test_pool_equals_reference_per_feed(cfg, catalog, kind):
    """Three concurrent noisy streams, one joining late so that two query
    buckets match in the same tick."""
    tracks, filters, dbs = catalog
    ours, ref = _pools(cfg, filters, dbs, kind)
    rng = np.random.default_rng(0)
    plan = {"a": 1, "b": 3, "c": 5}
    feeds = {sid: _chunks(_noisy(tracks, cfg, rng, t), 4096) for sid, t in plan.items()}
    for sid in ("a", "b"):
        ours.add_stream(sid)
        ref.add_stream(sid)
    out = {}
    for i in range(min(len(f) for f in feeds.values())):
        if i == 4:
            ours.add_stream("c")
            ref.add_stream("c")
        out = _feed_both(ours, ref, {sid: feeds[sid][i] for sid in ours.stream_ids})
    for sid, t in plan.items():
        assert out[sid].track_id == str(t)
    assert ours.latency_stats()["n_matches"] == ref.latency_stats()["n_matches"] > 0


def test_pool_ragged_cadences_equal_reference(cfg, catalog):
    """Streams at different chunk cadences, joining and leaving mid-run
    (tests/test_streaming_pool.py's schedule), feed by feed."""
    tracks, filters, dbs = catalog
    ours, ref = _pools(cfg, filters, dbs, "dense")
    rng = np.random.default_rng(1)
    step = ours.step_samples
    feeds = {"a": _chunks(_noisy(tracks, cfg, rng, 1), 2 * step),
             "b": _chunks(_noisy(tracks, cfg, rng, 3), step // 2),
             "c": _chunks(_noisy(tracks, cfg, rng, 5), int(1.7 * step))}
    for sid in ("a", "b"):
        ours.add_stream(sid)
        ref.add_stream(sid)
    pos = dict.fromkeys(feeds, 0)
    results = {}
    for tick in range(60):
        if tick == 8:
            ours.add_stream("c")
            ref.add_stream("c")
        if tick == 30:
            assert results["a"].track_id == "1"
            ours.remove_stream("a")
            ref.remove_stream("a")
        chunks = {}
        for sid in ours.stream_ids:
            if pos[sid] < len(feeds[sid]):
                chunks[sid] = feeds[sid][pos[sid]]
                pos[sid] += 1
        if not chunks:
            break
        results = _feed_both(ours, ref, chunks)
    assert "a" not in results
    assert results["b"].track_id == "3" and results["c"].track_id == "5"


def test_pool_stream_equals_session(cfg, catalog):
    """One pool stream == a lone StreamingSession on the same schedule,
    with chunks that span several windows."""
    tracks, filters, dbs = catalog
    pdb = dbs["two_stage"][1]
    audio = tracks[2][int(0.3 * cfg.sample_rate):int(4.0 * cfg.sample_rate)]
    sess = StreamingSession(pdb, filters, _port(cfg), query_prints=64, chunk_prints=16)
    pool = StreamingPool(pdb, filters, _port(cfg), capacity=2, query_prints=64,
                         chunk_prints=16)
    pool.add_stream("x")
    for c in _chunks(audio, 5 * 4096):
        _equal_hyp(pool.feed({"x": c})["x"], sess.feed(c))
    assert sess.current_best.track_id == "2"


def test_pool_lifecycle_and_unknown_ids(cfg, catalog):
    _, filters, dbs = catalog
    pool = StreamingPool(dbs["dense"][1], filters, _port(cfg), capacity=2,
                         query_prints=64, chunk_prints=16)
    pool.add_stream("a")
    pool.add_stream("b")
    with pytest.raises(ValueError, match="capacity"):
        pool.add_stream("c")
    with pytest.raises(ValueError, match="already exists"):
        pool.add_stream("a")
    pool.remove_stream("a")
    pool.add_stream("c")
    assert sorted(pool.stream_ids) == ["b", "c"]
    chunk = np.zeros(pool.step_samples, dtype=np.float32)
    with pytest.raises(ValueError, match="unknown stream ids"):
        pool.feed({"b": chunk, "ghost": chunk})
    # The known stream's buffer is untouched by the failed call.
    assert pool._streams["b"].buf.shape[0] == 0
    with pytest.raises(ValueError, match="query_buckets"):
        StreamingPool(dbs["dense"][1], filters, _port(cfg), query_prints=64,
                      query_buckets=(128,))
