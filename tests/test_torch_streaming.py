"""The port's streaming surfaces on the CPU vs hpfw_tpu's: ChunkedExtractor
(bit-identical to whole-track extraction within the port, and to hpfw_tpu's
up to the margin audit), StreamingSession on its rigid path and with the
spec-level tempo and pitch scan, and StreamingPool, whose hypotheses equal
hpfw_tpu's feed by feed on the same PCM chunks (track, score and offset
equal; confidence within 1e-9; the scan's lock state equal).

Both packages match against the same prints: the DB is built once by
hpfw_tpu and handed to the port, and a two-stage DB is hpfw_tpu's
single-device Pallas path in interpret mode."""

import dataclasses

import numpy as np
import pytest
import torch

from hpfw_tpu import api as jax_api
from hpfw_tpu import oracle
from hpfw_tpu.io import synth, synth_jax
from hpfw_tpu.match import scaled as jax_scaled
from hpfw_tpu.match import sharded as jax_sharded
from hpfw_tpu.parallel import mesh as jax_meshlib
from hpfw_tpu.streaming import pool as jax_pool
from hpfw_tpu.streaming import session as jax_session
from hpfw_tpu_torch import ChunkedExtractor, StreamingPool, StreamingSession, api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.match.sharded import ShardedDB
from hpfw_tpu_torch.parallel.mesh import Mesh
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
    whole = api.fingerprint(pcm, filters, _port(cfg), device="cpu")
    np.testing.assert_array_equal(
        extract_chunked(pcm, filters, _port(cfg), chunk_prints=chunk, device="cpu"),
        whole)


def test_chunked_extractor_incremental_feed(cfg):
    """Odd-sized pieces give the whole track's prints, and the same prints
    as hpfw_tpu's ChunkedExtractor up to the margin audit."""
    pcm = synth.synth_track(22, 3.0, cfg)
    filters = _filters(cfg)
    whole = api.fingerprint(pcm, filters, _port(cfg), device="cpu")
    ours = ChunkedExtractor(filters, _port(cfg), chunk_prints=16, device="cpu")
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
    ours = ChunkedExtractor(filters, _port(cfg), chunk_prints=16, frame_ring=40,
                            device="cpu")
    ref = jax_session.ChunkedExtractor(filters, cfg, chunk_prints=16, frame_ring=40)
    for c in _chunks(pcm, 3000):
        ours.feed(c)
        ref.feed(c)
    assert len(ours.frame_ring) == len(ref.frame_ring) == 40
    np.testing.assert_allclose(np.asarray(ours.frame_ring), np.asarray(ref.frame_ring),
                               rtol=0, atol=1e-4)


def test_entry_points_default_to_the_card(cfg, monkeypatch):
    """With no device named, extraction and the DB go to the card whenever
    torch sees one, and raise when it sees none; the CPU only when the
    caller names it."""
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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (api.default_device, lambda: api._resolve_device(None, filters),
                 lambda: api.FingerprintDB(_port(cfg), filters, ["a"],
                                           np.zeros((1, 4, 2), np.uint32),
                                           np.array([4], np.int32))):
        with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
            make()
    assert api._resolve_device("cpu", filters) == torch.device("cpu")


def test_entry_points_raise_without_a_card(cfg, monkeypatch, tmp_path):
    """With no card and no device named, TwoStageDB.load, fingerprint,
    learn_filters and ChunkedExtractor raise instead of running on the CPU;
    device="cpu" runs them there, and a TwoStageDB follows its DB's
    device."""
    filters = _filters(cfg)
    pcm = synth.synth_track(24, 1.0, cfg)
    args = (_port(cfg), filters, ["a"], np.zeros((1, 40, 2), np.uint32),
            np.array([40], np.int32))
    TwoStageDB(api.FingerprintDB(*args, device="cpu"), stride=4).save(str(tmp_path / "c"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TwoStageDB.load(str(tmp_path / "c")),
                 lambda: api.fingerprint(pcm, filters, _port(cfg)),
                 lambda: api.learn_filters([pcm], _port(cfg)),
                 lambda: ChunkedExtractor(filters, _port(cfg))):
        with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
            make()
    db = api.FingerprintDB(*args, device="cpu")
    assert db.device == torch.device("cpu")
    assert TwoStageDB(db, stride=4).device == torch.device("cpu")
    assert TwoStageDB.load(str(tmp_path / "c"), device="cpu").device == torch.device("cpu")
    assert api.fingerprint(pcm, filters, _port(cfg), device="cpu").shape[0] > 0


@pytest.fixture(scope="module")
def catalog(cfg):
    """6 x 6 s tracks, a DB built by hpfw_tpu, the port's FingerprintDB over
    the same prints, and both packages' two-stage DBs over it."""
    tracks = synth.synth_catalog(6, 6.0, cfg)
    filters = _filters(cfg)
    jdb = jax_api.build_db(tracks, filters, cfg)
    pdb = api.FingerprintDB(_port(cfg), filters, jdb.track_ids, jdb.prints, jdb.lengths,
                            device="cpu")
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


@pytest.mark.parametrize("make,exc,match", [
    (lambda db, f, c: StreamingSession(db, f, c, spec_scan=True), ValueError, "needs cfg"),
], ids=["spec_scan_without_span"])
def test_session_scan_not_ported(cfg, catalog, make, exc, match):
    """spec_scan=True with no tempo or pitch span raises the reference's
    ValueError (the spec-level scan itself is ported: test_spec_scan_*)."""
    _, filters, dbs = catalog
    with pytest.raises(exc, match=match):
        make(dbs["dense"][1], filters, _port(cfg))
    with pytest.raises(ValueError, match=match):
        jax_session.StreamingSession(dbs["dense"][0], filters, cfg, spec_scan=True)


SCAN_AXES = {"tempo": dict(stretch_span=0.03), "tempo_pitch": dict(stretch_span=0.03,
                                                                     pitch_span_bins=1)}


@pytest.fixture(scope="module")
def scan_catalog(cfg):
    """tests/test_streaming.py's spec-scan catalog: 10 x 6 s tracks rendered
    by hpfw_tpu's synth_jax, one DB built by hpfw_tpu under each scan config
    and handed to the port, dense and two-stage."""
    tracks = [np.asarray(t) for t in synth_jax.synth_batch(np.arange(10), 6.0, cfg)]
    filters = _filters(cfg)
    jdb0 = jax_api.build_db(tracks, filters, cfg)
    out = {}
    for axes, kw in SCAN_AXES.items():
        c = dataclasses.replace(cfg, **kw)
        jdb = jax_api.FingerprintDB(c, filters, jdb0.track_ids, jdb0.prints, jdb0.lengths)
        pdb = api.FingerprintDB(_port(c), filters, jdb0.track_ids, jdb0.prints,
                                jdb0.lengths, device="cpu")
        out[axes] = (c, {"dense": (jdb, pdb),
                         "two_stage": (jax_scaled.TwoStageDB(
                             jdb, stride=4, use_pallas_fine=True, coarse_tile=8,
                             pallas_interpret=True), TwoStageDB(pdb, stride=4))})
    return filters, out


def _live(cfg, track, seconds, start_s=0.3, **kw):
    """A noisy live rendition of catalog track `track` (hpfw_tpu's synth_jax)."""
    return np.asarray(synth_jax.live_query_batch(
        [track], [int(start_s * cfg.sample_rate)], 6.0, seconds, cfg, noise_db=-20.0,
        **kw))[0]


def _session_state(sess):
    return (sess._scan_state, sess.tempo, sess.pitch, sess._subfloor,
            tuple(sess._scan_factors()))


def _share_scan_stacks(ours, ref, cfg, filters):
    """Hand the reference session's scan stack to the port's session, once
    the port's own stack of the same tick is held to it by the margin audit.

    The two frame rings differ by float32 noise (~1e-5), so a variant's
    print may flip a bit whose projected delta lies within 1e-4 (relative)
    of zero, and move a score by that bit: the audit accepts exactly those
    bits, computed in float64 from the reference's frames. With one stack,
    the rest of each tick (dispatch, lock, vote) must then be equal."""
    real_ref, real_ours = ref._scan_stack, ours._scan_stack
    halo = cfg.context_w + cfg.delta_lag - 1
    shared = {}

    def ref_stack(n, factors):
        shared[n, tuple(factors)] = want = real_ref(n, factors)
        frames = np.asarray(ref.extractor.frame_ring, np.float64)[-(n + halo):]
        shared["margins"] = [np.abs(oracle.deltas(oracle.features(v.numpy(), filters, cfg),
                                                  cfg))
                             for v in api.scan_spectra(torch.from_numpy(frames), factors)]
        return want

    def our_stack(n, factors):
        got, want = real_ours(n, factors), shared.pop((n, tuple(factors)))
        assert got.shape == want.shape
        for g, w, m in zip(got, want, shared.pop("margins")):
            assert_bits_match_with_margin_audit(g, w, m)
        return np.array(want)

    ref._scan_stack, ours._scan_stack = ref_stack, our_stack


def _run_sessions(ours, ref, live, step):
    """Feed both sessions the same chunks (the reference first, so that its
    scan stack is there to share); every feed, the hypotheses, the last
    window's top hit and the lock state are equal. Returns the states."""
    states = []
    for pos in range(0, len(live), step):
        want = ref.feed(live[pos:pos + step])
        _equal_hyp(ours.feed(live[pos:pos + step]), want)
        assert ours.last_match == ref.last_match
        assert _session_state(ours) == _session_state(ref)
        states.append(_session_state(ours))
    assert len(ours.match_latencies_ms) == len(ref.match_latencies_ms) > 0
    return states


def _sessions(pdb, jdb, filters, c, **kw):
    kw = dict(dict(query_prints=128, chunk_prints=16), **kw)
    ours = StreamingSession(pdb, filters, _port(c), **kw)
    ref = jax_session.StreamingSession(jdb, filters, c, **kw)
    _share_scan_stacks(ours, ref, c, filters)
    return ours, ref


@pytest.mark.parametrize("axes", list(SCAN_AXES))
@pytest.mark.parametrize("kind", ["dense", "two_stage"])
def test_spec_scan_session_equals_reference(cfg, scan_catalog, kind, axes):
    """A 3%-fast rendition (and, with the pitch axis, +0.5 semitone): the
    session acquires over the whole grid, locks within a grid step of the
    rendition and tracks, feed by feed as hpfw_tpu's session does."""
    filters, dbs = scan_catalog
    c, by_kind = dbs[axes]
    jdb, pdb = by_kind[kind]
    pitch = axes == "tempo_pitch"
    live = _live(c, 4, 5.0, stretch=1.03, pitch_st=0.5 if pitch else 0.0)
    ours, ref = _sessions(pdb, jdb, filters, c)
    assert ours._spec_scan and ours.extractor.frame_ring.maxlen == 128 + 11
    assert ours._scan_factors() == ref._scan_factors() == jax_api.scan_hypotheses(c)
    states = _run_sessions(ours, ref, live, c.sample_rate // 4)
    assert ours.current_best.track_id == "4"
    assert states[0][0] == "acquire" and ours._scan_state == "track"
    assert abs(ours.tempo - 1.03) < 0.015 and ours.pitch == (1 if pitch else 0)
    assert 1 <= len(ours._scan_factors()) <= 3


def test_spec_scan_in_tempo_locks_rigid(cfg, scan_catalog):
    """An in-tempo stream locks at (1.0, 0) and tracks with no scan at all."""
    filters, dbs = scan_catalog
    c, by_kind = dbs["tempo"]
    jdb, pdb = by_kind["two_stage"]
    ours, ref = _sessions(pdb, jdb, filters, c)
    _run_sessions(ours, ref, _live(c, 4, 5.0), c.sample_rate // 4)
    assert ours.current_best.track_id == "4"
    assert (ours._scan_state, ours.tempo, ours.pitch) == ("track", 1.0, 0)
    assert ours._scan_factors() == ()


def test_spec_scan_lock_margin(cfg, scan_catalog):
    """A lock margin no window clears: the session never locks, re-enters
    acquisition every third full window, and still identifies the track."""
    filters, dbs = scan_catalog
    c, by_kind = dbs["tempo"]
    jdb, pdb = by_kind["dense"]
    ours, ref = _sessions(pdb, jdb, filters, c, lock_margin=0.9)
    states = _run_sessions(ours, ref, _live(c, 4, 5.0, stretch=1.03), c.sample_rate // 4)
    assert {st[0] for st in states} == {"acquire"}
    assert max(st[3] for st in states) == 2
    assert ours.current_best.track_id == "4"


def test_spec_scan_track_change_relocks(cfg, scan_catalog):
    """The stream switches from a 3%-fast rendition to 2 s of noise and then
    to another track in tempo: the session locks on the first, the noise's
    unconfident windows send it back to acquisition, and it locks on the
    second at (1.0, 0), feed by feed as hpfw_tpu's session does."""
    filters, dbs = scan_catalog
    c, by_kind = dbs["tempo"]
    jdb, pdb = by_kind["two_stage"]
    noise = 0.05 * np.random.default_rng(3).standard_normal(2 * c.sample_rate)
    live = np.concatenate([_live(c, 4, 5.0, stretch=1.03), noise.astype(np.float32),
                           _live(c, 6, 5.0, start_s=0.8)])
    ours, ref = _sessions(pdb, jdb, filters, c)
    states = _run_sessions(ours, ref, live, c.sample_rate // 4)
    kinds = [st[0] for st in states]
    first_lock = kinds.index("track")
    reacquire = kinds.index("acquire", first_lock)
    assert abs(states[first_lock][1] - 1.03) < 0.015
    assert "track" in kinds[reacquire:]
    assert (ours._scan_state, ours.tempo, ours.pitch) == ("track", 1.0, 0)
    assert ours.current_best.track_id == "6"


@pytest.mark.parametrize("kind", ["dense", "two_stage"])
def test_session_without_spec_scan_equals_reference(cfg, catalog, kind):
    """spec_scan=False with stretch_span=0.02: the session matches the plain
    ring, and a two-stage DB runs its print-level tempo scan, feed by feed as
    hpfw_tpu's session does."""
    tracks, filters, dbs = catalog
    jdb, _ = dbs["dense"]
    span = dataclasses.replace(cfg, stretch_span=0.02)
    jspan = jax_api.FingerprintDB(span, filters, jdb.track_ids, jdb.prints, jdb.lengths)
    pspan = api.FingerprintDB(_port(span), filters, jdb.track_ids, jdb.prints, jdb.lengths,
                              device="cpu")
    if kind == "two_stage":
        jspan = jax_scaled.TwoStageDB(jspan, stride=4, use_pallas_fine=True, coarse_tile=8,
                                      pallas_interpret=True)
        pspan = TwoStageDB(pspan, stride=4)
    live = synth.make_query(tracks[3], 0.4, 3.0, cfg, noise_db=-15.0, seed=8)
    ours = StreamingSession(pspan, filters, _port(span), query_prints=64, chunk_prints=16,
                            spec_scan=False)
    ref = jax_session.StreamingSession(jspan, filters, span, query_prints=64, chunk_prints=16,
                                       spec_scan=False)
    for c in _chunks(live, cfg.sample_rate // 4):
        _equal_hyp(ours.feed(c), ref.feed(c))
        assert ours.last_match == ref.last_match
    assert ours.current_best.track_id == "3"


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


# -- over a ShardedDB: the port's on an 8-entry cpu mesh, hpfw_tpu's on mesh8.

def test_spec_scan_session_over_sharded_db_equals_dense(cfg, scan_catalog):
    """A +0.5 semitone, 3%-fast rendition: the session over a ShardedDB of
    the dense DB (a sharded match a hypothesis) gives the hypotheses, top
    hits and lock states of the session over the dense DB, feed by feed."""
    filters, dbs = scan_catalog
    c, by_kind = dbs["tempo_pitch"]
    pdb = by_kind["dense"][1]
    kw = dict(query_prints=128, chunk_prints=16)
    dense = StreamingSession(pdb, filters, _port(c), **kw)
    sharded = StreamingSession(ShardedDB(pdb, Mesh(["cpu"] * 8)), filters, _port(c), **kw)
    live = _live(c, 4, 5.0, stretch=1.03, pitch_st=0.5)
    for pos in range(0, len(live), c.sample_rate // 4):
        _equal_hyp(sharded.feed(live[pos:pos + c.sample_rate // 4]),
                   dense.feed(live[pos:pos + c.sample_rate // 4]))
        assert sharded.last_match == dense.last_match
        assert _session_state(sharded) == _session_state(dense)
    assert sharded.current_best.track_id == "4" and sharded._scan_state == "track"
    assert sharded.pitch == 1


def test_spec_scan_sharded_db_equals_reference(cfg):
    """tests/test_streaming.py:258: a 3%-fast stream over a mesh-sharded dense
    DB locks the right track, feed by feed as hpfw_tpu's session on mesh8."""
    c = dataclasses.replace(cfg, stretch_span=0.03)
    tracks = [np.asarray(t) for t in synth_jax.synth_batch(np.arange(8), 6.0, c)]
    filters = _filters(c)
    jdb = jax_api.build_db(tracks, filters, c)
    pdb = api.FingerprintDB(_port(c), filters, jdb.track_ids, jdb.prints, jdb.lengths,
                            device="cpu")
    live = np.asarray(synth_jax.live_query_batch(
        [5], [int(0.3 * c.sample_rate)], 6.0, 4.0, c, stretch=1.03, noise_db=-20.0))[0]
    ours, ref = _sessions(ShardedDB(pdb, Mesh(["cpu"] * 8)),
                          jax_sharded.ShardedDB(jdb, jax_meshlib.db_mesh(8)), filters, c,
                          query_prints=64)
    _run_sessions(ours, ref, live, c.sample_rate // 4)
    assert ours.current_best.track_id == "5"
    assert ours._scan_state == "track" and abs(ours.tempo - 1.03) < 0.015


def test_pool_over_sharded_db_equals_dense(cfg, catalog):
    """Three streams over a ShardedDB (each query alone through its match)
    give the hypotheses of the same pool over the dense DB, feed by feed."""
    tracks, filters, dbs = catalog
    pdb = dbs["dense"][1]
    kw = dict(capacity=3, query_prints=64, chunk_prints=16)
    dense = StreamingPool(pdb, filters, _port(cfg), **kw)
    sharded = StreamingPool(ShardedDB(pdb, Mesh(["cpu"] * 8)), filters, _port(cfg), **kw)
    rng = np.random.default_rng(2)
    feeds = {sid: _chunks(_noisy(tracks, cfg, rng, t), 4096)
             for sid, t in {"a": 0, "b": 2, "c": 5}.items()}
    for sid in feeds:
        dense.add_stream(sid)
        sharded.add_stream(sid)
    for i in range(min(len(f) for f in feeds.values())):
        chunks = {sid: f[i] for sid, f in feeds.items()}
        got, want = sharded.feed(chunks), dense.feed(chunks)
        assert list(got) == list(want)
        for sid in got:
            _equal_hyp(got[sid], want[sid])
    assert [got[sid].track_id for sid in "abc"] == ["0", "2", "5"]
