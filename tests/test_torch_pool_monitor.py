"""StreamingPool as a broadcast monitor over a device-resident catalog, on the
CPU at a small size: one stream.feed, stream.extract, stream.match and
stream.vote span a feed with their attributes; last_hit and query are what
the pool matched; a pool over a resident FingerprintDB's TwoStageDB gives
the hypotheses of one over the NumPy-built DB; and over a seeded run in
which a stream changes track, every last_hit is the plain reference's top-1
of its query (portbench/reference/matcher.py) and every hypothesis is
portbench/reference/streams.py's replay of the stream's hits."""

import dataclasses

import numpy as np
import pytest
import torch

from hpfw_tpu_torch import StreamingPool, api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.io import synth
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.oracle import fix_eigenvector_signs
from hpfw_tpu_torch.utils import profiling
from portbench.reference import matcher as reference
from portbench.reference import streams as vote_reference

# Short frames and catalog-scale matching (pack4 pass 1, a prefilter and a
# pool that prune the catalog), a 4-stream pool of 16-print chunks.
CFG = HpfwConfig.catalog_scale(frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8,
                               delta_lag=4, coarse_prefilter_pack4=True, coarse_prefilter=64,
                               fine_candidates=16)
T, L, TRACKS, SECONDS = 160, 560, 4, 6.0
POOL = dict(capacity=4, query_prints=64, chunk_prints=16)
# Stream "a" plays track 0 from 3.5 s, then track 1: its hypothesis changes track.
PLAN = {"a": [(0, 3.5), (1, 0.0)], "b": [(2, 0.5)], "c": [(3, 1.0)]}
FEEDS = 24


def _filters(cfg):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return fix_eigenvector_signs(f).astype(np.float32)


def _audio(tracks, plan, seed):
    """A stream's audio: its tracks from their starts, one after the other,
    with white noise 15 dB below."""
    x = np.concatenate([tracks[t][int(s * CFG.sample_rate):] for t, s in plan])
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    return x + noise * np.float32(np.sqrt(np.mean(x ** 2)) * 10 ** (-15 / 20)
                                  / np.sqrt(np.mean(noise ** 2)))


@pytest.fixture(scope="module")
def catalog():
    """T random rows with the prints of TRACKS tracks planted in rows 7k + 3;
    a resident DB over the tensor and a DB over a host copy of it."""
    filters = _filters(CFG)
    tracks = synth.synth_catalog(TRACKS, SECONDS, CFG)
    g = torch.Generator().manual_seed(22)
    prints = torch.randint(-2 ** 31, 2 ** 31, (T, L, 2), generator=g,
                           dtype=torch.int64).to(torch.int32)
    lengths = torch.full((T,), L, dtype=torch.int32)
    rows = [7 * k + 3 for k in range(TRACKS)]
    for r, x in zip(rows, tracks):
        fp = torch.from_numpy(api.fingerprint(x, filters, CFG, device="cpu").view(np.int32))
        prints[r, :len(fp)], prints[r, len(fp):], lengths[r] = fp, 0, len(fp)
    ids = [str(i) for i in range(T)]
    resident = api.FingerprintDB(CFG, filters, ids, prints, lengths, device="cpu")
    host = api.FingerprintDB(CFG, filters, ids, prints.numpy().view(np.uint32).copy(),
                             lengths.numpy(), device="cpu")
    audio = {sid: _audio(tracks, plan, seed) for seed, (sid, plan) in enumerate(PLAN.items())}
    return dict(filters=filters, prints=prints, lengths=lengths, rows=rows, resident=resident,
                host=host, audio=audio)


def _drive(db, filters, audio):
    """Feed a pool over db: per feed its hypotheses, each stream's last_hit
    and query, the batches match_batch was given and returned, and the
    spans the feed recorded."""
    ts = TwoStageDB(db)
    pool = StreamingPool(ts, filters, CFG, **POOL)
    before = {}
    for sid in audio:
        pool.add_stream(sid)
        before[sid] = (pool.last_hit(sid), pool.query(sid))
    calls = []
    real = ts.match_batch

    def match_batch(queries, **kw):
        out = real(queries, **kw)
        calls[-1].append((queries.copy(), out))
        return out
    ts.match_batch = match_batch
    feeds, at = [], 0
    for f in range(FEEDS):
        size = pool.window_samples + pool.step_samples if f == 0 else pool.step_samples
        first = profiling.new_id()
        calls.append([])
        hyps = pool.feed({sid: x[at:at + size] for sid, x in audio.items()})
        at += size
        spans = [s for s in profiling.spans() if s.sid > first]
        feeds.append(dict(hyps=hyps, hits={sid: pool.last_hit(sid) for sid in audio},
                          queries={sid: pool.query(sid) for sid in audio},
                          calls=calls[-1], spans=spans))
    return pool, feeds, before


@pytest.fixture(scope="module")
def resident_run(catalog):
    return _drive(catalog["resident"], catalog["filters"], catalog["audio"])


def test_feed_spans_and_attributes(resident_run):
    """Every feed after the first: one feed, extraction, match and vote span,
    the match padded to the pool's capacity; the first feed drains two
    windows a stream (two extractions) before its one match."""
    _, feeds, _ = resident_run
    n = len(PLAN)
    for f, rec in enumerate(feeds):
        by = {}
        for s in rec["spans"]:
            if s.name.startswith("stream."):
                by.setdefault(s.name, []).append(s)
        assert sorted(by) == ["stream.extract", "stream.feed", "stream.match", "stream.vote"]
        (feed,), (match,), (vote,) = by["stream.feed"], by["stream.match"], by["stream.vote"]
        assert feed.attrs == {"streams": n, "ready": n}
        assert [s.attrs for s in by["stream.extract"]] == [{"rows": n}] * (2 if f == 0 else 1)
        ring = min(POOL["query_prints"], POOL["chunk_prints"] * (f + 2))
        assert match.attrs == {"bucket": max(b for b in (16, 32, 64) if b <= ring), "rows": n,
                               "padded": POOL["capacity"]}
        assert vote.attrs == {"streams": n}
        assert all(feed.t0 <= s.t0 and s.t1 <= feed.t1 for s in rec["spans"])
        assert match.t1 <= vote.t0


def test_last_hit_and_query_are_what_was_matched(resident_run):
    pool, feeds, before = resident_run
    assert all(v == (None, None) for v in before.values())
    for rec in feeds:
        ((queries, results),) = rec["calls"]
        assert queries.shape == (POOL["capacity"],) + rec["queries"]["a"].shape
        for i, sid in enumerate(PLAN):            # streams match in sorted order
            np.testing.assert_array_equal(rec["queries"][sid], queries[i])
            ids, scores, offs = results[i]
            assert rec["hits"][sid] == (ids[0], int(scores[0]), int(offs[0]))
    q = pool.query("a")
    q[:] = 0
    assert pool.query("a").any()                  # a copy


def test_resident_and_numpy_built_pools_agree(catalog, resident_run):
    _, feeds, _ = resident_run
    _, host_feeds, _ = _drive(catalog["host"], catalog["filters"], catalog["audio"])
    for a, b in zip(feeds, host_feeds):
        assert a["hyps"] == b["hyps"] and a["hits"] == b["hits"]


def test_hits_and_hypotheses_equal_the_reference(catalog, resident_run):
    pool, feeds, _ = resident_run
    ref = reference.Catalog(catalog["prints"], catalog["lengths"], dataclasses.asdict(CFG))
    for rec in feeds:
        qs = np.stack([rec["queries"][sid] for sid in PLAN]).view(np.int32)
        for sid, w in zip(PLAN, ref.match(torch.from_numpy(qs))):
            tr, sc, of = reference.rank(w[0], w[1], w[2], 1, T)
            hit = rec["hits"][sid]
            assert (int(hit[0]), hit[1], hit[2]) == (int(tr[0]), int(sc[0]), int(of[0]))
    for sid in PLAN:
        hits = [rec["hits"][sid] + (rec["queries"][sid].shape[0],) for rec in feeds]
        want = vote_reference.replay(hits, pool.vote_decay, pool.vote_floor)
        for rec, w in zip(feeds, want):
            got = rec["hyps"][sid]
            assert (got.track_id, got.score, got.offset) == w[:3]
            assert abs(got.confidence - w[3]) <= 1e-9
    rows = catalog["rows"]
    seen = [rec["hyps"]["a"].track_id for rec in feeds]
    assert seen[3] == str(rows[0]) and seen[-1] == str(rows[1])
    assert feeds[-1]["hyps"]["b"].track_id == str(rows[2])
    assert feeds[-1]["hyps"]["c"].track_id == str(rows[3])
