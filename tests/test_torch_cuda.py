"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips unless torch sees a CUDA device. The card's
machine has no jax, so run this file there without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Imports nothing of jax or hpfw_tpu.
"""

import dataclasses
import functools
import re
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from hpfw_tpu_torch import ChunkedExtractor, MatchServer, StreamingSession, api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.filters import filters_from_jax
from hpfw_tpu_torch import graft_entry
from hpfw_tpu_torch.oracle import audit, fix_eigenvector_signs
from hpfw_tpu_torch.io import synth
from hpfw_tpu_torch.learn import pca
from hpfw_tpu_torch.match import matcher
from hpfw_tpu_torch.match import graphs
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.match.sharded import ShardedDB
from hpfw_tpu_torch.parallel import mesh as meshlib
from hpfw_tpu_torch.ops import _build, coarse_scan, fine, frontend, probe
from hpfw_tpu_torch.ops import fingerprint as fp_ops
from hpfw_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

SMALL = dict(frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8,
             delta_lag=4, db_downsample=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return fix_eigenvector_signs(f).astype(np.float32)


def _bits(a, b):
    return int(np.bitwise_count((a ^ b).cpu().numpy().view(np.uint32)).sum())


@pytest.mark.parametrize("cfg_kw,seconds", [(SMALL, 2.0), ({}, 6.0), (SMALL, 0.05)])
def test_cqt_kernel_matches_plain(dev, cfg_kw, seconds):
    cfg = HpfwConfig(**cfg_kw)
    pcm = torch.from_numpy(synth.synth_track(3, seconds, cfg)).to(dev)
    frames = frontend.frame_signal(pcm, cfg)
    got = frontend.cqt_kernel(frames, cfg)
    want = frontend.cqt_from_frames_ref(frames, cfg)
    assert got.shape == want.shape == (cfg.n_frames(pcm.shape[0]), cfg.n_bins)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # A contiguous copy of the frames gives the same bits as the strided view.
    if frames.shape[0]:
        assert torch.equal(frontend.cqt_kernel(frames.contiguous(), cfg), got)


@pytest.mark.parametrize("n_frames", [1, 63, 64, 65, 415, 10320])
def test_cqt_kernel_frame_counts(dev, n_frames):
    """K1 at the default config for F frames (one tile, either side of a
    64-frame tile, a 10 s query, a 240 s track): within 1e-4 of the plain
    version; a contiguous copy, an unaligned view, the view without its first
    frame and (for the track) its first 415 frames, launched as a small grid,
    give the same bits row for row."""
    cfg = HpfwConfig()
    n = cfg.frame_len + (n_frames - 1) * cfg.hop
    pcm = torch.from_numpy(synth.synth_track(11, n / cfg.sample_rate + 0.01, cfg)[:n + 1]).to(dev)
    frames = frontend.frame_signal(pcm[:n], cfg)
    assert frames.shape[0] == n_frames
    got = frontend.cqt_kernel(frames, cfg)
    torch.testing.assert_close(got, frontend.cqt_from_frames_ref(frames, cfg), rtol=0, atol=1e-4)
    assert torch.equal(frontend.cqt_kernel(frames.contiguous(), cfg), got)
    shifted = frontend.frame_signal(pcm[1:], cfg)             # 4-byte aligned only
    assert shifted.data_ptr() % 16 and shifted.shape[0] == n_frames
    assert torch.equal(frontend.cqt_kernel(shifted, cfg),
                       frontend.cqt_kernel(shifted.contiguous(), cfg))
    if n_frames > 1:
        assert torch.equal(frontend.cqt_kernel(frames[1:], cfg), got[1:])
    if n_frames > 1024:          # a large grid's slices against a small grid's
        assert torch.equal(frontend.cqt_kernel(frames[:415], cfg), got[:415])


@pytest.mark.parametrize("bit_order", ["lsb0", "msb0"])
@pytest.mark.parametrize("tie_break", ["gt", "ge"])
def test_encoder_kernel_matches_plain(dev, bit_order, tie_break):
    cfg = HpfwConfig(**SMALL, bit_order=bit_order, tie_break=tie_break)
    filt = filters_from_jax(_filters(cfg), cfg, dev)
    spec = frontend.cqt(torch.from_numpy(synth.synth_track(4, 3.0, cfg)).to(dev), cfg)
    got = fp_ops.encoder_kernel(spec, filt, cfg)
    want = fp_ops.fingerprint_from_spec_ref(spec, filt, cfg)
    assert got.shape == want.shape == (cfg.n_hashprints(int(3.0 * cfg.sample_rate)), 2)
    assert _bits(got, want) <= max(2, got.numel() * 32 // 10000)
    # Ties: a constant spectrum has every delta exactly 0.
    flat = torch.zeros_like(spec)
    tied = fp_ops.encoder_kernel(flat, filt, cfg)
    assert torch.equal(tied, fp_ops.fingerprint_from_spec_ref(flat, filt, cfg))


@functools.cache
def _track_spec(dev_name: str) -> torch.Tensor:
    """K1's spectrum of a 240 s track at the default config (10,320 frames)."""
    cfg = HpfwConfig()
    pcm = torch.from_numpy(synth.synth_track(100, 240.0, cfg)).to(dev_name)
    return frontend.cqt(pcm, cfg)


def _encoder_check(spec, filt, cfg):
    """K2 on spec, held to the plain version: at most max(2, bits/10000)."""
    got = fp_ops.encoder_kernel(spec, filt, cfg)
    want = fp_ops.fingerprint_from_spec_ref(spec, filt, cfg)
    assert got.shape == want.shape == (spec.shape[0] - cfg.context_w + 1 - cfg.delta_lag, 2)
    assert _bits(got, want) <= max(2, got.numel() * 32 // 10000)
    return got


def test_encoder_windows_equal_whole_track(dev):
    """67-frame windows (32 prints, the streaming launch) cut anywhere in a
    240 s spectrum give the whole-track launch's prints bit for bit."""
    cfg = HpfwConfig()
    filt = filters_from_jax(_filters(cfg), cfg, dev)
    spec = _track_spec(str(dev))
    whole = _encoder_check(spec, filt, cfg)
    assert whole.shape[0] == 10285
    for o in (0, 1, 37, 113, 4000):
        win = _encoder_check(spec[o:o + 67], filt, cfg)
        assert win.shape[0] == 32 and torch.equal(win, whole[o:o + 32])


@pytest.mark.parametrize("n_prints", [1, 111, 112, 113, 380, 10285])
def test_encoder_print_counts(dev, n_prints):
    """One print, either side of a 112-print tile, a 10 s query, a 240 s
    track: within the bit gate, and equal to the 240 s launch's first prints."""
    cfg = HpfwConfig()
    filt = filters_from_jax(_filters(cfg), cfg, dev)
    spec = _track_spec(str(dev))
    got = _encoder_check(spec[:n_prints + cfg.context_w - 1 + cfg.delta_lag], filt, cfg)
    whole = fp_ops.encoder_kernel(spec, filt, cfg)
    assert torch.equal(got, whole[:n_prints])


@pytest.mark.parametrize("lag", [1, 16, 64])
def test_encoder_delta_lags(dev, lag):
    cfg = HpfwConfig(delta_lag=lag)
    filt = filters_from_jax(_filters(cfg, seed=lag), cfg, dev)
    _encoder_check(_track_spec(str(dev))[:1000], filt, cfg)


@pytest.mark.parametrize("bit_order", ["lsb0", "msb0"])
@pytest.mark.parametrize("tie_break", ["gt", "ge"])
def test_encoder_default_config_orders_and_ties(dev, bit_order, tie_break):
    cfg = HpfwConfig(bit_order=bit_order, tie_break=tie_break)
    filt = filters_from_jax(_filters(cfg), cfg, dev)
    _encoder_check(_track_spec(str(dev))[:415], filt, cfg)
    flat = torch.zeros((415, cfg.n_bins), device=dev)        # every delta exactly 0
    assert torch.equal(fp_ops.encoder_kernel(flat, filt, cfg),
                       fp_ops.fingerprint_from_spec_ref(flat, filt, cfg))


@pytest.mark.parametrize("context_w", [1, 5])
def test_encoder_ranks_without_context_frames(dev, context_w):
    """context_w 1 and 5 leave cluster ranks with no context frame; over a
    grid of several waves each block still waits for all of its copies, so
    no late copy lands in a later block's shared memory."""
    cfg = HpfwConfig(**dict(SMALL, context_w=context_w))
    filt = filters_from_jax(_filters(cfg, seed=context_w), cfg, dev)
    rng = np.random.default_rng(context_w)
    spec = torch.from_numpy(rng.standard_normal((6000, cfg.n_bins)).astype(np.float32)).to(dev)
    got = _encoder_check(spec, filt, cfg)
    assert torch.equal(fp_ops.encoder_kernel(spec[100:400], filt, cfg),
                       got[100:400 - context_w + 1 - cfg.delta_lag])


def test_chunked_extractor_default_config_equals_fingerprint(dev):
    """The pool's and the session's launch (32 prints a window) at the default
    config: the streamed prints are api.fingerprint's, bit for bit."""
    cfg = HpfwConfig()
    filters = _filters(cfg)
    pcm = synth.synth_track(42, 20.0, cfg)
    ex = ChunkedExtractor(filters, cfg, chunk_prints=32, device=dev)
    got = np.concatenate([ex.feed(pcm[i:i + 12345]) for i in range(0, len(pcm), 12345)])
    assert got.shape[0] >= 32 * 20
    whole = api.fingerprint(pcm, filters, cfg, device=dev)
    np.testing.assert_array_equal(got, whole[:got.shape[0]])


def _random_db(rng, lengths, l_pad=None):
    l = l_pad or max(lengths)
    prints = np.zeros((len(lengths), l, 2), dtype=np.uint32)
    for i, ln in enumerate(lengths):
        prints[i, :ln] = rng.integers(0, 2 ** 32, (ln, 2), dtype=np.uint32)
    return prints, np.array(lengths, dtype=np.int32)


@pytest.mark.parametrize("n,l", [(380, 811), (380, 7701), (0, 1), (2000, 3000),
                                 (29056, 30000), (10_000, 200_000)])
def test_scan_geometry_fits_shared_memory(dev, n, l):
    """K3's launch as csrc/match.cu decides it: the large tile from
    SCAN_LARGE_FROM offsets a track, two blocks of the small tile an SM, the
    whole query resident on the main path's shapes, else a chunk that fits."""
    tile, cpos, smem, n_blocks = matcher.scan_geometry(n, l)
    assert tile == int(l - n + 1 >= matcher.SCAN_LARGE_FROM)
    assert n_blocks == -(-(l - n + 1) // (512 if tile == 0 else 2048))
    assert 1 <= cpos <= n + 31 and smem <= (112 if tile == 0 else 226) * 1024
    if (n, l) in ((380, 811), (380, 7701), (0, 1)):
        assert cpos == n + 31
    if n >= 10_000:                     # streamed in chunks
        assert cpos < n + 31
    with pytest.raises(ValueError):
        matcher.scan_geometry(n + 1, n)


def _force_tile(monkeypatch, tile):
    """K3's small tile (0), large tile (1) or its own choice (None)."""
    if tile is not None:
        monkeypatch.setattr(matcher, "SCAN_LARGE_FROM", 0 if tile else 2 ** 31 - 1)


@pytest.mark.parametrize("n_query", [0, 1, 37, 300, 380, 2000, 29056])
def test_scan_kernel_matches_plain(dev, n_query, monkeypatch):
    """K3 with either tile (and the default) equal to the plain scan: tracks
    of 0, 1, N - 1, N and N + 1 prints among longer ones, random prints past
    every length, a tie; 29,056 prints is the longest query K3 took before it
    streamed the query (two chunks of the small tile already at 2,000)."""
    rng = np.random.default_rng(n_query)
    l = max(900, n_query + 1)
    lengths = [900, 851, 15, 0, 300, 900, 123, 899, 1, max(n_query - 1, 0), n_query,
               n_query + 1]
    prints = rng.integers(0, 2 ** 32, (len(lengths), l, 2), dtype=np.uint32)
    lens = np.array(lengths, np.int32)
    q = rng.integers(0, 2 ** 32, (n_query, 2), dtype=np.uint32)
    if 0 < n_query <= 300:
        prints[1, 40:40 + n_query] = q           # planted
        prints[5, 10:10 + n_query] = q           # tie: first offset wins
        prints[5, 500:500 + n_query] = q
    args = (torch.from_numpy(q.view(np.int32)).to(dev),
            torch.from_numpy(prints.view(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev))
    s_r, o_r = matcher.score_tracks_ref(*args)
    for tile in (None, 0, 1):
        _force_tile(monkeypatch, tile)
        s_k, o_k = matcher.score_tracks_kernel(*args)
        assert torch.equal(s_k, s_r) and torch.equal(o_k, o_r), tile
    if 0 < n_query <= 300:
        assert int(s_r[5]) == 64 * n_query and int(o_r[5]) == 10


@pytest.mark.parametrize("tile", [0, 1])
def test_scan_kernel_ties_and_waves(dev, tile, monkeypatch):
    """1,100 tracks x 3,000 prints against a 380-print query (several waves
    of blocks, several blocks a track): ties inside a column, across a
    column (16 MT offsets), across a small and a large block (512 and 2,048
    offsets), each won by the first offset, and random prints past short
    lengths; exactly the plain scan."""
    rng = np.random.default_rng(11 + tile)
    t, l, n = 1100, 3000, 380
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    lens = np.full(t, l, np.int32)
    lens[7::5] = rng.integers(0, l, len(lens[7::5]))
    # A query of period 10 planted as a longer run: equal peaks at offsets 10
    # and 20 of track 0, inside one column.
    run = np.tile(rng.integers(0, 2 ** 32, (10, 2), dtype=np.uint32), (n // 10 + 2, 1))
    q = np.ascontiguousarray(run[:n])
    prints[0, 10:20 + n] = run[:n + 10]
    ties = {0: (10, 20), 1: (31, 31 + n), 2: (63, 63 + n), 3: (511, 511 + n),
            4: (2047, 2047 + n)}
    for track, offs in list(ties.items())[1:]:
        for o in offs:
            prints[track, o:o + n] = q
    args = (torch.from_numpy(q.view(np.int32)).to(dev),
            torch.from_numpy(prints.view(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev))
    _force_tile(monkeypatch, tile)
    s_k, o_k = matcher.score_tracks_kernel(*args)
    s_r, o_r = matcher.score_tracks_ref(*args)
    assert torch.equal(s_k, s_r) and torch.equal(o_k, o_r)
    for track, offs in ties.items():
        assert (int(s_k[track]), int(o_k[track])) == (64 * n, offs[0])


def test_api_on_card_matches_cpu_and_counts_launches(dev):
    cfg = HpfwConfig(**SMALL)
    filters = _filters(cfg)
    tracks = synth.synth_catalog(4, 3.0, cfg)
    _build.reset_launch_counts()
    db = api.build_db(tracks, filters, cfg, device=dev)
    q = api.fingerprint(synth.make_query(tracks[2], 0.5, 1.5, cfg), filters, cfg,
                        device=dev)
    ids, scores, offsets = api.match(q, db, top_k=3)
    assert _build.LAUNCHES == {"cqt": 5, "fingerprint": 5, "score_tracks": 1,
                               "coarse_scan": 0, "coarse_scan_batch": 0,
                               "coarse_scan_batch_packed": 0, "coarse_rescan": 0,
                               "fine_rescan": 0, "row_sum": 0}
    cpu_db = api.build_db(tracks, filters, cfg, device="cpu")
    diff = np.bitwise_count(db.prints ^ cpu_db.prints).sum()
    assert diff <= max(2, db.prints.size * 32 // 10000)
    assert ids[0] == "2" and abs(int(offsets[0]) - round(0.5 * cfg.sample_rate / cfg.hop)) <= 1


def test_bucketing_exact_on_card(dev):
    cfg = HpfwConfig(**SMALL)
    filt = filters_from_jax(_filters(cfg), cfg, dev)
    pcm = synth.synth_track(40, 1.7, cfg)
    for extra in [0, 17, cfg.hop - 1, 3 * cfg.hop + 5]:
        cut = pcm[: len(pcm) - extra]
        plain = api.fingerprint(cut, filt, cfg, bucket_s=0)
        bucketed = api.fingerprint(cut, filt, cfg, bucket_s=0.25)
        np.testing.assert_array_equal(bucketed, plain)


def test_chunked_extractor_defaults_to_the_card(dev):
    """Built from numpy filters with no device named, the extractor runs K1
    and K2 on the card, one each a window, with api.fingerprint's prints."""
    cfg = HpfwConfig(**SMALL)
    filters = _filters(cfg)
    pcm = synth.synth_track(41, 2.0, cfg)
    ex = ChunkedExtractor(filters, cfg, chunk_prints=16)
    assert ex.device.type == "cuda"
    _build.reset_launch_counts()
    got = ex.feed(pcm)
    windows = got.shape[0] // 16
    assert windows > 0
    assert _build.LAUNCHES["cqt"] == _build.LAUNCHES["fingerprint"] == windows
    np.testing.assert_array_equal(got, api.fingerprint(pcm, filters, cfg,
                                                       device=dev)[:got.shape[0]])


def test_wrappers_reject_bad_inputs(dev):
    cfg = HpfwConfig(**SMALL)
    frames = torch.zeros((3, cfg.frame_len), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        frontend.cqt_kernel(frames, cfg)
    spec = torch.zeros((40, cfg.n_bins), device=dev)
    with pytest.raises(ValueError):
        fp_ops.encoder_kernel(spec, torch.zeros((5, 64), device=dev), cfg)
    q = torch.zeros((10, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        matcher.score_tracks_kernel(q, torch.zeros((2, 5, 2), dtype=torch.int32,
                                                   device=dev),
                                    torch.zeros(2, dtype=torch.int32, device=dev))


def _coarse_db(rng, t, lc, c, nc, values):
    d = (rng.choice([-1, 1], (t, lc, c)) if values == "pm1"
         else rng.integers(-16, 17, (t, lc, c))).astype(np.int8)
    for i, ln in enumerate(rng.integers(nc, lc + 1, size=t)):
        d[i, ln:] = 0
    d[3] = d[7]                                       # cross-track ties
    return coarse_scan.flatten_coarse(torch.from_numpy(d))


@pytest.mark.parametrize("c,lc,nc,values", [
    (64, 161, 26, "pm1"), (32, 161, 26, "pm1"), (8, 40, 5, "sum"),
    (24, 700, 9, "pm1"), (64, 26, 26, "sum")])
def test_coarse_kernel_matches_plain(dev, c, lc, nc, values):
    """K4's three surfaces, exact: 60 s rows, C = 8..64, offsets past one
    pass of 256 (lc 700), a single offset (nc == lc), sum-valued prints."""
    rng = np.random.default_rng(c + lc)
    t = 203
    flat = _coarse_db(rng, t, lc, c, nc, values).to(dev)
    qs = torch.from_numpy(rng.choice([-1, 1], (6, nc, c)).astype(np.int8)).to(dev)
    got = coarse_scan.coarse_scan_kernel(qs[0], flat, lc_true=lc)
    want = coarse_scan.coarse_scan_ref(qs[0], flat, lc_true=lc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = coarse_scan.coarse_scan_batch_kernel(qs, flat, lc_true=lc)
    want = coarse_scan.coarse_scan_batch_ref(qs, flat, lc_true=lc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = torch.from_numpy(np.sort(np.stack([rng.permutation(t)[:40] for _ in range(2)]),
                                    axis=1).astype(np.int32)).to(dev)
    q4 = qs.view(2, 3, nc, c)
    got = coarse_scan.coarse_rescan_kernel(q4, flat, rows, lc_true=lc)
    want = coarse_scan.coarse_rescan_ref(q4, flat, rows, lc_true=lc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _tile_ties(geo, n_win, n_off, nc, rows):
    """Ties in rows of a packed chunk: (row, (first offset, equal later
    offset)), the first at a tile's last position, at a tile's first, or the
    later one at a tile's first, in turn where the row has them (tiles of
    PACKED_TILE stream positions in the short body, else PACKED_STEP)."""
    tile = (coarse_scan.PACKED_TILE if geo.lanes == coarse_scan.PACKED_SHORT_LANES
            else coarse_scan.PACKED_STEP)
    plants = []
    for r in rows:
        base = (r % geo.chunk_segs) * n_win
        first = [o for o in range(n_off) if (base + o) % tile == 0]
        last = [o for o in range(n_off) if (base + o) % tile == tile - 1]
        kinds = [[(a, b) for a, b in pairs if a >= 0 and b < n_off]
                 for pairs in ([(o, o + nc) for o in last], [(o, o + nc) for o in first],
                               [(o - nc, o) for o in first])]
        kinds = [k for k in kinds[r % 3:] + kinds[:r % 3] if k]
        if kinds:
            plants.append((r, kinds[0][0]))
    return plants


@pytest.mark.parametrize("c,lc,nc,lanes", [
    (32, 161, 26, 32), (32, 161, 26, 2), (32, 161, 26, 8), (32, 161, 26, 42),
    (64, 161, 26, 8), (64, 161, 26, 32), (8, 40, 5, 42), (24, 161, 9, 16), (24, 161, 9, 32)])
def test_packed_coarse_kernel_matches_plain_and_int8(dev, c, lc, nc, lanes):
    """Packed K4 == its plain version == int8 K4 on the unpacked rows, exactly:
    2-42 lanes (26 windows take the body of two halves, and at 42 lanes, past
    PACKED_LANES, two blocks of it on grid.y; 5 and 9 windows take the short
    body, one 64-lane block: its multi-block cases are in
    test_packed_short_body_matches_plain_and_int8, as are the long body's at
    17 windows and 64-65 lanes, and test_packed_coarse_kernel_long_query
    runs it at 42 lanes over rows in segments), C = 8-64 (C = 24 takes the
    odd packed-word path),
    203 or 204 rows (not a multiple of a chunk's),
    ties at the first and last offset of a tile of the stream, a peak at a
    row's last valid offset before a row that matches at its first, an
    all-negative row whose positions past n_off run into such a row, rows
    zero past their track's end and equal rows."""
    rng = np.random.default_rng(100 + c + lc + lanes)
    geo = coarse_scan.packed_geometry(lc, nc, c)
    n_off = lc - nc + 1
    t = 203 + (203 % geo.chunk_segs == 0)
    assert geo.seg_off == n_off and t % geo.chunk_segs
    qs = rng.choice([-1, 1], (lanes, nc, c)).astype(np.int8)
    qs[0] = 1
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    for i, ln in enumerate(rng.integers(nc, lc + 1, size=t)):
        d[i, ln:] = 0
    full = 6 + 2 * geo.chunk_segs                             # rows of full length
    d[:full] = rng.choice([-1, 1], (full, lc, c))
    ties = _tile_ties(geo, lc, n_off, nc, range(6, full))
    for r, offs in ties:
        for o in offs:
            d[r, o:o + nc] = qs[-1]
    d[1, n_off - 1:] = 1                                      # lane 0: the last valid offset
    d[2, :nc] = 1                                             # the next row matches at 0
    d[3] = -1                                                 # all negative for lane 0
    d[4, :nc] = 1
    d[t - 1] = d[5]
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d)).to(dev)
    packed = coarse_scan.pack_coarse_nibbles(flat)
    q = torch.from_numpy(qs).to(dev)
    got = coarse_scan.coarse_scan_batch_packed_kernel(q, packed, lc_true=lc)
    want = coarse_scan.coarse_scan_batch_packed_ref(q, packed, lc_true=lc)
    int8 = coarse_scan.coarse_scan_batch_kernel(q, flat, lc_true=lc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got, int8):
        assert torch.equal(a, b)
    assert torch.equal(coarse_scan.unpack_coarse_nibbles(packed)[:, :flat.shape[1]], flat)
    assert int(got[1][0, 1]) == n_off - 1 and int(got[1][0, 2]) == 0
    assert int(got[0][0, 3]) == -nc * c and int(got[0][0, 4]) == nc * c
    assert len(ties) >= 3
    for r, offs in ties:
        assert int(got[0][lanes - 1, r]) == nc * c and int(got[1][lanes - 1, r]) == offs[0]


@pytest.mark.parametrize("lc,nc,c,lanes", [(161, 97, 64, 3), (3000, 200, 32, 42)])
def test_packed_coarse_kernel_long_query(dev, lc, nc, c, lanes):
    """Packed K4 on queries too long for shared memory to hold at once (their
    blocks of 32 windows staged a_blocks at a time, for each tile), on whole
    rows and on long rows in segments: equal to its plain version and to
    int8 K4, with a planted peak and an all-negative row."""
    rng = np.random.default_rng(lc + nc + lanes)
    geo = coarse_scan.packed_geometry(lc, nc, c)
    assert geo.a_blocks < -(-nc // 32)
    t = 40
    qs = rng.choice([-1, 1], (lanes, nc, c)).astype(np.int8)
    qs[0] = 1
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    d[1, lc - nc - 3:lc - 3] = qs[-1]                        # a peak 3 offsets before the last
    d[2] = -1                                                 # all negative for lane 0
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d)).to(dev)
    packed = coarse_scan.pack_coarse_nibbles(flat)
    q = torch.from_numpy(qs).to(dev)
    got = coarse_scan.coarse_scan_batch_packed_kernel(q, packed, lc_true=lc)
    want = coarse_scan.coarse_scan_batch_packed_ref(q, packed, lc_true=lc)
    int8 = coarse_scan.coarse_scan_batch_kernel(q, flat, lc_true=lc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got, int8):
        assert torch.equal(a, b)
    assert int(got[1][lanes - 1, 1]) == lc - nc - 3
    assert int(got[0][0, 2]) == -nc * c and int(got[1][0, 2]) == 0


@pytest.mark.parametrize("lc,nc,c,lanes", [
    (161, 1, 64, 1), (161, 3, 8, 63), (161, 7, 32, 512), (161, 7, 64, 65), (161, 16, 32, 64),
    (161, 16, 8, 1), (161, 17, 32, 65), (3000, 1, 32, 64), (3000, 3, 32, 512),
    (3000, 7, 8, 65), (3000, 16, 64, 63), (3000, 17, 64, 64)])
def test_packed_short_body_matches_plain_and_int8(dev, lc, nc, c, lanes):
    """The short packed body (queries of up to PACKED_HALF windows, 64 lanes a
    block; nc = 17 the body of two halves) == its plain version == int8 K4 on
    the unpacked rows, exactly: nc 1-17, 1-512 lanes (either side of a block
    of 64), C = 8-64, rows of 161 windows (whole rows, several a chunk; ties
    at the edges of its tiles) and of 3,000 (segments; a tie across a segment
    boundary), an all-negative row and rows zero past their track's end."""
    rng = np.random.default_rng(lc + nc + c + lanes)
    geo = coarse_scan.packed_geometry(lc, nc, c)
    n_off = lc - nc + 1
    short = nc <= coarse_scan.PACKED_HALF
    assert geo.lanes == (coarse_scan.PACKED_SHORT_LANES if short else coarse_scan.PACKED_LANES)
    whole = geo.seg_off == n_off
    assert whole == (lc == 161)
    t = 2 * geo.chunk_segs + 9 if whole else 24
    qs = rng.choice([-1, 1], (lanes, nc, c)).astype(np.int8)
    qs[0] = 1
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    for i, ln in enumerate(rng.integers(nc, lc + 1, size=t)):
        d[i, ln:] = 0
    full = 6 + 2 * geo.chunk_segs if whole else 6          # rows of full length
    d[:full] = rng.choice([-1, 1], (full, lc, c))
    if whole:
        ties = _tile_ties(geo, lc, n_off, nc, range(6, full))
        assert len(ties) >= 3
    else:
        bp = geo.seg_off                                      # the first segment boundary
        ties = [(5, (bp - 30, bp + 5))]                       # a tie across it
    for r, offs in ties:
        for o in offs:
            d[r, o:o + nc] = qs[-1]
    d[1, n_off - 1:] = 1                                      # lane 0: the last valid offset
    d[2, :nc] = 1                                             # the next row matches at 0
    d[3] = -1                                                 # all negative for lane 0
    d[4, :nc] = 1
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d)).to(dev)
    packed = coarse_scan.pack_coarse_nibbles(flat)
    q = torch.from_numpy(qs).to(dev)
    got = coarse_scan.coarse_scan_batch_packed_kernel(q, packed, lc_true=lc)
    want = coarse_scan.coarse_scan_batch_packed_ref(q, packed, lc_true=lc)
    int8 = coarse_scan.coarse_scan_batch_kernel(q, flat, lc_true=lc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got, int8):
        assert torch.equal(a, b)
    assert int(got[1][0, 1]) == n_off - 1 and int(got[1][0, 2]) == 0
    assert int(got[0][0, 3]) == -nc * c and int(got[1][0, 3]) == 0
    assert int(got[0][0, 4]) == nc * c
    for r, offs in ties:
        assert int(got[0][lanes - 1, r]) == nc * c and int(got[1][lanes - 1, r]) == offs[0]


def test_packed_body_is_chosen_by_the_query_length(dev):
    """One pass-1 launch a call, named as the roofline reads it: the short
    body, coarse_kernel<8, true>, for queries of up to PACKED_HALF windows,
    and coarse_kernel<4, true> for 17 and 26."""
    rng = np.random.default_rng(23)
    lc = 161
    d = rng.choice([-1, 1], (50, lc, 32)).astype(np.int8)
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d)).to(dev)
    packed = coarse_scan.pack_coarse_nibbles(flat)
    for nc in (1, 7, 16, 17, 26):
        q = torch.from_numpy(rng.choice([-1, 1], (70, nc, 32)).astype(np.int8)).to(dev)
        coarse_scan.coarse_scan_batch_packed_kernel(q, packed, lc_true=lc)   # built and warm
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            coarse_scan.coarse_scan_batch_packed_kernel(q, packed, lc_true=lc)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if re.search(r"\bcoarse_kernel<\d+, true>", e.name)]
        body = f"coarse_kernel<{8 if nc <= coarse_scan.PACKED_HALF else 4}, true>"
        assert len(names) == 1 and body in names[0], (nc, names)


@pytest.mark.parametrize("lc,c,nc,lanes", [
    (3000, 64, 26, 1), (5000, 32, 26, 16), (3000, 8, 7, 2), (3002, 24, 26, 3),
    (3000, 40, 10, 9), (5000, 56, 26, 17), (3000, 64, 26, 16), (5000, 32, 26, 42),
    (3000, 64, 26, 32)])
def test_coarse_kernel_long_rows(dev, lc, c, nc, lanes):
    """K4 on rows past the old shared-memory limit (3,000 and 5,000 windows,
    several chunks each), C = 8..64, n_off not a multiple of 16, 1-42 lanes:
    every surface equal to its plain version, packed equal to int8, with
    ties inside a row and across a chunk boundary (the int8 body's and the
    packed body's segments) and all-negative rows."""
    rng = np.random.default_rng(lc + c + lanes)
    t = 40
    chunk_off, _ = coarse_scan.scan_geometry(lc, nc, c, lanes)
    b = chunk_off                                             # the first chunk boundary
    assert (lc - nc + 1) % 16 and lc - nc + 1 > 2 * chunk_off
    bp = coarse_scan.packed_geometry(lc, nc, c).seg_off      # the packed body's
    split = bp < lc - nc + 1                                  # first segment boundary
    qs = rng.choice([-1, 1], (lanes, nc, c)).astype(np.int8)
    qs[0] = 1
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    for i, ln in enumerate(rng.integers(lc // 2, lc + 1, size=t)):
        d[i, ln:] = 0
    d[:6, :] = rng.choice([-1, 1], (6, lc, c))                # full-length rows
    d[0, b - 20:b - 20 + nc] = qs[-1]                         # tie across the boundary
    d[0, b + 10:b + 10 + nc] = qs[-1]
    d[1, 100:100 + nc] = qs[-1]                               # tie inside a chunk
    d[1, 140:140 + nc] = qs[-1]
    d[2, b - 1:b - 1 + nc] = qs[-1]                           # last offset of chunk 0
    d[3] = -1                                                 # all negative for lane 0
    d[4] = -1                                                 # ... but for a zero tail:
    d[4, lc - nc - 5:] = 0                                    # 0 first at a padded offset
    if split:
        d[5, bp - 30:bp - 30 + nc] = qs[-1]                   # tie across the packed boundary
        d[5, bp + 5:bp + 5 + nc] = qs[-1]
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d)).to(dev)
    packed = coarse_scan.pack_coarse_nibbles(flat)
    q = torch.from_numpy(qs).to(dev)
    got = coarse_scan.coarse_scan_batch_kernel(q, flat, lc_true=lc)
    want = coarse_scan.coarse_scan_batch_ref(q, flat, lc_true=lc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][lanes - 1, 0]) == b - 20 and int(got[1][lanes - 1, 1]) == 100
    assert int(got[1][lanes - 1, 2]) == b - 1
    assert int(got[0][0, 3]) == -nc * c and int(got[1][0, 3]) == 0
    assert int(got[0][0, 4]) == 0 and int(got[1][0, 4]) == lc - nc - 5
    assert not split or int(got[1][lanes - 1, 5]) == bp - 30
    got_p = coarse_scan.coarse_scan_batch_packed_kernel(q, packed, lc_true=lc)
    assert torch.equal(got_p[0], got[0]) and torch.equal(got_p[1], got[1])
    one = coarse_scan.coarse_scan_kernel(q[0], flat, lc_true=lc)
    assert torch.equal(one[0], got[0][0]) and torch.equal(one[1], got[1][0])
    rows = torch.from_numpy(np.sort(rng.integers(0, t, (2, 24)), axis=1).astype(np.int32)).to(dev)
    q4 = q[None].expand(2, -1, -1, -1).contiguous()
    got_r = coarse_scan.coarse_rescan_kernel(q4, flat, rows, lc_true=lc)
    want_r = coarse_scan.coarse_rescan_ref(q4, flat, rows, lc_true=lc)
    assert torch.equal(got_r[0], want_r[0]) and torch.equal(got_r[1], want_r[1])


@pytest.mark.parametrize("t,w", [(1, 16), (37, 2688), (1000, 10368), (5, 0)])
def test_row_sum_kernel_matches_plain(dev, t, w):
    rng = np.random.default_rng(t + w)
    db = torch.from_numpy(rng.integers(-128, 128, (t, w)).astype(np.int8)).to(dev)
    got = probe.row_sum_kernel(db)
    assert torch.equal(got, probe.row_sum_ref(db))
    assert torch.equal(got, torch.sum(db, dim=1, dtype=torch.int32))


def test_row_sum_kernel_rejects_unaligned_rows(dev):
    with pytest.raises(ValueError, match="16-byte"):
        probe.row_sum_kernel(torch.zeros((4, 24), dtype=torch.int8, device=dev))
    with pytest.raises(ValueError):
        probe.row_sum_kernel(torch.zeros((4, 32), dtype=torch.int32, device=dev))


def test_fine_kernel_matches_plain(dev):
    rng = np.random.default_rng(8)
    t, l, n, n_fine = 40, 700, 300, 45
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    lengths = rng.integers(0, l + 1, t).astype(np.int32)
    lengths[:4] = [l, 150, 0, 299]
    qs = rng.integers(0, 2 ** 32, (3, n, 2), dtype=np.uint32)
    prints[0, 200:200 + n] = qs[0]
    for i, ln in enumerate(lengths):
        prints[i, ln:] = 0
    tracks = rng.integers(0, t, (3, 64)).astype(np.int32)
    starts = rng.integers(0, l - n - n_fine, (3, 64)).astype(np.int32)
    tracks[0, :6], starts[0, :6] = [0, 0, 1, 2, 3, 3], [180, 180, 0, 0, 0, 10]
    args = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
            for a in (qs, prints, lengths, tracks, starts)]
    got = fine.fine_rescan_kernel(*args, n_fine=n_fine)
    want = fine.fine_rescan_ref(*args, n_fine=n_fine)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0][0, 0]) == 64 * n and int(got[1][0, 0]) == 200


@pytest.mark.parametrize("n,n_fine", [(1, 1), (1, 65), (430, 1), (430, 32), (430, 33),
                                     (430, 65), (2000, 33)])
def test_fine_kernel_bands_and_lengths(dev, n, n_fine):
    """K5 equal to its plain version for bands of 1-65 offsets (one to two
    passes of 48 rows) and queries of 1-2,000 prints, with tracks shorter
    than the query, random prints past every length (the kernel must not
    read them as zeros), out-of-range track indices, negative starts, a
    ragged last block of candidates and planted ties."""
    rng = np.random.default_rng(n * 100 + n_fine)
    t, l = 50, 3000
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    lengths = rng.integers(0, l + 1, t).astype(np.int32)
    lengths[:4] = [l, n // 2, 0, n]
    # A query of period 10 planted as a longer run: equal peaks at offsets
    # 500 and 510 of track 0, and the first wins.
    run = np.tile(rng.integers(0, 2 ** 32, (10, 2), dtype=np.uint32), (n // 10 + 2, 1))
    qs = rng.integers(0, 2 ** 32, (3, n, 2), dtype=np.uint32)
    qs[0] = run[:n]
    prints[0, 500:510 + n] = run[:n + 10]
    k = 100
    tracks = rng.integers(0, t, (3, k)).astype(np.int32)
    starts = rng.integers(-8, l - n, (3, k)).astype(np.int32)
    tracks[0, :8] = [0, 0, 1, 2, 3, -1, t, t + 7]
    starts[0, :8] = [500 - n_fine // 2, 500, 0, 0, 0, 10, 10, 10]
    args = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
            for a in (qs, prints, lengths, tracks, starts)]
    got = fine.fine_rescan_kernel(*args, n_fine=n_fine)
    want = fine.fine_rescan_ref(*args, n_fine=n_fine)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0][0, 1]) == 64 * n and int(got[1][0, 1]) == 500
    if n_fine > 20:
        assert int(got[1][0, 0]) == 500


@pytest.mark.parametrize("preset", ["default", "catalog_scale", "catalog_scale_pack4"])
def test_two_stage_on_card_matches_cpu_and_counts_launches(dev, preset):
    cfg = (HpfwConfig(db_downsample=8) if preset == "default"
           else HpfwConfig.catalog_scale(db_downsample=8,
                                         coarse_prefilter_pack4=preset.endswith("pack4")))
    rng = np.random.default_rng(5)
    t, l, n = 61, 400, 96
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(t)], prints, np.full(t, l, np.int32),
                           device="cpu")
    qs = np.stack([prints[i, o:o + n] for i, o in ((3, 5), (40, 133), (60, 250))])
    on_cpu = TwoStageDB(db)
    _build.reset_launch_counts()
    on_card = TwoStageDB(db, device=dev)
    for q in qs:
        a, b = on_card.match(q, top_k=5, pool=16), on_cpu.match(q, top_k=5, pool=16)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    for a, b in zip(on_card.match_batch(qs, top_k=5, pool=16),
                    on_cpu.match_batch(qs, top_k=5, pool=16)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    used = {k for k in ("coarse_scan", "coarse_scan_batch", "coarse_scan_batch_packed",
                        "coarse_rescan", "fine_rescan") if _build.LAUNCHES[k]}
    assert used == {"default": {"coarse_scan", "coarse_scan_batch", "fine_rescan"},
                    "catalog_scale": {"coarse_scan_batch", "coarse_rescan", "fine_rescan"},
                    "catalog_scale_pack4": {"coarse_scan_batch_packed", "coarse_rescan",
                                            "fine_rescan"}}[preset]


def test_match_server_on_card_equals_match(dev):
    """The server's dispatcher stream, pinned copies and events give
    ts.match's answers, for lone queries and for batches that fill."""
    cfg = HpfwConfig.catalog_scale(db_downsample=8, coarse_prefilter_pack4=True)
    rng = np.random.default_rng(6)
    t, l, n = 61, 400, 96
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(t)], prints, np.full(t, l, np.int32),
                           device=dev)
    ts = TwoStageDB(db)
    qs = [prints[i, o:o + n] for i, o in ((3, 5), (40, 133), (60, 250), (7, 0), (11, 77))]
    want = [ts.match(q, pool=16) for q in qs]
    with MatchServer(ts, n, max_batch=4, max_wait_ms=20.0, pool=16) as srv:
        srv.warmup(qs[0])
        alone = [srv.match(q) for q in qs]
        together = [f.result(timeout=60) for f in [srv.submit(q) for q in qs * 3]]
    for got, w in zip(alone + together, want + want * 3):
        assert got[0] == w[0]
        np.testing.assert_array_equal(got[1], w[1])
        np.testing.assert_array_equal(got[2], w[2])


def _graph_catalog(dev, b):
    """A packed catalog_scale() DB of 61 random tracks on the card and on
    the CPU, and three batches of b excerpts of its tracks."""
    cfg = HpfwConfig.catalog_scale(db_downsample=8, coarse_prefilter_pack4=True)
    rng = np.random.default_rng(7)
    t, l, n = 61, 400, 96
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(t)], prints, np.full(t, l, np.int32),
                           device="cpu")
    batches = []
    for _ in range(3):
        rows, offs = rng.integers(0, t, b), rng.integers(0, l - n, b)
        qs = np.stack([prints[r, o:o + n] for r, o in zip(rows, offs)]).view(np.int32)
        batches.append(torch.from_numpy(qs).to(dev))
    return db, batches


def _dispatches(first):
    return [s.attrs["graphed"] for s in profiling.spans()
            if s.name == "match.dispatch" and s.sid > first]


@pytest.mark.parametrize("b", [1, 4, 16, 21, 63])
def test_graphed_dispatch_equals_eager_and_cpu(dev, b):
    """dispatch_batch's CUDA graph (the second call of a key captures it,
    later calls replay it on new queries) gives the eager dispatch's
    (B, 3, K) bit for bit, and the CPU DB's."""
    db, batches = _graph_catalog(dev, b)
    ts, on_cpu = TwoStageDB(db, device=dev), TwoStageDB(db)
    first = profiling.new_id()
    calls = [batches[0], batches[0], batches[1], batches[2], batches[0]]
    outs = [ts.dispatch_batch(q, pool=16) for q in calls]
    assert _dispatches(first) == [False, True, True, True, True]
    assert len(ts._graphs) == 1
    for q, got in zip(calls, outs):
        eager = TwoStageDB(db, device=dev).dispatch_batch(q, pool=16)   # a first call
        assert torch.equal(got, eager)
        assert torch.equal(got.cpu(), on_cpu.dispatch_batch(q.cpu(), pool=16))


def test_graph_results_held_across_replays(dev):
    """Two results of one key held across a third replay keep their values:
    each replay returns its own copy of the static output."""
    db, batches = _graph_catalog(dev, 4)
    ts = TwoStageDB(db, device=dev)
    want = [TwoStageDB(db, device=dev).dispatch_batch(q, pool=16) for q in batches]
    ts.dispatch_batch(batches[2], pool=16)
    held = [ts.dispatch_batch(q, pool=16) for q in batches[:2]]    # capture, replay
    third = ts.dispatch_batch(batches[2], pool=16)
    torch.cuda.synchronize()
    assert len(ts._graphs) == 1
    assert torch.equal(held[0], want[0]) and torch.equal(held[1], want[1])
    assert torch.equal(third, want[2]) and not torch.equal(held[0], held[1])


def test_graph_replays_count_launches_as_eager(dev):
    """_build.LAUNCHES after N calls of one key (one eager, one capture and
    replay, N - 2 replays) equals N eager calls'."""
    db, batches = _graph_catalog(dev, 16)
    _build.reset_launch_counts()
    TwoStageDB(db, device=dev).dispatch_batch(batches[0], pool=16)
    once = dict(_build.LAUNCHES)
    assert once["coarse_scan_batch_packed"] == once["coarse_rescan"] == 1
    ts = TwoStageDB(db, device=dev)
    _build.reset_launch_counts()
    for k in range(5):
        ts.dispatch_batch(batches[k % 3], pool=16)
    assert len(ts._graphs) == 1
    assert _build.LAUNCHES == {k: 5 * v for k, v in once.items()}


def test_graph_keys_by_stream_and_cap(dev):
    """A key is per stream: the same shape on two streams makes two graphs,
    each replayed on its own stream; past graphs.CAP keys, calls run eager."""
    db, batches = _graph_catalog(dev, 4)
    ts = TwoStageDB(db, device=dev)
    want = TwoStageDB(db, device=dev).dispatch_batch(batches[1], pool=16)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    for stream in (torch.cuda.current_stream(dev), side):
        with torch.cuda.stream(stream):
            ts.dispatch_batch(batches[0], pool=16)
            ts.dispatch_batch(batches[0], pool=16)
            got = ts.dispatch_batch(batches[1], pool=16)
        torch.cuda.current_stream(dev).wait_stream(stream)
        assert torch.equal(got, want)
    assert len(ts._graphs) == 2
    first = profiling.new_id()
    for pool in range(24, 24 + 8 * graphs.CAP, 8):
        ts.dispatch_batch(batches[0], pool=pool)
        ts.dispatch_batch(batches[0], pool=pool)
    assert len(ts._graphs) == graphs.CAP
    assert _dispatches(first)[-2:] == [False, False]


def test_graph_captures_from_two_threads_on_one_stream(dev):
    """Two threads on one stream, each with a key of its own due to capture
    at the same call: the stream's captures go one at a time (a thread that
    finds one under way runs eager), none fails, every result equals the
    eager dispatch's, and both keys end with a graph."""
    db, small = _graph_catalog(dev, 4)
    _, large = _graph_catalog(dev, 16)
    ts = TwoStageDB(db, device=dev)
    want = {b: [TwoStageDB(db, device=dev).dispatch_batch(q, pool=16) for q in qs]
            for b, qs in ((4, small), (16, large))}
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    barrier = threading.Barrier(2)
    got, errors = {4: [], 16: []}, []

    def work(b, qs):
        try:
            with torch.cuda.stream(stream):
                for k in range(6):
                    barrier.wait(timeout=120)
                    got[b].append(ts.dispatch_batch(qs[k % 3], pool=16))
        except Exception as e:          # reported below
            errors.append(e)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        threads = [threading.Thread(target=work, args=a) for a in ((4, small), (16, large))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads)
    assert not [w for w in caught if "capture failed" in str(w.message)]
    assert len(ts._graphs) == len(ts._graphs._graphs) == 2
    for b in (4, 16):
        assert len(got[b]) == 6
        for k, out in enumerate(got[b]):
            assert torch.equal(out, want[b][k % 3])


def test_server_restarts_on_one_db_drop_their_graphs(dev):
    """MatchServers started and closed in turn on one DB: each captures its
    buckets in warm-up, answers by a replay, and drops its streams' graphs
    when it closes, so the DB never holds more than one server's graphs."""
    db, batches = _graph_catalog(dev, 1)
    ts = TwoStageDB(db, device=dev)
    q = batches[0][0].cpu().numpy().view(np.uint32)
    want = ts.match(q, pool=16)
    for _ in range(6):
        with MatchServer(ts, q.shape[0], max_batch=4, pool=16) as srv:
            srv.warmup(q)
            assert len(ts._graphs) == 2                   # buckets 1 and 4
            first = profiling.new_id()
            got = srv.match(q)
        assert _dispatches(first) == [True]
        assert len(ts._graphs) == 0
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_coarse_and_fine_wrappers_reject_bad_inputs(dev):
    flat = torch.zeros((4, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        coarse_scan.coarse_scan_kernel(torch.zeros((3, 12), dtype=torch.int8, device=dev),
                                       flat, lc_true=2)
    with pytest.raises(ValueError):
        coarse_scan.coarse_scan_kernel(torch.zeros((3, 64), dtype=torch.int8), flat,
                                       lc_true=2)
    z = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fine.fine_rescan_kernel(torch.zeros((1, 10, 2), dtype=torch.int32, device=dev),
                                torch.zeros((2, 5, 2), dtype=torch.int32, device=dev),
                                torch.zeros(3, dtype=torch.int32, device=dev), z, z,
                                n_fine=3)


def _plain_on_card(monkeypatch):
    """Route every CQT and encoder call through the plain versions (on the
    card too), as the launch counters then show."""
    monkeypatch.setattr(frontend, "cqt_from_frames", frontend.cqt_from_frames_ref)
    monkeypatch.setattr(fp_ops, "fingerprint_from_spec", fp_ops.fingerprint_from_spec_ref)


@pytest.mark.parametrize("cfg_kw,seconds", [(SMALL, 3.0), ({}, 12.0)])
def test_accumulate_track_on_card_matches_plain(dev, cfg_kw, seconds, monkeypatch):
    """Filter learning's moments through K1 against the plain CQT on the
    card: the same count, X^T X and sum X to rtol 1e-4 (K1 is within 1e-4 of
    its plain version), and filters within |cos| > 0.98."""
    cfg = HpfwConfig(**cfg_kw)
    corpus = [synth.synth_track(50 + i, seconds, cfg) for i in range(2)]
    _build.reset_launch_counts()
    state = pca.CovarianceState.zero(cfg)
    for t in corpus:
        state = pca.accumulate_track(state, t, cfg, device=dev)
    assert _build.LAUNCHES["cqt"] == 2
    with monkeypatch.context() as m:
        _plain_on_card(m)
        _build.reset_launch_counts()
        plain = pca.CovarianceState.zero(cfg)
        for t in corpus:
            plain = pca.accumulate_track(plain, t, cfg, device=dev)
        assert _build.LAUNCHES["cqt"] == 0
    assert state.count == plain.count == 2 * (cfg.n_frames(len(corpus[0])) - cfg.context_w + 1)
    np.testing.assert_allclose(state.xtx, plain.xtx, rtol=1e-4)
    np.testing.assert_allclose(state.xsum, plain.xsum, rtol=1e-4)
    cos = np.abs(np.sum(pca.finalize_filters(state, cfg).astype(np.float64)
                        * pca.finalize_filters(plain, cfg), axis=0))
    assert np.all(cos > 0.98), cos.min()


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_scan_identity_row_equals_fingerprint_on_card(dev, interp):
    """fingerprint_scan_batch on the card at V = 21: the identity row equals
    fingerprint_batch bit for bit; every variant's K2 prints, the slow
    hypotheses' repeated clamped last frames included, are within K2's bar of
    the plain encoder on the same variant spectrum."""
    cfg = HpfwConfig()
    filters = _filters(cfg)
    pcm = np.stack([synth.synth_track(60 + i, 10.0, cfg) for i in range(2)])
    got = api.fingerprint_scan_batch(pcm, filters, cfg, span=0.03, pitch_span_bins=1,
                                     interp=interp, device=dev)
    assert got.shape == (2, 21, cfg.n_hashprints(pcm.shape[1]), 2)
    np.testing.assert_array_equal(got[:, 10], api.fingerprint_batch(pcm, filters, cfg,
                                                                    device=dev))
    filt = filters_from_jax(filters, cfg, dev)
    hyps = api.scan_hypotheses(cfg, span=0.03, pitch_span_bins=1)
    spec = frontend.cqt(torch.from_numpy(pcm[0]).to(dev), cfg)
    for v, sv in enumerate(api.scan_spectra(spec, hyps, interp)):
        pk = fp_ops.encoder_kernel(sv, filt, cfg)
        assert np.array_equal(got[0, v], pk.cpu().numpy().view(np.uint32)), v
        pr = fp_ops.fingerprint_from_spec_ref(sv, filt, cfg)
        assert _bits(pk, pr) <= max(2, pk.numel() * 32 // 10000), (v, hyps[v])


def test_fingerprint_multi_on_card_equals_per_bank(dev):
    """fingerprint_multi at A = 6 banks: one K1 launch, six K2 launches, each
    row fingerprint() under its bank bit for bit and within K2's bar of the
    plain versions."""
    cfg = HpfwConfig()
    stack = np.stack([_filters(cfg, seed=s) for s in range(6)])
    pcm = synth.synth_track(70, 10.0, cfg)
    _build.reset_launch_counts()
    multi = api.fingerprint_multi(pcm, stack, cfg, device=dev)
    assert (_build.LAUNCHES["cqt"], _build.LAUNCHES["fingerprint"]) == (1, 6)
    assert multi.shape == (6, cfg.n_hashprints(len(pcm)), 2)
    plain = api.fingerprint_multi(pcm, stack, cfg, device="cpu")
    for a in range(6):
        np.testing.assert_array_equal(multi[a], api.fingerprint(pcm, stack[a], cfg,
                                                                device=dev))
        assert _bits(torch.from_numpy(multi[a].view(np.int32)),
                     torch.from_numpy(plain[a].view(np.int32))) <= max(2, multi[a].size
                                                                       * 32 // 10000)


def _rendition(pcm, start_s, seconds, cfg, seed):
    """A noisy excerpt played 2.9% fast and +0.5 semitone (one CQT bin)."""
    clip = synth.make_query(pcm, start_s, 1.05 * seconds, cfg, noise_db=-20.0, seed=seed)
    return synth.pitch_shift(clip, 0.5, cfg)[:int(seconds * cfg.sample_rate)]


def _plain_matcher_on_card(monkeypatch):
    """Route the two-stage matcher's K4 and K5 calls through their plain
    versions (on the card too). Dispatches run eager: a CUDA graph captured
    earlier would replay the kernels without calling these names."""
    from hpfw_tpu_torch.match import scaled
    monkeypatch.setattr(graphs.DispatchGraphs, "run",
                        lambda self, device, key, queries, fn: (fn(queries), False))
    for name, ref in (("coarse_scan", coarse_scan.coarse_scan_ref),
                      ("coarse_scan_batch", coarse_scan.coarse_scan_batch_ref),
                      ("coarse_scan_batch_packed", coarse_scan.coarse_scan_batch_packed_ref),
                      ("coarse_rescan", coarse_scan.coarse_rescan_ref),
                      ("fine_rescan_batch", fine.fine_rescan_ref)):
        monkeypatch.setattr(scaled, name, ref)


def _drive(sess, live, step):
    """Per feed: the lock state, the top track, and for a matching feed the
    query window, the scan stack and the window's top hit."""
    stacks = []
    real = sess._scan_stack

    def recorded(n, factors):
        stacks.append(real(n, factors))
        return stacks[-1]

    sess._scan_stack = recorded
    out = []
    for p in range(0, len(live), step):
        n_match, n_stacks = len(sess.match_latencies_ms), len(stacks)
        best = sess.feed(live[p:p + step])
        rec = [(sess._scan_state, sess.tempo, sess.pitch), best and best.track_id]
        if len(sess.match_latencies_ms) > n_match:
            rec += [np.array(sess._ring, np.uint32)[-max(b for b in sess.query_buckets
                                                         if b <= len(sess._ring)):],
                    stacks[-1] if len(stacks) > n_stacks else None, sess.last_match]
        out.append(rec)
    return out


def test_spec_scan_session_on_card_equals_plain(dev, monkeypatch):
    """A tempo x pitch spec-scan session over a TwoStageDB on the card
    (K1, K2, K4, K5) against the same session through the plain versions on
    the card: the same lock states and top tracks every feed, and the same
    window top hit wherever the window's and the scan's prints are equal."""
    cfg = HpfwConfig(stretch_span=0.03, pitch_span_bins=1)
    filters = _filters(cfg)
    tracks = synth.synth_catalog(12, 20.0, cfg)
    db = api.build_db(tracks, filters, cfg, device=dev)
    ts = TwoStageDB(db, stride=4)
    live = _rendition(tracks[5], 2.0, 12.0, cfg, seed=1)
    step = cfg.sample_rate // 4
    _build.reset_launch_counts()
    card = _drive(StreamingSession(ts, filters, cfg, query_prints=128, chunk_prints=32),
                  live, step)
    assert all(_build.LAUNCHES[k] for k in ("cqt", "fingerprint", "coarse_scan_batch",
                                            "fine_rescan"))
    _plain_on_card(monkeypatch)
    _plain_matcher_on_card(monkeypatch)
    _build.reset_launch_counts()
    plain = _drive(StreamingSession(ts, filters, cfg, query_prints=128, chunk_prints=32),
                   live, step)
    assert not any(_build.LAUNCHES.values())
    equal = 0
    for a, b in zip(card, plain):
        assert a[:2] == b[:2] and len(a) == len(b)
        if len(a) > 2 and np.array_equal(a[2], b[2]) and (
                (a[3] is None and b[3] is None)
                or (a[3] is not None and b[3] is not None and np.array_equal(a[3], b[3]))):
            assert a[4] == b[4]
            equal += 1
    assert equal > 0
    assert card[-1][:2] == [("track", card[-1][0][1], 1), "5"]
    assert abs(card[-1][0][1] - 1.03) <= 0.01 + 1e-9


def test_escalating_server_on_card_equals_api(dev):
    """EscalatingMatchServer on the card (two streams, the spectra handed
    from the rigid to the scan stream) gives match_scan_escalating's answers
    and flags, alone and in batches, with and without the structure gate."""
    from hpfw_tpu_torch import EscalatingMatchServer
    cfg = HpfwConfig()
    filters = _filters(cfg)
    tracks = synth.synth_catalog(12, 20.0, cfg)
    ts = TwoStageDB(api.build_db(tracks, filters, cfg, device=dev), stride=4)
    pcms = np.stack([synth.make_query(tracks[i], 2.0, 8.0, cfg, noise_db=-20.0, seed=i)
                     for i in range(3)] + [_rendition(tracks[i], 2.0, 8.0, cfg, seed=i)
                                           for i in range(3, 6)])
    kw = dict(span=0.03, pitch_span_bins=1)
    for gate in (None, 0.75):
        st: dict = {}
        want = api.match_scan_escalating(pcms, filters, ts, cfg, structure_gate=gate,
                                         stats=st, **kw)
        with EscalatingMatchServer(ts, filters, pcms.shape[1], max_batch=4,
                                   max_wait_ms=20.0, structure_gate=gate, **kw) as srv:
            srv.warmup(pcms[0])
            for got in ([srv.match(p) for p in pcms],
                        [f.result(timeout=120)
                         for f in [srv.submit(p) for p in list(pcms) * 3]]):
                for k, (ids, sc, off, esc) in enumerate(got):
                    w = want[k % len(pcms)]
                    assert list(ids) == list(w[0]) and esc == (k % len(pcms) in st["escalated"])
                    np.testing.assert_array_equal(sc, w[1])
                    np.testing.assert_array_equal(off, w[2])
            stats = dict(srv.stats)
        assert stats["escalated"] == 4 * len(st["escalated"]) > 0
        assert stats["confident"] + stats["structure_kept"] + stats["escalated"] == 4 * len(pcms)
        assert [w[0][0] for w in want] == [str(i) for i in range(6)]


def test_fingerprint_stream_on_card_equals_batch(dev):
    """Copy-stream uploads, events and pinned copies: every yielded batch
    equals fingerprint_batch bit for bit, in order, batch sizes 1-4."""
    cfg = HpfwConfig()
    filters = _filters(cfg)
    base = synth.synth_track(80, 30.0, cfg)
    batches = [np.stack([np.roll(base, 1000 * (7 * i + j)) for j in range(1 + i % 4)])
               for i in range(6)]
    _build.reset_launch_counts()
    got = list(api.fingerprint_stream(iter(batches), filters, cfg, device=dev))
    assert _build.LAUNCHES["cqt"] == _build.LAUNCHES["fingerprint"] == sum(map(len, batches))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(g, api.fingerprint_batch(b, filters, cfg, device=dev))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 63, 64, 65, 1000, (1 << 20) + 3])
def test_stream_copy_equals_the_source(dev, n):
    """csrc/stage.cu's streaming-store copy, the staging's host copy, at every
    head and tail length and alignment: the source's bytes, none past them."""
    rng = np.random.default_rng(n)
    src = rng.integers(0, 256, n + 16, dtype=np.uint8)
    for so, do in ((0, 0), (3, 5), (16, 1)):
        dst = np.zeros(n + 32, np.uint8)
        _build.library().hpfw_stream_copy(dst[do:].ctypes.data, src[so:].ctypes.data, n)
        np.testing.assert_array_equal(dst[do:do + n], src[so:so + n])
        assert not dst[:do].any() and not dst[do + n:].any()


def test_fingerprint_stream_on_card_reuses_staging_blocks(dev):
    """Ten batches of two shapes, each several staging chunks (the second's
    last chunk shorter), so each pinned block is reused, read by a consumer
    that sleeps between batches: every batch equals fingerprint_batch bit
    for bit, K1 and K2 run once a track, and no staging thread is left."""
    cfg = HpfwConfig()
    filters = _filters(cfg)
    base = synth.synth_track(81, 240.0, cfg)
    shapes = [(4, base.shape[0]), (7, 150 * cfg.sample_rate + 77)]
    batches = [np.stack([np.roll(base, 1000 * (5 * i + j))[:shapes[i % 2][1]]
                         for j in range(shapes[i % 2][0])]) for i in range(10)]
    assert all(b.nbytes >= 2 * api._STAGE_MIN_CHUNK_BYTES for b in batches)
    _build.reset_launch_counts()
    got = []
    for out in api.fingerprint_stream(iter(batches), filters, cfg, device=dev):
        got.append(out)
        time.sleep(0.05)
    assert _build.LAUNCHES["cqt"] == _build.LAUNCHES["fingerprint"] == sum(map(len, batches))
    assert len(got) == len(batches)
    assert not [t for t in threading.enumerate() if t.name.startswith("hpfw-stage")]
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(g, api.fingerprint_batch(b, filters, cfg, device=dev))


def test_build_db_from_files_on_card_equals_build_db(dev, tmp_path):
    """Files through native decode and bucket-padded batches on the card:
    the ids and lengths of build_db over the decoded PCM, and each track's
    prints within K2's bar of them."""
    from hpfw_tpu_torch.io import ingest, wav
    cfg = HpfwConfig()
    filters = _filters(cfg)
    paths = []
    for k in range(7):
        pcm = synth.synth_track(90 + k, 6.0 + 3.0 * k, cfg)
        paths.append(str(tmp_path / f"t{k}.wav"))
        wav.save_wav(paths[-1], np.stack([pcm, pcm[::-1]], axis=1), cfg.sample_rate)
    got = api.build_db_from_files(paths, filters, cfg, batch=3, bucket_seconds=10.0,
                                  device=dev)
    pcms = ingest.load_files(paths, cfg)
    want = api.build_db(dict(zip(paths, pcms)), filters, cfg, device=dev)
    assert got.track_ids == want.track_ids and got.device == want.device
    np.testing.assert_array_equal(got.lengths, want.lengths)
    for t in range(len(paths)):
        n = int(got.lengths[t])
        a = torch.from_numpy(got.prints[t, :n].view(np.int32))
        b = torch.from_numpy(want.prints[t, :n].view(np.int32))
        assert _bits(a, b) <= max(2, a.numel() * 32 // 10000), t


def _same(a, b):
    assert list(a[0]) == list(b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("d", [1, 4])
def test_sharded_db_on_card_equals_dense(dev, d):
    """A ShardedDB over d logical shards of the card: api.match's top 10 (K3
    dense), d K3 launches a match, and each shard's gathered block equal to
    the same mesh's on the CPU."""
    cfg = HpfwConfig(**SMALL)
    rng = np.random.default_rng(8)
    t, l, n = 45, 300, 60
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    lengths = np.full(t, l, np.int32)
    lengths[[4, 30]] = [40, 150]
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(t)], prints, lengths, device=dev)
    sdb = ShardedDB(db, meshlib.Mesh([dev] * d))
    on_cpu = ShardedDB(db, meshlib.Mesh(["cpu"] * d))
    for i, o in ((3, 5), (40, 133), (44, 240)):
        q = prints[i, o:o + n]
        _build.reset_launch_counts()
        got = sdb.match(q, top_k=10, top_pool=16)
        assert _build.LAUNCHES["score_tracks"] == d
        _same(got, api.match(q, db, top_k=10))
        assert (got[0][0], int(got[1][0]), int(got[2][0])) == (str(i), 64 * n, o)
        _same(got, on_cpu.match(q, top_k=10, top_pool=16))


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("pack4", [False, True])
def test_sharded_two_stage_on_card_equals_unsharded(dev, d, pack4):
    """TwoStageDB over d logical shards of the card, catalog_scale() knobs
    with every track pooled (prefilter and pool >= the tracks): match and
    match_batch equal the unsharded DB's; the shards' K4 and K5 launch d
    times the unsharded DB's count; the mesh DB on the CPU gives the same
    gathered blocks."""
    cfg = HpfwConfig.catalog_scale(db_downsample=8, coarse_prefilter=64,
                                   coarse_prefilter_pack4=pack4)
    rng = np.random.default_rng(9)
    t, l, n = 61, 400, 96
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(t)], prints, np.full(t, l, np.int32),
                           device=dev)
    qs = np.stack([prints[i, o:o + n] for i, o in ((3, 5), (40, 133), (60, 250))])
    flat = TwoStageDB(db)
    mesh_db = TwoStageDB(db, mesh=meshlib.Mesh([dev] * d))
    assert mesh_db.devices == [dev] and len(mesh_db.shards) == d
    counts = []
    for ts in (flat, mesh_db):
        _build.reset_launch_counts()
        for q in qs:
            ts.match(q, top_k=10, pool=64)
        counts.append(dict(_build.LAUNCHES))
    for k in ("coarse_scan_batch_packed" if pack4 else "coarse_scan_batch", "coarse_rescan",
              "fine_rescan"):
        assert counts[1][k] == d * counts[0][k] > 0, k
    for q in qs:
        _same(mesh_db.match(q, top_k=10, pool=64), flat.match(q, top_k=10, pool=64))
    for a, b in zip(mesh_db.match_batch(qs, top_k=10, pool=64),
                    flat.match_batch(qs, top_k=10, pool=64)):
        _same(a, b)
    on_cpu = TwoStageDB(api.FingerprintDB(cfg, db.filters, db.track_ids, prints, db.lengths,
                                          device="cpu"), mesh=meshlib.Mesh(["cpu"] * d))
    qd = torch.from_numpy(qs.view(np.int32))
    assert torch.equal(mesh_db.dispatch_batch(qd.to(dev), pool=64).cpu(),
                       on_cpu.dispatch_batch(qd, pool=64))


def test_db_mesh_past_the_cards_raises(dev):
    n = torch.cuda.device_count()
    assert meshlib.db_mesh().devices == tuple(torch.device("cuda", i) for i in range(n))
    with pytest.raises(ValueError, match=f"requested {n + 1} devices, have {n}"):
        meshlib.db_mesh(n + 1)
    with pytest.raises(ValueError, match=f"torch sees {n} CUDA devices"):
        meshlib.Mesh([torch.device("cuda", n)])


# ---- the CLI and the device synthesizer ----

def _cli(argv):
    import contextlib
    import io

    from hpfw_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_cli_selfcheck_on_card(dev):
    import json

    rc, out = _cli(["selfcheck"])
    got = json.loads(out)
    assert rc == 0 and got["backend"] == "cuda"
    assert got["differing_bits"] <= got["total_bits"] * 1e-4


def test_cli_fingerprint_card_against_native_cpu(dev, tmp_path):
    """fingerprint on the card and --cpu (the native C++ extraction) within
    selfcheck's 1e-4 gate, at the default config."""
    from hpfw_tpu_torch.io import wav

    cfg = HpfwConfig()
    path = str(tmp_path / "t.wav")
    wav.save_wav(path, synth.synth_track(5, 12.0, cfg), cfg.sample_rate)
    np.savez(tmp_path / "f.npz", filters=_filters(cfg))
    base = ["fingerprint", path, "--filters", str(tmp_path / "f.npz")]
    assert _cli(base + ["-o", str(tmp_path / "card.npz")])[0] == 0
    assert _cli(base + ["--cpu", "-o", str(tmp_path / "cpu.npz")])[0] == 0
    a, b = np.load(tmp_path / "card.npz")["prints"], np.load(tmp_path / "cpu.npz")["prints"]
    assert a.shape == b.shape == (cfg.n_hashprints(int(12.0 * cfg.sample_rate)), 2)
    assert int(np.bitwise_count(a ^ b).sum()) <= a.size * 32 * 1e-4


@pytest.mark.parametrize("kind", ["catalog", "artist"])
def test_synth_device_card_against_cpu(dev, kind):
    """4 tracks of 6 s rendered on the card and on the CPU, within the
    tolerance tests/test_torch_synth_device.py holds the port to jax."""
    from hpfw_tpu_torch.io import synth_device as sd

    cfg = HpfwConfig()
    if kind == "catalog":
        make = functools.partial(sd.synth_batch, [0, 3, 17, 1234], 6.0, cfg)
        tol = (1e-2, 3e-3)
    else:
        make = functools.partial(sd.synth_artist_batch, 3, [0, 1, 2, 5], 6.0, cfg)
        tol = (2.5e-2, 1.2e-2)
    got = make(device=dev)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = make(device="cpu").numpy()
    diff = got.cpu().numpy().astype(np.float64) - want
    assert np.abs(diff).max() < tol[0]
    assert np.sqrt(np.mean(diff ** 2) / np.mean(want.astype(np.float64) ** 2)) < tol[1]


# -- the card's prints against the float64 oracle --

@functools.cache
def _audit_track(seconds: float):
    """A synthetic track at the default config, the filters, and the
    oracle's prints and margins of it."""
    cfg = HpfwConfig()
    pcm = synth.synth_track(int(seconds) + 300, seconds, cfg)
    filters = _filters(cfg)
    return pcm, filters, audit.oracle_prints_and_margins(pcm, filters, cfg)


@pytest.mark.parametrize("path", ["kernels", "plain"])
@pytest.mark.parametrize("seconds", [8.0, 15.0, 30.0])
def test_prints_pass_oracle_margin_audit(dev, seconds, path, monkeypatch):
    """api.fingerprint on the card at HpfwConfig(), through K1 -> K2 or
    through the plain versions on the card: every print within the float64
    oracle's margin audit."""
    cfg = HpfwConfig()
    pcm, filters, (want, margins) = _audit_track(seconds)
    if path == "plain":
        monkeypatch.setattr(frontend, "cqt_from_frames", frontend.cqt_from_frames_ref)
        monkeypatch.setattr(fp_ops, "fingerprint_from_spec", fp_ops.fingerprint_from_spec_ref)
    _build.reset_launch_counts()
    got = api.fingerprint(pcm, filters, cfg, device=dev)
    launched = (_build.LAUNCHES["cqt"], _build.LAUNCHES["fingerprint"])
    assert launched == ((1, 1) if path == "kernels" else (0, 0))
    assert got.shape == want.shape == (cfg.n_hashprints(len(pcm)), 2)
    audit.assert_bits_match_with_margin_audit(got, want, margins)
    assert audit.margin_audit_counts(got, want, margins)["off_free"] == 0


def test_entry_on_card_launches_k1_k2_and_passes_audit(dev):
    forward, (pcm, filters) = graft_entry.entry()
    assert pcm.device.type == filters.device.type == "cuda"
    _build.reset_launch_counts()
    out = forward(pcm, filters)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["cqt"], _build.LAUNCHES["fingerprint"]) == (1, 1)
    assert out.dtype == torch.int32 and tuple(out.shape) == (380, 2)
    want, margins = audit.oracle_prints_and_margins(pcm.cpu().numpy(), filters.cpu().numpy(),
                                                    HpfwConfig())
    cpu_forward, cpu_args = graft_entry.entry(device="cpu")
    for got in (out.cpu().numpy(), cpu_forward(*cpu_args).numpy()):
        got = got.view(np.uint32)
        audit.assert_bits_match_with_margin_audit(got, want, margins)
        assert audit.margin_audit_counts(got, want, margins)["off_free"] == 0


@pytest.mark.parametrize("d", [1, 4])
def test_warmup_over_logical_shards(dev, d, tmp_path):
    """warmup() over d logical shards of the card runs K4 and K5 in every
    shard for each length and batch size, and leaves the answers as they
    were on a DB that was never warmed."""
    cfg = HpfwConfig.catalog_scale(db_downsample=8, coarse_prefilter=64)
    rng = np.random.default_rng(11)
    t, l, n = 61, 400, 96
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(t)], prints, np.full(t, l, np.int32),
                           device=dev)
    qs = np.stack([prints[i, o:o + n] for i, o in ((3, 5), (40, 133), (60, 250))])
    cold = TwoStageDB(db, mesh=meshlib.Mesh([dev] * d))
    warm = TwoStageDB(db, mesh=meshlib.Mesh([dev] * d))
    _build.reset_launch_counts()
    warm.warmup([n, 2 * n], batch_sizes=(1, 3), pool=64)
    # Per length: one dispatch and two batches, each a pass 1, a rescan and
    # a fine rescan in every shard.
    assert all(_build.LAUNCHES[k] == 2 * 3 * d
               for k in ("coarse_scan_batch", "coarse_rescan", "fine_rescan")), _build.LAUNCHES
    for q in qs:
        _same(warm.match(q, top_k=10, pool=64), cold.match(q, top_k=10, pool=64))
    for a, b in zip(warm.match_batch(qs, top_k=10, pool=64),
                    cold.match_batch(qs, top_k=10, pool=64)):
        _same(a, b)
    assert warm.bundle_compile_cache(str(tmp_path), [n]) == 0
    assert not any(tmp_path.iterdir())


def test_resident_db_past_2_31_elements_equals_plain(dev, monkeypatch):
    """A device-resident FingerprintDB of 420,000 x 2,583 random prints
    (2.17e9 int32 elements, past 2^31) under catalog_scale(pack4):
    TwoStageDB builds its index from that very tensor; match_batch of noisy
    excerpts of rows on both sides of element 2^31 finds each row first at
    its offset, and equals the same DB matched through the plain K4/K5
    versions; no host copy of the prints is made."""
    cfg = HpfwConfig.catalog_scale(coarse_prefilter_pack4=True)
    t, l, n, chunk = 420_000, 2583, 430, 16384
    g = torch.Generator(device=dev).manual_seed(18)
    prints = torch.empty((t, l, 2), dtype=torch.int32, device=dev)
    for i in range(0, t, chunk):
        prints[i:i + chunk] = torch.randint(-2 ** 31, 2 ** 31, (min(chunk, t - i), l, 2),
                                            generator=g, device=dev,
                                            dtype=torch.int64).to(torch.int32)
    assert prints.numel() > 2 ** 31
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(t)], prints,
                           torch.full((t,), l, dtype=torch.int32, device=dev), device=dev)
    first = profiling.new_id()
    ts = TwoStageDB(db)
    assert ts.prints.data_ptr() == prints.data_ptr() and ts.db_c.numel() > 2 ** 31
    derive = [s for s in profiling.spans() if s.name == "index.derive" and s.sid > first]
    assert [s.attrs["rows"] for s in derive] == [t]
    # Row 415,681 holds element 2^31 (2^31 / (2 L) = 415,681.4).
    rows, offs = [419_999, 415_681, 415_682, 300_000, 7], [2100, 1000, 0, 50, 1]
    qs = torch.stack([prints[r, o:o + n] for r, o in zip(rows, offs)])
    bits = torch.rand((len(rows), n, 2, 32), generator=g, device=dev) < 0.15
    flips = (bits.to(torch.int64) << torch.arange(32, device=dev)).sum(-1)
    qs = (qs.to(torch.int64) ^ flips).to(torch.int32).cpu().numpy().view(np.uint32)
    got = ts.match_batch(qs)
    for (ids, scores, o), r, off in zip(got, rows, offs):
        assert (ids[0], int(o[0])) == (str(r), off) and scores[0] > 0.6 * 64 * n
    _plain_matcher_on_card(monkeypatch)
    for a, b in zip(got, ts.match_batch(qs)):
        _same(a, b)
    assert db.host_bytes == 0
    assert not [s for s in profiling.spans() if s.name.startswith("db.") and s.sid > first]
    del ts, db, prints
    torch.cuda.empty_cache()


def test_pool_of_64_streams_over_resident_catalog_equals_reference(dev):
    """A StreamingPool of 64 streams over a TwoStageDB of a resident
    FingerprintDB of 100,000 x 2,583 prints under catalog_scale(pack4), 16
    rows holding the prints of 30 s tracks: each stream plays a planted track
    from its own start with noise 10 dB below, 0.743 s a feed. After every
    feed each stream's last_hit is the plain reference's top-1 of its query
    (portbench/reference/matcher.py, float32), and every hypothesis the
    pool returned is reference/streams.py's replay of the stream's hits."""
    from portbench.reference import matcher as reference
    from portbench.reference import streams as vote_reference
    from portbench.reference.extract import matmul_precision
    from hpfw_tpu_torch import StreamingPool
    from hpfw_tpu_torch.io import synth_device

    cfg = HpfwConfig.catalog_scale(coarse_prefilter_pack4=True)
    t, l, n_planted, seconds, n_streams = 100_000, 2583, 16, 30.0, 64
    g = torch.Generator(device=dev).manual_seed(22)
    prints = torch.randint(-2 ** 31, 2 ** 31, (t, l, 2), generator=g, device=dev,
                           dtype=torch.int64).to(torch.int32)
    lengths = torch.full((t,), l, dtype=torch.int32, device=dev)
    filters = torch.from_numpy(_filters(cfg)).to(dev)
    pcm = synth_device.synth_batch(np.arange(n_planted), seconds, cfg, device=dev)
    rows = torch.randperm(t, generator=g, device=dev)[:n_planted]
    planted = api.fingerprint_batch_device(pcm, filters, cfg)
    prints[rows, :planted.shape[1]] = planted
    prints[rows, planted.shape[1]:] = 0
    lengths[rows] = planted.shape[1]
    db = api.FingerprintDB(cfg, filters.cpu().numpy(), [str(i) for i in range(t)], prints,
                           lengths, device=dev)
    pool = StreamingPool(TwoStageDB(db), filters, cfg, capacity=n_streams)
    noise = torch.randn(pcm.shape, generator=g, device=dev)
    noise *= pcm.pow(2).mean(1, keepdim=True).sqrt() / noise.pow(2).mean(1, keepdim=True).sqrt()
    audio = (pcm + noise * 10 ** (-10 / 20)).cpu().numpy()
    starts = torch.randint(0, audio.shape[1] // 2, (n_streams,), generator=g, device=dev)
    sids = [f"s{i}" for i in range(n_streams)]
    for sid in sids:
        pool.add_stream(sid)
    ref = reference.Catalog(prints, lengths, dataclasses.asdict(cfg))
    hits = {sid: [] for sid in sids}
    at = [int(s) for s in starts.tolist()]
    for f in range(8):
        size = pool.window_samples + 2 * pool.step_samples if f == 0 else pool.step_samples
        hyps = pool.feed({sid: audio[i % n_planted, at[i]:at[i] + size]
                          for i, sid in enumerate(sids)})
        at = [a + size for a in at]
        queries = np.stack([pool.query(sid) for sid in sids])
        with matmul_precision(False):
            want = ref.match(torch.from_numpy(queries.view(np.int32)).to(dev))
        for sid, w, q in zip(sids, want, queries):
            tr, sc, of = reference.rank(w[0], w[1], w[2], 1, t)
            hit = pool.last_hit(sid)
            assert (int(hit[0]), hit[1], hit[2]) == (int(tr[0]), int(sc[0]), int(of[0]))
            hits[sid].append((hit[0], hit[1], hit[2], q.shape[0], hyps[sid]))
    identified = 0
    for i, sid in enumerate(sids):
        replay = vote_reference.replay([h[:4] for h in hits[sid]], pool.vote_decay,
                                       pool.vote_floor)
        for (*_, got), want in zip(hits[sid], replay):
            assert (got.track_id, got.score, got.offset) == want[:3]
            assert abs(got.confidence - want[3]) <= 1e-9
        identified += hits[sid][-1][4].track_id == str(int(rows[i % n_planted]))
    # A stream whose excerpt starts in a quiet stretch of its track may not
    # have locked yet; nearly all have.
    assert identified >= 0.9 * n_streams
    del pool, db, prints, ref
    torch.cuda.empty_cache()
