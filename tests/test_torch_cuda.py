"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips unless torch sees a CUDA device. The card's
machine has no jax, so run this file there without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Imports nothing of jax or hpfw_tpu.
"""

import numpy as np
import pytest
import torch

from hpfw_tpu_torch import ChunkedExtractor, MatchServer, api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.filters import filters_from_jax, fix_eigenvector_signs
from hpfw_tpu_torch.io import synth
from hpfw_tpu_torch.match import matcher
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.ops import _build, coarse_scan, fine, frontend, probe
from hpfw_tpu_torch.ops import fingerprint as fp_ops

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


def _random_db(rng, lengths, l_pad=None):
    l = l_pad or max(lengths)
    prints = np.zeros((len(lengths), l, 2), dtype=np.uint32)
    for i, ln in enumerate(lengths):
        prints[i, :ln] = rng.integers(0, 2 ** 32, (ln, 2), dtype=np.uint32)
    return prints, np.array(lengths, dtype=np.int32)


@pytest.mark.parametrize("n_query", [0, 1, 37, 300])
def test_scan_kernel_matches_plain(dev, n_query):
    rng = np.random.default_rng(n_query)
    lengths = [900, 851, 15, 0, 300, 900, 123, 899]
    prints, lens = _random_db(rng, lengths, l_pad=max(900, n_query))
    q = rng.integers(0, 2 ** 32, (n_query, 2), dtype=np.uint32)
    if n_query:
        prints[1, 40:40 + n_query] = q           # planted
        prints[5, 10:10 + n_query] = q           # tie: first offset wins
        prints[5, 500:500 + n_query] = q
    args = (torch.from_numpy(q.view(np.int32)).to(dev),
            torch.from_numpy(prints.view(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev))
    s_k, o_k = matcher.score_tracks_kernel(*args)
    s_r, o_r = matcher.score_tracks_ref(*args)
    assert torch.equal(s_k, s_r) and torch.equal(o_k, o_r)
    if n_query:
        assert int(s_k[5]) == 64 * n_query and int(o_k[5]) == 10


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


@pytest.mark.parametrize("c,lc,nc", [(32, 161, 26), (64, 161, 26), (8, 40, 5), (24, 161, 9)])
def test_packed_coarse_kernel_matches_plain_and_int8(dev, c, lc, nc):
    """Packed K4 == its plain version == int8 K4 on the unpacked rows, exactly;
    C = 24 takes the odd packed-word path."""
    rng = np.random.default_rng(100 + c + lc)
    flat = _coarse_db(rng, 203, lc, c, nc, "pm1").to(dev)
    packed = coarse_scan.pack_coarse_nibbles(flat)
    qs = torch.from_numpy(rng.choice([-1, 1], (16, nc, c)).astype(np.int8)).to(dev)
    got = coarse_scan.coarse_scan_batch_packed_kernel(qs, packed, lc_true=lc)
    want = coarse_scan.coarse_scan_batch_packed_ref(qs, packed, lc_true=lc)
    int8 = coarse_scan.coarse_scan_batch_kernel(qs, flat, lc_true=lc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got, int8):
        assert torch.equal(a, b)
    assert torch.equal(coarse_scan.unpack_coarse_nibbles(packed)[:, :flat.shape[1]], flat)


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
