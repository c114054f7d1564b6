"""The three CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips unless torch sees a CUDA device. The card's
machine has no jax, so run this file there without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Imports nothing of jax or hpfw_tpu.
"""

import numpy as np
import pytest
import torch

from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.filters import filters_from_jax, fix_eigenvector_signs
from hpfw_tpu_torch.io import synth
from hpfw_tpu_torch.match import matcher
from hpfw_tpu_torch.ops import _build, frontend
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
    assert _build.LAUNCHES == {"cqt": 5, "fingerprint": 5, "score_tracks": 1}
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
