"""The plain reference agrees with itself and with first principles at tiny
sizes, and with the port's plain CPU path where both exist."""

import numpy as np
import pytest
import torch

from portbench.reference import extract, matcher

P = {"sample_rate": 22050, "fmin": 130.8127826502993, "bins_per_octave": 24, "n_bins": 121,
     "hop": 512, "frame_len": 8192, "window": "hann", "log_eps": 1e-4, "context_w": 20,
     "delta_lag": 16, "n_filters": 64, "tie_break": "gt", "stretch_step": 0.01}


def pm1(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 2, shape, generator=g) * 2 - 1).to(torch.int8)


@pytest.mark.parametrize("g,c", [(3, 32), (40, 64), (40, 32), (70, 64)])
def test_scan_paths_agree_with_brute_force(g, c, monkeypatch):
    monkeypatch.setattr(matcher, "_BLOCK_ELEMS", 1 << 12)       # many blocks
    db = pm1((37, 40, 64), 0)
    db[:, 35:] = 0
    qv = pm1((g, 7, c), 1).float()
    best, first = matcher.scan(qv, db, 38)
    corr = torch.stack([sum((db[:, o + j, :c].float() * qv[:, j][:, None]).sum(-1)
                            for j in range(7)) for o in range(32)], -1)
    assert torch.equal(best, corr.max(-1).values.long())
    assert torch.equal(first, (corr == corr.max(-1, keepdim=True).values).float().argmax(-1))


def test_fine_band_is_the_exact_similarity():
    g = torch.Generator().manual_seed(2)
    prints = torch.randint(-2 ** 31, 2 ** 31, (5, 60, 2), generator=g, dtype=torch.int64).int()
    lengths = torch.tensor([60, 50, 45, 20, 0], dtype=torch.int32)
    q = prints[1, 7:27].clone()
    tracks = torch.arange(5)
    starts = torch.tensor([0, 3, 20, 0, 0])
    s, o = matcher.fine(q, prints, lengths, tracks, starts, 9)
    assert int(s[1]) == 64 * 20 and int(o[1]) == 7              # the excerpt's own place

    def sim(t, off):
        n = 20
        ln = int(lengths[t])
        if off < 0 or off > max(ln - n, 0):
            return -1
        k = max(0, min(ln - off, n))
        x = (prints[t, off:off + k].numpy().view(np.uint32) ^ q[:k].numpy().view(np.uint32))
        return 64 * k - int(np.unpackbits(x.view(np.uint8)).sum())
    for t in range(5):
        want = [sim(t, int(starts[t]) + r) for r in range(9)]
        assert int(s[t]) == max(want) and int(o[t]) == int(starts[t]) + want.index(max(want))


def test_top_tracks_ties_and_padding():
    v = torch.tensor([[5, 9, 9, 1, 9]])
    # Two asked for: rounded up to 8, as many distinct as there are (the
    # lower index first on ties), then the first repeated.
    assert matcher.top_tracks(v, 2).tolist() == [[1, 2, 4, 0, 3, 1, 1, 1]]
    assert matcher.top_tracks(v, 2, reverse_ties=True)[0, :2].tolist() == [4, 2]
    assert matcher.top_tracks(v, 9).shape[-1] == 8


def test_batch_equals_one_query_at_a_time():
    g = torch.Generator().manual_seed(3)
    prints = torch.randint(-2 ** 31, 2 ** 31, (40, 300, 2), generator=g, dtype=torch.int64).int()
    lengths = torch.full((40,), 300, dtype=torch.int32)
    m = {"db_downsample": 16, "coarse_prefilter_phases": 2, "coarse_prefilter_channels": 32,
         "coarse_prefilter": 16, "coarse_query_phases": 8, "coarse_channels": 64,
         "fine_candidates": 8}
    cat = matcher.Catalog(prints, lengths, m)
    qs = torch.stack([prints[5, 10:110], prints[17, 150:250], prints[3, 0:100]])
    together = cat.match(qs)
    alone = np.concatenate([cat.match(q[None]) for q in qs])
    assert np.array_equal(together, alone)
    for b, t in enumerate((5, 17, 3)):
        ids, scores, offs = matcher.rank(together[b, 0], together[b, 1], together[b, 2], 3, 40)
        assert ids[0] == t and scores[0] == 64 * 100


def test_basis_and_prints_match_the_ports_plain_path():
    from hpfw_tpu_torch.config import HpfwConfig
    from hpfw_tpu_torch.ops import frontend, fused
    from hpfw_tpu_torch.oracle.pipeline import cqt_kernel_matrix

    cfg = HpfwConfig()
    k = cqt_kernel_matrix(cfg)
    want = np.concatenate([k.real, k.imag], axis=1).astype(np.float32)
    assert np.array_equal(extract.cqt_basis(P), want)
    g = torch.Generator().manual_seed(4)
    pcm = torch.randn(3 * 22050, generator=g)
    filt = torch.randn(2420, 64, generator=g) / 50
    with extract.matmul_precision(False):
        assert torch.equal(extract.prints(pcm, filt, P), fused.fingerprint(pcm, filt, cfg))
        spec = frontend.cqt(pcm, cfg)
        assert torch.equal(extract.spectrum(pcm, P), spec)


def test_scan_variants_and_identity():
    from hpfw_tpu_torch import api
    from hpfw_tpu_torch.config import HpfwConfig

    hyps = extract.hypotheses(0.03, 0.01, 1)
    assert len(hyps) == 21 and hyps[10] == (1.0, 0)
    cfg = HpfwConfig()
    assert tuple(hyps) == api.scan_hypotheses(cfg, 0.03, None, 1)
    spec = torch.randn(60, 121, generator=torch.Generator().manual_seed(5))
    v = extract.scan_spectra(spec, hyps)
    assert torch.equal(v[10], spec)
    assert torch.equal(v, api.scan_spectra(spec, hyps))


def test_tf32_switch_restores():
    before = torch.backends.cuda.matmul.allow_tf32
    with extract.matmul_precision(True):
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
