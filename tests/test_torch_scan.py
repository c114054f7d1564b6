"""The port's rendition scans and escalation on the CPU vs hpfw_tpu.api.

scan_spectra / scan_from_spec / fingerprint_scan_batch against the
reference's spec-level scan (variant spectra to 1e-6, prints within K2's bar
of max(2, bits/10,000) differing bits, the identity row equal to plain
extraction bit for bit), scan_hypotheses and its errors, the escalation
gates on tables of cases, and match_scan_escalating against the reference's
on the same FingerprintDB prints (the twins of tests/test_stretch.py's
escalation tests).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfw_tpu import api as jax_api
from hpfw_tpu import oracle
from hpfw_tpu.io import synth, synth_jax
from hpfw_tpu.match.scaled import TwoStageDB as JaxTwoStageDB
from hpfw_tpu.ops import frontend as jax_frontend
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.ops import fingerprint as fp_ops

# (span, pitch_span_bins) of a pure-tempo, a pure-pitch and the product grid.
GRIDS = {"tempo": (0.02, 0), "pitch": (0.0, 2), "product": (0.03, 1)}


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


def _u32(t):
    return t.numpy().view(np.uint32)


def _bits(a, b):
    return int(np.bitwise_count(np.bitwise_xor(a, b)).sum())


def _within_k2_bar(got, want, label):
    """Each variant's prints within max(2, bits/10,000) differing bits."""
    assert got.shape == want.shape, label
    for v in range(got.shape[-3]):
        g, w = got[..., v, :, :], want[..., v, :, :]
        limit = max(2, g.size * 32 // 10000)
        assert _bits(g, w) <= limit, f"{label} variant {v}: {_bits(g, w)} > {limit}"


def _jax_variants(spec, hyps, interp):
    """The reference's variant spectra: the gather inside
    hpfw_tpu.api.scan_from_spec (:141-151), which returns prints only."""
    f, nb = spec.shape
    base = jnp.arange(f, dtype=jnp.float32)
    bins = jnp.arange(nb, dtype=jnp.int32)
    out = []
    for s, roll in hyps:
        sv = spec if roll == 0 else spec[:, jnp.clip(bins + roll, 0, nb - 1)]
        pos = jnp.clip(base / s, 0.0, f - 1.0)
        if interp == "linear":
            i0 = jnp.floor(pos).astype(jnp.int32)
            i1 = jnp.minimum(i0 + 1, f - 1)
            frac = (pos - i0.astype(jnp.float32))[:, None]
            out.append(sv[i0] * (1.0 - frac) + sv[i1] * frac)
        else:
            out.append(sv[jnp.round(pos).astype(jnp.int32)])
    return np.asarray(jnp.stack(out))


@pytest.fixture(scope="module")
def spec(cfg):
    """The reference's (XLA) CQT of a 2.5 s track, fed to both packages."""
    return np.array(jax_frontend.cqt(jnp.asarray(synth.synth_track(11, 2.5, cfg)), cfg))


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_scan_from_spec_matches_reference(cfg, spec, grid, interp):
    span, p = GRIDS[grid]
    hyps = jax_api.scan_hypotheses(cfg, span=span, pitch_span_bins=p)
    assert api.scan_hypotheses(_port(cfg), span=span, pitch_span_bins=p) == hyps
    filters = _filters(cfg, seed=2)
    spec_t, filt_t = torch.from_numpy(spec), torch.from_numpy(filters)
    variants = api.scan_spectra(spec_t, hyps, interp)
    assert variants.shape == (len(hyps),) + spec.shape and variants.dtype == torch.float32
    np.testing.assert_allclose(variants.numpy(), _jax_variants(jnp.asarray(spec), hyps, interp),
                               rtol=0, atol=1e-6)
    got = _u32(api.scan_from_spec(spec_t, filt_t, _port(cfg), hyps, interp))
    want = np.asarray(jax_api.scan_from_spec(jnp.asarray(spec), jnp.asarray(filters), cfg,
                                             hyps, interp))
    assert got.shape == want.shape == (len(hyps), cfg.n_hashprints(
        cfg.frame_len + (spec.shape[0] - 1) * cfg.hop), 2)
    _within_k2_bar(got, want, f"{grid}/{interp}")
    # The identity hypothesis sits at V//2 and is the plain extraction.
    mid = len(hyps) // 2
    assert hyps[mid] == (1.0, 0)
    assert torch.equal(variants[mid], spec_t)
    np.testing.assert_array_equal(
        got[mid], _u32(fp_ops.fingerprint_from_spec(spec_t, filt_t, _port(cfg))))
    # Each variant's prints are the encoder's prints of that variant spectrum.
    for v in (0, len(hyps) - 1):
        np.testing.assert_array_equal(
            got[v], _u32(fp_ops.fingerprint_from_spec(variants[v], filt_t, _port(cfg))))


def test_scan_spectra_plain_factors_and_clamped_edges(spec):
    """A plain float is the hypothesis (s, 0); a slow hypothesis repeats the
    clamped last frame, a roll repeats the edge bin."""
    spec_t = torch.from_numpy(spec)
    f, nb = spec.shape
    plain = api.scan_spectra(spec_t, [0.97, 1.0], "nearest")
    torch.testing.assert_close(plain, api.scan_spectra(spec_t, [(0.97, 0), (1.0, 0)],
                                                       "nearest"), rtol=0, atol=0)
    tail = int(np.ceil(0.97 * (f - 1)))
    assert torch.equal(plain[0, tail + 1:], spec_t[-1].expand(f - tail - 1, nb))
    rolled = api.scan_spectra(spec_t, [(1.0, 2), (1.0, -2)], "linear")
    assert torch.equal(rolled[0, :, :-2], spec_t[:, 2:])
    assert torch.equal(rolled[0, :, -2:], spec_t[:, -1:].expand(f, 2))
    assert torch.equal(rolled[1, :, 2:], spec_t[:, :-2])
    assert torch.equal(rolled[1, :, :2], spec_t[:, :1].expand(f, 2))


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_fingerprint_scan_batch_matches_reference(cfg, interp):
    """From PCM: the port's (B, V, N, 2) stack within K2's bar of the
    reference's, and its identity row equal to the port's own
    fingerprint_batch (the twin of test_stretch.py:166)."""
    pcm = np.stack([synth.synth_track(31 + i, 4.0, cfg) for i in range(2)])
    filters = _filters(cfg)
    port = _port(cfg)
    got = api.fingerprint_scan_batch(pcm, filters, port, span=0.03, pitch_span_bins=1,
                                     interp=interp, device="cpu")
    want = jax_api.fingerprint_scan_batch(pcm, filters, cfg, span=0.03, pitch_span_bins=1,
                                          interp=interp)
    assert got.dtype == np.uint32 and got.shape == want.shape == (
        2, 21, cfg.n_hashprints(pcm.shape[1]), 2)
    _within_k2_bar(got, want, interp)
    np.testing.assert_array_equal(got[:, 10], api.fingerprint_batch(pcm, filters, port,
                                                                    device="cpu"))


def test_scan_hypotheses_and_validation_match_reference(cfg):
    port = _port(cfg)
    for kw in [dict(span=0.02), dict(span=0.03, step=0.015), dict(pitch_span_bins=2),
               dict(span=0.03, pitch_span_bins=1), dict(span=0.0, pitch_span_bins=1)]:
        got = api.scan_hypotheses(port, **kw)
        assert got == jax_api.scan_hypotheses(cfg, **kw), kw
        assert got[len(got) // 2] == (1.0, 0)
    knobs = dict(stretch_span=0.03, pitch_span_bins=1)
    assert (api.scan_hypotheses(dataclasses.replace(port, **knobs))
            == jax_api.scan_hypotheses(dataclasses.replace(cfg, **knobs)))
    with pytest.raises(ValueError, match="positive stretch span"):
        jax_api.scan_hypotheses(cfg)
    with pytest.raises(ValueError, match="positive stretch span"):
        api.scan_hypotheses(port)
    pcm = np.zeros((1, cfg.sample_rate), np.float32)
    filters = _filters(cfg)
    for args, kw in [((pcm[0],), dict(span=0.02)),          # 1-D
                     ((pcm,), {}),                           # no span, config 0
                     ((pcm,), dict(span=0.02, interp="cubic"))]:
        with pytest.raises(ValueError):
            jax_api.fingerprint_scan_batch(*args, filters, cfg, **kw)
        with pytest.raises(ValueError):
            api.fingerprint_scan_batch(*args, filters, port, device="cpu", **kw)
    # Too short for one print: an empty stack of the grid's height.
    short = np.zeros((3, 1000), np.float32)
    got = api.fingerprint_scan_batch(short, filters, port, span=0.02, device="cpu")
    want = jax_api.fingerprint_scan_batch(short, filters, cfg, span=0.02)
    assert got.shape == want.shape == (3, 5, 0, 2) and got.dtype == want.dtype


# ---- the escalation gates ----

@pytest.mark.parametrize("scores,n,kw", [
    ([400, 100], 8, {}),                       # 0.78 of 512: hi_sim
    ([399, 398], 8, {}),                       # below hi_sim, no margin
    ([330, 300], 8, {}),                       # >= threshold, margin 0.09
    ([330, 320], 8, {}),                       # >= threshold, margin 0.03
    ([300, 10], 8, {}),                        # below threshold
    ([330], 8, {}),                            # one candidate
    ([], 8, {}),                               # no candidate
    ([], 8, dict(hi_sim=0.0)),                 # escalation disabled
    ([100, 99], 8, dict(hi_sim=-1.0)),
    ([330, 320], 8, dict(margin=0.01)),
    ([500, 200], 8, dict(threshold=1.01, hi_sim=1.01)),
])
def test_rigid_confident_table(scores, n, kw):
    s = np.array(scores, np.int64)
    assert api.rigid_confident(s, n, **kw) == jax_api.rigid_confident(s, n, **kw)


@pytest.mark.parametrize("scan,rigid,kw", [
    ([510], [500], {}), ([511], [500], {}), ([600], [500], {}), ([], [500], {}),
    ([10], [], {}), ([600], [500], dict(override=0.25)), ([501], [500], dict(override=0.0)),
])
def test_scan_overrides_table(scan, rigid, kw):
    a, b = np.array(scan, np.int64), np.array(rigid, np.int64)
    assert api.scan_overrides(a, b, **kw) == jax_api.scan_overrides(a, b, **kw)


@pytest.mark.parametrize("case", ["excerpt", "stretched", "random"])
def test_rigid_structured_matches_reference(cfg, case):
    """A true in-tempo excerpt is structured, a 3%-fast one has slope, a
    random track scatters; the port's gate agrees with the reference's."""
    rng = np.random.default_rng(4)
    track = rng.integers(0, 2 ** 32, (400, 2), dtype=np.uint32)
    q = track[60:260].copy()
    if case == "stretched":
        q = track[np.clip(np.round(60 + np.arange(200) * 1.03).astype(int), 0, 399)]
    elif case == "random":
        track = rng.integers(0, 2 ** 32, (400, 2), dtype=np.uint32)
    for kw in [{}, dict(inlier=0.5, slope_tol=0.05)]:
        got = api.rigid_structured(q, track, 60, length=400, **kw)
        assert got == jax_api.rigid_structured(q, track, 60, length=400, **kw), kw
    assert api.rigid_structured(q, track, 60) == (case == "excerpt")


# ---- match_scan_escalating against the reference on the same DB prints ----

@pytest.fixture(scope="module")
def escalation(cfg):
    """12 synth_jax tracks of 6 s in one FingerprintDB, read by both packages'
    TwoStageDBs (stride 4); an in-tempo and a 3%-fast live rendition of
    tracks 3 and 9 (test_stretch.py's setup)."""
    cfg2 = dataclasses.replace(cfg, stretch_span=0.03)
    tracks = np.asarray(synth_jax.synth_batch(np.arange(12), 6.0, cfg2))
    filters = _filters(cfg2)
    db = jax_api.build_db(list(tracks), filters, cfg2)
    jts = JaxTwoStageDB(db, stride=4, use_pallas_fine=True, pallas_interpret=True)
    port_db = api.FingerprintDB(_port(cfg2), filters, db.track_ids, db.prints, db.lengths,
                                device="cpu")
    pts = TwoStageDB(port_db, stride=4)
    pcm = np.stack([
        np.asarray(synth_jax.live_query_batch(
            [t], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=s, noise_db=-25.0))[0] for t, s in [(3, 1.0), (9, 1.03)]])
    # The most bits by which the port's query prints (rigid and every scan
    # variant) differ from the reference's: the bound on a score difference.
    bits = max(_bits(api.fingerprint_batch(pcm, filters, _port(cfg2), device="cpu"),
                     jax_api.fingerprint_batch(pcm, filters, cfg2)),
               max(_bits(a, b) for a, b in zip(
                   api.fingerprint_scan_batch(pcm, filters, _port(cfg2),
                                              device="cpu").swapaxes(0, 1),
                   jax_api.fingerprint_scan_batch(pcm, filters, cfg2).swapaxes(0, 1))))
    return cfg2, filters, jts, pts, pcm, bits


# kwargs of one match_scan_escalating call each (test_stretch.py:255, :298),
# and the stats the reference records there where it asserts them.
ESCALATION_CASES = {
    "defaults": (dict(top_k=1, pool=16), None),
    "structure_gate": (dict(top_k=1, pool=16, threshold=1.01, hi_sim=1.01,
                            structure_gate=0.75),
                       dict(structure_kept=[0], escalated=[1])),
    "retry_pool": (dict(top_k=1, pool=8, threshold=1.01, hi_sim=1.01, retry_pool=32,
                        structure_gate=0.75), dict(retried=[0, 1])),
    "rigid_only": (dict(top_k=1, pool=16, hi_sim=0.0, retry_pool=32, structure_gate=0.75),
                   dict(retried=[], escalated=[], structure_kept=[])),
    "override_unstructured": (dict(top_k=1, pool=16, threshold=1.01, hi_sim=1.01,
                                   structure_gate=0.75, override=10.0,
                                   override_unstructured=0.0),
                              dict(escalated=[1], overridden=[1])),
    "override_blocks": (dict(top_k=1, pool=16, threshold=1.01, hi_sim=1.01,
                             structure_gate=0.75, override=10.0),
                        dict(escalated=[1], overridden=[])),
    "deeper_rank": (dict(top_k=3, pool=16, batch=1, retry_fine_window=8), None),
}


@pytest.mark.parametrize("case", list(ESCALATION_CASES))
def test_match_scan_escalating_matches_reference(escalation, case):
    cfg2, filters, jts, pts, pcm, bits = escalation
    kw, want_stats = ESCALATION_CASES[case]
    st_j, st_p = {}, {}
    want = jax_api.match_scan_escalating(pcm, filters, jts, cfg2, stats=st_j, **kw)
    got = api.match_scan_escalating(pcm, filters, pts, _port(cfg2), stats=st_p, **kw)
    assert st_p == st_j
    if want_stats:
        assert {k: st_p[k] for k in want_stats} == want_stats
    assert len(got) == len(want) == 2
    for (g_ids, g_s, g_o), (w_ids, w_s, w_o) in zip(got, want):
        assert list(g_ids) == list(w_ids)
        np.testing.assert_array_equal(g_o, w_o)
        assert np.abs(np.asarray(g_s, np.int64) - np.asarray(w_s, np.int64)).max() <= bits
    if case != "rigid_only":
        assert [r[0][0] for r in got] == ["3", "9"]
