"""Port hashprint encoder (CPU path: the plain version of K2) vs hpfw_tpu and
the oracle, including the full-config margin audit of the whole pipeline."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hpfw_tpu import oracle
from hpfw_tpu.config import HpfwConfig as JaxConfig
from hpfw_tpu.io import synth
from hpfw_tpu.ops import fingerprint as jax_fp
from hpfw_tpu.ops.pallas_fingerprint import (pad_filters_split,
                                            pallas_fingerprint_from_spec_presplit)
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.ops import fingerprint as fp_ops
from hpfw_tpu_torch.ops import fused
from tests.test_torch_frontend import _split3
from tests.test_tpu_pipeline import assert_bits_match_with_margin_audit


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


def _u32(t):
    return t.numpy().view(np.uint32)


def test_project_features_matches_oracle(cfg):
    pcm = synth.synth_track(6, 1.5, cfg)
    filters = _filters(cfg)
    spec64 = oracle.cqt(pcm, cfg)
    want = oracle.features(spec64, filters, cfg)
    got = fp_ops.project_features(torch.from_numpy(spec64.astype(np.float32)),
                                  torch.from_numpy(filters), _port(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("bit_order", ["lsb0", "msb0"])
@pytest.mark.parametrize("tie_break", ["gt", "ge"])
def test_pack_and_unpack_match_oracle(cfg, bit_order, tie_break):
    jcfg = dataclasses.replace(cfg, bit_order=bit_order, tie_break=tie_break)
    port = _port(jcfg)
    rng = np.random.default_rng(8)
    d = rng.integers(-2, 3, size=(70, 64)).astype(np.float32)   # many exact ties
    got = _u32(fp_ops.binarize_and_pack(torch.from_numpy(d), port))
    want = oracle.pack_bits(oracle.binarize(d, jcfg), jcfg)
    np.testing.assert_array_equal(got, want)
    bits = rng.integers(0, 2, size=(33, 64)).astype(bool)
    packed = fp_ops.pack_bits(torch.from_numpy(bits), port)
    np.testing.assert_array_equal(_u32(packed), oracle.pack_bits(bits, jcfg))
    np.testing.assert_array_equal(fp_ops.unpack_bits(packed, port).numpy(), bits)


def test_fingerprint_from_spec_matches_jax_and_pallas(cfg):
    filters = _filters(cfg, seed=2)
    spec = oracle.cqt(synth.synth_track(11, 2.5, cfg), cfg).astype(np.float32)
    got = _u32(fp_ops.fingerprint_from_spec(torch.from_numpy(spec),
                                            torch.from_numpy(filters), _port(cfg)))
    xla = np.asarray(jax_fp.fingerprint_from_spec(jnp.asarray(spec), jnp.asarray(filters), cfg))
    # pallas_fingerprint_from_spec itself cannot be called: it is jitted yet
    # converts its traced filters with np.asarray. The presplit entry is the
    # one hpfw_tpu's fused pipeline uses.
    fh, fm, fl = (jnp.asarray(x) for x in pad_filters_split(filters, cfg))
    pallas = np.asarray(pallas_fingerprint_from_spec_presplit(
        jnp.asarray(spec), fh, fm, fl, cfg, interpret=True))
    assert got.shape == xla.shape == pallas.shape == (spec.shape[0] - cfg.context_w + 1
                                                      - cfg.delta_lag, 2)
    limit = max(2, got.size * 32 // 10000)
    for other in (xla, pallas):
        assert int(np.bitwise_count(got ^ other).sum()) <= limit


def test_full_pipeline_margin_audit():
    full = JaxConfig()
    filters = _filters(full)
    pcm = synth.synth_track(31, 8.0, full)
    got = _u32(fused.fingerprint(torch.from_numpy(pcm), torch.from_numpy(filters),
                                 _port(full)))
    want = oracle.fingerprint(pcm, filters, full)
    margins = oracle.delta_margins(pcm, filters, full)
    assert got.shape == want.shape == (full.n_hashprints(len(pcm)), 2)
    assert_bits_match_with_margin_audit(got, want, margins)


def test_encoder_short_spectrum_gives_no_prints(cfg):
    port = _port(cfg)
    spec = torch.zeros((cfg.context_w + cfg.delta_lag - 1, cfg.n_bins))
    out = fp_ops.fingerprint_from_spec(spec, torch.zeros((cfg.context_dim, 64)), port)
    assert out.shape == (0, 2) and out.dtype == torch.int32


KSPLIT = 4           # K2's fixed parts of the context frames (its cluster)
WGS = 2              # K2's warpgroups a block, each a fixed half of its slices
SLICE = 32           # K2's reduction slice


def _bin_pad(cfg):
    return -(-cfg.n_bins // SLICE) * SLICE


def _pad_bins(x: torch.Tensor, w: int, cfg) -> torch.Tensor:
    """(rows, w * n_bins) or (w * n_bins, cols) -> the same with each context
    frame's bins zero-padded to K2's bin_pad, along the context axis."""
    pad = _bin_pad(cfg)
    if x.shape[0] == w * cfg.n_bins:                       # filters
        out = torch.zeros((w, pad, x.shape[1]), dtype=x.dtype)
        out[:, :cfg.n_bins] = x.reshape(w, cfg.n_bins, -1)
        return out.reshape(w * pad, -1)
    out = torch.zeros((x.shape[0], w, pad), dtype=x.dtype)
    out[:, :, :cfg.n_bins] = x.reshape(x.shape[0], w, cfg.n_bins)
    return out.reshape(x.shape[0], w * pad)


def _k2_order(spec: torch.Tensor, filters: torch.Tensor, cfg) -> torch.Tensor:
    """Plain emulation of K2's arithmetic: both operands split into three bf16
    parts, bins padded to a multiple of 32, the context frames cut into
    KSPLIT fixed parts and each part's 32-deep slices into WGS fixed halves;
    in each half, each slice's six products (exact in float64, then float32)
    summed small first and folded into the half's sum; each rank's two
    halves added, then the ranks in order, then the lag delta, sign and
    pack."""
    w = cfg.context_w
    m = spec.shape[0] - w + 1
    ctx = spec.unfold(0, w, 1).transpose(1, 2).reshape(m, w * cfg.n_bins)
    ah, am, al = (x.double() for x in _split3(_pad_bins(ctx, w, cfg)))
    fh, fm, fl = (x.double() for x in _split3(_pad_bins(filters, w, cfg)))
    frames = -(-w // KSPLIT)
    slices = _bin_pad(cfg) // SLICE
    y = torch.zeros((m, cfg.n_filters))
    for rank in range(KSPLIT):
        lo, hi = rank * frames * slices, max(0, min(w, (rank + 1) * frames)) * slices
        half = -(-max(0, hi - lo) // WGS)
        rank_sum = None
        for wg in range(WGS):
            acc = torch.zeros((m, cfg.n_filters))
            for s in range(lo + wg * half, min(hi, lo + (wg + 1) * half)):
                k = slice(s * SLICE, (s + 1) * SLICE)
                prods = [fa[k].T @ sb[:, k].T for fa, sb in
                         ((fl, ah), (fm, am), (fh, al), (fm, ah), (fh, am), (fh, ah))]
                part = prods[0].float()
                for p in prods[1:]:
                    part = part + p.float()
                acc = acc + part.T
            rank_sum = acc if rank_sum is None else rank_sum + acc
        y = y + rank_sum
    return fp_ops.binarize_and_pack(fp_ops.delta(y, cfg), cfg)


@pytest.mark.parametrize("full", [True, False], ids=["default", "small"])
def test_k2_split_equals_filters_pad_split(cfg, full):
    """K2's in-kernel split (round to nearest bf16, the remainders exact in
    float32) gives hpfw_tpu.ops.fused.filters_pad_split's parts bit for bit,
    bins zero-padded per context frame."""
    from hpfw_tpu.ops.fused import filters_pad_split
    from hpfw_tpu.ops.pallas_fingerprint import BIN_PAD

    jcfg = JaxConfig() if full else cfg
    port = _port(jcfg)
    filters = _filters(jcfg, seed=5)
    want = filters_pad_split(jnp.asarray(filters), jcfg)
    got = _split3(_pad_bins(torch.from_numpy(filters), jcfg.context_w, port))
    w, b = jcfg.context_w, jcfg.n_bins
    for g, x in zip(got, want):
        g = g.to(torch.bfloat16).reshape(w, _bin_pad(port), -1)
        x = np.asarray(x).reshape(w, BIN_PAD, -1)
        np.testing.assert_array_equal(g[:, :b].view(torch.int16).numpy(),
                                      x[:, :b].view(np.int16))
        assert not g[:, b:].any() and not x[:, b:].astype(np.float32).any()


def test_k2_split_gemm_emulation_beside_plain_and_pallas():
    """K2's split-product order at the full config: within max(2, bits/10000)
    differing bits of the plain version, and every bit that differs from the
    Pallas kernel (interpret mode) or from the oracle inside the oracle's
    margin."""
    full = JaxConfig()
    port = _port(full)
    filters = _filters(full, seed=3)
    pcm = synth.synth_track(21, 8.0, full)
    spec = oracle.cqt(pcm, full).astype(np.float32)
    spec_t, filt_t = torch.from_numpy(spec), torch.from_numpy(filters)
    got = _k2_order(spec_t, filt_t, port)
    plain = fp_ops.fingerprint_from_spec_ref(spec_t, filt_t, port)
    assert got.shape == plain.shape == (full.n_hashprints(len(pcm)), 2)
    assert int(np.bitwise_count(_u32(got) ^ _u32(plain)).sum()) <= max(2, got.numel() * 32 // 10000)
    fh, fm, fl = (jnp.asarray(x) for x in pad_filters_split(filters, full))
    pallas = np.asarray(pallas_fingerprint_from_spec_presplit(
        jnp.asarray(spec), fh, fm, fl, full, interpret=True))
    margins = oracle.delta_margins(pcm, filters, full)
    assert_bits_match_with_margin_audit(_u32(got), pallas, margins)
    assert_bits_match_with_margin_audit(_u32(got), oracle.fingerprint(pcm, filters, full), margins)
