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
