"""Port front end (CPU path: the plain version of K1) vs hpfw_tpu and the oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hpfw_tpu import oracle
from hpfw_tpu.config import HpfwConfig as JaxConfig
from hpfw_tpu.io import synth
from hpfw_tpu.ops import frontend as jax_frontend
from hpfw_tpu.ops.pallas_frontend import pallas_cqt_from_frames
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.ops import frontend


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def test_frame_signal_is_strided_view_of_pcm(cfg):
    pcm = synth.synth_track(2, 1.1, cfg)
    t = torch.from_numpy(pcm)
    frames = frontend.frame_signal(t, _port(cfg))
    assert frames.stride() == (cfg.hop, 1) and frames.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(frames.numpy(), oracle.frame_signal(pcm, cfg))


def test_cqt_matches_oracle(cfg):
    pcm = synth.synth_track(5, 1.5, cfg)
    got = frontend.cqt(torch.from_numpy(pcm), _port(cfg)).numpy()
    want = oracle.cqt(pcm, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_cqt_matches_jax_frontend(cfg):
    # Both are float32 GEMMs over the same float32 kernel, summed in different
    # orders. A rounding difference d in |X| moves log(eps + |X|) by about
    # d / (eps + |X|), so quiet bins (|X| near eps = 1e-4) turn float32
    # rounding into up to ~4e-5 here; 1e-4 is half the oracle bar of 2e-4.
    pcm = synth.synth_track(6, 1.5, cfg)
    got = frontend.cqt(torch.from_numpy(pcm), _port(cfg)).numpy()
    want = np.asarray(jax_frontend.cqt(jnp.asarray(pcm), cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_frames", [None, 7, 0], ids=["1.2s", "7_frames", "0_frames"])
def test_cqt_full_config_beside_pallas(n_frames):
    full = JaxConfig()
    if n_frames is None:
        pcm = synth.synth_track(3, 1.2, full)
    else:
        n = full.frame_len + (n_frames - 1) * full.hop if n_frames else full.frame_len - 1
        pcm = synth.synth_track(4, n / full.sample_rate + 0.01, full)[:n]
    got = frontend.cqt(torch.from_numpy(pcm), _port(full)).numpy()
    want = oracle.cqt(pcm, full)
    assert got.shape == want.shape == (full.n_frames(len(pcm)), full.n_bins)
    # The Pallas kernel's split-bf16 products meet 2e-5 against the oracle
    # (test_pallas_frontend.py). A plain float32 GEMM over 8192 terms does
    # not: on the 1.2 s input hpfw_tpu's own XLA float32 path is 5.5e-5 off,
    # and the port's CPU GEMM 2.6e-5 to 3.4e-5 depending on its thread count.
    # 5e-5 is a quarter of the 2e-4 oracle bar of test_tpu_pipeline.py.
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    if want.shape[0]:
        frames = oracle.frame_signal(pcm, full)
        pallas = np.asarray(pallas_cqt_from_frames(
            jnp.asarray(frames, dtype=jnp.float32), full, interpret=True))
        np.testing.assert_allclose(pallas, want, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=7e-5)


def test_cqt_from_contiguous_frames_equals_view(cfg):
    pcm = torch.from_numpy(synth.synth_track(8, 1.0, cfg))
    port = _port(cfg)
    view = frontend.frame_signal(pcm, port)
    torch.testing.assert_close(frontend.cqt_from_frames(view.contiguous(), port),
                               frontend.cqt_from_frames(view, port), rtol=0, atol=0)
