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


@pytest.mark.parametrize("full", [True, False], ids=["default", "small"])
def test_cqt_kernel_split_identical_to_reference(cfg, full):
    """K1's host split equals pallas_frontend.cqt_kernel_split bit for bit: all
    three bf16 parts in the padded (frame_len, 256) layout, and K1's operand
    holds them transposed."""
    from hpfw_tpu.ops.pallas_frontend import cqt_kernel_split as jax_split

    jcfg = JaxConfig() if full else cfg
    port = _port(jcfg)
    got = frontend.cqt_kernel_split(port)
    want = jax_split(jcfg)
    assert frontend.bin_pad(port) == 128
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape == (jcfg.frame_len, 256)
        np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
    dev = frontend.kernel_split_device(port, torch.device("cpu"))
    assert dev.shape == (3, 256, jcfg.frame_len) and dev.is_contiguous()
    for i, g in enumerate(got):
        assert torch.equal(dev[i], g.t())


def _split3(x: torch.Tensor):
    """float32 -> its three bf16 parts as float32, as pallas_frontend._split3."""
    h = x.to(torch.bfloat16).float()
    r = x - h
    m = r.to(torch.bfloat16).float()
    return h, m, (r - m).to(torch.bfloat16).float()


def _split_products(frames: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """The six products of significance >= 2^-16 of the split frames and the
    split matrix, 32-deep slice by slice: (frame_len / 32, F, 2 * bin_pad),
    in float64, where each is exact (bf16 x bf16 over 32 terms)."""
    f, n = frames.shape[0], cfg.frame_len
    ah, am, al = (x.double().view(f, n // 32, 32).transpose(0, 1) for x in _split3(frames))
    bh, bm, bl = (p.double().view(n // 32, 32, -1) for p in frontend.cqt_kernel_split(cfg))
    return torch.stack([al @ bh, am @ bm, ah @ bl, am @ bh, ah @ bm, ah @ bh])


def _log_magnitude(acc: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    pad = frontend.bin_pad(cfg)
    re, im = acc[:, :cfg.n_bins], acc[:, pad:pad + cfg.n_bins]
    return torch.log(cfg.log_eps + torch.sqrt(re * re + im * im)).float()


def _split_gemm_k1_order(frames: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """Plain emulation of K1's arithmetic in float32 and in K1's order: each
    32-deep slice's six products summed small first, the slices of each of
    the 8 chunks of frame_len added in turn, then the chunks in turn."""
    part = _split_products(frames, cfg).float()
    part = part[0] + part[1] + part[2] + part[3] + part[4] + part[5]
    n = cfg.frame_len
    chunk = -(-n // 8 // 32) * 32
    acc = torch.zeros(part.shape[1:])
    for c in range(0, n, chunk):
        run = torch.zeros(part.shape[1:])
        for s in range(c // 32, min(c + chunk, n) // 32):
            run = run + part[s]
        acc = acc + run
    return _log_magnitude(acc, cfg)


def test_split_gemm_emulation_beside_pallas_and_plain():
    """K1's six-product split GEMM at the full config. Summed exactly, it is
    the oracle to 2e-6 and the Pallas kernel (interpret mode) to 2e-5: the
    split loses nothing at float32 level. Summed in float32 in K1's order, it
    meets K1's card gate (1e-4 of the plain version) and the 5e-5 oracle bar
    of test_cqt_full_config_beside_pallas. Two float32 orders differ by up to
    ~2.4e-5 at the quietest bins (|X| near log_eps) of this input, so the
    float32 emulation is not held to the Pallas kernel at 2e-5."""
    full = JaxConfig()
    port = _port(full)
    pcm = synth.synth_track(3, 1.2, full)
    frames = torch.from_numpy(oracle.frame_signal(pcm, full).astype(np.float32))
    want = oracle.cqt(pcm, full)
    exact = _log_magnitude(_split_products(frames, port).sum(dim=(0, 1)), port)
    pallas = np.asarray(pallas_cqt_from_frames(jnp.asarray(frames.numpy()), full,
                                               interpret=True))
    np.testing.assert_allclose(exact.numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(exact.numpy(), pallas, rtol=0, atol=2e-5)
    k1 = _split_gemm_k1_order(frames, port)
    torch.testing.assert_close(k1, frontend.cqt_from_frames_ref(frames, port),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(k1.numpy(), want, rtol=0, atol=5e-5)
