"""The device catalog synthesizer (io/synth_device.py) and its threefry
(io/_threefry.py) on the CPU, against hpfw_tpu.io.synth_jax and jax.random.

- threefry2x32: PRNGKey, fold_in and raw bits bit-equal to jax.random's;
  uniform bit-equal; normal within 4 ulp and 98% of draws equal (at most 3
  ulp and 99.06% equal seen over 10^6 draws: the port evaluates XLA's
  erfinv polynomial with torch's log1p);
- the four renderers against synth_jax at 4-6 s: XLA's CPU backend rounds
  its float32 chain differently (fused multiply-adds, its own sin and
  cumsum), so the audio is held to max |diff| < 1e-2 and relative RMS
  < 3e-3 (measured: at most 4.9e-3 and 1.7e-3 over 8 x 6 s tracks, the
  queries and the live renditions; the artist renders at most 1.1e-2 and
  6.0e-3 at 4 s, held to 2.5e-2 and 1.2e-2), and prints
  built from the two renderings may differ only in bits whose float64
  margin is below 10% of the RMS margin (at most 0.06 seen), fewer than
  0.5% of them (0.15% seen);
- tests/test_synth_jax.py's properties on the port: deterministic across
  batches, B = 1 equal to a batch row, query excerpts equal to the catalog
  audio under -80 dB noise, covers correlated.
"""

import jax
import numpy as np
import pytest
import torch

from hpfw_tpu import oracle
from hpfw_tpu.io import synth_jax
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.io import _threefry as tf
from hpfw_tpu_torch.io import synth_device as sd
from tests.test_persist import _filters


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7000, 77_003, 2 ** 31 + 5, 5_000_000_035, -5])
def test_prng_key_and_fold_in_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    mine = tf.PRNGKey(seed)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(key))
    data = [0, 1, 6, 1009, 1_000_003 + 77, 2_000_003, 2 ** 31 + 3]
    folded = tf.fold_in(mine, torch.tensor(data))
    for i, x in enumerate(data):
        want = np.asarray(jax.random.fold_in(key, x))
        np.testing.assert_array_equal(tf.fold_in(mine, x).numpy(), want)
        np.testing.assert_array_equal(folded[i].numpy(), want)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (1001,)])
def test_bits_and_uniform_bit_equal(shape):
    for seed, d in [(7000, 4), (0, 1_000_003), (12, 6)]:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        mine = tf.fold_in(tf.PRNGKey(seed), d)
        np.testing.assert_array_equal(tf.bits(mine, shape).numpy(),
                                      np.asarray(jax.random.bits(key, shape)).astype(np.int64))
        np.testing.assert_array_equal(tf.uniform(mine, shape).numpy(),
                                      np.asarray(jax.random.uniform(key, shape)))
        np.testing.assert_array_equal(
            tf.uniform(mine, shape, -2.5, 3.0).numpy(),
            np.asarray(jax.random.uniform(key, shape, minval=-2.5, maxval=3.0)))


def test_batched_keys_draw_as_their_rows():
    base = tf.PRNGKey(7000)
    keys = tf.fold_in(base, torch.arange(12))
    u, z = tf.uniform(keys, (7,)), tf.normal(keys, (9,))
    for i in range(12):
        np.testing.assert_array_equal(u[i].numpy(), tf.uniform(tf.fold_in(base, i), (7,)).numpy())
        np.testing.assert_array_equal(z[i].numpy(), tf.normal(tf.fold_in(base, i), (9,)).numpy())


def test_normal_within_ulps():
    key = jax.random.fold_in(jax.random.PRNGKey(7000), 1_000_003)
    mine = tf.fold_in(tf.PRNGKey(7000), 1_000_003)
    want = np.asarray(jax.random.normal(key, (1_000_000,)))
    got = tf.normal(mine, (1_000_000,)).numpy()
    ulps = _ulps(got, want)
    assert ulps.max() <= 4, ulps.max()
    assert (ulps == 0).mean() > 0.98
    edge = torch.tensor([1.0, -1.0, 0.0, 0.5])
    np.testing.assert_array_equal(tf.erfinv(edge).numpy()[:3], [np.inf, -np.inf, 0.0])


def _audio_close(got, want, max_abs, rel_rms):
    diff = got.astype(np.float64) - want
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(diff).max() < max_abs, np.abs(diff).max()
    assert np.sqrt(np.mean(diff ** 2) / np.mean(want.astype(np.float64) ** 2)) < rel_rms


@pytest.fixture(scope="module")
def catalogs(cfg):
    ids = np.arange(8)
    return (np.asarray(synth_jax.synth_batch(ids, 6.0, cfg)),
            sd.synth_batch(ids, 6.0, _port(cfg), device="cpu").numpy())


def test_synth_batch_close_to_jax(catalogs):
    want, got = catalogs
    _audio_close(got, want, 1e-2, 3e-3)


def test_prints_of_the_two_renderings(cfg, catalogs):
    """Margin audit: a bit may differ only where the float64 margin of the
    reference's audio is below 10% of its RMS margin."""
    want, got = catalogs
    filters = _filters(cfg)
    pc = _port(cfg)
    fw = api.fingerprint_batch(want, filters, pc, device="cpu")
    fg = api.fingerprint_batch(got, filters, pc, device="cpu")
    n_diff = 0
    for i in range(want.shape[0]):
        m = oracle.delta_margins(want[i], filters, cfg)
        bits = lambda p: np.unpackbits(p.view(np.uint8), bitorder="little").reshape(-1, 64)  # noqa: E731
        diff = bits(fg[i]) != bits(fw[i])
        n_diff += int(diff.sum())
        assert np.all(m[diff] < 0.1 * np.sqrt(np.mean(m ** 2))), i
    assert n_diff < 0.005 * fw.size * 32, n_diff


@pytest.mark.parametrize("kw", [dict(), dict(noise_db=-30.0, noise_seeds=[5, 6, 7])])
def test_query_batch_close_to_jax(cfg, kw):
    args = ([2, 13, 7], [1000, 3000, 500 * cfg.sample_rate], 4.0, 2.0)
    want = np.asarray(synth_jax.query_batch(*args, cfg, **kw))
    _audio_close(sd.query_batch(*args, _port(cfg), device="cpu", **kw).numpy(), want,
                 1e-2, 3e-3)


@pytest.mark.parametrize("kw", [dict(pitch_st=0.5, stretch=1.03), dict(stretch=0.8),
                                dict(pitch_st=-1.0)])
def test_live_query_batch_close_to_jax(cfg, kw):
    args = ([2, 7], [1000, 3000], 4.0, 2.0)
    want = np.asarray(synth_jax.live_query_batch(*args, cfg, **kw))
    _audio_close(sd.live_query_batch(*args, _port(cfg), device="cpu", **kw).numpy(), want,
                 1e-2, 3e-3)


@pytest.mark.parametrize("artist", [0, 3, 5])
def test_synth_artist_batch_close_to_jax(cfg, artist):
    want = np.asarray(synth_jax.synth_artist_batch(artist, [0, 1, 2, 5], 4.0, cfg))
    got = sd.synth_artist_batch(artist, [0, 1, 2, 5], 4.0, _port(cfg), device="cpu").numpy()
    _audio_close(got, want, 2.5e-2, 1.2e-2)


def test_host_side_copies_identical():
    for i in range(40):
        assert sd.cover_source(i) == synth_jax.cover_source(i)
    for a in range(12):
        assert sd.artist_style(a) == synth_jax.artist_style(a)


def test_deterministic_across_batches(cfg):
    pc = _port(cfg)
    a = sd.synth_batch(np.arange(8), 3.0, pc, device="cpu").numpy()
    b = sd.synth_batch([3, 5], 3.0, pc, device="cpu").numpy()
    np.testing.assert_array_equal(a[3], b[0])
    np.testing.assert_array_equal(a[5], b[1])
    assert a.shape == (8, 3 * cfg.sample_rate) and a.dtype == np.float32
    assert np.all(np.abs(a).max(axis=1) <= 0.9 + 1e-6)


def test_single_matches_batch(cfg):
    pc = _port(cfg)
    a = sd.synth_batch(np.arange(6), 3.0, pc, device="cpu").numpy()
    one = sd.synth_batch([4], 3.0, pc, device="cpu").numpy()
    np.testing.assert_array_equal(one[0], a[4])
    art = sd.synth_artist_batch(2, np.arange(4), 2.0, pc, device="cpu").numpy()
    np.testing.assert_array_equal(sd.synth_artist_batch(2, [3], 2.0, pc, device="cpu")[0].numpy(),
                                  art[3])


def test_query_excerpts_catalog_audio(cfg):
    pc = _port(cfg)
    pcm = sd.synth_batch(np.arange(6), 4.0, pc, device="cpu").numpy()
    s = int(0.5 * cfg.sample_rate)
    q = sd.query_batch([5], [s], 4.0, 2.0, pc, noise_db=-80.0, device="cpu").numpy()
    assert np.abs(q[0] - pcm[5][s:s + q.shape[1]]).max() < 1e-3
    live = sd.live_query_batch([5], [s], 4.0, 2.0, pc, noise_db=-80.0, device="cpu").numpy()
    np.testing.assert_array_equal(live, q)


def test_covers_have_correlated_prints(cfg):
    pc = _port(cfg)
    pcm = sd.synth_batch(np.arange(5), 4.0, pc, device="cpu").numpy()
    fps = api.fingerprint_batch(pcm, _filters(cfg), pc, device="cpu")

    def sim(a, b):
        return 1.0 - np.unpackbits(np.bitwise_xor(a, b).view(np.uint8)).sum() / (a.size * 32)

    cover, unrelated = sim(fps[3], fps[0]), sim(fps[4], fps[0])
    assert cover > 0.65 and abs(unrelated - 0.5) < 0.1
    assert cover < 0.999


def test_renders_where_told(cfg):
    out = sd.synth_batch([1, 2], 1.0, _port(cfg), device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sd.synth_batch([1], 1.0, _port(cfg))
