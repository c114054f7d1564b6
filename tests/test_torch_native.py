"""The port's copies of hpfw_tpu's native CPU pipeline (io/native.py:
fingerprint_cpu, resample_linear, match_db) against the originals.

Both wrappers run on the port's build of native/*.cc (the reference module's
library is swapped for it, so these tests never depend on native/'s own
lazily built library): the arrays must be equal. fingerprint_cpu is held to
the oracle by the margin audit, match_db to the port's api.match on the CPU,
and resample_linear to the NumPy twin io/wav.resample_linear, which
io/wav.resample(kind="linear") dispatches to in both packages.
"""

import numpy as np
import pytest

from hpfw_tpu import oracle
from hpfw_tpu.io import native as jax_native
from hpfw_tpu.io import synth
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.io import native, wav
from tests.test_persist import _filters
from tests.test_tpu_pipeline import assert_bits_match_with_margin_audit


@pytest.fixture
def reference(monkeypatch):
    """hpfw_tpu.io.native bound to the port's library build."""
    monkeypatch.setattr(jax_native, "_lib", native.load_library())
    return jax_native


@pytest.mark.parametrize("seconds,threads", [(3.0, 0), (1.3, 3), (0.05, 1)])
def test_fingerprint_cpu_equals_reference(reference, cfg, seconds, threads):
    pcm = synth.synth_track(11, seconds, cfg)
    filters = _filters(cfg)
    pc = HpfwConfig.from_json(cfg.to_json())
    got = native.fingerprint_cpu(pcm, filters, pc, n_threads=threads)
    want = reference.fingerprint_cpu(pcm, filters, cfg, n_threads=threads)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint32 and got.shape == (pc.n_hashprints(pcm.shape[0]), 2)
    if got.shape[0]:
        assert_bits_match_with_margin_audit(got, oracle.fingerprint(pcm, filters, cfg),
                                            oracle.delta_margins(pcm, filters, cfg))


@pytest.mark.parametrize("sr_out", [8000, 16000, 22050, 44100, 48000])
def test_resample_linear_equals_reference_and_twin(reference, cfg, sr_out):
    pcm = synth.synth_track(10, 0.7, cfg)
    got = native.resample_linear(pcm, cfg.sample_rate, sr_out)
    np.testing.assert_array_equal(got, reference.resample_linear(pcm, cfg.sample_rate, sr_out))
    twin = wav.resample(pcm, cfg.sample_rate, sr_out, kind="linear")
    assert got.shape == twin.shape
    np.testing.assert_allclose(got, twin, atol=1e-6)


@pytest.mark.parametrize("threads", [0, 4])
def test_match_db_equals_reference_and_api(reference, cfg, threads):
    rng = np.random.default_rng(0)
    lengths = [300, 120, 37, 300, 251, 0]
    tracks = [rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint32) for n in lengths]
    q = rng.integers(0, 2 ** 32, (50, 2), dtype=np.uint32)
    tracks[3][77:127] = q
    tracks[1][5:55] = q ^ np.uint32(1)
    got = native.match_db(q, tracks, n_threads=threads)
    want = reference.match_db(q, tracks, n_threads=threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pc = HpfwConfig.from_json(cfg.to_json())
    prints = np.zeros((len(tracks), max(lengths), 2), np.uint32)
    for i, t in enumerate(tracks):
        prints[i, :t.shape[0]] = t
    db = api.FingerprintDB(pc, _filters(cfg), [str(i) for i in range(len(tracks))], prints,
                           np.array(lengths, np.int32), device="cpu")
    ids, scores, offs = api.match(q, db, top_k=len(tracks))
    order = [int(i) for i in ids]
    np.testing.assert_array_equal(scores, got[0][order])
    np.testing.assert_array_equal(offs, got[1][order])
    assert order[0] == 3 and got[1][3] == 77
