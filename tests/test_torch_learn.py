"""The port's filter learning on the CPU vs hpfw_tpu.learn.pca: the covariance
moments, the .npz state in both directions, the eigh step bit for bit, and
the filters against the float64 oracle."""

import numpy as np
import pytest
import torch

from hpfw_tpu import oracle
from hpfw_tpu.io import synth
from hpfw_tpu.learn import pca as jax_pca
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.learn import pca


def _port(cfg):
    return HpfwConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def corpus(cfg):
    """4 tracks of 1.5 s (one compile of the reference's moments)."""
    return synth.synth_catalog(4, 1.5, cfg, base_seed=90)


@pytest.fixture(scope="module")
def states(cfg, corpus):
    """The reference's and the port's states over the whole corpus."""
    return (_accumulate("jax", cfg, jax_pca.CovarianceState.zero(cfg), corpus),
            _accumulate("port", cfg, pca.CovarianceState.zero(_port(cfg)), corpus))


def test_accumulate_track_matches_reference(cfg, corpus, states):
    ref, port = states
    assert port.count == ref.count > 0
    assert port.xtx.dtype == port.xsum.dtype == np.float32
    assert port.xtx.shape == (cfg.context_dim, cfg.context_dim)
    np.testing.assert_allclose(port.xtx, ref.xtx, rtol=1e-5)
    np.testing.assert_allclose(port.xsum, ref.xsum, rtol=1e-5)
    # One track's moments: the same count, and X^T X symmetric.
    one = pca.accumulate_track(pca.CovarianceState.zero(_port(cfg)), corpus[0], _port(cfg),
                               device="cpu")
    want = jax_pca.accumulate_track(jax_pca.CovarianceState.zero(cfg), corpus[0], cfg)
    assert one.count == want.count == cfg.n_frames(len(corpus[0])) - cfg.context_w + 1
    np.testing.assert_allclose(one.xtx, want.xtx, rtol=1e-5)
    np.testing.assert_allclose(one.xtx, one.xtx.T, rtol=1e-6)


@pytest.mark.parametrize("n_samples", [0, 100, 2048 + 6 * 256])
def test_short_track_leaves_state_unchanged(cfg, n_samples):
    """Fewer than context_w frames: the state comes back as it was."""
    port = _port(cfg)
    assert port.n_frames(n_samples) < port.context_w
    state = pca.CovarianceState.zero(port)
    assert pca.accumulate_track(state, np.ones(n_samples, np.float32), port,
                                device="cpu") is state
    with pytest.raises(ValueError, match="no context windows"):
        pca.finalize_filters(state, port)


def _accumulate(pkg, cfg, state, tracks):
    """Fold tracks into state with the package named by pkg ("jax", "port")."""
    for t in tracks:
        state = (jax_pca.accumulate_track(state, t, cfg) if pkg == "jax" else
                 pca.accumulate_track(state, t, _port(cfg), device="cpu"))
    return state


@pytest.mark.parametrize("saver,resumer", [("jax", "port"), ("port", "jax")])
def test_state_saved_by_one_package_resumes_in_the_other(cfg, corpus, states, tmp_path,
                                                         saver, resumer):
    """Two tracks in one package, saved; the other loads the file and folds in
    the rest: the state of a whole run in the second package."""
    mod = {"jax": jax_pca, "port": pca}
    s = _accumulate(saver, cfg, mod[saver].CovarianceState.zero(cfg), corpus[:2])
    path = str(tmp_path / "cov.npz")
    s.save(path)
    with np.load(path) as z:
        assert set(z.files) == {"xtx", "xsum", "count"} and z["count"].dtype == np.int64
    r = mod[resumer].CovarianceState.load(path)
    assert r.count == s.count
    np.testing.assert_array_equal(r.xtx, s.xtx)
    np.testing.assert_array_equal(r.xsum, s.xsum)
    r = _accumulate(resumer, cfg, r, corpus[2:])
    whole = states[0] if resumer == "jax" else states[1]
    assert r.count == whole.count
    np.testing.assert_allclose(r.xtx, whole.xtx, rtol=1e-5)
    np.testing.assert_allclose(r.xsum, whole.xsum, rtol=1e-5)


def test_resume_mid_corpus_gives_the_same_state(cfg, corpus, states, tmp_path):
    """The port's twin of test_tpu_pipeline.py::test_learn_filters_resumable."""
    port = _port(cfg)
    s = pca.CovarianceState.zero(port)
    for t in corpus[:2]:
        s = pca.accumulate_track(s, t, port, device="cpu")
    path = str(tmp_path / "cov.npz")
    s.save(path)
    s = pca.CovarianceState.load(path)
    for t in corpus[2:]:
        s = pca.accumulate_track(s, t, port, device="cpu")
    whole = states[1]
    assert s.count == whole.count
    np.testing.assert_allclose(s.xtx, whole.xtx, rtol=1e-6)
    np.testing.assert_allclose(s.xsum, whole.xsum, rtol=1e-6)


@pytest.mark.parametrize("which", ["jax_state", "port_state"])
def test_finalize_filters_bit_identical_across_packages(cfg, states, which):
    state = states[0] if which == "jax_state" else states[1]
    got = pca.finalize_filters(pca.CovarianceState(state.xtx, state.xsum, state.count),
                               _port(cfg))
    want = jax_pca.finalize_filters(state, cfg)
    assert got.dtype == np.float32 and got.shape == (cfg.context_dim, cfg.n_filters)
    np.testing.assert_array_equal(got, want)


def test_learn_filters_close_to_oracle(cfg):
    """The twin of test_tpu_pipeline.py::test_learn_filters_tpu_close_to_oracle,
    through the public entry, with the device given as a string and a
    torch.device."""
    corpus = synth.synth_catalog(3, 2.0, cfg, base_seed=77)
    got = api.learn_filters(corpus, _port(cfg), device="cpu")
    want = oracle.learn_filters(corpus, cfg)
    assert got.shape == want.shape and got.dtype == np.float32
    cos = np.abs(np.sum(got.astype(np.float64) * want, axis=0))
    assert np.all(cos > 0.98), cos.min()
    np.testing.assert_array_equal(
        pca.learn_filters(corpus, _port(cfg), device=torch.device("cpu")), got)
