"""The port's copies of framework-free pieces, pinned to their originals.

hpfw_tpu_torch cannot import hpfw_tpu (whose package import pulls in jax),
so it carries copies of the config, the synthetic-audio generator, the
eigenvector sign convention and the CQT kernel matrix. These tests hold each
copy bit-identical to the original, prove the port imports no jax, and check
that the kernel build fails loudly without a CUDA toolkit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpfw_tpu import oracle
from hpfw_tpu.config import HpfwConfig as JaxConfig
from hpfw_tpu.io import synth as jax_synth
from hpfw_tpu.ops import frontend as jax_frontend
from hpfw_tpu_torch import filters as port_filters
from hpfw_tpu_torch.config import HpfwConfig as PortConfig
from hpfw_tpu_torch.io import synth as port_synth
from hpfw_tpu_torch.ops import _build
from hpfw_tpu_torch.ops import frontend as port_frontend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8,
             delta_lag=4, db_downsample=4)


@pytest.mark.parametrize("make", [
    lambda C: C(),
    lambda C: C(**SMALL),
    lambda C: C.catalog_scale(),
    lambda C: C(bit_order="msb0", tie_break="ge", window="hamming"),
], ids=["default", "small", "catalog_scale", "msb0_ge_hamming"])
def test_config_json_identical_and_cross_loads(make):
    port, jax_cfg = make(PortConfig), make(JaxConfig)
    assert port.to_json() == jax_cfg.to_json()
    assert JaxConfig.from_json(port.to_json()) == jax_cfg
    assert PortConfig.from_json(jax_cfg.to_json()) == port
    assert port.context_dim == jax_cfg.context_dim
    assert port.min_samples() == jax_cfg.min_samples()
    for n in (0, 5000, 200_000):
        assert port.n_hashprints(n) == jax_cfg.n_hashprints(n)


@pytest.mark.parametrize("bad", [dict(n_filters=32), dict(bit_order="x"),
                                 dict(frame_len=1024)])
def test_config_validate_rejects_alike(bad):
    with pytest.raises(AssertionError):
        JaxConfig(**bad).validate()
    with pytest.raises(AssertionError):
        PortConfig(**bad).validate()


def test_synth_copies_bit_identical():
    p, j = PortConfig(**SMALL), JaxConfig(**SMALL)
    for seed, dur in [(0, 0.5), (7, 1.3), (1234, 2.0)]:
        np.testing.assert_array_equal(port_synth.synth_track(seed, dur, p),
                                      jax_synth.synth_track(seed, dur, j))
    for a, b in zip(port_synth.synth_catalog(3, 1.0, p), jax_synth.synth_catalog(3, 1.0, j)):
        np.testing.assert_array_equal(a, b)
    track = jax_synth.synth_track(9, 3.0, j)
    for kw in [dict(), dict(noise_db=-15.0, seed=3), dict(noise_db=-5.0, gain=4.0)]:
        np.testing.assert_array_equal(port_synth.make_query(track, 0.7, 1.5, p, **kw),
                                      jax_synth.make_query(track, 0.7, 1.5, j, **kw))


def test_fix_eigenvector_signs_identical():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((40, 64))
    f[:, 3] = 0.0   # an all-zero column keeps sign +1
    np.testing.assert_array_equal(port_filters.fix_eigenvector_signs(f),
                                  oracle.fix_eigenvector_signs(f))


@pytest.mark.parametrize("kw", [SMALL, {}, dict(window="hamming", **SMALL)],
                         ids=["small", "default", "hamming"])
def test_cqt_kernel_matrix_identical(kw):
    np.testing.assert_array_equal(port_frontend.cqt_kernel_matrix(PortConfig(**kw)),
                                  oracle.pipeline.cqt_kernel_matrix(JaxConfig(**kw)))
    for a, b in zip(port_frontend.cqt_kernel_arrays(PortConfig(**kw)),
                    jax_frontend.cqt_kernel_arrays(JaxConfig(**kw))):
        np.testing.assert_array_equal(a, b)


def test_filters_from_jax_keeps_values_and_checks_shape():
    cfg = PortConfig(**SMALL)
    f = np.random.default_rng(1).standard_normal((cfg.context_dim, 64)).astype(np.float32)
    t = port_filters.filters_from_jax(f, cfg, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), f)
    with pytest.raises(ValueError):
        port_filters.filters_from_jax(f[:-1], cfg, "cpu")


def test_port_imports_no_jax():
    code = ("import sys, hpfw_tpu_torch, hpfw_tpu_torch.api, hpfw_tpu_torch.filters, "
            "hpfw_tpu_torch.io.synth, hpfw_tpu_torch.ops.fused, "
            "hpfw_tpu_torch.ops._build, hpfw_tpu_torch.match.matcher, "
            "hpfw_tpu_torch.ops.coarse, hpfw_tpu_torch.ops.coarse_scan, "
            "hpfw_tpu_torch.ops.fine, hpfw_tpu_torch.match.scaled, "
            "hpfw_tpu_torch.match.stretch, hpfw_tpu_torch.ops.probe, "
            "hpfw_tpu_torch.serve, hpfw_tpu_torch.streaming.session, "
            "hpfw_tpu_torch.streaming.pool; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hpfw_tpu')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
