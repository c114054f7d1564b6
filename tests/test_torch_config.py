"""The port's copies of framework-free pieces, pinned to their originals.

hpfw_tpu_torch cannot import hpfw_tpu (whose package import pulls in jax),
so it carries copies of the config, the synthetic-audio generators (tracks,
artist tracks, queries, pitch shift), the float64 oracle (oracle/pipeline.py,
the one home of the eigenvector sign convention and the CQT kernel matrix),
match/align.py, the audio I/O of io/wav.py with the MPEG and ADTS frame
headers its sniffers read, the native CPU pipeline's wrappers, the
profiling scopes, the device synthesizer's host-side helpers and the golden
tests' margin audit (oracle/audit.py). These tests hold each copy
bit-identical to the original, prove the port imports no jax, and check
that the kernel build fails loudly without a CUDA toolkit.
"""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpfw_tpu import oracle
from hpfw_tpu.config import HpfwConfig as JaxConfig
from hpfw_tpu.io import aac as jax_aac
from hpfw_tpu.io import mp3 as jax_mp3
from hpfw_tpu.io import native as jax_native
from hpfw_tpu.io import synth as jax_synth
from hpfw_tpu.io import synth_jax
from hpfw_tpu.io import wav as jax_wav
from hpfw_tpu.match import align as jax_align
from hpfw_tpu.ops import frontend as jax_frontend
from hpfw_tpu.oracle import pipeline as jax_pipeline
from hpfw_tpu.utils import profiling as jax_profiling
from hpfw_tpu_torch import filters as port_filters
from hpfw_tpu_torch import oracle as port_oracle
from hpfw_tpu_torch.config import HpfwConfig as PortConfig
from hpfw_tpu_torch.io import _sniff as port_sniff
from hpfw_tpu_torch.io import native as port_native
from hpfw_tpu_torch.io import synth as port_synth
from hpfw_tpu_torch.io import synth_device
from hpfw_tpu_torch.io import wav as port_wav
from hpfw_tpu_torch.match import align as port_align
from hpfw_tpu_torch.ops import _build
from hpfw_tpu_torch.ops import frontend as port_frontend
from hpfw_tpu_torch.oracle import audit as port_audit
from hpfw_tpu_torch.oracle import pipeline as port_pipeline
from hpfw_tpu_torch.utils import profiling as port_profiling
from test_tpu_pipeline import assert_bits_match_with_margin_audit as golden_audit

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
    for a_seed, t_seed, dur in [(0, 0, 0.5), (3, 7, 1.3), (11, 2, 2.0)]:
        np.testing.assert_array_equal(port_synth.synth_artist_track(a_seed, t_seed, dur, p),
                                      jax_synth.synth_artist_track(a_seed, t_seed, dur, j))
    for a, b in zip(port_synth.synth_artist_catalog(2, 3, 1.0, p),
                    jax_synth.synth_artist_catalog(2, 3, 1.0, j)):
        np.testing.assert_array_equal(a, b)
    for st in (0.5, -1.0, 0.25, 0.0):
        np.testing.assert_array_equal(port_synth.pitch_shift(track, st, p),
                                      jax_synth.pitch_shift(track, st, j))


@pytest.mark.parametrize("case", ["excerpt", "stretched", "random", "flat", "edge"])
def test_align_copy_identical(case):
    """match/align.py's copy gives the original's outputs on seeded inputs:
    a true excerpt, a 2%-fast one, a random track, a flat (constant) track
    and an offset near the track's end, at several k, band and tol."""
    rng = np.random.default_rng(21)
    track = rng.integers(0, 2 ** 32, (500, 2), dtype=np.uint32)
    o = 440 if case == "edge" else 80
    q = track[o:o + 160].copy()
    if case == "stretched":
        q = track[np.clip(np.round(o + np.arange(160) * 1.02).astype(int), 0, 499)]
    elif case == "random":
        q = rng.integers(0, 2 ** 32, (160, 2), dtype=np.uint32)
    elif case == "flat":
        track = np.full((500, 2), 0x0F0F0F0F, np.uint32)
    for kw in [{}, dict(k=4, band=8, tol=1.0), dict(k=16, band=30, prom_min=0.0),
               dict(length=470)]:
        got = port_align.structure_evidence(q, track, o, **kw)
        want = jax_align.structure_evidence(q, track, o, **kw)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{case} {kw} {key}")
    pos = np.arange(6) * 10
    d = np.array([0, 1, 1, 9, 2, 2])
    assert port_align.offset_line_fit(pos, d) == jax_align.offset_line_fit(pos, d)
    assert port_align.offset_line_fit(pos[:1], d[:1]) == jax_align.offset_line_fit(pos[:1], d[:1])
    with pytest.raises(ValueError):
        port_align.subwindow_offsets(q[:3], track, o)


# The audio I/O copied unchanged from hpfw_tpu/io: (port module, original
# module, names). The sniffers also keep their bodies, less the imports that
# the port makes once at the top of io/wav.py.
IO_COPIES = [
    (port_wav, jax_wav, ["_mulaw_table", "_alaw_table", "_decode_f80", "_decode_aiff_bytes",
                         "_decode_au_bytes", "resample_linear", "_design_kaiser_sinc",
                         "resample_sinc", "_KAISER_BETA", "_HALF_LEN_FACTOR"]),
    (port_sniff, jax_mp3, ["BITRATES", "BITRATES_LSF", "SAMPLE_RATES", "SAMPLE_RATES_V2",
                           "SAMPLE_RATES_V25", "FrameHeader", "_find_sync",
                           "_free_format_size", "_skip_id3"]),
    (port_sniff, jax_aac, ["ADTS_RATES", "_AdtsHeader", "_find_adts"]),
    (port_native, jax_native, ["_fptr", "fingerprint_cpu", "resample_linear", "match_db"]),
    (port_pipeline, jax_pipeline, list(oracle.__all__)),
    (port_oracle, oracle, ["__all__"]),
    (port_profiling, jax_profiling, ["scope_stats", "reset_scopes", "dump_metrics"]),
    (synth_device, synth_jax, ["cover_source", "artist_style", "COVER_PERIOD",
                               "COVER_SHIFT_ST", "N_PARTIALS", "NOISE_DB"]),
]


@pytest.mark.parametrize("port_mod,jax_mod,names", IO_COPIES,
                         ids=["wav", "mp3_headers", "adts_headers", "native", "oracle",
                              "oracle_names", "profiling", "synth_device"])
def test_io_copies_identical(port_mod, jax_mod, names):
    for name in names:
        ours, theirs = getattr(port_mod, name), getattr(jax_mod, name)
        if callable(ours):
            assert inspect.getsource(ours) == inspect.getsource(theirs), name
        else:
            assert ours == theirs, name


def test_sniffers_identical_but_imports():
    def body(fn):
        return [ln for ln in inspect.getsource(fn).splitlines()
                if ln.strip() and not ln.strip().startswith("from .")]

    for name in ("_looks_like_mpeg", "_looks_like_adts"):
        assert body(getattr(port_wav, name)) == body(getattr(jax_wav, name)), name


def test_fix_eigenvector_signs_identical():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((40, 64))
    f[:, 3] = 0.0   # an all-zero column keeps sign +1
    np.testing.assert_array_equal(port_oracle.fix_eigenvector_signs(f),
                                  oracle.fix_eigenvector_signs(f))
    from hpfw_tpu_torch.learn import pca

    assert pca.fix_eigenvector_signs is port_pipeline.fix_eigenvector_signs


@pytest.mark.parametrize("kw", [SMALL, {}, dict(window="hamming", **SMALL)],
                         ids=["small", "default", "hamming"])
def test_cqt_kernel_matrix_identical(kw):
    assert port_frontend.cqt_kernel_matrix is port_pipeline.cqt_kernel_matrix
    np.testing.assert_array_equal(port_pipeline.cqt_kernel_matrix(PortConfig(**kw)),
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
            "hpfw_tpu_torch.streaming.pool, hpfw_tpu_torch.learn.pca, "
            "hpfw_tpu_torch.match.align, hpfw_tpu_torch.artist, hpfw_tpu_torch.io.wav, "
            "hpfw_tpu_torch.io.ingest, hpfw_tpu_torch.io.native, hpfw_tpu_torch.cli, "
            "hpfw_tpu_torch.oracle, hpfw_tpu_torch.oracle.pipeline, "
            "hpfw_tpu_torch.utils.profiling, hpfw_tpu_torch.io.synth_device, "
            "hpfw_tpu_torch.io._threefry, hpfw_tpu_torch.graft_entry, "
            "hpfw_tpu_torch.oracle.audit; "
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


@pytest.fixture(scope="module")
def audit_track():
    """A small-config track's oracle prints and margins, and the bit of each
    (print, filter) in the packed words (lsb0: filter i is bit i % 32 of
    word i // 32)."""
    cfg = JaxConfig(**SMALL)
    pcm = jax_synth.synth_track(5, 2.0, cfg)
    filters = oracle.fix_eigenvector_signs(
        np.random.default_rng(0).standard_normal((cfg.context_dim, 64))).astype(np.float32)
    return pcm, filters, oracle.fingerprint(pcm, filters, cfg), \
        oracle.delta_margins(pcm, filters, cfg)


def _flip(prints, where):
    out = prints.copy()
    for n, i in where:
        out[n, i // 32] ^= np.uint32(1 << (i % 32))
    return out


def test_audit_copy_identical():
    assert (inspect.getsource(port_audit.assert_bits_match_with_margin_audit)
            == inspect.getsource(golden_audit))


@pytest.mark.parametrize("case", ["equal", "free_bits_flipped", "beyond_margin",
                                  "degenerate", "off_free_in_a_free_print"])
def test_audit_verdicts_and_counts_equal_golden(audit_track, case):
    """The copy and the golden audit give the same verdict and message, and
    margin_audit_counts the counts that the message states (or that pass),
    and by position the differing bits whose own margin is not free: the
    golden audit passes a non-free bit flipped in a print that has a free
    bit elsewhere, and off_free counts it."""
    _, _, want, margins = audit_track
    rel_tol = {"free_bits_flipped": 0.005, "off_free_in_a_free_print": 0.005,
               "degenerate": 1.0}.get(case, 1e-4)
    floor = rel_tol * np.sqrt(np.mean(margins ** 2))
    free = np.argwhere(margins < floor)
    where = []
    if case == "free_bits_flipped":
        assert 0 < len(free) < 0.01 * margins.size
        where = free[::2]
    elif case == "beyond_margin":
        where = [(3, int(np.argmax(margins[3]))), (40, 7), (40, 8)]
    elif case == "off_free_in_a_free_print":
        n = int(free[0, 0])
        where = [(n, int(np.argmax(margins[n])))]
    got = _flip(want, where)
    verdicts = []
    for fn in (golden_audit, port_audit.assert_bits_match_with_margin_audit):
        try:
            fn(got, want, margins, rel_tol=rel_tol)
            verdicts.append(None)
        except AssertionError as e:     # pytest appends its rewrite of the golden's assert
            verdicts.append(str(e).splitlines()[0])
    assert verdicts[0] == verdicts[1]
    c = port_audit.margin_audit_counts(got, want, margins, rel_tol=rel_tol)
    assert c["free_bits"] == len(free)
    assert c["differing_bits"] == int(np.unpackbits((got ^ want).view(np.uint8)).sum())
    assert (verdicts[0] is None) == (c["over"] == 0 and not c["degenerate"])
    expect = {"equal": (0, False), "free_bits_flipped": (0, False),
              "beyond_margin": (2, False), "degenerate": (0, True),
              "off_free_in_a_free_print": (0, False)}[case]
    assert (c["over"], c["degenerate"]) == expect
    assert c["off_free"] == sum(int(margins[n, i] >= floor) for n, i in where)
    assert c["off_free"] == {"beyond_margin": 3, "off_free_in_a_free_print": 1}.get(case, 0)
    if case == "beyond_margin":
        assert verdicts[0] == (f"{c['over']} prints differ beyond margin tolerance "
                               f"(total diff bits {c['differing_bits']}, "
                               f"free bits {c['free_bits']})")
    elif case == "degenerate":
        assert re.fullmatch(r"margin audit degenerate: (\d+) free bits", verdicts[0]).group(1) \
            == str(c["free_bits"])


def test_oracle_prints_and_margins_equal_oracle(audit_track):
    pcm, filters, want, margins = audit_track
    got, got_margins = port_audit.oracle_prints_and_margins(pcm, filters, PortConfig(**SMALL))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_margins, margins)
