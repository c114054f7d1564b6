"""Port TwoStageDB on the CPU (the plain versions of K4 and K5) vs hpfw_tpu's
TwoStageDB on its single-device Pallas path in interpret mode: the same ids,
scores and offsets, case by case, and caches that load in either package.

Sizes follow tests/test_scaled.py: T=48 tracks of L=200 prints, 64-print
queries, stride 8, coarse_tile=8 on the JAX side.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hpfw_tpu import api as jax_api
from hpfw_tpu.config import HpfwConfig as JaxConfig
from hpfw_tpu.match import scaled as jax_scaled
from hpfw_tpu.match import stretch as jax_stretch
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig as PortConfig
from hpfw_tpu_torch.match import scaled, stretch
from hpfw_tpu_torch.match.scaled import TwoStageDB

SMALL = dict(frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8,
             delta_lag=4, db_downsample=8)
T, L, NQ, STRIDE = 48, 200, 64, 8

# Knob sets of one two-stage configuration each: (TwoStageDB kwargs, match
# kwargs). "catalog_scale" takes its knobs from HpfwConfig.catalog_scale().
CONFIGS = {
    "phases_1": ({}, dict(pool=8)),
    "query_phases_4": (dict(query_phases=4), dict(pool=8)),
    "two_pass_prefilter_T": (dict(query_phases=4, prefilter=T, prefilter_phases=2),
                             dict(pool=T)),
    "two_pass_prefilter_16": (dict(query_phases=4, prefilter=16, prefilter_phases=2),
                              dict(pool=8)),
    "prefilter_channels_32": (dict(query_phases=4, prefilter=16, prefilter_phases=2,
                                   prefilter_channels=32), dict(pool=8)),
    "catalog_scale": ({}, dict(pool=16)),
    "sum_coarse_channels_32": (dict(coarse_kind="sum", coarse_channels=32), dict(pool=8)),
}


def _cfgs(name):
    if name == "catalog_scale":
        return JaxConfig.catalog_scale(**SMALL), PortConfig.catalog_scale(**SMALL)
    return JaxConfig(**SMALL), PortConfig(**SMALL)


@pytest.fixture(scope="module")
def data():
    """Random prints with some short tracks, and 4 noisy misphased excerpts
    (r = 1, 3, 4, 7 mod the stride) of tracks 7..10."""
    rng = np.random.default_rng(9)
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    lengths = np.full(T, L, np.int32)
    lengths[[2, 20, 33]] = [150, 97, 64]
    for i, ln in enumerate(lengths):
        prints[i, ln:] = 0
    qs = []
    for k, r in enumerate((1, 3, 4, 7)):
        off = (4 + k) * STRIDE + r
        q = prints[7 + k, off:off + NQ].copy()
        flip = (rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32))
        qs.append(np.bitwise_xor(q, flip))
    return prints, lengths, np.stack(qs)


_BUILT = {}


def _pair(data, name):
    """(JAX TwoStageDB, port TwoStageDB, match kwargs) of a configuration,
    built once per test module."""
    if name not in _BUILT:
        prints, lengths, _ = data
        kw, match_kw = CONFIGS[name]
        jcfg, pcfg = _cfgs(name)
        filt = np.zeros((jcfg.context_dim, 64), np.float32)
        ids = [str(i) for i in range(T)]
        jdb = jax_api.FingerprintDB(jcfg, filt, ids, prints, lengths)
        pdb = api.FingerprintDB(pcfg, filt, ids, prints, lengths)
        j = jax_scaled.TwoStageDB(jdb, stride=STRIDE, use_pallas_fine=True, coarse_tile=8,
                                  pallas_interpret=True, **kw)
        _BUILT[name] = (j, TwoStageDB(pdb, stride=STRIDE, **kw), match_kw)
    return _BUILT[name]


def _same(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("surface", ["match", "match_batch"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_stage_equals_reference(data, name, surface):
    j, p, kw = _pair(data, name)
    qs = data[2]
    if surface == "match":
        for k, q in enumerate(qs):
            got = p.match(q, top_k=5, **kw)
            _same(got, j.match(q, top_k=5, **kw))
            if p.query_phases > 1:              # phased coarse finds every plant
                dense = api.match(q, p.db, top_k=1)
                assert got[0][0] == dense[0][0] == str(7 + k)
                assert (int(got[1][0]), int(got[2][0])) == (int(dense[1][0]),
                                                            int(dense[2][0]))
    else:
        for got, want in zip(p.match_batch(qs, top_k=5, **kw),
                             j.match_batch(qs, top_k=5, **kw)):
            _same(got, want)


def test_derived_state_equals_reference(data):
    for name in ("prefilter_channels_32", "sum_coarse_channels_32"):
        j, p, _ = _pair(data, name)
        np.testing.assert_array_equal(p.db_c.numpy(), np.asarray(j.db_c))
        np.testing.assert_array_equal(p.db_c1.numpy(), np.asarray(j.db_c1))
        assert (p.lc_true, p.n_real, p.prefilter_channels) == (
            j.lc_true, j.n_real, j.prefilter_channels)


@pytest.mark.parametrize("surface", ["match", "match_batch"])
def test_stretch_scan_and_calibrate_equal_reference(data, surface):
    j, p, _ = _pair(data, "query_phases_4")
    qs = data[2]
    for calibrate in (False, True):
        kw = dict(top_k=5, pool=8, stretch_span=0.02, calibrate=calibrate)
        if surface == "match":
            _same(p.match(qs[1], return_variant=True, **kw),
                  j.match(qs[1], return_variant=True, **kw))
        else:
            for got, want in zip(p.match_batch(qs[:2], **kw), j.match_batch(qs[:2], **kw)):
                _same(got, want)


@pytest.mark.parametrize("surface", ["match", "match_batch"])
def test_variant_stacks_equal_reference(data, surface):
    """A pre-scanned (V, N, 2) stack for match, (B, V, N, 2) for match_batch."""
    j, p, _ = _pair(data, "phases_1")
    stacks = stretch.print_variants(data[2][:2], [0.98, 1.0, 1.02])   # (2, 3, N, 2)
    if surface == "match":
        _same(p.match(stacks[0], top_k=5, pool=8, return_variant=True),
              j.match(stacks[0], top_k=5, pool=8, return_variant=True))
    else:
        for got, want in zip(p.match_batch(stacks, top_k=5, pool=8),
                             j.match_batch(stacks, top_k=5, pool=8)):
            _same(got, want)


@pytest.mark.parametrize("t,pool", [(5, 3), (40, 16), (4 * 64 * 16, 16)])
def test_pool_candidates_equal_reference_on_ties(t, pool):
    """Composite-key top-k == lax.top_k (lower index first on ties), padding
    included; the largest case takes the reference's two-level path."""
    rng = np.random.default_rng(t)
    scores = rng.integers(-5, 5, (3, t), dtype=np.int32)          # many ties
    got = scaled._pool_candidates(torch.from_numpy(scores), pool)
    for b in range(3):
        want = np.asarray(jax_scaled._pool_candidates(jnp.asarray(scores[b]), pool))
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("name", ["phases_1", "prefilter_channels_32"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cache_loads_in_either_package(data, tmp_path, name, direction):
    j, p, kw = _pair(data, name)
    # A loaded DB takes its dispatch defaults from the config, so the knobs
    # the source was built with are passed to each call.
    kw = dict(kw, phases=p.query_phases, prefilter=p.prefilter,
              phases1=p.prefilter_phases)
    path = str(tmp_path / "cache")
    if direction == "port_to_jax":
        p.save(path)
        other = jax_scaled.TwoStageDB.load(path, pallas_interpret=True)
        src = p
    else:
        j.save(path)
        other = TwoStageDB.load(path, device="cpu")
        src = j
        np.testing.assert_array_equal(other.db_c1.numpy(), np.asarray(j.db_c1))
    for q in data[2]:
        _same(other.match(q, top_k=5, **kw), src.match(q, top_k=5, **kw))
    for got, want in zip(other.match_batch(data[2], top_k=5, **kw),
                         src.match_batch(data[2], top_k=5, **kw)):
        _same(got, want)


def test_track_axis_padded_to_whole_tiles(tmp_path):
    """T % 8 != 0: the port pads to whole 8-track tiles as the reference does
    at coarse_tile=8, so the DB, its cache in either package and the
    reference agree even where an empty track takes a pool slot."""
    rng = np.random.default_rng(4)
    prints = rng.integers(0, 2 ** 32, (13, 120, 2), dtype=np.uint32)
    ids = [f"t{i}" for i in range(13)]
    jcfg, pcfg = JaxConfig(**SMALL), PortConfig(**SMALL)
    filt = np.zeros((pcfg.context_dim, 64), np.float32)
    ts = TwoStageDB(api.FingerprintDB(pcfg, filt, ids, prints, np.full(13, 120, np.int32)),
                    query_phases=2)
    ref = jax_scaled.TwoStageDB(
        jax_api.FingerprintDB(jcfg, filt, ids, prints, np.full(13, 120, np.int32)),
        query_phases=2, use_pallas_fine=True, coarse_tile=8, pallas_interpret=True)
    ts.save(str(tmp_path / "c"))
    back = TwoStageDB.load(str(tmp_path / "c"))
    other = jax_scaled.TwoStageDB.load(str(tmp_path / "c"), pallas_interpret=True)
    assert ts.db_c.shape[0] == back.db_c.shape[0] == 16 and back.n_real == 13
    for k, q in enumerate([prints[11, 21:21 + NQ], prints[4, 30:30 + NQ]]):
        want = ts.match(q, top_k=5, pool=8, phases=2)
        assert want[0][0] == ("t11", "t4")[k] and int(want[1][0]) == 64 * NQ
        for other_ts in (ref, back, other):
            _same(other_ts.match(q, top_k=5, pool=8, phases=2), want)


@pytest.mark.parametrize("make,exc,match", [
    (lambda db: TwoStageDB(db, stride=8).match(np.zeros((8 * 26, 2), np.uint32)),
     ValueError, "longer than"),
    (lambda db: TwoStageDB(db, stride=8, query_phases=3), ValueError, "divide"),
    (lambda db: TwoStageDB(db, prefilter_channels=32, coarse_channels=16), ValueError,
     "prefilter_channels"),
    (lambda db: TwoStageDB(db, coarse_kind="sum", stride=16).match(
        np.zeros((16384, 2), np.uint32)), ValueError, "2\\^24"),
    (lambda db: TwoStageDB(db, prefilter_pack4=True, coarse_kind="sum"), ValueError,
     "nibble"),
    (lambda db: TwoStageDB(db, mesh=object()), NotImplementedError, "A12"),
], ids=["overlong_query", "phases_divide", "prefilter_channels", "sum_bound",
        "pack4", "mesh"])
def test_errors(make, exc, match):
    rng = np.random.default_rng(0)
    cfg = PortConfig(**SMALL)
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32), ["a", "b"],
                           rng.integers(0, 2 ** 32, (2, 200, 2), dtype=np.uint32),
                           np.full(2, 200, np.int32))
    with pytest.raises(exc, match=match):
        make(db)


def test_overlong_query_raises_in_both(data):
    j, p, _ = _pair(data, "phases_1")
    q = np.zeros(((p.lc_true + 1) * STRIDE, 2), np.uint32)
    for ts in (j, p):
        with pytest.raises(ValueError, match="longer than"):
            ts.match(q, top_k=1)


def test_stretch_copy_bit_identical():
    rng = np.random.default_rng(2)
    q = rng.integers(0, 2 ** 32, (2, 57, 2), dtype=np.uint32)
    for span, step in [(0.03, 0.01), (0.05, 0.02), (0.0, 0.01)]:
        assert stretch.stretch_grid(span, step) == jax_stretch.stretch_grid(span, step)
        f = stretch.stretch_grid(span, step)
        np.testing.assert_array_equal(stretch.print_variants(q, f),
                                      jax_stretch.print_variants(q, f))
        np.testing.assert_array_equal(stretch.print_variants(q[0], f),
                                      jax_stretch.print_variants(q[0], f))
    for span in (0, 2):
        assert stretch.pitch_grid(span) == jax_stretch.pitch_grid(span)
        assert (stretch.hypothesis_grid([0.98, 1.0], stretch.pitch_grid(span))
                == jax_stretch.hypothesis_grid([0.98, 1.0], jax_stretch.pitch_grid(span)))


def test_catalog_scale_knobs_picked_up(data):
    j, p, _ = _pair(data, "catalog_scale")
    assert (p.query_phases, p.prefilter, p.prefilter_phases, p.prefilter_channels) == \
        (8, 8192, 2, 32) == (j.query_phases, j.prefilter, j.prefilter_phases,
                             j.prefilter_channels)
    assert p.db_c1 is not p.db_c and p.db.cfg.fine_candidates == 1024
    assert dataclasses.asdict(p.db.cfg) == dataclasses.asdict(j.db.cfg)
    assert jax.default_backend() == "cpu"
