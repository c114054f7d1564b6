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
from hpfw_tpu.parallel import mesh as jax_meshlib
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig as PortConfig
from hpfw_tpu_torch.match import scaled, stretch
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.parallel.mesh import Mesh
from hpfw_tpu_torch.utils import profiling

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
    "prefilter_pack4": (dict(query_phases=4, prefilter=16, prefilter_phases=2,
                             prefilter_pack4=True), dict(pool=8)),
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
        pdb = api.FingerprintDB(pcfg, filt, ids, prints, lengths, device="cpu")
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
    ts = TwoStageDB(api.FingerprintDB(pcfg, filt, ids, prints, np.full(13, 120, np.int32),
                                      device="cpu"),
                    query_phases=2)
    ref = jax_scaled.TwoStageDB(
        jax_api.FingerprintDB(jcfg, filt, ids, prints, np.full(13, 120, np.int32)),
        query_phases=2, use_pallas_fine=True, coarse_tile=8, pallas_interpret=True)
    ts.save(str(tmp_path / "c"))
    back = TwoStageDB.load(str(tmp_path / "c"), device="cpu")
    other = jax_scaled.TwoStageDB.load(str(tmp_path / "c"), pallas_interpret=True)
    assert ts.db_c.shape[0] == back.db_c.shape[0] == 16 and back.n_real == 13
    for k, q in enumerate([prints[11, 21:21 + NQ], prints[4, 30:30 + NQ]]):
        want = ts.match(q, top_k=5, pool=8, phases=2)
        assert want[0][0] == ("t11", "t4")[k] and int(want[1][0]) == 64 * NQ
        for other_ts in (ref, back, other):
            _same(other_ts.match(q, top_k=5, pool=8, phases=2), want)


@pytest.mark.parametrize("pool", [8, 12, 64])
@pytest.mark.parametrize("layout", ["xla", "fine_only"])
@pytest.mark.parametrize("name", ["phases_1", "query_phases_4"])
def test_reference_default_caches_load(data, tmp_path, name, layout, pool):
    """The caches hpfw_tpu writes on any backend but a TPU: (T, lc, C) coarse
    prints beside a (T, L, 2) prints array (its default there) or beside
    word planes (use_pallas_fine=True, use_pallas_coarse=False), for 45
    tracks (not a multiple of 8). The port flattens and pads them and
    answers as the reference does on them; the reference's match_batch
    needs word planes, so without them each query's match is the answer."""
    prints, lengths, qs = data[0][:45], data[1][:45], data[2]
    kw = CONFIGS[name][0]
    jcfg, pcfg = _cfgs(name)
    jdb = jax_api.FingerprintDB(jcfg, np.zeros((jcfg.context_dim, 64), np.float32),
                                [str(i) for i in range(45)], prints, lengths)
    fine = layout == "fine_only"
    j = jax_scaled.TwoStageDB(jdb, stride=STRIDE, use_pallas_fine=fine,
                              use_pallas_coarse=False, pallas_interpret=True, **kw)
    path = str(tmp_path / "cache")
    j.save(path)
    p = TwoStageDB.load(path, device="cpu")
    assert p.db_c.shape == (48, p.db_c.shape[1]) and p.n_real == 45 and p.db_c1 is p.db_c
    mkw = dict(top_k=10, pool=pool, phases=j.query_phases)
    want = [j.match(q, **mkw) for q in qs]
    for q, w in zip(qs, want):
        _same(p.match(q, **mkw), w)
    if fine:
        want = j.match_batch(qs, **mkw)
    for got, w in zip(p.match_batch(qs, **mkw), want):
        _same(got, w)


def test_reference_xla_cache_pools_real_tracks_only(tmp_path):
    """Tracks whose coarse peaks are all negative (all-ones prints against a
    query of mostly clear bits): the zero rows that pad 13 tracks to 16
    would outrank them in the pool; loaded from the reference's unpadded
    cache, the port pools real tracks only, as the reference does."""
    rng = np.random.default_rng(12)
    q = (rng.integers(0, 2 ** 32, (NQ, 2), dtype=np.uint32)
         & rng.integers(0, 2 ** 32, (NQ, 2), dtype=np.uint32)
         & rng.integers(0, 2 ** 32, (NQ, 2), dtype=np.uint32))
    prints = np.full((13, 120, 2), 0xFFFFFFFF, np.uint32)
    prints[0] = rng.integers(0, 2 ** 32, (120, 2), dtype=np.uint32)
    prints[0, 24:24 + NQ] = q
    jcfg = JaxConfig(**SMALL)
    jdb = jax_api.FingerprintDB(jcfg, np.zeros((jcfg.context_dim, 64), np.float32),
                                [f"t{i}" for i in range(13)], prints, np.full(13, 120, np.int32))
    j = jax_scaled.TwoStageDB(jdb)
    j.save(str(tmp_path / "c"))
    p = TwoStageDB.load(str(tmp_path / "c"), device="cpu")
    want = j.match(q, top_k=10, pool=8)
    assert want[0][:8] == ["t0"] + [f"t{i}" for i in range(1, 8)]
    _same(p.match(q, top_k=10, pool=8), want)
    _same(p.match_batch(q[None], top_k=10, pool=8)[0], want)


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
], ids=["overlong_query", "phases_divide", "prefilter_channels", "sum_bound",
        "pack4"])
def test_errors(make, exc, match):
    rng = np.random.default_rng(0)
    cfg = PortConfig(**SMALL)
    db = api.FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32), ["a", "b"],
                           rng.integers(0, 2 ** 32, (2, 200, 2), dtype=np.uint32),
                           np.full(2, 200, np.int32), device="cpu")
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


# -- sharded over a mesh: the port on 8 logical `cpu` shards against hpfw_tpu
# on its 8-device simulation (tests/conftest.py), both padded to 8 x 8 tracks.

MESH_CONFIGS = ["phases_1", "query_phases_4", "two_pass_prefilter_16",
                "prefilter_channels_32", "prefilter_pack4"]
_MESH_BUILT = {}


def _mesh_pair(data, name, **extra):
    """(JAX TwoStageDB on mesh8 at coarse_tile=8, port TwoStageDB on an
    8-entry cpu mesh, match kwargs), built once per test module."""
    key = (name, tuple(sorted(extra.items())))
    if key not in _MESH_BUILT:
        prints, lengths, _ = data
        kw, match_kw = CONFIGS[name]
        kw = dict(kw, **extra)
        jcfg, pcfg = _cfgs(name)
        filt = np.zeros((jcfg.context_dim, 64), np.float32)
        ids = [str(i) for i in range(T)]
        jdb = jax_api.FingerprintDB(jcfg, filt, ids, prints, lengths)
        pdb = api.FingerprintDB(pcfg, filt, ids, prints, lengths, device="cpu")
        j = jax_scaled.TwoStageDB(jdb, stride=STRIDE, mesh=jax_meshlib.db_mesh(8),
                                  use_pallas_fine=True, coarse_tile=8,
                                  pallas_interpret=True, **kw)
        p = TwoStageDB(pdb, stride=STRIDE, mesh=Mesh(["cpu"] * 8), **kw)
        _MESH_BUILT[key] = (j, p, match_kw)
    return _MESH_BUILT[key]


@pytest.mark.parametrize("surface", ["match", "match_batch"])
@pytest.mark.parametrize("name", MESH_CONFIGS)
def test_mesh_two_stage_equals_reference(data, name, surface):
    j, p, kw = _mesh_pair(data, name)
    qs = data[2]
    if surface == "match":
        for q in qs:
            _same(p.match(q, top_k=5, **kw), j.match(q, top_k=5, **kw))
    else:
        for got, want in zip(p.match_batch(qs, top_k=5, **kw),
                             j.match_batch(qs, top_k=5, **kw)):
            _same(got, want)


def test_mesh_dispatch_gathers_the_reference_blocks(data):
    """The gathered (B, 3, 8 x K) candidate blocks themselves, shard by
    shard, and the derived shards against the reference's sharded arrays."""
    j, p, kw = _mesh_pair(data, "two_pass_prefilter_16")
    qs = data[2]
    got = p.dispatch_batch(torch.from_numpy(qs.view(np.int32)), **kw)
    want = j.dispatch_batch(jnp.asarray(qs), **kw)
    assert got.shape == (4, 3, 8 * 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(p.shards) == 8 and p.prints is None and p.devices == [torch.device("cpu")]
    for field, ref in (("db_c", j.db_c), ("db_c1", j.db_c1), ("lengths", j.lengths)):
        np.testing.assert_array_equal(
            torch.cat([getattr(s, field) for s in p.shards]).numpy(), np.asarray(ref))


@pytest.mark.parametrize("surface", ["match", "match_batch"])
def test_mesh_stretch_scan_and_variant_stacks_equal_reference(data, surface):
    """The print-level tempo scan with calibrate, and a pre-scanned (V, N, 2)
    stack with return_variant (a (B, V, N, 2) stack for match_batch)."""
    j, p, _ = _mesh_pair(data, "query_phases_4")
    qs = data[2]
    stacks = stretch.print_variants(qs[:2], [0.98, 1.0, 1.02])
    for calibrate in (False, True):
        kw = dict(top_k=5, pool=8, stretch_span=0.02, calibrate=calibrate)
        if surface == "match":
            _same(p.match(qs[1], return_variant=True, **kw),
                  j.match(qs[1], return_variant=True, **kw))
        else:
            for got, want in zip(p.match_batch(qs[:2], **kw), j.match_batch(qs[:2], **kw)):
                _same(got, want)
    if surface == "match":
        _same(p.match(stacks[0], top_k=5, pool=8, return_variant=True),
              j.match(stacks[0], top_k=5, pool=8, return_variant=True))
    else:
        for got, want in zip(p.match_batch(stacks, top_k=5, pool=8),
                             j.match_batch(stacks, top_k=5, pool=8)):
            _same(got, want)


@pytest.mark.parametrize("mesh", [None, 8], ids=["one_device", "mesh8"])
@pytest.mark.parametrize("query", ["stack", "tempo_scan"])
def test_match_is_one_dispatch_of_match_batch(data, query, mesh):
    """match of a (V, N, 2) stack, or of one query under the tempo scan,
    records one match.dispatch span and answers as match_batch on that
    batch of one; each answer's variant index is the first variant whose
    row holds that track at that score and offset."""
    _, p, _ = (_mesh_pair if mesh else _pair)(data, "query_phases_4")
    q = data[2][1]
    if query == "stack":
        kw = dict(top_k=5, pool=8)
        stack = stretch.print_variants(q, [0.98, 1.0, 1.02])[0]
        arg, batch = stack, stack[None]
    else:
        kw = dict(top_k=5, pool=8, stretch_span=0.02)
        stack = stretch.print_variants(q, stretch.stretch_grid(0.02, p.db.cfg.stretch_step))[0]
        arg, batch = q, q[None]
    first = profiling.new_id()
    got = p.match(arg, return_variant=True, **kw)
    assert [s.name for s in profiling.spans()
            if s.sid > first and s.name == "match.dispatch"] == ["match.dispatch"]
    _same(got[:3], p.match_batch(batch, **kw)[0])
    rows = p.dispatch_batch(torch.from_numpy(stack.view(np.int32)), pool=8).numpy()
    assert len(got[0]) == 5
    for tid, score, off, var in zip(*got):
        idx = p.db.index_of(tid)
        holds = [(v, j) for v in range(len(stack)) for j in range(rows.shape[-1])
                 if rows[v, 1, j] == idx and rows[v, 0, j] == score]
        assert (var, off) == (holds[0][0], rows[holds[0][0], 2, holds[0][1]])


def test_mesh_of_one_equals_unsharded(data):
    """A mesh of one device is the one-device DB, bit for bit."""
    _, p, kw = _pair(data, "catalog_scale")
    one = TwoStageDB(p.db, stride=STRIDE, mesh=Mesh(["cpu"]))
    qs = data[2]
    for q in qs:
        _same(one.match(q, top_k=5, **kw), p.match(q, top_k=5, **kw))
    assert torch.equal(one.dispatch_batch(torch.from_numpy(qs.view(np.int32)), **kw),
                       p.dispatch_batch(torch.from_numpy(qs.view(np.int32)), **kw))


@pytest.mark.parametrize("layout", ["pallas", "fine_only", "xla"])
def test_reference_mesh_cache_loads(data, tmp_path, layout):
    """hpfw_tpu's mesh caches at its default coarse_tile (128: 8 shards of 128
    tracks, 80 of them empty in the first), in each of its layouts, split at
    their own padded length: the port answers as the reference does."""
    prints, lengths, qs = data
    name = {"pallas": "prefilter_channels_32", "fine_only": "query_phases_4",
            "xla": "phases_1"}[layout]
    kw = CONFIGS[name][0]
    jcfg, _ = _cfgs(name)
    jdb = jax_api.FingerprintDB(jcfg, np.zeros((jcfg.context_dim, 64), np.float32),
                                [str(i) for i in range(T)], prints, lengths)
    j = jax_scaled.TwoStageDB(jdb, stride=STRIDE, mesh=jax_meshlib.db_mesh(8),
                              use_pallas_fine=layout != "xla",
                              use_pallas_coarse=layout == "pallas", pallas_interpret=True,
                              **kw)
    path = str(tmp_path / "cache")
    j.save(path)
    p = TwoStageDB.load(path, mesh=Mesh(["cpu"] * 8))
    t_shard = 128 if layout == "pallas" else 6
    assert [s.db_c.shape[0] for s in p.shards] == [t_shard] * 8 and p.n_real == T
    mkw = dict(top_k=5, pool=8, phases=j.query_phases)
    if layout == "pallas":
        mkw.update(prefilter=j.prefilter, phases1=j.prefilter_phases)
    want = [j.match(q, **mkw) for q in qs]
    for q, w in zip(qs, want):
        _same(p.match(q, **mkw), w)
    if layout != "xla":
        want = j.match_batch(qs, **mkw)
    for got, w in zip(p.match_batch(qs, **mkw), want):
        _same(got, w)


def test_port_mesh_cache_loads_in_reference(data, tmp_path):
    _, p, kw = _mesh_pair(data, "prefilter_pack4")
    kw = dict(kw, phases=p.query_phases, prefilter=p.prefilter, phases1=p.prefilter_phases)
    path = str(tmp_path / "cache")
    p.save(path)
    other = jax_scaled.TwoStageDB.load(path, mesh=jax_meshlib.db_mesh(8),
                                       pallas_interpret=True)
    back = TwoStageDB.load(path, mesh=Mesh(["cpu"] * 8))
    for q in data[2]:
        want = p.match(q, top_k=5, **kw)
        _same(other.match(q, top_k=5, **kw), want)
        _same(back.match(q, top_k=5, **kw), want)
    for got, want in zip(other.match_batch(data[2], top_k=5, **kw),
                         p.match_batch(data[2], top_k=5, **kw)):
        _same(got, want)


def test_mesh_size_mismatch_raises_in_both(data, tmp_path):
    _, p, _ = _mesh_pair(data, "phases_1")
    _, single, _ = _pair(data, "phases_1")
    p.save(str(tmp_path / "mesh8"))
    single.save(str(tmp_path / "single"))
    cases = [("mesh8", Mesh(["cpu"] * 4), jax_meshlib.db_mesh(4)), ("mesh8", None, None),
             ("single", Mesh(["cpu"] * 8), jax_meshlib.db_mesh(8))]
    for cache, pmesh, jmesh in cases:
        path = str(tmp_path / cache)
        with pytest.raises(ValueError, match="cache was built for mesh size"):
            TwoStageDB.load(path, mesh=pmesh, device="cpu")
        with pytest.raises(ValueError, match="cache was built for mesh size"):
            jax_scaled.TwoStageDB.load(path, mesh=jmesh, pallas_interpret=True)


# -- the serving warm-up, keep_host and mmap: the reference's signatures --

def _answers(ts, qs, **kw):
    return [ts.match(q, top_k=5, **kw) for q in qs] + ts.match_batch(qs, top_k=5, **kw)


def _files(path):
    return {f.name: f.read_bytes() for f in sorted(path.iterdir())}


def _port_only(data, name, mesh=None, **extra):
    """The port's TwoStageDB of a configuration (no reference built)."""
    _, p, kw = _pair(data, "phases_1")
    pcfg = _cfgs(name)[1]
    pdb = api.FingerprintDB(pcfg, p.db.filters, p.db.track_ids, p.db.prints, p.db.lengths,
                            device="cpu")
    return TwoStageDB(pdb, stride=STRIDE, mesh=mesh, **CONFIGS[name][0], **extra), \
        CONFIGS[name][1]


@pytest.mark.parametrize("mesh", [None, 2], ids=["one_device", "mesh2"])
@pytest.mark.parametrize("name", ["phases_1", "catalog_scale"])
def test_warmup_leaves_answers_unchanged(data, name, mesh):
    """warmup() leaves match and match_batch as they were, on one device
    and over 2 logical shards."""
    p, kw = _port_only(data, name, Mesh(["cpu"] * mesh) if mesh else None)
    qs = data[2][:2]
    before = _answers(p, qs, **kw)
    assert p.warmup([NQ], batch_sizes=(2,), pool=kw["pool"]) is None
    for got, want in zip(_answers(p, qs, **kw), before):
        _same(got, want)


def test_bundle_compile_cache_writes_nothing(data, tmp_path):
    _, p, kw = _pair(data, "phases_1")
    p.save(str(tmp_path / "c"))
    saved = _files(tmp_path / "c")
    assert p.bundle_compile_cache(str(tmp_path / "c"), [NQ], batch_sizes=(2,),
                                  pool=kw["pool"]) == 0
    assert _files(tmp_path / "c") == saved


@pytest.mark.parametrize("name,mesh", [("prefilter_pack4", None), ("phases_1", 2)],
                         ids=["pack4_one_device", "phases_1_mesh2"])
def test_keep_host_save_byte_identical(data, tmp_path, name, mesh):
    """A keep_host=True DB's save() writes the same bytes as a plain DB's,
    and the cache answers as the source does: on one device loaded by both
    packages, over logical shards by the port (the mesh cache tests above
    load the port's mesh caches in the reference)."""
    pmesh = Mesh(["cpu"] * mesh) if mesh else None
    plain, kw = _port_only(data, name, pmesh)
    kept, _ = _port_only(data, name, pmesh, keep_host=True)
    kw = dict(kw, phases=plain.query_phases, prefilter=plain.prefilter,
              phases1=plain.prefilter_phases)
    kept.save(str(tmp_path / "kept"))
    plain.save(str(tmp_path / "plain"))
    assert _files(tmp_path / "kept") == _files(tmp_path / "plain")
    q = data[2][:1]
    want = plain.match(q[0], top_k=5, **kw)
    port = TwoStageDB.load(str(tmp_path / "kept"), mesh=pmesh, device=None if mesh else "cpu")
    _same(port.match(q[0], top_k=5, **kw), want)
    if mesh is None:
        ref = jax_scaled.TwoStageDB.load(str(tmp_path / "kept"), pallas_interpret=True)
        _same(ref.match(q[0], top_k=5, **kw), want)


def test_load_without_mmap_equals_load(data, tmp_path):
    _, p, kw = _pair(data, "prefilter_pack4")
    kw = dict(kw, phases=p.query_phases, prefilter=p.prefilter, phases1=p.prefilter_phases)
    p.save(str(tmp_path / "c"))
    mapped = TwoStageDB.load(str(tmp_path / "c"), device="cpu")
    whole = TwoStageDB.load(str(tmp_path / "c"), mmap=False, device="cpu")
    for a, b in zip(mapped.shards[0], whole.shards[0]):
        assert torch.equal(a, b)
    for got, want in zip(_answers(whole, data[2][:2], **kw), _answers(p, data[2][:2], **kw)):
        _same(got, want)


@pytest.fixture(scope="module")
def persist_db(cfg):
    """tests/test_persist.py's small_db, built by the port on the CPU."""
    from hpfw_tpu_torch.io import synth
    from hpfw_tpu_torch.oracle import fix_eigenvector_signs

    pcfg = PortConfig.from_json(cfg.to_json())
    tracks = synth.synth_catalog(14, 4.0, pcfg)
    rng = np.random.default_rng(0)
    filters = fix_eigenvector_signs(rng.standard_normal((pcfg.context_dim, pcfg.n_filters)) /
                                    np.sqrt(pcfg.context_dim)).astype(np.float32)
    db = api.build_db(tracks, filters, pcfg, device="cpu")
    q = synth.make_query(tracks[9], 0.8, 2.0, pcfg, noise_db=-15.0, seed=2)
    return db, api.fingerprint(q, filters, pcfg, device="cpu")


@pytest.mark.parametrize("call", ["save_load_xla_path", "save_load_pallas_planes",
                                  "save_load_sharded", "without_keep_host_mmap_false",
                                  "warmup_serving_shapes"])
def test_reference_persist_calls_run_on_port(persist_db, tmp_path, call):
    """tests/test_persist.py's calls, with the TPU route selectors
    (use_pallas_fine, pallas_interpret) dropped and the CPU named, give its
    results on the port."""
    db, qfp = persist_db
    cache = str(tmp_path / "cache")
    mesh = Mesh(["cpu"] * 8) if call == "save_load_sharded" else None
    if call == "warmup_serving_shapes":
        ts = TwoStageDB(db, stride=4)
        ts.warmup([qfp.shape[0]], batch_sizes=(2,), pool=14)
        ids, s, o = ts.match(qfp, top_k=1, pool=14)
        assert ids[0] == "9"
        return
    keep = call != "without_keep_host_mmap_false"
    ts = TwoStageDB(db, stride=4, mesh=mesh, keep_host=keep)
    ts.save(cache)
    loaded = TwoStageDB.load(cache, mesh=mesh, mmap=keep,
                             device=None if mesh else "cpu")
    assert loaded.stride == 4 and loaded.n_real == 14
    assert loaded.db.cfg == db.cfg and loaded.db.track_ids == db.track_ids
    want = ts.match(qfp, top_k=5, pool=14)
    _same(loaded.match(qfp, top_k=5, pool=14), want)
    assert want[0][0] == "9"
