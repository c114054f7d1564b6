"""Nibble-packed pass-1 rows in the port (the plain version of packed K4) vs
hpfw_tpu's pack_coarse_nibbles, its packed4 Pallas scan in interpret mode and
its TwoStageDB(prefilter_pack4=True): exact equality, caches both ways.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hpfw_tpu import api as jax_api
from hpfw_tpu.match import scaled as jax_scaled
from hpfw_tpu.ops import pallas_coarse
from hpfw_tpu_torch import api
from hpfw_tpu_torch.config import HpfwConfig
from hpfw_tpu_torch.match import scaled
from hpfw_tpu_torch.match.scaled import TwoStageDB
from hpfw_tpu_torch.ops import coarse_scan


@pytest.mark.parametrize("lcw", [128, 256, 640, 2432, 5248])
def test_pack_identical_to_reference(lcw, monkeypatch):
    """Widths with and without the 256-feature pad; chunked packing equals
    packing all rows at once, and unpacking gives the rows back."""
    rng = np.random.default_rng(lcw)
    d = rng.integers(-8, 8, (21, lcw)).astype(np.int8)
    d[0] = -8
    d[1] = 7
    want = np.asarray(pallas_coarse.pack_coarse_nibbles(jnp.asarray(d)))
    whole = coarse_scan.pack_coarse_nibbles(torch.from_numpy(d))
    assert whole.dtype == torch.int8 and whole.shape == (21, -(-lcw // 256) * 128)
    np.testing.assert_array_equal(whole.numpy(), want)
    for chunk_rows in (1, 4):
        monkeypatch.setattr(coarse_scan, "PACK_CHUNK_ROWS", chunk_rows)
        assert torch.equal(coarse_scan.pack_coarse_nibbles(torch.from_numpy(d)), whole)
    back = coarse_scan.unpack_coarse_nibbles(whole).numpy()
    np.testing.assert_array_equal(back[:, :lcw], d)
    assert not back[:, lcw:].any()


SCAN_CASES = ["random", "ties", "all_negative"]


def _scan_case(name, c):
    """(queries (G, Nc, C), rows (T, Lc, C)) int8, zero past each length."""
    rng = np.random.default_rng(SCAN_CASES.index(name) * 100 + c)
    t, lc = 32, 37
    g, nc = {"random": (3, 5), "ties": (2, 4), "all_negative": (4, 2)}[name]
    q = rng.choice([-1, 1], (g, nc, c)).astype(np.int8)
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    lens = rng.integers(nc, lc + 1, size=t)
    if name == "ties":
        d[:] = 0
        d[:, 3:3 + nc] = q[0]                # equal peaks at offsets 3 and 11
        d[:, 11:11 + nc] = q[0]
        d[5] = d[9]
        lens[:] = lc
    if name == "all_negative":
        q[:] = 1
        d[4] = -1                            # every offset of track 4 < 0 ...
        lens[4] = lc                         # ... and none of them padded
    for i, ln in enumerate(lens):
        d[i, ln:] = 0
    return q, d


@pytest.mark.parametrize("name", SCAN_CASES)
@pytest.mark.parametrize("c", [8, 16, 32, 64])
def test_packed_scan_equals_reference_and_int8(c, name):
    q, d = _scan_case(name, c)
    lc = d.shape[1]
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d))
    packed = coarse_scan.pack_coarse_nibbles(flat)
    qt = torch.from_numpy(q)
    best, first = coarse_scan.coarse_scan_batch_packed(qt, packed, lc_true=lc)
    assert best.shape == first.shape == (q.shape[0], d.shape[0])
    p_b, p_i = pallas_coarse.pallas_coarse_scan_batch_stacked(
        jnp.asarray(q), jnp.asarray(packed.numpy()), s=8, tt=8, lc_true=lc,
        interpret=True, packed4=True)
    np.testing.assert_array_equal(best.numpy(), np.asarray(p_b))
    np.testing.assert_array_equal(first.numpy(), np.asarray(p_i))
    i_b, i_i = coarse_scan.coarse_scan_batch(qt, flat, lc_true=lc)
    assert torch.equal(best, i_b) and torch.equal(first, i_i)
    if name == "ties":
        assert int(first[0, 0]) == 3
    if name == "all_negative":
        assert (best[:, 4] == -2 * c).all() and (first[:, 4] == 0).all()
        # Scanned over every packed window, the zero pad wins: why lc_true
        # is a required keyword of the packed surface.
        pad_b, _ = coarse_scan.coarse_scan_batch_packed(qt, packed,
                                                        lc_true=2 * packed.shape[1] // c)
        assert (pad_b[:, 4] == 0).all()


def test_packed_surface_requires_lc_true_and_whole_windows():
    q, d = _scan_case("random", 32)
    packed = coarse_scan.pack_coarse_nibbles(coarse_scan.flatten_coarse(torch.from_numpy(d)))
    with pytest.raises(TypeError):
        coarse_scan.coarse_scan_batch_packed(torch.from_numpy(q), packed)
    with pytest.raises(ValueError, match="do not hold"):
        coarse_scan.coarse_scan_batch_packed(torch.from_numpy(q), packed,
                                             lc_true=2 * packed.shape[1] // 32 + 1)


T, L, NQ, STRIDE = 48, 200, 64, 8
KNOBS = dict(stride=STRIDE, query_phases=4, prefilter=16, prefilter_phases=2,
             prefilter_channels=32)


@pytest.fixture(scope="module")
def data(cfg):
    """tests/test_scaled.py:474-511's catalog and noisy misphased queries."""
    rng = np.random.default_rng(27)
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    qs = []
    for k, r in enumerate((1, 3, 4, 7)):
        off = (4 + k) * STRIDE + r
        q = prints[7 + k, off:off + NQ].copy()
        flip = (rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32))
        qs.append(np.bitwise_xor(q, flip))
    filt = np.zeros((cfg.context_dim, 64), np.float32)
    ids = [str(i) for i in range(T)]
    lengths = np.full(T, L, np.int32)
    jdb = jax_api.FingerprintDB(cfg, filt, ids, prints, lengths)
    pdb = api.FingerprintDB(HpfwConfig.from_json(cfg.to_json()), filt, ids, prints, lengths)
    return jdb, pdb, np.stack(qs)


_BUILT = {}


def _pair(data, pack4=True, **kw):
    key = (pack4, tuple(sorted(kw.items())))
    if key not in _BUILT:
        jdb, pdb, _ = data
        knobs = dict(KNOBS, **kw)
        j = jax_scaled.TwoStageDB(jdb, use_pallas_fine=True, coarse_tile=8,
                                  pallas_interpret=True, prefilter_pack4=pack4, **knobs)
        _BUILT[key] = (j, TwoStageDB(pdb, prefilter_pack4=pack4, **knobs))
    return _BUILT[key]


def _same(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("surface", ["match", "match_batch"])
def test_two_stage_pack4_equals_reference_and_int8(data, surface):
    j, p = _pair(data)
    _, unpacked = _pair(data, pack4=False)
    qs = data[2]
    if surface == "match":
        for k, q in enumerate(qs):
            got = p.match(q, top_k=5, pool=8)
            _same(got, j.match(q, top_k=5, pool=8))
            _same(got, unpacked.match(q, top_k=5, pool=8))
            assert got[0][0] == str(7 + k)
    else:
        got = p.match_batch(qs, top_k=3, pool=8)
        for a, b, c in zip(got, j.match_batch(qs, top_k=3, pool=8),
                           unpacked.match_batch(qs, top_k=3, pool=8)):
            _same(a, b)
            _same(a, c)


def test_packed_db_c1_bytes_equal_reference(data):
    j, p = _pair(data)
    _, unpacked = _pair(data, pack4=False)
    assert p.prefilter_pack4 and p.db_c1 is not p.db_c
    np.testing.assert_array_equal(p.db_c1.numpy(), np.asarray(j.db_c1))
    np.testing.assert_array_equal(p.db_c.numpy(), np.asarray(j.db_c))
    assert torch.equal(coarse_scan.pack_coarse_nibbles(unpacked.db_c1), p.db_c1)
    # Without a channel prefix the packed pass-1 DB is a packed copy of db_c.
    _, full = _pair(data, prefilter_channels=64)
    assert torch.equal(full.db_c1, coarse_scan.pack_coarse_nibbles(full.db_c))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_packed_cache_loads_in_either_package(data, tmp_path, direction):
    j, p = _pair(data)
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
    assert other.prefilter_pack4
    kw = dict(top_k=5, pool=8, phases=4, phases1=2, prefilter=16)
    for q in data[2]:
        _same(other.match(q, **kw), src.match(q, **kw))
    for got, want in zip(other.match_batch(data[2], **kw), src.match_batch(data[2], **kw)):
        _same(got, want)


def test_single_lane_runs_packed(data, monkeypatch):
    """prefilter_phases=1 and one query make pass 1 a single lane; packed rows
    still go through the batch surface, never the single-query scan."""
    j, p = _pair(data, prefilter_phases=1)
    calls = []

    def spy(query_cs, db_packed, *, lc_true):
        calls.append(tuple(query_cs.shape))
        return coarse_scan.coarse_scan_batch_packed(query_cs, db_packed, lc_true=lc_true)

    def refuse(*args, **kw):
        raise AssertionError("packed rows reached the single-query scan")

    monkeypatch.setattr(scaled, "coarse_scan_batch_packed", spy)
    monkeypatch.setattr(scaled, "coarse_scan", refuse)
    for q in data[2][:2]:
        _same(p.match(q, top_k=5, pool=8), j.match(q, top_k=5, pool=8))
    assert calls and all(shape[0] == 1 for shape in calls)
