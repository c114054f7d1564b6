"""Port dense matcher (CPU path: the plain version of K3) vs the oracle,
hpfw_tpu.match.matcher and the Pallas scan kernel in interpret mode: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hpfw_tpu import oracle
from hpfw_tpu.match import matcher as jax_matcher
from hpfw_tpu.ops.pallas_match import pallas_score_tracks
from hpfw_tpu_torch.match import matcher


def _random_db(rng, lengths, l_pad=None):
    l = l_pad or max(lengths)
    prints = np.zeros((len(lengths), l, 2), dtype=np.uint32)
    for i, ln in enumerate(lengths):
        prints[i, :ln] = rng.integers(0, 2 ** 32, (ln, 2), dtype=np.uint32)
    return prints, np.array(lengths, dtype=np.int32)


def _case(name):
    """The four cases of tests/test_pallas_match.py."""
    if name == "random_lengths":
        rng = np.random.default_rng(0)
        prints, lens = _random_db(rng, [300, 251, 300, 77, 300, 123, 290, 300, 265])
        q = rng.integers(0, 2 ** 32, (40, 2), dtype=np.uint32)
    elif name == "short_track_planted":
        rng = np.random.default_rng(1)
        prints, lens = _random_db(rng, [200, 15, 64, 200])
        q = rng.integers(0, 2 ** 32, (40, 2), dtype=np.uint32)
        prints[2, 9:49] = q
    elif name == "many_offsets":
        rng = np.random.default_rng(2)
        prints, lens = _random_db(rng, [400] * 5 + [397, 385])
        q = rng.integers(0, 2 ** 32, (37, 2), dtype=np.uint32)
    else:  # ties_to_first_offset
        rng = np.random.default_rng(3)
        q = rng.integers(0, 2 ** 32, (10, 2), dtype=np.uint32)
        track = np.zeros((200, 2), dtype=np.uint32)
        track[50:60] = q
        track[150:160] = q
        prints, lens = track[None], np.array([200], dtype=np.int32)
    return q, prints, lens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("name", ["random_lengths", "short_track_planted",
                                  "many_offsets", "ties_to_first_offset"])
def test_score_tracks_exact(name):
    q, prints, lens = _case(name)
    s, o = matcher.score_tracks(_t(q), _t(prints), torch.from_numpy(lens))
    s, o = s.numpy(), o.numpy()
    want = [oracle.match_track(q, prints[i, :lens[i]]) for i in range(len(lens))]
    np.testing.assert_array_equal(s, [w[0] for w in want])
    np.testing.assert_array_equal(o, [w[1] for w in want])
    args = (jnp.asarray(q), jnp.asarray(prints), jnp.asarray(lens))
    s_x, o_x = jax_matcher.score_tracks(*args)
    s_p, o_p = pallas_score_tracks(*args, interpret=True)
    for s_other, o_other in ((s_x, o_x), (s_p, o_p)):
        np.testing.assert_array_equal(s, np.asarray(s_other))
        np.testing.assert_array_equal(o, np.asarray(o_other))
    if name == "short_track_planted":
        assert s[2] == 64 * 40 and o[2] == 9
    if name == "ties_to_first_offset":
        assert s[0] == 64 * 10 and o[0] == 50


_MASK32 = 0xFFFFFFFF


def _pm1(words: torch.Tensor) -> torch.Tensor:
    """(..., 2) int32 words -> (..., 64) int64 +-1 channels, bit c % 32 of
    word c // 32 as channel c."""
    bits = (words[..., None].to(torch.int64) >> torch.arange(32)) & 1
    return (2 * bits - 1).reshape(*words.shape[:-1], 64)


def _k3_tiled(query, prints, lengths, *, mt, nt, cpos):
    """K3's formulation in plain torch, item by item and chunk by chunk: an
    item (track, offset block) scores the M x NCOL offsets o0 + k M + r
    (M = 16 mt, NCOL = 8 nt) as C[r, k] = sum_{p, c} q[p - r][c] *
    d01[o0 + k M + p][c] over positions p < N + M - 1, taken in chunks of
    cpos, with the query +-1 (0 outside [0, N)) and the track's bits 0/1 (0
    at or past len); sim = C + 64 kcut - popcount(q[0 : kcut]) with kcut =
    min(len, N). Each item writes its own key, the best (sim * 2^32 + 2^32 -
    1 - o) over its offsets o <= o_max, or 0 when it has none to visit, into
    a (T, items a track) buffer, and each track's result is the maximum of
    its row, split into (score, offset), as merge_keys does."""
    m, ncol = 16 * mt, 8 * nt
    ob = m * ncol
    t_count, l, _ = prints.shape
    n = query.shape[0]
    n_pos = n + m - 1
    qz = torch.cat([_pm1(query), torch.zeros((1, 64), dtype=torch.int64)])  # row n: zeros
    r = torch.arange(m)
    n_blocks = -(-(l - n + 1) // ob)
    keys = torch.full((t_count, n_blocks), -1, dtype=torch.int64)   # every item writes its key
    for t in range(t_count):
        ln = min(max(int(lengths[t]), 0), l)
        o_max, kcut = min(max(ln - n, 0), l - n), min(ln, n)
        pc = int((qz[:kcut] > 0).sum())
        d01 = torch.cat([(_pm1(prints[t]) > 0).to(torch.int64),
                         torch.zeros((1, 64), dtype=torch.int64)])                  # row l: zeros
        for blk in range(n_blocks):
            o0 = blk * ob
            if o0 > o_max:
                keys[t, blk] = 0                                      # skipped
                continue
            c = torch.zeros((m, ncol), dtype=torch.int64)
            for p0 in range(0, n_pos, cpos):
                p = torch.arange(p0, min(p0 + cpos, n_pos))
                j = p[None, :] - r[:, None]                                   # (M, cnt)
                a = qz[torch.where((j >= 0) & (j < n), j, n)]                 # (M, cnt, 64)
                pos = o0 + torch.arange(ncol)[:, None] * m + p[None, :]       # (NCOL, cnt)
                b = d01[torch.where(pos < ln, pos, l)]                        # (NCOL, cnt, 64)
                c += torch.einsum("rpc,kpc->rk", a, b)
            o = o0 + torch.arange(ncol)[None, :] * m + r[:, None]             # (M, NCOL)
            key = (c + 64 * kcut - pc) * 2 ** 32 + (2 ** 32 - 1 - o)
            keys[t, blk] = key[o <= o_max].max()
    assert bool((keys >= 0).all())
    best = keys.max(dim=1).values
    return (best >> 32).to(torch.int32), (2 ** 32 - 1 - (best & _MASK32)).to(torch.int32)


# (mt, nt, cpos): K3's two tiles with the whole query resident, and small
# tiles with short chunks, so that several blocks and chunks run.
TILINGS = [(2, 2, 10_000), (2, 8, 10_000), (1, 1, 24), (1, 2, 7), (2, 1, 40)]


@pytest.mark.parametrize("mt,nt,cpos", TILINGS)
@pytest.mark.parametrize("name", ["random_lengths", "short_track_planted",
                                  "many_offsets", "ties_to_first_offset"])
def test_k3_tiled_formulation_exact(name, mt, nt, cpos):
    """K3's tiled +-1 / 0-1 GEMM with the cross-block key merge equals the
    plain scan, the oracle and the Pallas kernel (interpret mode) on the
    four cases of tests/test_pallas_match.py."""
    q, prints, lens = _case(name)
    got = _k3_tiled(_t(q), _t(prints), torch.from_numpy(lens), mt=mt, nt=nt, cpos=cpos)
    want = matcher.score_tracks_ref(_t(q), _t(prints), torch.from_numpy(lens))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    oracle_want = [oracle.match_track(q, prints[i, :lens[i]]) for i in range(len(lens))]
    np.testing.assert_array_equal(got[0].numpy(), [w[0] for w in oracle_want])
    np.testing.assert_array_equal(got[1].numpy(), [w[1] for w in oracle_want])
    s_p, o_p = pallas_score_tracks(jnp.asarray(q), jnp.asarray(prints), jnp.asarray(lens),
                                   interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(s_p))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(o_p))


@pytest.mark.parametrize("mt,nt,cpos", TILINGS[2:])
@pytest.mark.parametrize("n", [0, 1, 37, 90])
def test_k3_tiled_edges(n, mt, nt, cpos):
    """Ties on either side of a column (tile) boundary and of a block
    boundary, tracks shorter than the query and of length 0, nonzero
    garbage past every length, and queries longer than one chunk."""
    rng = np.random.default_rng(n + 7 * mt + nt)
    m, ob = 16 * mt, 16 * mt * 8 * nt
    l = max(3 * ob, n + 2 * ob)
    prints = rng.integers(0, 2 ** 32, (8, l, 2), dtype=np.uint32)    # garbage everywhere
    lens = np.array([l, l, n // 2, 0, n, n + 1, l - 3, max(n - 1, 0)], np.int32)
    q = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint32)
    if n:
        for o in (m - 1, m - 1 + n):            # a tie across a column boundary
            prints[0, o:o + n] = q
        for o in (ob - 1, ob - 1 + n):          # a tie across a block boundary
            prints[1, o:o + n] = q
        prints[6, l - 3 - n:l - 3] = q          # at the last visited offset
    args = (_t(q), _t(prints), torch.from_numpy(lens))
    got = _k3_tiled(*args, mt=mt, nt=nt, cpos=cpos)
    want = matcher.score_tracks_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    oracle_want = [oracle.match_track(q, prints[i, :lens[i]]) for i in range(len(lens))]
    np.testing.assert_array_equal(got[0].numpy(), [w[0] for w in oracle_want])
    np.testing.assert_array_equal(got[1].numpy(), [w[1] for w in oracle_want])
    if n:
        assert [int(x) for x in got[1][[0, 1, 6]]] == [m - 1, ob - 1, l - 3 - n]
        assert all(int(x) == 64 * n for x in got[0][[0, 1, 6]])


def test_score_tracks_blocks_do_not_change_result(monkeypatch):
    q, prints, lens = _case("many_offsets")
    want = matcher.score_tracks_ref(_t(q), _t(prints), torch.from_numpy(lens))
    monkeypatch.setattr(matcher, "REF_BLOCK_ELEMS", 7 * 37 * 5)   # 5 offsets a block
    got = matcher.score_tracks_ref(_t(q), _t(prints), torch.from_numpy(lens))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_popcount_matches_numpy():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.integers(0, 2 ** 32, 1000, dtype=np.uint32),
                        np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)])
    got = matcher._popcount32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(x))


def test_rank_and_pad_prints_match_jax():
    rng = np.random.default_rng(5)
    scores = rng.integers(0, 20, 50).astype(np.int32)   # many ties
    offsets = rng.integers(0, 100, 50).astype(np.int32)
    for k in (1, 10, 50):
        for a, b in zip(matcher.rank(scores, offsets, k),
                        jax_matcher.rank(scores, offsets, k)):
            np.testing.assert_array_equal(a, b)
    tracks = [rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint32) for n in (5, 0, 9)]
    for a, b in zip(matcher.pad_prints(tracks, min_len=12),
                    jax_matcher.pad_prints(tracks, min_len=12)):
        np.testing.assert_array_equal(a, b)
