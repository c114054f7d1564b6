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
