"""Port fine rescan (the plain version of K5) vs hpfw_tpu's Pallas fine kernel
in interpret mode and its XLA twin match/scaled._fine_rescan: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hpfw_tpu.match.scaled import _fine_rescan
from hpfw_tpu.ops import pallas_fine
from hpfw_tpu_torch.ops import fine

T, L, N, FW = 32, 300, 90, 16
N_FINE = 2 * FW + 1
SPAN = N + N_FINE - 1
CASES = ["planted", "past_end", "all_invalid", "duplicates_ties"]


def _case(name):
    """Prints, lengths, B=2 queries, (B, K) candidate tracks and centers."""
    rng = np.random.default_rng(CASES.index(name))
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    lengths = np.full(T, L, np.int32)
    lengths[3], lengths[9], lengths[11] = 150, 60, 0
    qs = rng.integers(0, 2 ** 32, (2, N, 2), dtype=np.uint32)
    prints[7, 141:141 + N] = qs[0]
    k = 16
    tracks = np.stack([rng.permutation(T)[:k] for _ in range(2)]).astype(np.int32)
    centers = rng.integers(0, L - N, (2, k)).astype(np.int32)
    tracks[0, 0], centers[0, 0] = 7, 144
    if name == "past_end":
        # Bands running past max(len - N, 0), where kcut < N, and a track
        # shorter than the query (only offset 0 is valid).
        tracks[:, 1:4] = [[3, 3, 9]]
        centers[:, 1:4] = [[70, 130, 0]]
    if name == "all_invalid":
        # Every offset of these bands lies past max(len - N, 0) or the
        # track is empty: (-1, start).
        tracks[:, 1:3] = [[3, 11]]
        centers[:, 1:3] = [[120, 40]]
    if name == "duplicates_ties":
        # A query of period 10 planted as a longer run: equal peaks at
        # offsets 100, 110 and 120 of one band.
        qs[1] = np.tile(qs[1, :10], (N // 10, 1))
        prints[5, 100:210] = np.tile(qs[1, :10], (11, 1))
        tracks[1, :4] = 5
        centers[1, :4] = 105
    for i, ln in enumerate(lengths):
        prints[i, ln:] = 0
    return prints, lengths, qs, tracks, centers


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("name", CASES)
def test_fine_rescan_exact(name):
    prints, lengths, qs, tracks, centers = _case(name)
    starts = np.clip(centers - FW, 0, max(L - SPAN, 0)).astype(np.int32)
    s, o = fine.fine_rescan_batch(_t(qs), _t(prints), torch.from_numpy(lengths),
                                  torch.from_numpy(tracks), torch.from_numpy(starts),
                                  n_fine=N_FINE)
    s, o = s.numpy(), o.numpy()
    d0, d1, lpad = pallas_fine.plane_pad(prints)
    s_p, o_p = pallas_fine.pallas_fine_rescan_batch(
        jnp.asarray(qs), jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(lengths),
        jnp.asarray(tracks), jnp.asarray(starts), n_fine=N_FINE, lpad=lpad,
        interpret=True)
    np.testing.assert_array_equal(s, np.asarray(s_p))
    np.testing.assert_array_equal(o, np.asarray(o_p))
    for b in range(2):
        s_x, o_x = _fine_rescan(jnp.asarray(qs[b]), jnp.asarray(prints[tracks[b]]),
                                jnp.asarray(lengths[tracks[b]]), jnp.asarray(centers[b]),
                                fine_window=FW)
        np.testing.assert_array_equal(s[b], np.asarray(s_x))
        np.testing.assert_array_equal(o[b], np.asarray(o_x))
    assert s[0, 0] == 64 * N and o[0, 0] == 141
    if name == "past_end":
        assert s[0, 3] == 64 * 60 - int(np.bitwise_count(prints[9, :60] ^ qs[0, :60]).sum())
    if name == "all_invalid":
        np.testing.assert_array_equal(s[:, 1:3], -1)
        np.testing.assert_array_equal(o[:, 1:3], starts[:, 1:3])
    if name == "duplicates_ties":
        np.testing.assert_array_equal(s[1, :4], 64 * N)
        np.testing.assert_array_equal(o[1, :4], 100)


def test_fine_rescan_blocks_do_not_change_result(monkeypatch):
    prints, lengths, qs, tracks, centers = _case("past_end")
    args = (_t(qs), _t(prints), torch.from_numpy(lengths), torch.from_numpy(tracks),
            torch.from_numpy(np.clip(centers - FW, 0, L - SPAN).astype(np.int32)))
    want = fine.fine_rescan_ref(*args, n_fine=N_FINE)
    monkeypatch.setattr(fine, "REF_BLOCK_ELEMS", 2 * N * 3)       # 3 candidates a block
    got = fine.fine_rescan_ref(*args, n_fine=N_FINE)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("l", [1, 100, 1024, 2579])
def test_plane_pad_identical(l):
    """The cache's tight planes, as the reference's single-device layout."""
    p = np.random.default_rng(l).integers(0, 2 ** 32, (3, l, 2), dtype=np.uint32)
    assert fine.plane_lpad(l) == pallas_fine.plane_lpad(l, tight=True)
    for a, b in zip(fine.plane_pad(p), pallas_fine.plane_pad(p, tight=True)):
        np.testing.assert_array_equal(a, b)
