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
CASES = ["planted", "past_end", "all_invalid", "duplicates_ties", "garbage_past_end"]


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
    if name in ("past_end", "garbage_past_end"):
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
    if name != "garbage_past_end":      # else random prints past each length
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
    if name in ("past_end", "garbage_past_end"):
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


@pytest.mark.parametrize("l", [1, 100, 1024, 2579])
def test_mesh_plane_pad_identical(l):
    """The planes of a mesh cache: every slot with its own headroom, no tail,
    as the reference's sharded layout."""
    p = np.random.default_rng(l).integers(0, 2 ** 32, (3, l, 2), dtype=np.uint32)
    assert fine.plane_lpad(l, tight=False) == pallas_fine.plane_lpad(l, tight=False)
    for a, b in zip(fine.plane_pad(p, tight=False), pallas_fine.plane_pad(p, tight=False)):
        np.testing.assert_array_equal(a, b)


GROUP_ROWS = 48      # band offsets K5 scores a pass (three m16 tiles)


def _pm1(words: torch.Tensor) -> torch.Tensor:
    """(..., 2) int32 words -> (..., 64) int64 +-1 channels, bit c % 32 of
    word c // 32 as channel c."""
    bits = (words[..., None].to(torch.int64) >> torch.arange(32)) & 1
    return (2 * bits - 1).reshape(*words.shape[:-1], 64)


def _k5_pm1(queries, prints, lengths, tracks, starts, *, n_fine):
    """K5's formulation in plain torch, over the query's +-1 Toeplitz matrix
    and the window zeroed outside [0, len_t), band rows in passes of 48 over
    K5's position range [r0, min(span, r0 + 47 + N)): the TPU kernel's sim =
    (corr + 64 * kcut) / 2 with the window +-1, equal (asserted) to K5's sim
    = corr01 + 64 * kcut - popcount(q[0 : kcut]) with the window as 0/1
    bytes; -1 outside the valid offsets, and the first-best (sim, ~r) key."""
    b, n, _ = queries.shape
    t, l, _ = prints.shape
    span = n + n_fine - 1
    tr = tracks.to(torch.int64)
    in_range = (tr >= 0) & (tr < t)
    tr = tr.clamp(0, max(t - 1, 0))
    lens = torch.where(in_range, lengths.to(torch.int64)[tr].clamp(0, l), 0)
    st = starts.to(torch.int64)
    pos = st[..., None] + torch.arange(span)                          # (B, K, span)
    inside = (pos >= 0) & (pos < lens[..., None])
    w = _pm1(prints[tr[..., None], pos.clamp(0, max(l - 1, 0))])       # (B, K, span, 64)
    w = torch.where(inside[..., None], w, 0)
    w01 = (w > 0).to(torch.int64)                                      # the bits, 0 outside
    qz = torch.cat([_pm1(queries), torch.zeros((b, 1, 64), dtype=torch.int64)], dim=1)
    # popcount(q[0 : k]) for k = 0 .. N
    ones = torch.cat([torch.zeros((b, 1), dtype=torch.int64), (qz[:, :n] > 0).sum(-1)], dim=1)
    pc = ones.cumsum(dim=1)                                            # (B, N + 1)
    best = torch.full(tr.shape, -2 ** 62, dtype=torch.int64)
    for r0 in range(0, n_fine, GROUP_ROWS):
        rows = torch.arange(r0, min(r0 + GROUP_ROWS, n_fine))
        p = torch.arange(r0, min(span, r0 + GROUP_ROWS - 1 + n))
        j = p[None, :] - rows[:, None]                                 # query print of A[r, p]
        a = qz[:, torch.where((j >= 0) & (j < n), j, n)]               # (B, R, P, 64)
        corr = torch.einsum("brpc,bkpc->bkr", a, w[:, :, p])
        corr01 = torch.einsum("brpc,bkpc->bkr", a, w01[:, :, p])
        o = st[..., None] + rows
        kcut = (lens[..., None] - o).clamp(0, n)
        valid = (o >= 0) & (o <= (lens - n).clamp(min=0)[..., None])
        sim = torch.where(valid, (corr + 64 * kcut) // 2, -1)
        pc_k = torch.gather(pc, 1, kcut.reshape(b, -1)).reshape(kcut.shape)
        assert torch.equal(sim, torch.where(valid, corr01 + 64 * kcut - pc_k, -1))
        best = torch.maximum(best, (sim * 2 ** 32 + (2 ** 32 - 1 - rows)).amax(dim=-1))
    offs = st + (2 ** 32 - 1 - (best & 0xFFFFFFFF))
    return (best >> 32).to(torch.int32), offs.to(torch.int32)


@pytest.mark.parametrize("name", CASES)
def test_pm1_formulation_equals_ref_and_pallas(name):
    """K5's +-1 GEMM formulation equals the plain popcount rescan and the
    Pallas kernel (interpret mode) exactly, garbage past a track's end
    included."""
    prints, lengths, qs, tracks, centers = _case(name)
    starts = np.clip(centers - FW, 0, max(L - SPAN, 0)).astype(np.int32)
    args = (_t(qs), _t(prints), torch.from_numpy(lengths), torch.from_numpy(tracks),
            torch.from_numpy(starts))
    got = _k5_pm1(*args, n_fine=N_FINE)
    want = fine.fine_rescan_ref(*args, n_fine=N_FINE)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    d0, d1, lpad = pallas_fine.plane_pad(prints)
    s_p, o_p = pallas_fine.pallas_fine_rescan_batch(
        jnp.asarray(qs), jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(lengths),
        jnp.asarray(tracks), jnp.asarray(starts), n_fine=N_FINE, lpad=lpad,
        interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(s_p))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(o_p))


@pytest.mark.parametrize("n,n_fine", [(1, 1), (1, 65), (90, 32), (90, 65), (200, 97)])
def test_pm1_row_groups_equal_ref(n, n_fine):
    """K5's passes of 48 band rows, each over its own position range, on
    bands of one offset to three passes, queries of 1 to 200 prints, tracks
    shorter than the query, garbage past each length, out-of-range track
    indices, negative starts and planted ties."""
    rng = np.random.default_rng(n + n_fine)
    t, l = 12, 400
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    lengths = rng.integers(0, l + 1, t).astype(np.int32)
    lengths[:3] = [l, n // 2, 0]
    qs = rng.integers(0, 2 ** 32, (2, n, 2), dtype=np.uint32)
    # A query of period 10 planted as a longer run: equal peaks at offsets 50
    # and 60, and the first wins.
    run = np.tile(rng.integers(0, 2 ** 32, (10, 2), dtype=np.uint32), (n // 10 + 2, 1))
    qs[0] = run[:n]
    prints[0, 50:60 + n] = run[:n + 10]
    tracks = rng.integers(-2, t + 2, (2, 40)).astype(np.int32)
    starts = rng.integers(-5, l - n, (2, 40)).astype(np.int32)
    tracks[0, :3], starts[0, :3] = [0, 0, 1], [40, 55, 0]
    args = (_t(qs), _t(prints), torch.from_numpy(lengths), torch.from_numpy(tracks),
            torch.from_numpy(starts))
    got = _k5_pm1(*args, n_fine=n_fine)
    want = fine.fine_rescan_ref(*args, n_fine=n_fine)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n_fine > 20:
        assert int(got[0][0, 0]) == 64 * n and int(got[1][0, 0]) == 50
