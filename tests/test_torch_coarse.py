"""Port coarse stage (the plain versions of K4) vs hpfw_tpu's coarse ops and
the Pallas coarse kernels in interpret mode: exact int32 equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hpfw_tpu.ops import coarse as jax_coarse
from hpfw_tpu.ops import pallas_coarse
from hpfw_tpu_torch.ops import coarse, coarse_scan


def _prints(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _jax_best(corr):
    corr = np.asarray(corr)
    return corr.max(axis=-1), corr.argmax(axis=-1)


@pytest.mark.parametrize("stride,kind,channels", [
    (4, "sign", 64), (8, "sum", 64), (8, "sign", 32), (3, "sign", 16), (16, "sum", 40)])
def test_coarse_pm1_identical(stride, kind, channels):
    rng = np.random.default_rng(stride * 7 + channels)
    packed = rng.integers(0, 2 ** 32, (5, 101, 2), dtype=np.uint32)
    packed[1, 8:16] = packed[1, 0]          # repeated prints: sums far from 0
    got = coarse.coarse_pm1(_prints(packed), stride, kind=kind, channels=channels)
    want = jax_coarse.coarse_pm1(jnp.asarray(packed), stride, kind=kind,
                                 channels=channels)
    assert got.dtype == torch.int8 and got.shape == (5, 101 // stride, channels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = coarse.coarse_pm1(_prints(packed[2]), stride, kind=kind, channels=channels)
    np.testing.assert_array_equal(one.numpy(), np.asarray(want)[2])


def test_unpack_bits_pm1_identical():
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 2 ** 32, (7, 3, 2), dtype=np.uint32)
    packed[0, 0] = [0, 2 ** 32 - 1]
    packed[0, 1] = [2 ** 31, 1]
    np.testing.assert_array_equal(coarse.unpack_bits_pm1(_prints(packed)).numpy(),
                                  np.asarray(jax_coarse.unpack_bits_pm1(jnp.asarray(packed))))


@pytest.mark.parametrize("lc,c", [(19, 64), (37, 32), (10, 8), (40, 24), (12, 64)])
def test_flatten_coarse_identical(lc, c):
    rng = np.random.default_rng(lc)
    d = rng.choice([-1, 1], (3, lc, c)).astype(np.int8)
    got = coarse_scan.flatten_coarse(torch.from_numpy(d))
    want = np.asarray(pallas_coarse.flatten_coarse(jnp.asarray(d)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == coarse_scan.flat_width(lc, c)


SCAN_CASES = ["random_lengths", "ties", "all_negative", "sum_valued", "channels_32"]


def _scan_case(name):
    """(query (Nc, C), db (T, Lc, C)) int8, zero past each track's length."""
    rng = np.random.default_rng(SCAN_CASES.index(name))
    t, lc, nc, c = 32, 37, 5, 64
    if name == "channels_32":
        c = 32
    if name == "sum_valued":
        q = rng.integers(-8, 9, (nc, c)).astype(np.int8)
        d = rng.integers(-8, 9, (t, lc, c)).astype(np.int8)
    else:
        q = rng.choice([-1, 1], (nc, c)).astype(np.int8)
        d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    lens = rng.integers(nc, lc + 1, size=t)
    if name == "ties":
        d[:] = 0
        d[:, 3:3 + nc] = q                  # equal peaks at offsets 3 and 11
        d[:, 11:11 + nc] = q
        d[5] = d[9]
        lens[:] = lc
    if name == "all_negative":
        q[:] = 1
        d[4, :] = -1                        # every real offset of track 4 < 0
        lens[4] = 12                        # ... and offsets 12.. fully padded
    for i, ln in enumerate(lens):
        d[i, ln:] = 0
    return q, d


@pytest.mark.parametrize("name", SCAN_CASES)
def test_coarse_scan_exact(name):
    q, d = _scan_case(name)
    lc = d.shape[1]
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d))
    best, first = coarse_scan.coarse_scan(torch.from_numpy(q), flat, lc_true=lc)
    want_b, want_i = _jax_best(jax_coarse.coarse_correlation(jnp.asarray(q), jnp.asarray(d)))
    np.testing.assert_array_equal(best.numpy(), want_b)
    np.testing.assert_array_equal(first.numpy(), want_i)
    p_b, p_i = pallas_coarse.pallas_coarse_scan(
        jnp.asarray(q), jnp.asarray(flat.numpy()), s=8, tt=8, lc_true=lc, interpret=True)
    np.testing.assert_array_equal(best.numpy(), np.asarray(p_b))
    np.testing.assert_array_equal(first.numpy(), np.asarray(p_i))
    np.testing.assert_array_equal(
        coarse.coarse_correlation(torch.from_numpy(q), torch.from_numpy(d)).numpy(),
        np.asarray(jax_coarse.coarse_correlation(jnp.asarray(q), jnp.asarray(d))))
    if name == "ties":
        assert int(first[0]) == 3
    if name == "all_negative":
        assert int(best[4]) == 0 and int(first[4]) == 12


@pytest.mark.parametrize("c", [64, 32])
def test_coarse_scan_batch_exact(c):
    rng = np.random.default_rng(c)
    t, lc, nc, b = 32, 37, 5, 3
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    for i, ln in enumerate(rng.integers(0, lc + 1, size=t)):
        d[i, ln:] = 0
    d[3] = d[7]
    qs = rng.choice([-1, 1], (b, nc, c)).astype(np.int8)
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d))
    best, first = coarse_scan.coarse_scan_batch(torch.from_numpy(qs), flat, lc_true=lc)
    assert best.shape == first.shape == (b, t)
    p_b, p_i = pallas_coarse.pallas_coarse_scan_batch_stacked(
        jnp.asarray(qs), jnp.asarray(flat.numpy()), s=8, tt=8, lc_true=lc, interpret=True)
    np.testing.assert_array_equal(best.numpy(), np.asarray(p_b))
    np.testing.assert_array_equal(first.numpy(), np.asarray(p_i))
    corr = jax_coarse.coarse_correlation_batch(jnp.asarray(qs), jnp.asarray(d))
    want_b, want_i = _jax_best(corr)
    np.testing.assert_array_equal(best.numpy(), want_b)
    np.testing.assert_array_equal(first.numpy(), want_i)
    np.testing.assert_array_equal(
        coarse.coarse_correlation_batch(torch.from_numpy(qs), torch.from_numpy(d)).numpy(),
        np.asarray(corr))


@pytest.mark.parametrize("c,duplicates", [(64, False), (32, True)])
def test_coarse_rescan_exact(c, duplicates):
    """Block-diagonal rescan through an index array == the reference kernel
    on the gathered rows, at B=2 queries, V=3 variants, M=16 rows each."""
    rng = np.random.default_rng(11 + c)
    t, lc, nc, b, v, m = 48, 37, 5, 2, 3, 16
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    for i, ln in enumerate(rng.integers(nc, lc + 1, size=t)):
        d[i, ln:] = 0
    d[3] = d[7]
    rows = np.sort(np.stack([rng.permutation(t)[:m] for _ in range(b)]), axis=1)
    if duplicates:                          # a padded pool repeats its first row
        rows[1, -3:] = rows[1, 0]
        rows[1] = np.sort(rows[1])
    qs = rng.choice([-1, 1], (b, v, nc, c)).astype(np.int8)
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d))
    best, first = coarse_scan.coarse_rescan(
        torch.from_numpy(qs), flat, torch.from_numpy(rows.astype(np.int32)), lc_true=lc)
    assert best.shape == first.shape == (b, v, m)
    p_b, p_i = pallas_coarse.pallas_coarse_rescan_stacked(
        jnp.asarray(qs), jnp.asarray(flat.numpy()[rows.reshape(-1)]), s=8, lc_true=lc,
        interpret=True)
    np.testing.assert_array_equal(best.numpy(), np.asarray(p_b))
    np.testing.assert_array_equal(first.numpy(), np.asarray(p_i))


def test_plain_scan_blocks_do_not_change_result(monkeypatch):
    q, d = _scan_case("random_lengths")
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d))
    want = coarse_scan.coarse_scan_ref(torch.from_numpy(q), flat, lc_true=d.shape[1])
    monkeypatch.setattr(coarse, "REF_BLOCK_ELEMS", 3 * 37 * 5)   # 3 tracks a block
    got = coarse_scan.coarse_scan_ref(torch.from_numpy(q), flat, lc_true=d.shape[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_scan_rejects_query_longer_than_rows():
    q = torch.ones((6, 64), dtype=torch.int8)
    flat = coarse_scan.flatten_coarse(torch.ones((2, 5, 64), dtype=torch.int8))
    with pytest.raises(ValueError, match="longer than"):
        coarse_scan.coarse_scan(q, flat, lc_true=5)


def _keys_to_results(key):
    return (key >> 32).to(torch.int32), (2 ** 32 - 1 - (key & (2 ** 32 - 1))).to(torch.int32)


def _chunked_scan(qs, flat, lc_true, lanes):
    """Plain emulation of the int8 body's streaming of long rows: each row
    scanned chunk by chunk over the windows [o0, o1 + Nc - 1) of row_chunks,
    each chunk's best as the 64-bit key corr * 2^32 + 2^32 - 1 - offset, the
    keys merged by max across chunks."""
    g, nc, c = qs.shape
    chunk_off, smem = coarse_scan.scan_geometry(lc_true, nc, c, lanes)
    assert chunk_off % coarse_scan.OFFSET_GROUP == 0 and smem <= coarse_scan.MAX_SMEM
    chunks = coarse_scan.row_chunks(lc_true - nc + 1, chunk_off)
    assert chunks[0][0] == 0 and chunks[-1][1] == lc_true - nc + 1
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    db_c = flat.view(flat.shape[0], -1, c)
    key = None
    for o0, o1 in chunks:
        corr = coarse.coarse_correlation_batch(qs, db_c[:, o0:o1 + nc - 1]).to(torch.int64)
        assert corr.shape[2] == o1 - o0
        o = torch.arange(o0, o1, dtype=torch.int64)
        k = (corr * 2 ** 32 + (2 ** 32 - 1 - o)).max(dim=2).values
        key = k if key is None else torch.maximum(key, k)
    return _keys_to_results(key)


def _tile_step(geo):
    """Window positions a tile of the packed body yields: all PACKED_TILE in
    the short body (geo.lanes PACKED_SHORT_LANES), else PACKED_STEP."""
    return (coarse_scan.PACKED_TILE if geo.lanes == coarse_scan.PACKED_SHORT_LANES
            else coarse_scan.PACKED_STEP)


def _packed_stream_scan(qs, flat, lc_true, seed=0):
    """Plain emulation of the packed body (csrc/coarse.cu packed_scan): the
    lanes in blocks of geo.lanes (zero lanes past them: PACKED_LANES, or the
    short body's PACKED_SHORT_LANES for a query of up to PACKED_HALF
    windows); each row cut into
    segments of seg_off offsets and seg_off + Nc - 1 windows, chunk_segs
    whole rows a chunk or one segment of a long row, laid back to back in a
    stream whose other windows hold garbage (stale bytes in the kernel); every
    window position of the chunk's tiles (_tile_step positions each: the
    short body yields all PACKED_TILE)
    scanned, those past a segment's valid offsets masked, and the 64-bit keys
    merged per row and lane across segments."""
    g, nc, c = qs.shape
    geo = coarse_scan.packed_geometry(lc_true, nc, c)
    seg_win = geo.seg_off + nc - 1
    assert geo.smem == coarse_scan.packed_smem(nc, c, seg_win, geo.chunk_segs, geo.a_blocks)
    assert geo.smem <= coarse_scan.MAX_SMEM
    n_off = lc_true - nc + 1
    pieces = coarse_scan.row_chunks(n_off, geo.seg_off)
    assert pieces[0][0] == 0 and pieces[-1][1] == n_off
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    t = flat.shape[0]
    db_c = flat.view(t, -1, c)[:, :lc_true]
    if len(pieces) == 1:
        chunks = [[(r, 0, n_off) for r in range(r0, min(r0 + geo.chunk_segs, t))]
                  for r0 in range(0, t, geo.chunk_segs)]
    else:
        assert geo.chunk_segs == 1 and geo.seg_off % 8 == 0
        chunks = [[(r, o0, o1)] for r in range(t) for o0, o1 in pieces]
    assert geo.lanes == (coarse_scan.PACKED_SHORT_LANES if nc <= coarse_scan.PACKED_HALF
                         else coarse_scan.PACKED_LANES)
    q = torch.nn.functional.pad(qs, (0, 0, 0, 0, 0, -g % geo.lanes))
    key = torch.full((q.shape[0], t), -2 ** 63, dtype=torch.int64)
    rng = np.random.default_rng(seed)
    step = _tile_step(geo)
    for chunk in chunks:
        tiles = -(-len(chunk) * seg_win // step)
        stream = torch.from_numpy(rng.integers(-8, 8, (tiles * step + nc - 1, c)).astype(np.int8))
        for s, (r, o0, _) in enumerate(chunk):
            w = db_c[r, o0:o0 + seg_win]
            stream[s * seg_win:s * seg_win + w.shape[0]] = w
        corr = coarse.coarse_correlation_batch(q, stream[None])[:, 0].to(torch.int64)
        assert corr.shape[1] == tiles * step
        pos = torch.arange(tiles * step)
        seg, i = pos // seg_win, pos % seg_win
        for s, (r, o0, o1) in enumerate(chunk):
            m = (seg == s) & (i < o1 - o0)
            k = (corr[:, m] * 2 ** 32 + (2 ** 32 - 1 - (o0 + i[m]))).max(dim=1).values
            key[:, r] = torch.maximum(key[:, r], k)
    return _keys_to_results(key[:g])


@pytest.mark.parametrize("lc,c,lanes,packed", [
    (3000, 64, 2, False), (5000, 32, 16, False), (3100, 24, 3, False), (3000, 64, 9, False),
    (5000, 32, 2, True), (5000, 64, 42, True), (5000, 24, 3, True)])
def test_long_row_chunks_merge_to_the_whole_scan(lc, c, lanes, packed):
    """Rows of 3,000+ windows (past the old shared-memory limit) streamed in
    K4's chunks (the packed body's segments, 42 lanes in two blocks): the
    merged keys equal coarse_scan_batch_ref and the reference's
    coarse_correlation_batch, with ties and peaks placed across and inside
    the overlap of two chunks, and an all-negative row."""
    rng = np.random.default_rng(lc + c + lanes)
    t, nc = 6, 26
    chunk_off = (coarse_scan.packed_geometry(lc, nc, c).seg_off if packed
                 else coarse_scan.scan_geometry(lc, nc, c, lanes)[0])
    assert lc - nc + 1 > 2 * chunk_off                       # three chunks or more
    qs = rng.choice([-1, 1], (lanes, nc, c)).astype(np.int8)
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    b = chunk_off                                             # the first chunk boundary
    d[0, b - 20:b - 20 + nc] = qs[0]                          # tie: in chunk 0, windows in both ...
    d[0, b + 10:b + 10 + nc] = qs[0]                          # ... and in chunk 1
    d[1, b - 1:b - 1 + nc] = qs[0]                            # peak: last offset of chunk 0
    d[2, b:b + nc] = qs[-1]                                   # peak: first offset of chunk 1
    d[3] = -qs[0, 0]                                          # every offset negative for lane 0
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d))
    q = torch.from_numpy(qs)
    got = (_packed_stream_scan(q, flat, lc, seed=lc) if packed
           else _chunked_scan(q, flat, lc, lanes))
    want = coarse_scan.coarse_scan_batch_ref(q, flat, lc_true=lc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    corr = np.asarray(jax_coarse.coarse_correlation_batch(jnp.asarray(qs), jnp.asarray(d)))
    np.testing.assert_array_equal(got[0].numpy(), corr.max(axis=-1))
    np.testing.assert_array_equal(got[1].numpy(), corr.argmax(axis=-1))
    assert int(got[0][0, 0]) == nc * c and int(got[1][0, 0]) == b - 20
    assert int(got[1][0, 1]) == b - 1 and int(got[1][lanes - 1, 2]) == b
    assert int(got[0][0, 3]) < 0


def _tile_edges(geo, n_win, n_off, nc, rows):
    """Ties in rows of a chunk: (row, (first offset, equal later offset)),
    the first at a tile's last position, at a tile's first, or the later one
    at a tile's first, in turn where the row has them (tiles of _tile_step
    positions of the packed stream)."""
    tile = _tile_step(geo)
    plants = []
    for r in rows:
        base = (r % geo.chunk_segs) * n_win
        first = [o for o in range(n_off) if (base + o) % tile == 0]
        last = [o for o in range(n_off) if (base + o) % tile == tile - 1]
        kinds = [[(a, b) for a, b in pairs if a >= 0 and b < n_off]
                 for pairs in ([(o, o + nc) for o in last], [(o, o + nc) for o in first],
                               [(o - nc, o) for o in first])]
        kinds = [k for k in kinds[r % 3:] + kinds[:r % 3] if k]
        if kinds:
            plants.append((r, kinds[0][0]))
    return plants


@pytest.mark.parametrize("c,lc,nc,lanes", [
    (32, 161, 26, 32), (64, 161, 26, 8), (8, 40, 5, 42), (24, 161, 9, 2), (32, 161, 7, 65),
    (32, 161, 16, 3), (64, 161, 7, 3)])
def test_packed_stream_of_whole_rows_equals_the_scan(c, lc, nc, lanes):
    """The packed body's stream of whole rows (chunk_segs a chunk, the rows
    not a multiple of it): equal to coarse_scan_batch_ref with peaks at the
    first and the last offset of a tile and a tie across tiles, a row's peak
    at its last valid offset before a row that matches at its first, and an
    all-negative row whose positions past n_off straddle into such a row."""
    rng = np.random.default_rng(c + lc + lanes)
    geo = coarse_scan.packed_geometry(lc, nc, c)
    n_off = lc - nc + 1
    assert geo.seg_off == n_off
    t = 2 * geo.chunk_segs + 9
    qs = rng.choice([-1, 1], (lanes, nc, c)).astype(np.int8)
    qs[0] = 1
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    edges = _tile_edges(geo, lc, n_off, nc, range(6, 6 + 2 * geo.chunk_segs))
    for r, offs in edges:                                     # peaks and ties at tile edges
        for o in offs:
            d[r, o:o + nc] = qs[-1]
    d[1, n_off - 1:] = 1                                      # lane 0: the last valid offset
    d[2, :nc] = 1                                             # the next row matches at 0
    d[3] = -1                                                 # all negative for lane 0; its
    d[4, :nc] = 1                                             # positions past n_off meet a match
    flat = coarse_scan.flatten_coarse(torch.from_numpy(d))
    q = torch.from_numpy(qs)
    got = _packed_stream_scan(q, flat, lc, seed=c)
    want = coarse_scan.coarse_scan_batch_ref(q, flat, lc_true=lc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][0, 1]) == n_off - 1 and int(got[1][0, 2]) == 0
    assert int(got[0][0, 3]) == -nc * c and int(got[1][0, 3]) == 0
    assert int(got[0][0, 4]) == nc * c and int(got[1][0, 4]) == 0
    assert len(edges) >= 3
    for r, offs in edges:
        assert int(got[0][lanes - 1, r]) == nc * c and int(got[1][lanes - 1, r]) == offs[0]


def test_rows_of_common_length_are_one_chunk():
    """At config-4 shapes (161 windows, 26-window queries) a row is one or two
    chunks of the int8 body within SCAN_SMEM, pass 1's 32 channels one; the
    packed body takes whole rows, several a chunk, two blocks an SM, its
    query staged once, and every lane of a group of up to PACKED_LANES in one
    block, so each row is read once."""
    for c, lanes in ((32, 16), (64, 16), (64, 8), (64, 1)):
        chunk_off, smem = coarse_scan.scan_geometry(161, 26, c, lanes)
        assert smem <= coarse_scan.SCAN_SMEM
        n = len(coarse_scan.row_chunks(136, chunk_off))
        assert n == 1 if c == 32 else n <= 2
    for c in (32, 24, 16, 8):
        geo = coarse_scan.packed_geometry(161, 26, c)
        assert geo.smem <= coarse_scan.SCAN_SMEM and geo.seg_off == 136
        assert geo.chunk_segs > 1 and geo.a_blocks == 1
    geo = coarse_scan.packed_geometry(161, 26, 64)
    assert geo.seg_off == 136 and geo.chunk_segs > 1 and geo.a_blocks == 1
    assert coarse_scan.PACKED_LANES == 32
    assert geo.lanes == coarse_scan.PACKED_LANES
    # A stream's 128-print ring (7 windows) takes the short body: 64 lanes a
    # block, whole rows, three blocks an SM.
    geo = coarse_scan.packed_geometry(161, 7, 32)
    assert coarse_scan.PACKED_SHORT_LANES == 64 and geo.lanes == coarse_scan.PACKED_SHORT_LANES
    assert geo.seg_off == 155 and geo.chunk_segs > 1 and geo.smem <= coarse_scan.PACKED_SMEM


@pytest.mark.parametrize("c", [8, 16, 24, 32, 40, 48, 56, 64])
def test_packed_geometry_fits_shared_memory(c):
    """Every row length and query length the wrapper takes fits a block's
    227 KB, and lanes past PACKED_LANES go over grid.y: whole rows where one
    fits, else segments of a multiple of 8 offsets one a chunk; the query's
    blocks of 32 windows staged at once where they fit, else in turns.
    Queries as long as the int8 body takes fit too, and a 10 s query against
    60 s rows of 8-32 channels fits two blocks an SM. Queries of up to
    PACKED_HALF windows take the short body (64 lanes a block, the whole
    query staged, tiles that yield all their positions), and a stream's
    7-window ring against 60 s rows of 8-32 channels fits three an SM."""
    for lc, nc in ((161, 26), (40, 5), (26, 26), (700, 9), (3000, 26), (5000, 26), (3000, 7),
                   (161, 120), (1000, 200), (3000, 377), (161, 7), (161, 16), (161, 17)):
        try:
            coarse_scan.scan_geometry(lc, nc, c, 1)
        except ValueError:                   # past what the int8 body takes
            continue
        n_off = lc - nc + 1
        geo = coarse_scan.packed_geometry(lc, nc, c)
        seg_win = geo.seg_off + nc - 1
        assert geo.smem == coarse_scan.packed_smem(nc, c, seg_win, geo.chunk_segs, geo.a_blocks)
        assert geo.smem <= coarse_scan.MAX_SMEM
        assert 1 <= geo.a_blocks <= -(-nc // 32)
        assert 1 <= geo.chunk_segs <= coarse_scan.MAX_CHUNK_SEGS
        if geo.seg_off < n_off:
            assert geo.seg_off % 8 == 0 and geo.chunk_segs == 1
        else:
            assert geo.seg_off == n_off
        if (lc, nc) == (161, 26) and c <= 32:
            assert geo.smem <= coarse_scan.SCAN_SMEM and geo.seg_off == n_off
        short = nc <= coarse_scan.PACKED_HALF               # the short body: 64 lanes a block
        assert geo.lanes == (coarse_scan.PACKED_SHORT_LANES if short else coarse_scan.PACKED_LANES)
        assert geo.lanes == coarse_scan.packed_lanes(nc)
        assert _tile_step(geo) == (coarse_scan.PACKED_TILE if short else coarse_scan.PACKED_STEP)
        assert not short or geo.a_blocks == 1
        if (lc, nc) == (161, 7) and c <= 32:                # three blocks an SM
            assert geo.smem <= coarse_scan.PACKED_SMEM and geo.seg_off == n_off
    for lanes, blocks in ((1, 1), (2, 1), (32, 1), (33, 2), (42, 2), (126, 4)):
        assert -(-lanes // coarse_scan.PACKED_LANES) == blocks
    for lanes, blocks in ((1, 1), (63, 1), (64, 1), (65, 2), (512, 8)):
        assert -(-lanes // coarse_scan.PACKED_SHORT_LANES) == blocks
