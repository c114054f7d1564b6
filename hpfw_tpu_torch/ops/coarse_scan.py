"""Coarse scan: per-track best correlation and first best coarse offset.

Counterpart of hpfw_tpu/ops/pallas_coarse.py. For a coarse query q (Nc, C)
and a DB row d of lc_true windows:
    corr(o) = sum_{j < Nc} q(j) . d(o + j)    for o < n_off = lc_true - Nc + 1
    best = max_o corr(o),  first = min {o : corr(o) = best}
n_off comes from the DB's window count, not from each track's length: a
track's windows past its end are zero and score 0, so a track whose real
offsets all correlate negatively reports 0 at a padded offset, as the
reference does.

The coarse DB is FLAT, (T, Lc_pad * C) int8 rows (flatten_coarse), the
layout the reference stores and saves; pass 1 of the two-pass matcher may
read it nibble-packed instead (pack_coarse_nibbles: two features a byte,
half the bytes). Four surfaces, one CUDA kernel (K4, csrc/coarse.cu):
    coarse_scan               one query against every row          (B4)
    coarse_scan_batch         G query lanes against every row      (B5)
    coarse_scan_batch_packed  the same over nibble-packed rows     (B5 packed4)
    coarse_rescan             query b's V variants against only its own M
                              rows, read through an index array    (B6)
On CUDA tensors each launches K4; on CPU tensors each runs its plain
version (the *_ref functions), which the tests hold against the reference.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import NamedTuple

import torch

from . import _build
from .coarse import correlation_blocks

# K4 launch geometry (csrc/coarse.cu). The int8 body: a block of SCAN_WARPS
# warps stages 8 query lanes (16 when there are more than 8) and scans
# ROWS_PER_BLOCK rows, each warp its own, streaming a row through shared
# memory a chunk of offsets at a time, two chunks deep; chunks are sized so
# that a block takes at most SCAN_SMEM bytes (two blocks an SM). The packed
# body: a block (one warpgroup) stages PACKED_LANES lanes, two halves of
# each query as the 64 rows of its wgmma products, and streams segments of
# rows back to back, PACKED_STEP positions a tile of PACKED_TILE, at most
# MAX_CHUNK_SEGS segments a chunk, within PACKED_SMEM bytes (three blocks an
# SM) where it can. A query of at most PACKED_HALF windows takes the short
# body instead: PACKED_SHORT_LANES lanes a block, one row of the products
# each, and tiles that yield all PACKED_TILE positions. A query too long for
# even one chunk within the MAX_SMEM a block may use raises.
SCAN_WARPS = 4
OFFSET_GROUP = 48            # offsets a warp scans at a time: 3 tiles of 16
ROWS_PER_BLOCK = 16
PACKED_LANES = 32
PACKED_TILE = 192            # window positions a tile's two chains of products cover
PACKED_STEP = 176            # positions a tile yields: half 1 is 16 on
PACKED_HALF = 16             # query windows of a half in each block of 32
PACKED_SHORT_LANES = 64      # lanes a block of the short body (nc <= PACKED_HALF)
MAX_CHUNK_SEGS = 64
SCAN_SMEM = 110 * 1024
PACKED_SMEM = 74 * 1024      # three packed blocks an SM
MAX_SMEM = 227 * 1024
MAX_GRID_Y = 65535
# Rows a chunk of pack_coarse_nibbles packs at once.
PACK_CHUNK_ROWS = 8192


def flat_width(lc: int, c: int) -> int:
    """Bytes of a flat coarse row: Lc windows padded so Lc * C % 128 == 0."""
    unit = 128 // math.gcd(c, 128)
    return -(-lc // unit) * unit * c


def flatten_coarse(db_c: torch.Tensor) -> torch.Tensor:
    """(T, Lc, C) int8 -> (T, Lc_pad * C) flat rows, zero windows appended
    so every row is 128 bytes (the reference's 128-lane rows)."""
    t, lc, c = db_c.shape
    pad = flat_width(lc, c) // c - lc
    if pad:
        db_c = torch.nn.functional.pad(db_c, (0, 0, 0, pad))
    return db_c.reshape(t, -1)


def pack_coarse_nibbles(db_flat: torch.Tensor) -> torch.Tensor:
    """(T, lcw) int8 flat coarse rows, values in [-8, 7] -> (T, lcw_pad / 2)
    int8, feature 2j in the low nibble of byte j and feature 2j + 1 in the
    high nibble, lcw padded with zero features to a multiple of 256; the
    bytes of hpfw_tpu.ops.pallas_coarse.pack_coarse_nibbles. Packed in int8,
    PACK_CHUNK_ROWS rows at a time, so no temporary is larger than a chunk."""
    t, lcw = db_flat.shape
    width = -(-lcw // 256) * 256
    out = torch.empty((t, width // 2), dtype=torch.int8, device=db_flat.device)
    for i in range(0, t, PACK_CHUNK_ROWS):
        blk = db_flat[i:i + PACK_CHUNK_ROWS]
        if width != lcw:
            blk = torch.nn.functional.pad(blk, (0, width - lcw))
        out[i:i + PACK_CHUNK_ROWS] = (blk[:, 0::2] & 15) | (blk[:, 1::2] * 16)
    return out


def unpack_coarse_nibbles(db_packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_coarse_nibbles: (T, W) packed -> (T, 2W) int8, each
    nibble sign-extended (the padding stays as zero features)."""
    p = db_packed.to(torch.int16)
    lo = ((p & 15) ^ 8) - 8
    hi = p >> 4
    return torch.stack([lo, hi], dim=2).reshape(p.shape[0], -1).to(torch.int8)


def _windows(db_flat: torch.Tensor, c: int, lc_true: int) -> torch.Tensor:
    """Flat rows -> (T, lc_true, C) view of the scanned windows."""
    t, lcw = db_flat.shape
    if lcw % c or lcw // c < lc_true:
        raise ValueError(f"flat rows of {lcw} bytes do not hold {lc_true} windows "
                         f"of {c} channels")
    return db_flat.view(t, lcw // c, c)[:, :lc_true]


def _check_packed(db_packed: torch.Tensor, c: int, lc_true: int) -> None:
    if db_packed.dim() != 2 or 2 * db_packed.shape[1] < lc_true * c:
        raise ValueError(f"packed rows of shape {tuple(db_packed.shape)} do not hold "
                         f"{lc_true} windows of {c} channels")


def _check_off(nc: int, lc_true: int) -> None:
    if lc_true - nc + 1 < 1:
        raise ValueError(f"query of {nc} coarse windows is longer than the "
                         f"{lc_true} windows of the DB rows")


def scan_geometry(n_win: int, nc: int, c: int, lanes: int) -> tuple[int, int]:
    """The int8 body's (chunk_off, shared-memory bytes) for rows of n_win
    windows, a query of nc windows of c channels and `lanes` lanes a group. A
    block stages 8 lanes (16 for more than 8) at nc * Cp + 16 bytes each (Cp =
    32 or 64, c rounded up); each warp a chunk of chunk_off offsets (a whole
    number of OFFSET_GROUP-offset groups) from cw = chunk_off + nc - 1
    windows at Cp + 16 bytes, two buffers deep. chunk_off covers the whole row
    where that fits in SCAN_SMEM. Nibble-packed rows take packed_geometry."""
    cp = 32 if c <= 32 else 64
    q_bytes = (8 if lanes <= 8 else 16) * (nc * cp + 16)

    def smem(chunk_off: int) -> int:
        return q_bytes + SCAN_WARPS * 2 * (chunk_off + nc - 1) * (cp + 16)

    chunk_off = OFFSET_GROUP * -(-(n_win - nc + 1) // OFFSET_GROUP)
    while chunk_off > OFFSET_GROUP and smem(chunk_off) > SCAN_SMEM:
        chunk_off -= OFFSET_GROUP
    if smem(chunk_off) > MAX_SMEM:
        raise ValueError(f"a query of {nc} coarse windows x {c} channels needs "
                         f"{smem(chunk_off)} bytes of K4's shared memory; a block has "
                         f"{MAX_SMEM}")
    return chunk_off, smem(chunk_off)


class PackedGeometry(NamedTuple):
    seg_off: int         # offsets a segment: n_off where a whole row fits
    chunk_segs: int      # segments a chunk
    a_blocks: int        # blocks of 32 query windows staged at a time
    smem: int            # shared-memory bytes a block
    lanes: int           # lanes a block: the body, by packed_lanes


def packed_lanes(nc: int) -> int:
    """The packed body a query of nc windows takes, by its lanes a block:
    PACKED_SHORT_LANES (the short body) for nc <= PACKED_HALF, else
    PACKED_LANES. The launch passes it on, and the kernel library checks it."""
    return PACKED_SHORT_LANES if nc <= PACKED_HALF else PACKED_LANES


def packed_smem(nc: int, c: int, seg_win: int, chunk_segs: int, a_blocks: int) -> int:
    """The packed body's shared memory (csrc/coarse.cu packed_smem): a_blocks
    blocks of 32 query windows for the 64 rows (PACKED_HALF windows of Cp
    bytes each, Cp = 32 or 64, c rounded up); Cp bytes a window for the
    chunk's tiles, PACKED_STEP positions apart, and the windows the last one
    reads past them; each segment's seg_win * c / 2 packed bytes, rounded up
    to 16; an 8-byte key a segment and lane. The short body (packed_lanes,
    a_blocks 1): the query's nc windows for the 64 rows, the
    chunk's tiles PACKED_TILE positions apart and nc - 1 windows past them,
    the packed bytes, and PACKED_SHORT_LANES keys a segment."""
    cp = 32 if c <= 32 else 64
    packed = chunk_segs * -(-(seg_win * c // 2) // 16) * 16
    if packed_lanes(nc) == PACKED_SHORT_LANES:
        tiles = -(-chunk_segs * seg_win // PACKED_TILE)
        return (64 * nc * cp + cp * (tiles * PACKED_TILE + nc - 1) + packed
                + 8 * PACKED_SHORT_LANES * chunk_segs)
    tiles = -(-chunk_segs * seg_win // PACKED_STEP)
    n_blocks = -(-nc // (2 * PACKED_HALF))
    return (64 * PACKED_HALF * cp * a_blocks
            + cp * ((tiles - 1) * PACKED_STEP + PACKED_TILE + 2 * PACKED_HALF * (n_blocks - 1)
                    + PACKED_HALF - 1)
            + packed + 8 * PACKED_LANES * chunk_segs)


def packed_geometry(n_win: int, nc: int, c: int) -> PackedGeometry:
    """The packed body's geometry for rows of n_win windows and a query of nc
    windows of c channels; a launch takes ceil(lanes / geo.lanes) blocks on
    grid.y (packed_lanes), so at catalog shapes each row is read and unpacked
    once. The query's blocks of 32 windows are staged once where they fit
    (within PACKED_SMEM, three blocks an SM, else MAX_SMEM) beside one segment of
    min(n_win, nc + 7) windows, else a_blocks at a time. Rows are segments
    laid back to back: a whole row each (seg_off = n_off) where one fits, the
    chunk_segs (up to MAX_CHUNK_SEGS) that scan the fewest positions a
    segment; else a chunk is one segment of seg_off offsets (a multiple of 8)
    and a row several, whose windows overlap by nc - 1. Past MAX_SMEM,
    raises."""
    n_off = n_win - nc + 1
    s_min = min(n_win, nc + 7)
    n_blocks = -(-nc // (2 * PACKED_HALF))
    lanes = packed_lanes(nc)
    step = PACKED_TILE if lanes == PACKED_SHORT_LANES else PACKED_STEP
    for budget, a_blocks in ([(PACKED_SMEM, n_blocks)]
                             + [(MAX_SMEM, a) for a in range(n_blocks, 0, -1)]):
        if packed_smem(nc, c, s_min, 1, a_blocks) <= budget:
            break
    else:
        raise ValueError(f"a query of {nc} coarse windows x {c} channels needs "
                         f"{packed_smem(nc, c, s_min, 1, 1)} bytes of K4's shared memory; "
                         f"a block has {MAX_SMEM}")

    def smem(seg_win: int, r: int) -> int:
        return packed_smem(nc, c, seg_win, r, a_blocks)

    if smem(n_win, 1) <= budget:
        fit = [r for r in range(1, MAX_CHUNK_SEGS + 1) if smem(n_win, r) <= budget]
        r = min(fit, key=lambda r: (Fraction(-(-r * n_win // step), r), -r))
        return PackedGeometry(n_off, r, a_blocks, smem(n_win, r), lanes)
    seg_off = (n_off - 1) // 8 * 8
    while smem(seg_off + nc - 1, 1) > budget:
        seg_off -= 8
    return PackedGeometry(seg_off, 1, a_blocks, smem(seg_off + nc - 1, 1), lanes)


def row_chunks(n_off: int, chunk_off: int) -> list[tuple[int, int]]:
    """The chunks K4 scans a row in: offsets [o0, o1), from the windows [o0,
    o1 + nc - 1), so that consecutive chunks' windows overlap by nc - 1."""
    return [(o0, min(o0 + chunk_off, n_off)) for o0 in range(0, n_off, chunk_off)]


def coarse_scan_batch_ref(query_cs: torch.Tensor, db_flat: torch.Tensor, *,
                          lc_true: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of coarse_scan_batch: ((G, T), (G, T)) int32."""
    g, nc, c = query_cs.shape
    _check_off(nc, lc_true)
    db_c = _windows(db_flat, c, lc_true)
    t = db_c.shape[0]
    best = torch.empty((g, t), dtype=torch.int32, device=db_flat.device)
    first = torch.empty_like(best)
    for t0, corr in correlation_blocks(query_cs, db_c):
        n_off = corr.shape[2]
        b = corr.max(dim=2).values
        o = torch.arange(n_off, dtype=torch.int32, device=corr.device)
        first[:, t0:t0 + corr.shape[1]] = torch.where(
            corr == b[..., None], o, n_off).min(dim=2).values
        best[:, t0:t0 + corr.shape[1]] = b
    return best, first


def coarse_scan_batch_packed_ref(query_cs: torch.Tensor, db_packed: torch.Tensor, *,
                                 lc_true: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of coarse_scan_batch_packed: unpack the rows, then
    coarse_scan_batch_ref over their first lc_true windows."""
    c = query_cs.shape[2]
    _check_packed(db_packed, c, lc_true)
    flat = unpack_coarse_nibbles(db_packed)[:, :lc_true * c]
    return coarse_scan_batch_ref(query_cs, flat, lc_true=lc_true)


def coarse_scan_ref(query_c: torch.Tensor, db_flat: torch.Tensor, *,
                    lc_true: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of coarse_scan: ((T,), (T,)) int32."""
    best, first = coarse_scan_batch_ref(query_c[None], db_flat, lc_true=lc_true)
    return best[0], first[0]


def coarse_rescan_ref(query_cs: torch.Tensor, db_flat: torch.Tensor,
                      rows: torch.Tensor, *, lc_true: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of coarse_rescan: ((B, V, M), (B, V, M)) int32."""
    out = [coarse_scan_batch_ref(q, db_flat[r.long()], lc_true=lc_true)
           for q, r in zip(query_cs, rows)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def _launch(name: str, query_cs: torch.Tensor, db_flat: torch.Tensor,
            rows: torch.Tensor | None, n_groups: int, n_rows: int,
            lc_true: int, packed: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 over n_groups groups of `lanes` lanes and n_rows rows each.

    query_cs: (n_groups * lanes, Nc, C) int8. rows: (n_groups, n_rows) int32
    indices into db_flat, or None for rows 0 .. n_rows - 1. packed: db_flat
    holds nibble-packed rows (pack_coarse_nibbles). Returns
    ((n_groups * lanes, n_rows), same) int32 best and first offsets."""
    _build.require(db_flat, "db_flat", torch.int8, 2)
    _build.require(query_cs, "query_cs", torch.int8, 3, db_flat.device)
    total, nc, c = query_cs.shape
    t, lcw = db_flat.shape
    if c % 8 or not 8 <= c <= 64:
        raise ValueError(f"coarse channels must be a multiple of 8 in [8, 64], got {c}")
    if lcw % 16 or db_flat.data_ptr() % 16:
        raise ValueError("coarse rows must be 16-byte aligned")
    if query_cs.data_ptr() % 16:
        query_cs = query_cs.clone()
    if packed:
        _check_packed(db_flat, c, lc_true)
    else:
        _windows(db_flat, c, lc_true)
    _check_off(nc, lc_true)
    if rows is not None:
        _build.require(rows, "rows", torch.int32, 2, db_flat.device)
        if tuple(rows.shape) != (n_groups, n_rows):
            raise ValueError(f"rows must be ({n_groups}, {n_rows}), got {tuple(rows.shape)}")
    lanes = total // n_groups
    if packed:
        geo = packed_geometry(lc_true, nc, c)
        chunk_off, chunk_segs, a_blocks = geo.seg_off, geo.chunk_segs, geo.a_blocks
        block_lanes = geo.lanes
    else:
        chunk_off, _ = scan_geometry(lc_true, nc, c, lanes)
        chunk_segs, a_blocks, block_lanes = 0, 0, (8 if lanes <= 8 else 16)
    if n_groups * -(-lanes // block_lanes) > MAX_GRID_Y:
        raise ValueError(f"too many query lanes for one launch ({total})")
    best = torch.empty((total, n_rows), dtype=torch.int32, device=db_flat.device)
    first = torch.empty_like(best)
    if total and n_rows:
        _build.launch(name, "hpfw_coarse_scan", db_flat.device,
                      query_cs.data_ptr(), n_groups, lanes, nc, c,
                      db_flat.data_ptr(), lcw, lc_true,
                      rows.data_ptr() if rows is not None else None, n_rows,
                      ROWS_PER_BLOCK, chunk_off, block_lanes if packed else 0, chunk_segs,
                      a_blocks, best.data_ptr(), first.data_ptr())
    return best, first


def coarse_scan_kernel(query_c, db_flat, *, lc_true):
    """K4, one query: the same contract as coarse_scan_ref."""
    best, first = _launch("coarse_scan", query_c[None].contiguous(), db_flat, None,
                          1, db_flat.shape[0], lc_true)
    return best[0], first[0]


def coarse_scan_batch_kernel(query_cs, db_flat, *, lc_true):
    """K4, G lanes against every row: the same contract as coarse_scan_batch_ref."""
    return _launch("coarse_scan_batch", query_cs, db_flat, None, 1,
                   db_flat.shape[0], lc_true)


def coarse_scan_batch_packed_kernel(query_cs, db_packed, *, lc_true):
    """K4, G lanes against every nibble-packed row: the same contract as
    coarse_scan_batch_packed_ref."""
    return _launch("coarse_scan_batch_packed", query_cs, db_packed, None, 1,
                   db_packed.shape[0], lc_true, packed=True)


def coarse_rescan_kernel(query_cs, db_flat, rows, *, lc_true):
    """K4, block-diagonal: the same contract as coarse_rescan_ref."""
    b, v, nc, c = query_cs.shape
    best, first = _launch("coarse_rescan", query_cs.reshape(b * v, nc, c), db_flat,
                          rows, b, rows.shape[1], lc_true)
    return best.view(b, v, -1), first.view(b, v, -1)


def _dispatch(kernel, ref, db_flat, *args, **kw):
    if db_flat.device.type == "cuda":
        return kernel(*args, **kw)
    if db_flat.device.type == "cpu":
        return ref(*args, **kw)
    raise ValueError(f"no coarse scan for device {db_flat.device}")


def coarse_scan(query_c: torch.Tensor, db_flat: torch.Tensor, *, lc_true: int):
    """Per-track (best corr, first best coarse offset), ((T,), (T,)) int32.
    query_c (Nc, C) int8; db_flat (T, Lc_pad * C) int8."""
    return _dispatch(coarse_scan_kernel, coarse_scan_ref, db_flat,
                     query_c, db_flat, lc_true=lc_true)


def coarse_scan_batch(query_cs: torch.Tensor, db_flat: torch.Tensor, *, lc_true: int):
    """coarse_scan for G equal-length queries (G, Nc, C): ((G, T), (G, T))."""
    return _dispatch(coarse_scan_batch_kernel, coarse_scan_batch_ref, db_flat,
                     query_cs, db_flat, lc_true=lc_true)


def coarse_scan_batch_packed(query_cs: torch.Tensor, db_packed: torch.Tensor, *,
                             lc_true: int):
    """coarse_scan_batch over nibble-packed rows (pack_coarse_nibbles), with
    the same results as over the unpacked rows. lc_true is required: the
    256-feature pad adds zero windows, and a zero offset there would beat
    offsets whose real correlations are all negative."""
    return _dispatch(coarse_scan_batch_packed_kernel, coarse_scan_batch_packed_ref,
                     db_packed, query_cs, db_packed, lc_true=lc_true)


def coarse_rescan(query_cs: torch.Tensor, db_flat: torch.Tensor, rows: torch.Tensor,
                  *, lc_true: int):
    """Block-diagonal rescan: variant v of query b (query_cs (B, V, Nc, C))
    against only the rows db_flat[rows[b]] (rows (B, M) int32). Returns
    ((B, V, M), (B, V, M)) int32, equal per (b, v) to coarse_scan on those
    rows."""
    return _dispatch(coarse_rescan_kernel, coarse_rescan_ref, db_flat,
                     query_cs, db_flat, rows, lc_true=lc_true)
