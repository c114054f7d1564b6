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

import torch

from . import _build
from .coarse import correlation_blocks

# K4 launch geometry: a block stages a chunk of query lanes in at most
# QUERY_SMEM bytes, and enough rows (at most 8, in at most ROW_SMEM bytes)
# for PAIRS_PER_BLOCK (row, lane) pairs, within the 227 KB a block may use.
# Windows are staged as 16-byte chunks, ceil(C/16) of them at an odd stride.
ROWS_PER_BLOCK = 8
PAIRS_PER_BLOCK = 16
ROW_SMEM = 104 * 1024
QUERY_SMEM = 32 * 1024
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
    chunks = -(-c // 16)
    row_bytes = lc_true * (chunks | 1) * 16
    q_bytes = nc * chunks * 16
    lane_chunk = max(1, min(lanes, QUERY_SMEM // max(q_bytes, 1)))
    rows_per_block = max(1, min(ROWS_PER_BLOCK, -(-PAIRS_PER_BLOCK // lane_chunk),
                                ROW_SMEM // row_bytes))
    smem = rows_per_block * row_bytes + lane_chunk * q_bytes
    if smem > MAX_SMEM:
        raise ValueError(f"coarse rows of {lc_true} windows x {c} channels need "
                         f"{smem} bytes of shared memory; the kernel has {MAX_SMEM}")
    if n_groups * -(-lanes // lane_chunk) > MAX_GRID_Y:
        raise ValueError(f"too many query lanes for one launch ({total})")
    best = torch.empty((total, n_rows), dtype=torch.int32, device=db_flat.device)
    first = torch.empty_like(best)
    if total and n_rows:
        _build.launch(name, "hpfw_coarse_scan", db_flat.device,
                      query_cs.data_ptr(), n_groups, lanes, nc, c,
                      db_flat.data_ptr(), lcw, lc_true,
                      rows.data_ptr() if rows is not None else None, n_rows,
                      rows_per_block, lane_chunk, int(packed), best.data_ptr(),
                      first.data_ptr())
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
