"""Coarse prints and their correlation: the plain tensor code of the catalog
matcher's coarse stage.

Counterpart of hpfw_tpu/ops/coarse.py. A coarse print summarises `stride`
consecutive hashprints per bit: the majority vote ("sign", ties to -1) or
the +/-1 sum itself ("sum"), keeping the first `channels` bits (hashprint
channels are PCA-ordered, so the prefix holds the most informative bits).
Prints are int32 tensors with the bit pattern of the uint32 words.

coarse_correlation(_batch) is the exhaustive correlation the coarse scan
reduces (ops/coarse_scan.py). It runs as float32 products, which are exact
here: every value is an integer and every partial sum stays below 2^24
(TwoStageDB checks the bound for sum-kind prints).
"""

from __future__ import annotations

import torch

# Elements (tracks x windows x query windows x lanes) per block of the plain
# correlation, which bounds its float32 temporaries to a few hundred MB.
REF_BLOCK_ELEMS = 1 << 25


def unpack_bits_pm1(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """(..., 2) int32 packed prints -> (..., 64) +/-1, lsb0: channel 32*w + b
    is bit b of word w. An arithmetic shift of an int32 word leaves bit b at
    position 0 whatever the sign, so the words need no widening (torch has
    no >> on uint32)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., :, None] >> shifts) & 1   # (..., 2, 32)
    bits = bits.reshape(*packed.shape[:-1], 64)
    return (bits * 2 - 1).to(dtype)


def coarse_pm1(packed: torch.Tensor, stride: int, *, kind: str = "sign",
               channels: int = 64) -> torch.Tensor:
    """Coarse prints per stride-window of full-resolution prints.

    packed: (L, 2) or (T, L, 2) int32. Returns (Lc, C) or (T, Lc, C) int8
    with Lc = L // stride (the tail beyond the last full window drops) and
    C = channels.
    """
    squeeze = packed.dim() == 2
    if squeeze:
        packed = packed[None]
    t, l, _ = packed.shape
    lc = l // stride
    pm1 = unpack_bits_pm1(packed[:, : lc * stride], torch.int32)
    sums = pm1.reshape(t, lc, stride, 64).sum(dim=2)
    if kind == "sum":
        if stride > 127:
            raise ValueError("sum coarse prints need stride <= 127 (int8)")
        out = sums.to(torch.int8)
    elif kind == "sign":
        out = torch.where(sums > 0, 1, -1).to(torch.int8)
    else:
        raise ValueError(f"unknown coarse kind {kind!r}")
    out = out[:, :, :channels]
    return out[0] if squeeze else out


def coarse_lengths(lengths: torch.Tensor, stride: int) -> torch.Tensor:
    """Full-resolution lengths -> number of complete coarse windows a track."""
    return lengths // stride


def correlation_blocks(query_cs: torch.Tensor, db_c: torch.Tensor):
    """Yield (t0, corr) over blocks of tracks: corr (B, r, Lc - Nc + 1) int32
    holds sum_j q_b(j) . d(t0 + i, o + j) for tracks t0 .. t0 + r - 1.

    query_cs (B, Nc, C), db_c (T, Lc, C) int8 with Lc >= Nc. Each block is
    one product of every DB window with every query window, then a sum along
    the diagonals."""
    b, nc, c = query_cs.shape
    t, lc, _ = db_c.shape
    n_off = lc - nc + 1
    w = query_cs.to(torch.float32).reshape(b * nc, c).T            # (C, B*Nc)
    rows = max(1, REF_BLOCK_ELEMS // max(1, lc * b * nc))
    for t0 in range(0, t, rows):
        p = (db_c[t0:t0 + rows].to(torch.float32) @ w).reshape(-1, lc, b, nc)
        acc = torch.zeros((p.shape[0], n_off, b), dtype=torch.float32,
                          device=db_c.device)
        for j in range(nc):
            acc += p[:, j:j + n_off, :, j]
        yield t0, acc.permute(2, 0, 1).to(torch.int32)


def coarse_correlation_batch(query_cs: torch.Tensor, db_c: torch.Tensor) -> torch.Tensor:
    """Exact correlation of B equal-length coarse queries (B, Nc, C) with
    every track (T, Lc, C) at every coarse offset: (B, T, Lc - Nc + 1) int32.
    Padded (zero) windows contribute nothing."""
    b, nc, _ = query_cs.shape
    t, lc, _ = db_c.shape
    n_off = max(lc - nc + 1, 0)
    out = torch.zeros((b, t, n_off), dtype=torch.int32, device=db_c.device)
    if n_off:
        for t0, corr in correlation_blocks(query_cs, db_c):
            out[:, t0:t0 + corr.shape[1]] = corr
    return out


def coarse_correlation(query_c: torch.Tensor, db_c: torch.Tensor) -> torch.Tensor:
    """corr(t, a) = sum_j q(j) . d(t, a + j): (T, Lc - Nc + 1) int32."""
    return coarse_correlation_batch(query_c[None], db_c)[0]
