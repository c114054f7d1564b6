"""Exact fine rescan of pooled candidates: stage 2 of the catalog matcher.

Counterpart of hpfw_tpu/ops/pallas_fine.py (the kernel) and
hpfw_tpu/match/scaled.py::_fine_rescan (its XLA twin). For query b and
candidate k (track t, band start s), at each offset o = s + r, r < n_fine:
    kcut = clip(len_t - o, 0, N)
    sim  = 64 * kcut - sum_{n < kcut} popcount(q[n] ^ d[o + n])
An offset is valid when 0 <= o <= max(len_t - N, 0) and scores -1 otherwise;
the result is the best sim of the band and the first offset reaching it,
(-1, s) when the whole band is invalid. A track index out of range scores
as an empty track.

Prints are read from the (T, L, 2) int32 print array. The flat word planes
of the reference's layouts (plane_lpad / plane_pad: tight on one device,
with headroom a slot under a mesh) are kept only for the two-stage cache
format that both packages read and write.

On CUDA tensors fine_rescan_batch launches K5 (csrc/fine.cu), which scores
the band as the TPU kernel does, sim = (corr + 64 * kcut) / 2 with corr the
+-1 product of the query and the window zeroed outside [0, len_t), on the
int8 tensor cores; it takes any query length and band width. On CPU tensors
it runs the plain version, fine_rescan_ref.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ..match.matcher import _popcount32

SNAP = 1024          # plane slot alignment of the cache format
WIDTH = 2048         # words of a plane's headroom in the cache format
_MASK32 = 0xFFFFFFFF
# Elements (queries x candidates x query prints) per block of the plain
# rescan, which bounds each int64 temporary to some 64 MB.
REF_BLOCK_ELEMS = 1 << 22
# Queries a K5 launch takes (its grid's y dimension).
MAX_QUERIES = 65535


def fine_rescan_ref(queries: torch.Tensor, prints: torch.Tensor,
                    lengths: torch.Tensor, cand_tracks: torch.Tensor,
                    cand_starts: torch.Tensor, *, n_fine: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of fine_rescan_batch: ((B, K), (B, K)) int32.

    Scans the band one offset at a time over blocks of candidates; a strict
    > keeps the first offset on ties."""
    b, n, _ = queries.shape
    t, l, _ = prints.shape
    k = cand_tracks.shape[1]
    dev = prints.device
    scores = torch.empty((b, k), dtype=torch.int32, device=dev)
    offsets = torch.empty_like(scores)
    q = (queries.to(torch.int64) & _MASK32)[:, None]                 # (B, 1, N, 2)
    pos_n = torch.arange(n, dtype=torch.int64, device=dev)
    block = max(1, REF_BLOCK_ELEMS // max(1, b * n))
    for k0 in range(0, k, block):
        tr = cand_tracks[:, k0:k0 + block].to(torch.int64)
        st = cand_starts[:, k0:k0 + block].to(torch.int64)
        in_range = (tr >= 0) & (tr < t)
        tr = tr.clamp(0, max(t - 1, 0))
        lens = torch.where(in_range, lengths.to(torch.int64)[tr].clamp(0, l), 0)
        o_max = (lens - n).clamp(min=0)
        best_s = torch.full(tr.shape, -2, dtype=torch.int64, device=dev)
        best_o = st.clone()
        for r in range(n_fine):
            o = st + r
            kcut = (lens - o).clamp(0, n)
            inside = pos_n < kcut[..., None]                         # (B, Kb, N)
            pos = (o[..., None] + pos_n).clamp(0, max(l - 1, 0))
            d = prints[tr[..., None], pos].to(torch.int64) & _MASK32  # (B, Kb, N, 2)
            dist = torch.where(inside, _popcount32(d ^ q).sum(dim=3), 0).sum(dim=2)
            sim = torch.where((o >= 0) & (o <= o_max), 64 * kcut - dist, -1)
            take = sim > best_s
            best_s = torch.where(take, sim, best_s)
            best_o = torch.where(take, o, best_o)
        scores[:, k0:k0 + block] = best_s.to(torch.int32)
        offsets[:, k0:k0 + block] = best_o.to(torch.int32)
    return scores, offsets


def fine_rescan_kernel(queries: torch.Tensor, prints: torch.Tensor,
                       lengths: torch.Tensor, cand_tracks: torch.Tensor,
                       cand_starts: torch.Tensor, *, n_fine: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 on the card; the same contract as fine_rescan_ref."""
    _build.require(prints, "prints", torch.int32, 3)
    dev = prints.device
    _build.require(queries, "queries", torch.int32, 3, dev)
    _build.require(lengths, "lengths", torch.int32, 1, dev)
    _build.require(cand_tracks, "cand_tracks", torch.int32, 2, dev)
    _build.require(cand_starts, "cand_starts", torch.int32, 2, dev)
    b, n, words = queries.shape
    t, l, pwords = prints.shape
    if (words != 2 or pwords != 2 or lengths.shape[0] != t
            or cand_tracks.shape != cand_starts.shape or cand_tracks.shape[0] != b):
        raise ValueError(f"expected queries (B, N, 2), prints (T, L, 2), lengths (T,), "
                         f"candidates (B, K); got {tuple(queries.shape)}, "
                         f"{tuple(prints.shape)}, {tuple(lengths.shape)}, "
                         f"{tuple(cand_tracks.shape)}, {tuple(cand_starts.shape)}")
    if n_fine < 1:
        raise ValueError(f"n_fine must be >= 1, got {n_fine}")
    if b > MAX_QUERIES:
        raise ValueError(f"at most {MAX_QUERIES} queries a launch, got {b}")
    if queries.data_ptr() % 8 or prints.data_ptr() % 8:
        raise ValueError("queries and prints must be 8-byte aligned (uint2 loads)")
    k = cand_tracks.shape[1]
    scores = torch.empty((b, k), dtype=torch.int32, device=dev)
    offsets = torch.empty_like(scores)
    if b and k:
        _build.launch("fine_rescan", "hpfw_fine_rescan", dev,
                      queries.data_ptr(), b, n, prints.data_ptr(), t, l,
                      lengths.data_ptr(), cand_tracks.data_ptr(), cand_starts.data_ptr(),
                      k, n_fine, scores.data_ptr(), offsets.data_ptr())
    return scores, offsets


def fine_rescan_batch(queries: torch.Tensor, prints: torch.Tensor,
                      lengths: torch.Tensor, cand_tracks: torch.Tensor,
                      cand_starts: torch.Tensor, *, n_fine: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (score, offset) of each candidate's band, on prints' device.

    queries (B, N, 2), prints (T, L, 2), lengths (T,), cand_tracks and
    cand_starts (B, K): all int32. Returns ((B, K), (B, K)) int32."""
    if prints.device.type == "cuda":
        return fine_rescan_kernel(queries, prints, lengths, cand_tracks, cand_starts,
                                  n_fine=n_fine)
    if prints.device.type == "cpu":
        return fine_rescan_ref(queries, prints, lengths, cand_tracks, cand_starts,
                               n_fine=n_fine)
    raise ValueError(f"no fine rescan for device {prints.device}")


def plane_lpad(l: int, *, tight: bool = True) -> int:
    """Per-track slot length of the cache's word planes: l rounded up to a
    multiple of 1024 (tight), or l + WIDTH rounded up, each slot with its own
    headroom, as the reference lays out planes sharded over a mesh."""
    return -(-(l if tight else l + WIDTH) // SNAP) * SNAP


def plane_pad(prints: np.ndarray, *, tight: bool = True
              ) -> tuple[np.ndarray, np.ndarray, int]:
    """(T, L, 2) uint32 packed prints -> the cache's two flat word planes and
    Lpad: T * Lpad + WIDTH words each when tight, T * Lpad otherwise."""
    t, l, _ = prints.shape
    lpad = plane_lpad(l, tight=tight)
    tail = WIDTH if tight else 0
    d0 = np.zeros(t * lpad + tail, np.uint32)
    d1 = np.zeros(t * lpad + tail, np.uint32)
    d0[: t * lpad].reshape(t, lpad)[:, :l] = prints[:, :, 0]
    d1[: t * lpad].reshape(t, lpad)[:, :l] = prints[:, :, 1]
    return d0, d1, lpad
