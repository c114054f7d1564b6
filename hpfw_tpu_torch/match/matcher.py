"""Dense Hamming-scan matcher.

Counterpart of hpfw_tpu/match/matcher.py (the plain path) and
hpfw_tpu/ops/pallas_match.py (the kernel). Semantics, identical to
oracle.match_track:
  - track length >= query length: best over offsets o in [0, len-N] of
      sum_n (64 - popcount(q[n] ^ d[o+n]))
  - shorter track: offset 0 with the query truncated to the track length.
Ties go to the first (lowest) offset. Prints are int32 tensors with the bit
pattern of the uint32 words. On CUDA tensors score_tracks launches K3
(csrc/match.cu); on CPU tensors it runs the plain version, score_tracks_ref.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import _build

# Elements (tracks x offsets x query prints) per block of the plain scan,
# which bounds its int64 temporaries to a few tens of MB.
REF_BLOCK_ELEMS = 1 << 22
# K3 streams the query in chunks, so any length scans that keeps 64 * N (its
# int32 correlation) and the block count in range.
MAX_QUERY_PRINTS = (2 ** 31 - 1) // 128
_MASK32 = 0xFFFFFFFF

# Offsets a track from which K3 takes its large block tile (2,048 offsets a
# block, one block an SM) over its small one (512, two blocks an SM, which
# spreads short tracks over the SMs). csrc/match.cu decides the rest of the
# launch.
SCAN_LARGE_FROM = 2048


def scan_geometry(n_query: int, track_len: int) -> tuple[int, int, int, int]:
    """K3's launch as csrc/match.cu decides it: (tile, query positions a
    chunk, shared memory a block in bytes, items a track)."""
    tile, cpos, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    n_blocks = _build.library().hpfw_score_tracks_geometry(
        n_query, track_len, SCAN_LARGE_FROM, ctypes.byref(tile), ctypes.byref(cpos),
        ctypes.byref(smem))
    if n_blocks < 0:
        raise ValueError(f"the scan kernel takes no query of {n_query} prints over tracks "
                         f"padded to {track_len}")
    return tile.value, cpos.value, smem.value, n_blocks


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32) (torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def score_tracks_ref(query: torch.Tensor, prints: torch.Tensor,
                     lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: best (score, offset) per track, ((T,), (T,)) int32.

    Scans the L-N+1 offsets in blocks, keeping the running best; within a
    block the best is the maximum score at the minimum offset reaching it,
    and an earlier block keeps ties.
    """
    t_count, l, _ = prints.shape
    n = query.shape[0]
    if l < n:
        raise ValueError("pad the DB prints to at least the query length")
    dev = prints.device
    if n == 0:  # an empty query scores 0 at offset 0 everywhere
        zeros = torch.zeros((t_count,), dtype=torch.int32, device=dev)
        return zeros, zeros.clone()
    n_off = l - n + 1
    lens = lengths.to(torch.int64).clamp(0, l)
    max_o = (lens - n).clamp(min=0)
    q = (query.to(torch.int64) & _MASK32).T              # (2, N)
    d = prints.to(torch.int64) & _MASK32                  # (T, L, 2)
    block = max(1, min(n_off, REF_BLOCK_ELEMS // max(1, t_count * n)))
    best_s = torch.full((t_count,), -2, dtype=torch.int64, device=dev)
    best_o = torch.zeros((t_count,), dtype=torch.int64, device=dev)
    pos_n = torch.arange(n, dtype=torch.int64, device=dev)
    for o0 in range(0, n_off, block):
        o = torch.arange(o0, min(o0 + block, n_off), dtype=torch.int64, device=dev)
        win = d[:, o0:o0 + o.shape[0] + n - 1].unfold(1, n, 1)   # (T, B, 2, N)
        pop = _popcount32(win ^ q).sum(dim=2)                   # (T, B, N)
        inside = (o[:, None] + pos_n) < lens[:, None, None]      # (T, B, N)
        dist = torch.where(inside, pop, 0).sum(dim=2)
        kcut = (lens[:, None] - o).clamp(0, n)
        sim = torch.where(o <= max_o[:, None], 64 * kcut - dist, -1)
        blk_best = sim.max(dim=1).values
        blk_off = torch.where(sim == blk_best[:, None], o, l).min(dim=1).values
        take = blk_best > best_s
        best_s = torch.where(take, blk_best, best_s)
        best_o = torch.where(take, blk_off, best_o)
    return best_s.to(torch.int32), best_o.to(torch.int32)


def score_tracks_kernel(query: torch.Tensor, prints: torch.Tensor,
                        lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on the card; the same contract as score_tracks_ref."""
    _build.require(prints, "prints", torch.int32, 3)
    _build.require(query, "query", torch.int32, 2, prints.device)
    _build.require(lengths, "lengths", torch.int32, 1, prints.device)
    t_count, l, words = prints.shape
    n = query.shape[0]
    if words != 2 or query.shape[1] != 2 or lengths.shape[0] != t_count:
        raise ValueError(f"expected query (N, 2), prints (T, L, 2), lengths (T,); "
                         f"got {tuple(query.shape)}, {tuple(prints.shape)}, "
                         f"{tuple(lengths.shape)}")
    if l < n:
        raise ValueError("pad the DB prints to at least the query length")
    if n > MAX_QUERY_PRINTS:
        raise ValueError(f"the scan kernel takes queries of at most "
                         f"{MAX_QUERY_PRINTS} prints, got {n}")
    if query.data_ptr() % 8 or prints.data_ptr() % 8:
        raise ValueError("query and prints must be 8-byte aligned (uint2 loads)")
    scores = torch.empty((t_count,), dtype=torch.int32, device=prints.device)
    offsets = torch.empty((t_count,), dtype=torch.int32, device=prints.device)
    if t_count == 0:
        return scores, offsets
    n_blocks = scan_geometry(n, l)[3]
    keys = torch.empty((t_count, n_blocks), dtype=torch.int64, device=prints.device)
    _build.launch("score_tracks", "hpfw_score_tracks", prints.device,
                  query.data_ptr(), n, prints.data_ptr(), t_count, l,
                  lengths.data_ptr(), SCAN_LARGE_FROM, keys.data_ptr(), scores.data_ptr(),
                  offsets.data_ptr())
    return scores, offsets


def score_tracks(query: torch.Tensor, prints: torch.Tensor,
                 lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Best (score, offset) per track on prints' device. Returns ((T,), (T,))
    int32. query (N, 2) int32, prints (T, L, 2) int32 zero-padded with
    L >= N, lengths (T,) int32."""
    if prints.device.type == "cuda":
        return score_tracks_kernel(query, prints, lengths)
    if prints.device.type == "cpu":
        return score_tracks_ref(query, prints, lengths)
    raise ValueError(f"no matcher for device {prints.device}")


def rank(scores: np.ndarray, offsets: np.ndarray, top_k: int):
    """Host-side final ranking: descending score, ascending index on ties."""
    scores = np.asarray(scores)
    offsets = np.asarray(offsets)
    order = np.lexsort((np.arange(scores.shape[0]), -scores))[:top_k]
    return order, scores[order], offsets[order]


def pad_prints(tracks: list[np.ndarray], min_len: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length packed print sequences into (T, L, 2) + lengths."""
    lengths = np.array([t.shape[0] for t in tracks], dtype=np.int32)
    l = max(int(lengths.max(initial=0)), min_len)
    out = np.zeros((len(tracks), l, 2), dtype=np.uint32)
    for i, tr in enumerate(tracks):
        out[i, : tr.shape[0]] = tr
    return out, lengths
