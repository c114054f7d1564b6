"""Plain two-stage catalog matching, as the configuration states it.

Stage 1 finds candidates by coarse prints; stage 2 scores them exactly.
- Coarse prints: per window of `stride` prints and per channel (channel 32w
  + b is bit b of word w), +1 when more than half the bits are set, else -1;
  windows past a track's length // stride are 0.
- A coarse query view of phase p drops the first p * stride / P prints and
  takes nc = (n - (stride - stride / P)) // stride windows. Its correlation
  with a track at coarse offset o is sum_j q(j) . d(o + j), for o < lc_true -
  nc + 1; a track keeps its best over offsets (first offset on ties) and
  over phases (first phase on ties), and the centre best * stride - p *
  stride / P.
- Pass 1 correlates every track with P1 phases on the first C1 channels and
  keeps the top `prefilter` tracks; pass 2 rescans those with P phases on C
  channels and keeps the top `pool`. Every top-k takes the larger value
  first and the lower track index on ties, and pads to a multiple of 8 with
  its first entry.
- Stage 2: each pooled track is scored at the 2 * fine_window + 1 offsets
  from clamp(centre - fine_window, 0, L - n - 2 * fine_window) on:
  sim(o) = 64 * kcut - sum_{i < kcut} popcount(q_i ^ d_{o+i}), kcut =
  clamp(len - o, 0, n), valid for 0 <= o <= max(len - n, 0) (else -1); the
  first best offset wins.
- The ranking orders (score desc, track asc), drops repeated tracks and keeps
  top_k.
Correlations are float32 GEMMs of +-1 values (TF32 off), exact: every sum is
an integer below 2^24. Everything runs on the device of the prints.
"""

from __future__ import annotations

import numpy as np
import torch

_KEY = 1 << 32
_M32 = 0xFFFFFFFF
# Elements of the window-by-window products held at once (float32).
_BLOCK_ELEMS = 1 << 29


def unpack_pm1(words: torch.Tensor) -> torch.Tensor:
    """(..., 2) int32 -> (..., 64) int8 +-1, channel 32w + b = bit b of word w."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return (bits.reshape(*words.shape[:-1], 64) * 2 - 1).to(torch.int8)


def coarse(prints: torch.Tensor, lengths: torch.Tensor, stride: int,
           chunk: int = 2048) -> torch.Tensor:
    """(T, L, 2) int32 prints -> (T, L // stride, 64) int8 sign coarse prints."""
    t, l, _ = prints.shape
    lc = l // stride
    out = torch.empty((t, lc, 64), dtype=torch.int8, device=prints.device)
    win = torch.arange(lc, device=prints.device)
    for i in range(0, t, chunk):
        pm = unpack_pm1(prints[i:i + chunk, :lc * stride]).to(torch.int16)
        s = pm.reshape(-1, lc, stride, 64).sum(dim=2)
        c = torch.where(s > 0, 1, -1).to(torch.int8)
        inside = win[None] < (lengths[i:i + chunk] // stride)[:, None]
        out[i:i + chunk] = torch.where(inside[..., None], c, 0)
    return out


def views(queries: torch.Tensor, stride: int, phases: int, channels: int):
    """(B, n, 2) queries -> ((B, P, nc, C) float32 coarse views, (P,) shifts)."""
    step = stride // phases
    n = queries.shape[1]
    nc = (n - (stride - step)) // stride
    vs = []
    for p in range(phases):
        w = unpack_pm1(queries[:, p * step:p * step + nc * stride]).to(torch.int16)
        s = w.reshape(w.shape[0], nc, stride, 64).sum(dim=2)
        vs.append(torch.where(s > 0, 1.0, -1.0)[..., :channels])
    shifts = torch.arange(phases, dtype=torch.int64, device=queries.device) * step
    return torch.stack(vs, dim=1), shifts


def scan(qv: torch.Tensor, db: torch.Tensor, lc_true: int):
    """(G, nc, C) float32 lanes against (R, >= lc_true, >= C) int8 rows (the
    first C channels): ((G, R) best, (G, R) first best offset) int64.

    With more lanes than channels, one GEMM of each row's unfolded windows
    (every offset's nc windows) by the lanes; otherwise one GEMM of every
    row window by every query window, then sums along the diagonals. Both
    are exact."""
    g, nc, c = qv.shape
    r = db.shape[0]
    n_off = lc_true - nc + 1
    best = torch.empty((g, r), dtype=torch.int64, device=db.device)
    first = torch.empty_like(best)
    unfold = g > c
    per_row = n_off * nc * c if unfold else lc_true * g * nc
    rows = max(1, _BLOCK_ELEMS // per_row)
    off = torch.arange(n_off, device=db.device)[None, :, None]
    if unfold:
        w = qv.reshape(g, nc * c).T                                      # (nc*C, G)
    else:
        w = qv.permute(2, 0, 1).reshape(c, g * nc)                       # column (g, j)
    for r0 in range(0, r, rows):
        x = db[r0:r0 + rows, :lc_true, :c].to(torch.float32)
        if unfold:
            xu = x.unfold(1, nc, 1).transpose(2, 3).reshape(-1, nc * c)  # (rows*n_off, nc*C)
            acc = (xu @ w).view(x.shape[0], n_off, g)
        else:
            p = (x.reshape(-1, c) @ w).view(x.shape[0], lc_true, g, nc)
            acc = torch.zeros((x.shape[0], n_off, g), dtype=torch.float32, device=db.device)
            for j in range(nc):
                acc += p[:, j:j + n_off, :, j]
        corr = acc.to(torch.int64)                                      # exact integers
        b = corr.max(dim=1).values                                      # (rows, G)
        f = torch.where(corr == b[:, None], off, n_off).min(dim=1).values
        best[:, r0:r0 + rows] = b.T
        first[:, r0:r0 + rows] = f.T
    return best, first


def phase_select(best: torch.Tensor, first: torch.Tensor, shifts: torch.Tensor, stride: int):
    """(B, P, R) per-phase results -> ((B, R) best, (B, R) centre), first phase on ties."""
    p = best.shape[1]
    top = best.max(dim=1).values
    ph = torch.arange(p, device=best.device)[None, :, None]
    p_star = torch.where(best == top[:, None], ph, p).min(dim=1).values
    f = first.gather(1, p_star[:, None])[:, 0]
    return top, f * stride - shifts[p_star]


def top_tracks(values: torch.Tensor, k: int, reverse_ties: bool = False) -> torch.Tensor:
    """Indices of the min(k, R) largest along the last axis, the lower index
    first on ties (the higher with reverse_ties), padded
    to a multiple of 8 with the first."""
    r = values.shape[-1]
    k0 = max(1, min(k, r))
    k8 = -(-k0 // 8) * 8
    idx = torch.arange(r, dtype=torch.int64, device=values.device)
    tie = idx if reverse_ties else _KEY - 1 - idx
    top = torch.topk(values * _KEY + tie, min(k8, r), dim=-1).indices
    if k8 > top.shape[-1]:
        top = torch.cat([top, top[..., :1].expand(*top.shape[:-1], k8 - top.shape[-1])], -1)
    return top


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def similarity(q: torch.Tensor, prints: torch.Tensor, lengths: torch.Tensor,
               tracks: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(n, 2) query vs track tracks[k] at offsets[k, r] ((K,), (K, R)) -> (K, R)
    int64 sim = 64 * kcut - distance over the first kcut prints, -1 where
    the offset is not valid."""
    n = q.shape[0]
    l = prints.shape[1]
    i = torch.arange(n, device=q.device)
    lens = lengths[tracks].to(torch.int64)[:, None]
    kcut = (lens - offsets).clamp(0, n)
    pos = (offsets[..., None] + i).clamp(0, l - 1)
    d = prints[tracks[:, None, None], pos].to(torch.int64) & _M32
    dist = popcount(d ^ (q.to(torch.int64) & _M32)).sum(dim=-1)
    dist = torch.where(i < kcut[..., None], dist, 0).sum(dim=-1)
    ok = (offsets >= 0) & (offsets <= (lens - n).clamp(min=0))
    return torch.where(ok, 64 * kcut - dist, -1)


def fine(q: torch.Tensor, prints, lengths, tracks, starts, n_fine: int):
    """Each candidate's best (sim, offset) over its band, first offset on ties."""
    r = torch.arange(n_fine, device=q.device)
    s = similarity(q, prints, lengths, tracks, starts[:, None] + r)
    best = s.max(dim=1).values
    first = torch.where(s == best[:, None], r, n_fine).min(dim=1).values
    return best, starts + first


class Catalog:
    """The catalog's prints on a device, with the coarse prints derived from
    them, and the matching parameters the configuration states."""

    def __init__(self, prints: torch.Tensor, lengths: torch.Tensor, m: dict):
        self.m = m
        self.prints = prints
        self.lengths = lengths
        self.stride = m["db_downsample"]
        self.lc_true = prints.shape[1] // self.stride
        self.coarse = coarse(prints, lengths, self.stride)

    def candidates(self, queries: torch.Tensor, reverse_ties: bool = False):
        """(B, n, 2) int32 -> ((B, K) tracks, (B, K) band starts), the two
        coarse passes; reverse_ties takes the higher track index first on
        ties (the control, which breaks the stated tie rule)."""
        m, s = self.m, self.stride
        b = queries.shape[0]
        t = self.prints.shape[0]
        q1, sh1 = views(queries, s, m["coarse_prefilter_phases"], m["coarse_prefilter_channels"])
        best1, first1 = scan(q1.reshape(-1, *q1.shape[2:]), self.coarse, self.lc_true)
        best1, _ = phase_select(best1.view(b, -1, t), first1.view(b, -1, t), sh1, s)
        cand = top_tracks(best1, min(m["coarse_prefilter"], t), reverse_ties).sort(dim=1).values
        q2, sh2 = views(queries, s, m["coarse_query_phases"], m["coarse_channels"])
        best2, first2 = [], []
        for i in range(b):
            bb, ff = scan(q2[i], self.coarse[cand[i]], self.lc_true)
            best2.append(bb)
            first2.append(ff)
        best2, centre = phase_select(torch.stack(best2), torch.stack(first2), sh2, s)
        loc = top_tracks(best2, m["fine_candidates"], reverse_ties)
        n = queries.shape[1]
        fw = s
        span = n + 2 * fw
        starts = (centre.gather(1, loc) - fw).clamp(0, max(self.prints.shape[1] - span, 0))
        return cand.gather(1, loc), starts

    def match(self, queries: torch.Tensor, reverse_ties: bool = False) -> np.ndarray:
        """(B, n, 2) int32 queries -> (B, 3, K) int64 [scores, tracks, offsets]."""
        tracks, starts = self.candidates(queries, reverse_ties)
        n_fine = 2 * self.stride + 1
        out = []
        for i in range(queries.shape[0]):
            sc, of = fine(queries[i], self.prints, self.lengths, tracks[i], starts[i], n_fine)
            out.append(torch.stack([sc, tracks[i], of]))
        return torch.stack(out).cpu().numpy()


def rank(scores: np.ndarray, tracks: np.ndarray, offsets: np.ndarray, top_k: int,
         n_real: int):
    """(score desc, track asc), repeated tracks dropped: (tracks, scores, offsets)."""
    real = tracks < n_real
    scores, tracks, offsets = scores[real], tracks[real], offsets[real]
    keep, seen = [], set()
    for i in np.lexsort((tracks, -scores)):
        if int(tracks[i]) not in seen:
            seen.add(int(tracks[i]))
            keep.append(i)
            if len(keep) == top_k:
                break
    keep = np.array(keep, dtype=np.int64)
    return tracks[keep], scores[keep], offsets[keep]
