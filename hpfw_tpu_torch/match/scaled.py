"""Two-stage coarse -> fine matcher for catalog-scale databases, one device.

Counterpart of hpfw_tpu/match/scaled.py (its single-device Pallas layout).

Stage 1 (coarse): majority-vote coarse prints (ops/coarse.py) of every track
are correlated with the coarse query at every coarse offset, and each track
keeps its best correlation and first best offset (ops/coarse_scan.py, K4 on
the card). The top `pool` tracks by that peak go on.

Stage 2 (fine, exact): each pooled track is rescanned with the exact
XOR+popcount score over a band of 2 * fine_window + 1 offsets around its
coarse peak (ops/fine.py, K5 on the card). Scores are EXACT Hamming
similarities, so the result is exact-on-pool: when the coarse stage pools
the true track, its score and offset equal the dense scan's.

Options, as in the reference: query_phases > 1 scans P phase-shifted coarse
views of the query and keeps the best per track (a query whose true offset
is not a multiple of the stride otherwise straddles two DB windows); the
two-pass prefilter sweeps the whole catalog with a cheaper pass 1 (fewer
phases, optionally a channel prefix, optionally nibble-packed rows) and
rescans only the top `prefilter` tracks per query with every phase (the
block-diagonal rescan).

Every candidate ranking breaks ties toward the lower track index, the
phase choice toward the first phase, and offsets toward the first offset,
so the port returns the reference's ids, scores and offsets exactly.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..api import FingerprintDB, _to_tensor_prints, default_device
from ..config import HpfwConfig
from ..ops import coarse as coarse_ops
from ..ops.coarse_scan import (coarse_rescan, coarse_scan, coarse_scan_batch,
                               coarse_scan_batch_packed, flat_width, pack_coarse_nibbles)
from ..ops.fine import fine_rescan_batch, plane_pad
from .stretch import print_variants, stretch_grid

# Elements of the unpacked (tracks x prints x 64) intermediate per chunk of
# the coarse derivation.
_DERIVE_ELEMS = 1 << 27
_KEY_SHIFT = 1 << 32


def _pool_candidates(best_corr: torch.Tensor, pool: int) -> torch.Tensor:
    """EXACT top-`pool` track indices along the last axis, descending score
    and ascending index on ties, padded to a multiple of 8 by repeating the
    first candidate (the host ranking drops duplicates). Returns int64.

    torch.topk promises no order among equal values, so it ranks a unique
    composite key, score * 2^32 + (2^32 - 1 - index)."""
    t = best_corr.shape[-1]
    k0 = max(1, min(pool, t))
    k = -(-k0 // 8) * 8
    kk = min(k, t)
    index = torch.arange(t, dtype=torch.int64, device=best_corr.device)
    key = best_corr.to(torch.int64) * _KEY_SHIFT + (_KEY_SHIFT - 1 - index)
    cand = torch.topk(key, kk, dim=-1).indices
    if k > kk:
        cand = torch.cat([cand, cand[..., :1].expand(*cand.shape[:-1], k - kk)], dim=-1)
    return cand


def _rank_dedup(scores, idx, offs, track_ids, top_k, aux=None):
    """Host ranking: desc score, asc index, duplicates dropped. aux: an
    optional per-candidate array returned ranked alongside (e.g. tempo-
    variant provenance)."""
    order = np.lexsort((idx, -scores))
    seen = set()
    keep = []
    for i in order:
        if int(idx[i]) not in seen:
            seen.add(int(idx[i]))
            keep.append(i)
        if len(keep) == top_k:
            break
    keep = np.array(keep, dtype=np.int64)
    out = ([track_ids[i] for i in idx[keep]], scores[keep], offs[keep])
    return out if aux is None else out + (aux[keep],)


def _phase_variants(queries, *, stride, phases, kind, channels):
    """P phase-shifted coarse views of each query: ((B, P, Nc, C) int8, (P,)
    r). Variant p drops the first p * stride / P prints, so one variant lies
    within stride / (2P) of the DB's window phase."""
    step = stride // phases
    n = queries.shape[1]
    nc = (n - (stride - step)) // stride
    qs = torch.stack([coarse_ops.coarse_pm1(queries[:, p * step:p * step + nc * stride],
                                            stride, kind=kind, channels=channels)
                      for p in range(phases)], dim=1)
    rs = torch.arange(phases, dtype=torch.int64, device=queries.device) * step
    return qs, rs


def _phase_select(best_l, idx_l, rs, stride):
    """Per track, the best phase variant (the first on ties): (best, center
    of query print 0) from (B, P, M) scan results."""
    p = best_l.shape[1]
    best = best_l.max(dim=1).values
    phase = torch.arange(p, device=best_l.device)[:, None]
    p_star = torch.where(best_l == best[:, None], phase, p).min(dim=1).values
    idx_sel = idx_l.gather(1, p_star[:, None])[:, 0].to(torch.int64)
    return best, idx_sel * stride - rs[p_star]


def _coarse_best_phased(queries, db_c, *, stride, phases, kind, channels, lc_true,
                        packed=False):
    """Phase-max coarse stage of B queries in one sweep: their B * P variant
    lanes ride the same scan. Returns ((B, T) best, (B, T) centers of query
    print 0). A single lane runs the single-query scan, unless the rows are
    nibble-packed (packed), which only the batch surface reads."""
    qcs, rs = _phase_variants(queries, stride=stride, phases=phases, kind=kind,
                              channels=channels)
    b, p, nc, c = qcs.shape
    if packed:
        best, idx = coarse_scan_batch_packed(qcs.reshape(b * p, nc, c), db_c,
                                             lc_true=lc_true)
    elif b * p == 1:
        best, idx = coarse_scan(qcs[0, 0], db_c, lc_true=lc_true)
        best, idx = best[None], idx[None]
    else:
        best, idx = coarse_scan_batch(qcs.reshape(b * p, nc, c), db_c, lc_true=lc_true)
    t = db_c.shape[0]
    return _phase_select(best.view(b, p, t), idx.view(b, p, t), rs, stride)


def _coarse_pool_twopass(queries, db_c, db_c1, *, stride, phases, phases1, prefilter,
                         pool, kind, channels, channels1, lc_true, packed1):
    """Two-pass phased coarse stage: pass 1 sweeps the whole catalog with
    phases1 lanes a query on the (possibly channel-prefix, possibly
    nibble-packed: packed1) db_c1 and pools the top `prefilter` tracks per
    query; pass 2 rescans only those rows of the int8 db_c with all `phases`
    variants (block-diagonal). The pass-1 pool is sorted ascending, so
    pass-2 ties still fall to the lower global index.

    Returns ((B, K) global track indices, (B, K) centers)."""
    best1, _ = _coarse_best_phased(queries, db_c1, stride=stride, phases=phases1,
                                   kind=kind, channels=channels1, lc_true=lc_true,
                                   packed=packed1)
    m = min(prefilter, db_c.shape[0])
    cand_m = _pool_candidates(best1, m).sort(dim=1).values               # (B, M8)
    qcs, rs = _phase_variants(queries, stride=stride, phases=phases, kind=kind,
                              channels=channels)                         # (B, P, Nc, C)
    best2, idx2 = coarse_rescan(qcs, db_c, cand_m.to(torch.int32), lc_true=lc_true)
    best, centers = _phase_select(best2, idx2, rs, stride)               # (B, M8)
    cand_loc = _pool_candidates(best, pool)
    return cand_m.gather(1, cand_loc), centers.gather(1, cand_loc)


def _two_stage(queries, prints, lengths, db_c, db_c1, *, stride, pool, fine_window,
               lc_true, kind, channels, phases, phases1, prefilter, channels1, packed1):
    """Batched two-stage match of B equal-length queries (B, N, 2) int32:
    (B, 3, K) int32 [scores, track index, offsets]. packed1: db_c1 is
    nibble-packed (read by pass 1 only)."""
    if phases > 1 and prefilter:
        cand, centers = _coarse_pool_twopass(
            queries, db_c, db_c1, stride=stride, phases=phases, phases1=phases1,
            prefilter=prefilter, pool=pool, kind=kind, channels=channels,
            channels1=channels1, lc_true=lc_true, packed1=packed1)
    else:
        best, centers_all = _coarse_best_phased(
            queries, db_c, stride=stride, phases=phases, kind=kind, channels=channels,
            lc_true=lc_true)
        cand = _pool_candidates(best, pool)
        centers = centers_all.gather(1, cand)
    n = queries.shape[1]
    n_fine = 2 * fine_window + 1
    span = n + n_fine - 1
    starts = (centers - fine_window).clamp(0, max(prints.shape[1] - span, 0))
    cand = cand.to(torch.int32)
    s, o = fine_rescan_batch(queries, prints, lengths, cand, starts.to(torch.int32),
                             n_fine=n_fine)
    return torch.stack([s, cand, o], dim=1)


class TwoStageDB:
    """Catalog-scale database on one device: prints, lengths and the flat
    int8 coarse DB, plus a pass-1 DB db_c1 when prefilter_channels <
    coarse_channels (a channel prefix) or prefilter_pack4 (the pass-1 rows
    nibble-packed, two features a byte; their results are identical).

    device defaults to the source FingerprintDB's. On a CUDA device the
    coarse and fine stages run through K4 and K5; on the CPU through their
    plain versions. The knobs default to db.cfg's, as in the reference.
    """

    _CACHE_VERSION = 1

    def __init__(self, db: FingerprintDB, *, stride: int | None = None,
                 coarse_kind: str | None = None,
                 coarse_channels: int | None = None,
                 query_phases: int | None = None,
                 prefilter: int | None = None,
                 prefilter_phases: int | None = None,
                 prefilter_channels: int | None = None,
                 prefilter_pack4: bool | None = None,
                 mesh=None,
                 device: str | torch.device | None = None):
        cfg = db.cfg
        if mesh is not None:
            raise NotImplementedError(
                "a sharded TwoStageDB is not ported yet (ROADMAP A12)")
        self.db = db
        self.stride = stride if stride is not None else cfg.db_downsample
        self.coarse_kind = coarse_kind if coarse_kind is not None else cfg.coarse_kind
        self.coarse_channels = (coarse_channels if coarse_channels is not None
                                else cfg.coarse_channels)
        self.query_phases = (query_phases if query_phases is not None
                             else cfg.coarse_query_phases)
        self.prefilter = prefilter if prefilter is not None else cfg.coarse_prefilter
        self.prefilter_phases = (prefilter_phases if prefilter_phases is not None
                                 else cfg.coarse_prefilter_phases)
        pc = (prefilter_channels if prefilter_channels is not None
              else cfg.coarse_prefilter_channels)
        self.prefilter_channels = pc if pc else self.coarse_channels
        if self.prefilter_channels > self.coarse_channels:
            raise ValueError("prefilter_channels must be <= coarse_channels")
        self.prefilter_pack4 = bool(prefilter_pack4 if prefilter_pack4 is not None
                                    else cfg.coarse_prefilter_pack4)
        if self.prefilter_pack4 and self.coarse_kind == "sum" and self.stride > 7:
            raise ValueError(
                "nibble-packed pass-1 rows hold values in [-8, 7]; sum-coarse windows "
                f"of stride {self.stride} do not fit: use coarse_kind='sign'")
        if self.stride % self.query_phases:
            raise ValueError("query_phases must divide the coarse stride")
        if self.prefilter_phases > 1 and self.stride % self.prefilter_phases:
            raise ValueError("prefilter_phases must divide the coarse stride")
        self.device = torch.device(device) if device is not None else db.device
        if self.device == db.device:
            prints, lengths = db.device_arrays()
        else:
            prints = _to_tensor_prints(db.prints, self.device)
            lengths = torch.from_numpy(db.lengths).to(self.device)
        # Whole 8-track tiles, as the reference pads its track axis for its
        # kernels: empty tracks score 0 and drop at the n_real cut, and a DB
        # and its saved cache give the same results in either package.
        pad = -prints.shape[0] % 8
        if pad:
            prints = torch.cat([prints, prints.new_zeros((pad,) + prints.shape[1:])])
            lengths = torch.cat([lengths, lengths.new_zeros(pad)])
        self.prints, self.lengths = prints, lengths
        self.n_real = db.n_tracks
        self.lc_true = self.prints.shape[1] // self.stride
        counts = [self.coarse_channels]
        if self.prefilter_channels < self.coarse_channels:
            counts.append(self.prefilter_channels)
        flats = self._derive_coarse(counts)
        self.db_c = flats[0]
        self.db_c1 = pack_coarse_nibbles(flats[-1]) if self.prefilter_pack4 else flats[-1]

    def _derive_coarse(self, channel_counts):
        """Flat coarse DBs, one per channel count (prefixes of the first), zero
        past each track's lengths // stride windows. Derived in chunks of
        tracks: the unpack intermediate is 256x the packed bytes."""
        t, l, _ = self.prints.shape
        lc = self.lc_true
        flats = [torch.zeros((t, flat_width(lc, c)), dtype=torch.int8, device=self.device)
                 for c in channel_counts]
        chunk = max(1, min(t, _DERIVE_ELEMS // max(l * 64, 1)))
        window = torch.arange(lc, device=self.device)
        for i in range(0, t, chunk):
            c = coarse_ops.coarse_pm1(self.prints[i:i + chunk], self.stride,
                                      kind=self.coarse_kind, channels=channel_counts[0])
            inside = window < coarse_ops.coarse_lengths(self.lengths[i:i + chunk],
                                                        self.stride)[:, None]
            c = torch.where(inside[..., None], c, 0)
            for flat, ch in zip(flats, channel_counts):
                flat.view(t, -1, ch)[i:i + chunk, :lc] = c[..., :ch]
        return flats

    # -- derived-state persistence: the reference's format_version=1 cache --

    def save(self, path: str) -> None:
        """Write the derived state in the reference's single-device layout:
        flat coarse rows (and coarse1), tight word planes, lengths, filters,
        track ids and a JSON manifest."""
        os.makedirs(path, exist_ok=True)
        t = self.db_c.shape[0]

        def dump(name, arr):
            np.save(os.path.join(path, name + ".npy"), np.asarray(arr))

        d0, d1, lpad = plane_pad(self.prints.cpu().numpy().view(np.uint32))
        manifest = {
            "format_version": self._CACHE_VERSION,
            "stride": int(self.stride),
            "coarse_kind": self.coarse_kind,
            "coarse_channels": int(self.coarse_channels),
            "prefilter_channels": int(self.prefilter_channels),
            "prefilter_pack4": self.prefilter_pack4,
            # The reference's kernels scan whole tiles of this many tracks.
            "coarse_tile": min(128, t & -t),
            "lc_true": int(self.lc_true),
            "n_real": int(self.n_real),
            "use_pallas_fine": True,
            "use_pallas_coarse": True,
            "mesh_size": 0,
            "config_json": self.db.cfg.to_json(),
            "lpad": int(lpad),
            "l_true": int(self.prints.shape[1]),
        }
        dump("d0", d0)
        dump("d1", d1)
        dump("coarse", self.db_c.cpu())
        if self.db_c1 is not self.db_c:
            dump("coarse1", self.db_c1.cpu())
        dump("lengths", self.lengths.cpu())
        dump("filters", self.db.filters)
        dump("track_ids", np.array(self.db.track_ids))
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)

    @classmethod
    def load(cls, path: str, *,
             device: str | torch.device | None = None) -> "TwoStageDB":
        """Rebuild a TwoStageDB on device (default: the card when torch sees
        one) from a save() directory of either package (the single-device Pallas layout), without re-deriving."""
        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
        if m["format_version"] != cls._CACHE_VERSION:
            raise ValueError(f"unsupported two-stage cache version {m['format_version']}")
        if m["mesh_size"] or not (m["use_pallas_fine"] and m["use_pallas_coarse"]):
            raise ValueError(
                "only a single-device cache with flat coarse rows and word planes "
                "(use_pallas_fine=True, no mesh) loads here; rebuild the cache")

        def grab(name):
            return np.load(os.path.join(path, name + ".npy"), mmap_mode="r")

        cfg = HpfwConfig.from_json(m["config_json"])
        lengths = np.array(grab("lengths"), dtype=np.int32)
        t, l, lpad, n_real = lengths.shape[0], m["l_true"], m["lpad"], m["n_real"]
        prints = np.empty((t, l, 2), np.uint32)
        prints[..., 0] = grab("d0")[: t * lpad].reshape(t, lpad)[:, :l]
        prints[..., 1] = grab("d1")[: t * lpad].reshape(t, lpad)[:, :l]
        dev = torch.device(device) if device is not None else default_device()
        self = cls.__new__(cls)
        self.db = FingerprintDB(
            cfg, np.load(os.path.join(path, "filters.npy")),
            [str(i) for i in np.load(os.path.join(path, "track_ids.npy"))],
            prints[:n_real], lengths[:n_real], device=dev)
        self.stride = m["stride"]
        self.coarse_kind = m["coarse_kind"]
        self.coarse_channels = m["coarse_channels"]
        self.prefilter_channels = m.get("prefilter_channels", m["coarse_channels"])
        self.prefilter_pack4 = bool(m.get("prefilter_pack4", False))
        self.query_phases = cfg.coarse_query_phases
        self.prefilter = cfg.coarse_prefilter
        self.prefilter_phases = cfg.coarse_prefilter_phases
        self.device = dev
        self.n_real = n_real
        self.lc_true = m["lc_true"]
        self.prints = _to_tensor_prints(prints, dev)
        self.lengths = torch.from_numpy(lengths).to(dev)
        self.db_c = torch.from_numpy(np.array(grab("coarse"))).to(dev)
        self.db_c1 = (torch.from_numpy(np.array(grab("coarse1"))).to(dev)
                      if (self.prefilter_channels < self.coarse_channels
                          or self.prefilter_pack4) else self.db_c)
        return self

    # -- matching --

    def _check_query_len(self, n: int) -> None:
        """The two-stage scan needs at least one coarse alignment."""
        lc = self.lc_true
        if self.coarse_kind == "sum" and n * 64 * self.stride >= 2 ** 24:
            raise ValueError(
                "query too long for exact f32 accumulation of sum-coarse "
                f"correlations (n*64*stride = {n * 64 * self.stride} >= 2^24); "
                "use coarse_kind='sign' or a shorter query")
        if n // self.stride > lc:
            raise ValueError(
                f"query ({n} prints, {n // self.stride} coarse) is longer than "
                f"every DB track ({lc} coarse windows); two-stage matching "
                "needs query <= padded DB length — use api.match for "
                "truncated-overlap semantics")

    def _twopass_args(self, phases, prefilter, phases1, t):
        """Resolve and validate the two-pass knobs of a dispatch: (prefilter,
        phases1, channels1). channels1, the pass-1 channel count, is fixed
        at construction (the prefix DB is derived then)."""
        pf = prefilter if prefilter is not None else self.prefilter
        p1 = phases1 if phases1 is not None else self.prefilter_phases
        if pf:
            pf = min(int(pf), int(t))
        if pf and phases > 1:
            if self.stride % p1:
                raise ValueError("phases1 must divide the coarse stride")
        else:
            pf, p1 = 0, 1
        return pf, p1, (self.prefilter_channels if pf else self.coarse_channels)

    def dispatch_batch(self, queries_dev: torch.Tensor, *, pool: int | None = None,
                       fine_window: int | None = None, phases: int | None = None,
                       prefilter: int | None = None, phases1: int | None = None
                       ) -> torch.Tensor:
        """Run one batched match of (B, N, 2) int32 queries on self.device
        without a host sync; returns the (B, 3, K) int32 [scores, track
        index, offsets] tensor."""
        cfg = self.db.cfg
        pool = pool if pool is not None else cfg.fine_candidates
        fw = fine_window if fine_window is not None else self.stride
        ph = phases if phases is not None else self.query_phases
        pf, p1, c1 = self._twopass_args(ph, prefilter, phases1, self.db_c.shape[0])
        return _two_stage(queries_dev, self.prints, self.lengths, self.db_c, self.db_c1,
                          stride=self.stride, pool=pool, fine_window=fw,
                          lc_true=self.lc_true, kind=self.coarse_kind,
                          channels=self.coarse_channels, phases=ph, phases1=p1,
                          prefilter=pf, channels1=c1,
                          packed1=bool(pf) and self.prefilter_pack4)

    def dispatch(self, query_dev: torch.Tensor, **kw) -> torch.Tensor:
        """One query (N, 2) int32: the (3, K) tensor of dispatch_batch."""
        return self.dispatch_batch(query_dev[None], **kw)[0]

    def _stretch_factors(self, span, step):
        """Resolve the tempo-scan grid for a dispatch (None = config)."""
        cfg = self.db.cfg
        span = span if span is not None else cfg.stretch_span
        step = step if step is not None else cfg.stretch_step
        return stretch_grid(span, step) if span else None

    def match(self, query_prints: np.ndarray, *, top_k: int | None = None,
              pool: int | None = None, fine_window: int | None = None,
              phases: int | None = None, prefilter: int | None = None,
              phases1: int | None = None, stretch_span: float | None = None,
              stretch_step: float | None = None, return_variant: bool = False,
              calibrate: bool = False):
        """Rank tracks against one query, (N, 2) uint32 prints or a (V, N, 2)
        stack of tempo variants ranked together. Returns (track_ids,
        scores, offsets) (+ variant index with return_variant)."""
        cfg = self.db.cfg
        top_k = top_k if top_k is not None else cfg.top_k
        qh = np.asarray(query_prints, dtype=np.uint32)
        variants = None
        if qh.ndim == 3:
            variants = qh
            qh = qh[qh.shape[0] // 2]      # identity row (grid center)
        self._check_query_len(qh.shape[0])
        factors = self._stretch_factors(stretch_span, stretch_step)
        if variants is None and factors is not None:
            variants = print_variants(qh, factors)[0]
        kw = dict(pool=pool, fine_window=fine_window, phases=phases,
                  prefilter=prefilter, phases1=phases1)
        if variants is not None:
            outs = [self.dispatch(_to_tensor_prints(v, self.device), **kw)
                    for v in variants]
            host = [o.cpu().numpy() for o in outs]
            scores = np.concatenate([o[0] for o in host])
            idx = np.concatenate([o[1] for o in host])
            offs = np.concatenate([o[2] for o in host])
            if calibrate:
                # Rank by each hypothesis's excess over its pool's median
                # score, an estimate of that row's imposter background.
                scores = np.concatenate([o[0] - np.median(o[0]) for o in host])
            var = np.repeat(np.arange(len(variants), dtype=np.int32),
                            scores.shape[0] // len(variants))
        else:
            out = self.dispatch(_to_tensor_prints(qh, self.device), **kw)
            scores, idx, offs = out.cpu().numpy()
            var = np.zeros(scores.shape[0], dtype=np.int32)
        real = idx < self.n_real
        scores, idx, offs, var = scores[real], idx[real], offs[real], var[real]
        return _rank_dedup(scores, idx, offs, self.db.track_ids, top_k,
                           aux=var if return_variant else None)

    def match_batch(self, query_batch: np.ndarray, *, top_k: int | None = None,
                    pool: int | None = None, fine_window: int | None = None,
                    phases: int | None = None, prefilter: int | None = None,
                    phases1: int | None = None, stretch_span: float | None = None,
                    stretch_step: float | None = None, calibrate: bool = False):
        """Match B equal-length queries, (B, N, 2) uint32 or (B, V, N, 2)
        variant stacks, in one coarse sweep. Returns a list of B (track_ids,
        scores, offsets) tuples, each what match() returns for that query."""
        cfg = self.db.cfg
        top_k = top_k if top_k is not None else cfg.top_k
        qh = np.asarray(query_batch, dtype=np.uint32)
        n_var = 1
        if qh.ndim == 4:
            n_var = qh.shape[1]
            qh = qh.reshape(-1, qh.shape[2], 2)
        self._check_query_len(qh.shape[1])
        factors = (self._stretch_factors(stretch_span, stretch_step)
                   if n_var == 1 else None)
        if factors is not None:
            n_var = len(factors)
            qh = print_variants(qh, factors).reshape(-1, qh.shape[1], 2)
        out = self.dispatch_batch(_to_tensor_prints(qh, self.device), pool=pool,
                                  fine_window=fine_window, phases=phases,
                                  prefilter=prefilter, phases1=phases1).cpu().numpy()
        cal = None
        if n_var > 1:
            # (B*V, 3, K) -> (B, 3, V*K): a query's variant rows rank together.
            out = out.reshape(-1, n_var, 3, out.shape[-1])
            if calibrate:
                cal = out[:, :, 0].astype(np.float64)
                cal -= np.median(cal, axis=-1, keepdims=True)
                cal = cal.reshape(cal.shape[0], -1)
            out = np.moveaxis(out, 1, 2).reshape(out.shape[0], 3, -1)
        results = []
        for b in range(out.shape[0]):
            scores, idx, offs = out[b]
            if cal is not None:
                scores = cal[b]
            real = idx < self.n_real
            scores, idx, offs = scores[real], idx[real], offs[real]
            results.append(_rank_dedup(scores, idx, offs, self.db.track_ids, top_k))
        return results
