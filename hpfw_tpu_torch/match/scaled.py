"""Two-stage coarse -> fine matcher for catalog-scale databases.

Counterpart of hpfw_tpu/match/scaled.py: its Pallas layout, on one device
or sharded over a mesh of devices (parallel/mesh.py).

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

Sharded over a mesh, each shard runs the same two stages on its own
contiguous tracks, with the prefilter capped at its track count, and the
shards' fixed-size (B, 3, K) candidate blocks are gathered along K onto the
mesh's first device in shard order, their track indices made global, as the
reference's shard_map and tiled all_gather do.

Every candidate ranking breaks ties toward the lower track index, the
phase choice toward the first phase, and offsets toward the first offset,
so the port returns the reference's ids, scores and offsets exactly.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..api import FingerprintDB, _to_tensor_prints, default_device
from ..config import HpfwConfig
from ..ops import coarse as coarse_ops
from ..ops.coarse_scan import (coarse_rescan, coarse_scan, coarse_scan_batch,
                               coarse_scan_batch_packed, flat_width, flatten_coarse,
                               pack_coarse_nibbles)
from ..ops.fine import fine_rescan_batch, plane_pad
from ..parallel.mesh import Mesh, gather_blocks, split_tracks
from ..utils.profiling import trace
from .graphs import DispatchGraphs
from .stretch import print_variants, stretch_grid

# Elements of the unpacked (tracks x prints x 64) intermediate per chunk of
# the coarse derivation.
_DERIVE_ELEMS = 1 << 27
_KEY_SHIFT = 1 << 32


def _top_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest int32 values along the last axis, descending,
    the lower index first on ties, as lax.top_k orders them. torch.topk
    promises no order among equal values, so it ranks a unique composite
    key, value * 2^32 + (2^32 - 1 - index). Returns int64."""
    index = torch.arange(values.shape[-1], dtype=torch.int64, device=values.device)
    key = values.to(torch.int64) * _KEY_SHIFT + (_KEY_SHIFT - 1 - index)
    return torch.topk(key, k, dim=-1).indices


def _pool_candidates(best_corr: torch.Tensor, pool: int, rows: int | None = None,
                     exact: bool = False) -> torch.Tensor:
    """EXACT top-`pool` track indices along the last axis, descending score
    and ascending index on ties, padded to a multiple of 8 by repeating the
    first candidate (the host ranking drops duplicates). Returns int64.
    Like the reference's Pallas path it takes min(pool, T) rounded up to 8
    distinct tracks where there are that many; exact takes min(pool, T), as
    its XLA path does. rows: rank only the first rows tracks."""
    if rows is not None:
        best_corr = best_corr[..., :rows]
    t = best_corr.shape[-1]
    k0 = max(1, min(pool, t))
    k = -(-k0 // 8) * 8
    kk = k0 if exact else min(k, t)
    cand = _top_indices(best_corr, kk)
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


def _rank_variants(out, n_var, n_real, track_ids, top_k, *, calibrate=False, variant=False):
    """Host ranking of B queries' (B * V, 3, K) [scores, track index,
    offsets] rows, each query's V variant rows together: the real tracks
    only (index < n_real), with calibrate each row's scores less that row's
    median (an estimate of its imposter background). Returns a list of B
    _rank_dedup results (track_ids, scores, offsets), plus each answer's
    variant index with variant."""
    k = out.shape[-1]
    out = out.reshape(-1, n_var, 3, k)
    rows = out.transpose(0, 2, 1, 3).reshape(len(out), 3, n_var * k)   # views at V = 1
    cal = None
    if calibrate:
        cal = out[:, :, 0].astype(np.float64)
        cal = (cal - np.median(cal, axis=-1, keepdims=True)).reshape(len(out), -1)
    var = np.repeat(np.arange(n_var, dtype=np.int32), k) if variant else None
    results = []
    for b, (scores, idx, offs) in enumerate(rows):
        real = idx < n_real
        results.append(_rank_dedup((scores if cal is None else cal[b])[real], idx[real],
                                   offs[real], track_ids, top_k,
                                   aux=None if var is None else var[real]))
    return results


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
                         pool, kind, channels, channels1, lc_true, packed1, pool_rows=None,
                         pool_exact=False):
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
    cand_m = _pool_candidates(best1, m, pool_rows, pool_exact).sort(dim=1).values  # (B, M8)
    qcs, rs = _phase_variants(queries, stride=stride, phases=phases, kind=kind,
                              channels=channels)                         # (B, P, Nc, C)
    best2, idx2 = coarse_rescan(qcs, db_c, cand_m.to(torch.int32), lc_true=lc_true)
    best, centers = _phase_select(best2, idx2, rs, stride)               # (B, M8)
    cand_loc = _pool_candidates(best, pool)
    return cand_m.gather(1, cand_loc), centers.gather(1, cand_loc)


def _two_stage(queries, prints, lengths, db_c, db_c1, *, stride, pool, fine_window,
               lc_true, kind, channels, phases, phases1, prefilter, channels1, packed1,
               pool_rows=None, pool_exact=False, base=0):
    """Batched two-stage match of B equal-length queries (B, N, 2) int32:
    (B, 3, K) int32 [scores, track index + base, offsets]. packed1: db_c1 is
    nibble-packed (read by pass 1 only); pool_rows, pool_exact: how the
    first pool ranks (_pool_candidates); base: the global index of the
    first track (a shard's)."""
    if phases > 1 and prefilter:
        cand, centers = _coarse_pool_twopass(
            queries, db_c, db_c1, stride=stride, phases=phases, phases1=phases1,
            prefilter=prefilter, pool=pool, kind=kind, channels=channels,
            channels1=channels1, lc_true=lc_true, packed1=packed1, pool_rows=pool_rows,
            pool_exact=pool_exact)
    else:
        best, centers_all = _coarse_best_phased(
            queries, db_c, stride=stride, phases=phases, kind=kind, channels=channels,
            lc_true=lc_true)
        cand = _pool_candidates(best, pool, pool_rows, pool_exact)
        centers = centers_all.gather(1, cand)
    n = queries.shape[1]
    n_fine = 2 * fine_window + 1
    span = n + n_fine - 1
    starts = (centers - fine_window).clamp(0, max(prints.shape[1] - span, 0))
    cand = cand.to(torch.int32)
    s, o = fine_rescan_batch(queries, prints, lengths, cand, starts.to(torch.int32),
                             n_fine=n_fine)
    return torch.stack([s, cand + base if base else cand, o], dim=1)


def _derive_coarse(prints, lengths, *, stride, kind, channel_counts):
    """Flat coarse DBs of (T, L, 2) prints on their device, one per channel
    count (prefixes of the first), zero past each track's lengths // stride
    windows. Derived in chunks of tracks: the unpack intermediate is 256x
    the packed bytes."""
    t, l, _ = prints.shape
    lc = l // stride
    flats = [torch.zeros((t, flat_width(lc, c)), dtype=torch.int8, device=prints.device)
             for c in channel_counts]
    chunk = max(1, min(t, _DERIVE_ELEMS // max(l * 64, 1)))
    window = torch.arange(lc, device=prints.device)
    for i in range(0, t, chunk):
        c = coarse_ops.coarse_pm1(prints[i:i + chunk], stride, kind=kind,
                                  channels=channel_counts[0])
        inside = window < coarse_ops.coarse_lengths(lengths[i:i + chunk], stride)[:, None]
        c = torch.where(inside[..., None], c, 0)
        for flat, ch in zip(flats, channel_counts):
            flat.view(t, -1, ch)[i:i + chunk, :lc] = c[..., :ch]
    return flats


class Shard(NamedTuple):
    """One device's part of a TwoStageDB: (T_s, L, 2) int32 prints, (T_s,)
    lengths, the flat coarse DB and the pass-1 DB (db_c itself when pass 1
    reads the same rows)."""
    prints: torch.Tensor
    lengths: torch.Tensor
    db_c: torch.Tensor
    db_c1: torch.Tensor


class TwoStageDB:
    """Catalog-scale database: prints, lengths and the flat int8 coarse DB,
    plus a pass-1 DB db_c1 when prefilter_channels < coarse_channels (a
    channel prefix) or prefilter_pack4 (the pass-1 rows nibble-packed, two
    features a byte; their results are identical).

    On one device (mesh=None) they sit on `device`, by default the source
    FingerprintDB's, as prints, lengths, db_c and db_c1; the prints are the
    DB's device_arrays(), so a device-resident DB's tensor is used as it is
    and never copied to the host. With a mesh (parallel/mesh.py) the track
    axis is padded to a multiple of mesh size x 8 and split into contiguous
    shards, shard i on mesh entry i, uploaded from the DB's host prints (a
    device-resident FingerprintDB copies its prints to the host once for
    this: db.prints) and derived there a shard at a time; `shards` holds
    every part (on one device, the one shard), and matching runs in every
    shard before the candidate blocks meet on the first device, `device`. On a CUDA device the coarse and fine stages run through K4
    and K5; on the CPU through their plain versions. The knobs default to
    db.cfg's, as in the reference. keep_host is the reference's keyword and
    changes nothing: save() copies the prints and coarse rows back from the
    devices once and writes the same bytes either way.
    """

    _CACHE_VERSION = 1
    # How the pool ranks: every row, in groups of 8 (the reference's Pallas
    # layout), unless a loaded cache of its other layouts says otherwise.
    _pool_rows: int | None = None
    _pool_exact = False

    def __init__(self, db: FingerprintDB, *, stride: int | None = None,
                 coarse_kind: str | None = None,
                 coarse_channels: int | None = None,
                 query_phases: int | None = None,
                 prefilter: int | None = None,
                 prefilter_phases: int | None = None,
                 prefilter_channels: int | None = None,
                 prefilter_pack4: bool | None = None,
                 mesh: Mesh | None = None,
                 keep_host: bool = False,
                 device: str | torch.device | None = None):
        cfg = db.cfg
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
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.first:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.first}")
            self.device = mesh.first
            # Whole 8-track tiles in every shard: the reference pads to mesh
            # size x coarse_tile, and the port's tile is 8 (ROADMAP C).
            unit = mesh.size * 8
            prints = np.ascontiguousarray(db.prints, dtype=np.uint32).view(np.int32)
            lengths = db.lengths
            pad = -prints.shape[0] % unit
            if pad:
                prints = np.concatenate([prints, np.zeros((pad,) + prints.shape[1:],
                                                          prints.dtype)])
                lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
            parts = zip(split_tracks(prints, mesh), split_tracks(lengths, mesh))
        else:
            self.device = torch.device(device) if device is not None else db.device
            if self.device == db.device or db.host_bytes == 0:
                # No host copy (a resident DB): its tensor, moved only to
                # another device.
                prints, lengths = (a.to(self.device) for a in db.device_arrays())
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
            parts = [(prints, lengths)]
        self.n_real = db.n_tracks
        self.lc_true = prints.shape[1] // self.stride
        counts = [self.coarse_channels]
        if self.prefilter_channels < self.coarse_channels:
            counts.append(self.prefilter_channels)
        shards = []
        for p, ln in parts:
            with trace("index.derive", rows=int(p.shape[0])) as span:
                flats = _derive_coarse(p, ln, stride=self.stride, kind=self.coarse_kind,
                                       channel_counts=counts)
                shard = Shard(p, ln, flats[0], pack_coarse_nibbles(flats[-1])
                              if self.prefilter_pack4 else flats[-1])
                span.attrs["bytes"] = shard.db_c.nbytes + (
                    shard.db_c1.nbytes if shard.db_c1 is not shard.db_c else 0)
                if shard.db_c.is_cuda:
                    torch.cuda.synchronize(shard.db_c.device)   # the span ends with the work
            shards.append(shard)
        self._set_shards(shards)

    def _set_shards(self, shards: list[Shard]) -> None:
        """Hold the parts; on one device also as prints, lengths, db_c and
        db_c1 (None under a mesh). A dispatch's CUDA graph holds the parts'
        addresses, so any graphs go."""
        self.shards = shards
        (self.prints, self.lengths, self.db_c, self.db_c1) = (
            shards[0] if self.mesh is None else (None,) * 4)
        self._graphs = DispatchGraphs()

    @property
    def _graphed(self) -> bool:
        """Whether dispatch_batch replays CUDA graphs (match/graphs.py): on
        one card."""
        return self.mesh is None and self.device.type == "cuda"

    def _drop_graphs(self, streams) -> None:
        """Drop the dispatch graphs of these streams (a closing server's)."""
        self._graphs.drop({s.cuda_stream for s in streams if s is not None})

    @property
    def devices(self) -> list[torch.device]:
        """The distinct devices the shards sit on, the first device first."""
        return self.mesh.distinct if self.mesh is not None else [self.device]

    # -- derived-state persistence: the reference's format_version=1 cache --

    def save(self, path: str) -> None:
        """Write the derived state in the reference's Pallas layout: flat
        coarse rows (and coarse1), word planes, lengths, filters, track ids
        and a JSON manifest. On one device the planes pack tight; under a
        mesh every track slot has its own WIDTH of headroom, and the manifest
        holds the mesh size, as the reference's sharded layout does."""
        os.makedirs(path, exist_ok=True)
        t_shard = self.shards[0].db_c.shape[0]

        def dump(name, arr):
            np.save(os.path.join(path, name + ".npy"), np.asarray(arr))

        def whole(field):
            return torch.cat([getattr(s, field).cpu() for s in self.shards])

        prints = whole("prints")
        d0, d1, lpad = plane_pad(prints.numpy().view(np.uint32), tight=self.mesh is None)
        manifest = {
            "format_version": self._CACHE_VERSION,
            "stride": int(self.stride),
            "coarse_kind": self.coarse_kind,
            "coarse_channels": int(self.coarse_channels),
            "prefilter_channels": int(self.prefilter_channels),
            "prefilter_pack4": self.prefilter_pack4,
            # The reference's kernels scan whole tiles of this many tracks a shard.
            "coarse_tile": min(128, t_shard & -t_shard),
            "lc_true": int(self.lc_true),
            "n_real": int(self.n_real),
            "use_pallas_fine": True,
            "use_pallas_coarse": True,
            "mesh_size": self.mesh.size if self.mesh is not None else 0,
            "config_json": self.db.cfg.to_json(),
            "lpad": int(lpad),
            "l_true": int(prints.shape[1]),
        }
        dump("d0", d0)
        dump("d1", d1)
        dump("coarse", whole("db_c"))
        if self.shards[0].db_c1 is not self.shards[0].db_c:
            dump("coarse1", whole("db_c1"))
        dump("lengths", whole("lengths"))
        dump("filters", self.db.filters)
        dump("track_ids", np.array(self.db.track_ids))
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)

    @classmethod
    def load(cls, path: str, *, mesh: Mesh | None = None, mmap: bool = True,
             device: str | torch.device | None = None) -> "TwoStageDB":
        """Rebuild a TwoStageDB from a save() directory of either package,
        without re-deriving: on device (default: the card; raises when torch
        sees none), or over a mesh.

        As in the reference, a cache written without a mesh loads without
        one, and a mesh cache needs a mesh of its size. Every layout of the
        reference loads: flat coarse rows and word planes (use_pallas_fine
        and use_pallas_coarse, what it writes on a TPU and what save()
        writes), and (T, lc, C) coarse prints beside word planes or beside a
        (T, L, 2) prints array (use_pallas_fine=False), whose rows are
        flattened. On one device the latter two come with the track axis
        unpadded: the tracks are padded to whole 8-track tiles as __init__
        does, and the pool ranks only the real tracks, as the unpadded
        reference does. A mesh cache splits into shards at its own padded
        length, never padded again, so every shard holds the reference's
        rows. Without word planes the pool is exactly min(pool, tracks), as
        the reference's lax.top_k takes it. mmap=False reads each array
        whole instead of mapping it, as in the reference."""
        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
        if m["format_version"] != cls._CACHE_VERSION:
            raise ValueError(f"unsupported two-stage cache version {m['format_version']}")
        mesh_size = mesh.size if mesh is not None else 0
        if mesh_size != m["mesh_size"]:
            raise ValueError(
                f"cache was built for mesh size {m['mesh_size']}, "
                f"loading with mesh size {mesh_size}; rebuild the cache for "
                "this layout")

        def grab(name):
            return np.load(os.path.join(path, name + ".npy"), mmap_mode="r" if mmap else None)

        cfg = HpfwConfig.from_json(m["config_json"])
        lengths = np.array(grab("lengths"), dtype=np.int32)
        t, n_real = lengths.shape[0], m["n_real"]
        if m["use_pallas_fine"]:
            l, lpad = m["l_true"], m["lpad"]
            prints = np.empty((t, l, 2), np.uint32)
            prints[..., 0] = grab("d0")[: t * lpad].reshape(t, lpad)[:, :l]
            prints[..., 1] = grab("d1")[: t * lpad].reshape(t, lpad)[:, :l]
        else:
            prints = np.array(grab("prints"), dtype=np.uint32)
        if mesh is not None:
            dev = mesh.first
        else:
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
        self.mesh = mesh
        self.device = dev
        self.n_real = n_real
        self.lc_true = m["lc_true"]
        prints = np.ascontiguousarray(prints).view(np.int32)
        db_c = np.array(grab("coarse"))
        if m["use_pallas_coarse"]:
            db_c1 = (np.array(grab("coarse1"))
                     if (self.prefilter_channels < self.coarse_channels
                         or self.prefilter_pack4) else None)
        else:
            db_c = flatten_coarse(torch.from_numpy(db_c)).numpy()
            db_c1 = None
            if mesh is None:
                pad = -t % 8
                prints = np.concatenate([prints, np.zeros((pad,) + prints.shape[1:],
                                                          prints.dtype)])
                lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
                db_c = np.concatenate([db_c, np.zeros((pad, db_c.shape[1]), db_c.dtype)])
                self._pool_rows = n_real
            self._pool_exact = not m["use_pallas_fine"]
        split = ((lambda a: split_tracks(a, mesh)) if mesh is not None
                 else (lambda a: [torch.from_numpy(a).to(dev)]))
        coarse = split(db_c)
        coarse1 = split(db_c1) if db_c1 is not None else coarse
        self._set_shards([Shard(*parts) for parts in zip(split(prints), split(lengths),
                                                          coarse, coarse1)])
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
        index, offsets] tensor. Under a mesh, every shard's match is queued
        (each on its own device, the prefilter capped at the shard's tracks)
        before the shards' (B, 3, K_s) blocks are gathered along K in shard
        order.

        On one card the match replays as a CUDA graph (match/graphs.py): the
        second call of a shape and knobs on a stream captures it, and later
        calls replay it, with the same results. Each call is a
        `match.dispatch` span whose `graphed` says whether a graph ran."""
        cfg = self.db.cfg
        pool = pool if pool is not None else cfg.fine_candidates
        fw = fine_window if fine_window is not None else self.stride
        ph = phases if phases is not None else self.query_phases

        def match(i, sh, queries):
            pf, p1, c1 = self._twopass_args(ph, prefilter, phases1, sh.db_c.shape[0])
            return _two_stage(
                queries.to(sh.db_c.device), sh.prints, sh.lengths, sh.db_c, sh.db_c1,
                stride=self.stride, pool=pool, fine_window=fw, lc_true=self.lc_true,
                kind=self.coarse_kind, channels=self.coarse_channels, phases=ph,
                phases1=p1, prefilter=pf, channels1=c1,
                packed1=bool(pf) and self.prefilter_pack4, pool_rows=self._pool_rows,
                pool_exact=self._pool_exact, base=i * sh.db_c.shape[0])

        with trace("match.dispatch") as span:
            graphed = False
            if self._graphed:
                key = (tuple(queries_dev.shape), queries_dev.stride(), queries_dev.dtype,
                       pool, fw, ph) + self._twopass_args(ph, prefilter, phases1,
                                                          self.db_c.shape[0])
                out, graphed = self._graphs.run(self.device, key, queries_dev,
                                                lambda q: match(0, self.shards[0], q))
            else:
                blocks = [match(i, sh, queries_dev) for i, sh in enumerate(self.shards)]
                out = (blocks[0] if self.mesh is None
                       else gather_blocks(blocks, self.mesh, dim=2))
            span.attrs["graphed"] = graphed
        return out

    def dispatch(self, query_dev: torch.Tensor, *, pool: int | None = None,
                 fine_window: int | None = None, phases: int | None = None,
                 prefilter: int | None = None, phases1: int | None = None) -> torch.Tensor:
        """One query (N, 2) int32: the (3, K) tensor of dispatch_batch."""
        return self.dispatch_batch(query_dev[None], pool=pool, fine_window=fine_window,
                                   phases=phases, prefilter=prefilter, phases1=phases1)[0]

    def _synchronize(self) -> None:
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def warmup(self, query_lens, *, batch_sizes=(), pool: int | None = None,
               fine_window: int | None = None) -> None:
        """Run the serving programs now, on zero queries: dispatch for each
        query length and dispatch_batch for each batch size at that length,
        every device synchronised after each, as the reference runs them to
        compile them. The port compiles nothing per shape; what this takes
        out of a server's first requests is the first use of each kernel
        (loading the kernel library) and the allocator's first blocks for
        those shapes, and on one card, where each shape runs twice, the
        capture of its CUDA graph. Under a mesh every shard runs."""
        runs = 2 if self._graphed else 1
        for n in query_lens:
            q = torch.zeros((int(n), 2), dtype=torch.int32, device=self.device)
            for _ in range(runs):
                self.dispatch(q, pool=pool, fine_window=fine_window)
                self._synchronize()
            for b in batch_sizes:
                qb = q.new_zeros((int(b), int(n), 2))
                for _ in range(runs):
                    self.dispatch_batch(qb, pool=pool, fine_window=fine_window)
                    self._synchronize()

    def bundle_compile_cache(self, path: str, query_lens, *, batch_sizes=(),
                             pool: int | None = None, fine_window: int | None = None) -> int:
        """warmup(), then the number of compile-cache entries bundled into
        the save() directory path: always 0. The reference ships its XLA
        compile-cache entries there; the port has no compile cache (its
        kernels build once a machine, ops/_build.py), so it writes nothing
        under path, and load() needs nothing but save()'s files."""
        self.warmup(query_lens, batch_sizes=batch_sizes, pool=pool, fine_window=fine_window)
        return 0

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
        stack of tempo variants ranked together: match_batch's path for a
        batch of one, one dispatch_batch a call. Returns (track_ids, scores,
        offsets) (+ variant index with return_variant). calibrate ranks a
        stack's or a tempo scan's variant rows by their excess over each
        row's median score."""
        qh = np.asarray(query_prints, dtype=np.uint32)
        if qh.ndim == 3:
            self._check_query_len(qh.shape[1])
            rows, n_var, variants = qh, qh.shape[0], True
        else:
            rows, n_var, variants = self._scan_rows(qh[None], stretch_span, stretch_step)
        return self._match_rows(rows, n_var, top_k=top_k, calibrate=calibrate and variants,
                                variant=return_variant, pool=pool, fine_window=fine_window,
                                phases=phases, prefilter=prefilter, phases1=phases1)[0]

    def match_batch(self, query_batch: np.ndarray, *, top_k: int | None = None,
                    pool: int | None = None, fine_window: int | None = None,
                    phases: int | None = None, prefilter: int | None = None,
                    phases1: int | None = None, stretch_span: float | None = None,
                    stretch_step: float | None = None, calibrate: bool = False):
        """Match B equal-length queries, (B, N, 2) uint32 or (B, V, N, 2)
        variant stacks, in one coarse sweep. Returns a list of B (track_ids,
        scores, offsets) tuples, each what match() returns for that query.
        The host ranking is a `match.rank` span (utils/profiling.py)."""
        qh = np.asarray(query_batch, dtype=np.uint32)
        # As in the reference, a (B, 1, N, 2) batch takes the tempo scan as
        # a (B, N, 2) one does.
        if qh.ndim == 4 and qh.shape[1] > 1:
            self._check_query_len(qh.shape[2])
            rows, n_var = qh.reshape(-1, qh.shape[2], 2), qh.shape[1]
        else:
            rows, n_var, _ = self._scan_rows(qh.reshape(-1, qh.shape[-2], 2), stretch_span,
                                             stretch_step)
        return self._match_rows(rows, n_var, top_k=top_k, calibrate=calibrate and n_var > 1,
                                pool=pool, fine_window=fine_window, phases=phases,
                                prefilter=prefilter, phases1=phases1)

    def _scan_rows(self, qh: np.ndarray, stretch_span, stretch_step):
        """(B, N, 2) queries -> (the (B * V, N, 2) rows of their tempo scan,
        V, True); the queries themselves, 1 and False with no scan."""
        self._check_query_len(qh.shape[1])
        factors = self._stretch_factors(stretch_span, stretch_step)
        if factors is None:
            return qh, 1, False
        return print_variants(qh, factors).reshape(-1, qh.shape[1], 2), len(factors), True

    def _match_rows(self, rows: np.ndarray, n_var: int, *, top_k: int | None,
                    calibrate: bool, variant: bool = False, **kw):
        """(B * V, N, 2) uint32 rows, V variants a query, in one
        dispatch_batch, ranked by _rank_variants."""
        top_k = top_k if top_k is not None else self.db.cfg.top_k
        out = self.dispatch_batch(_to_tensor_prints(rows, self.device), **kw).cpu().numpy()
        with trace("match.rank"):
            return _rank_variants(out, n_var, self.n_real, self.db.track_ids, top_k,
                                  calibrate=calibrate, variant=variant)
