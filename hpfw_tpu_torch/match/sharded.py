"""Sharded dense matcher: a scan in each track shard, then a fixed-size merge.

Counterpart of hpfw_tpu/match/sharded.py. The print database is split over
the mesh's track axis (parallel/mesh.py), the query is replicated, and each
shard scans only its own tracks with the dense matcher (matcher.score_tracks,
K3 on the card), keeps its top `top_pool` tracks, and the shards' candidate
blocks are gathered onto the first device in shard order. What crosses
devices is D * top_pool * 3 words, whatever the catalog's size.

Every choice breaks ties as the reference's does: a track's first best
offset, a shard's top-k toward the lower index (lax.top_k is stable;
torch.topk ranks the composite key of scaled._top_indices), and the
host ranking by descending score, then ascending global index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import _to_tensor_prints
from ..parallel.mesh import Mesh, gather_blocks, pad_tracks_to_mesh, split_tracks
from . import matcher
from .scaled import _top_indices


def sharded_score(query: torch.Tensor, shards, *, mesh: Mesh, top_pool: int = 128,
                  offset_block: int = 64):
    """The merged candidate pool: ((D*k,) scores, (D*k,) global track
    indices, (D*k,) offsets), int32 on the mesh's first device, k =
    min(top_pool, tracks a shard), shard by shard, each shard's block in
    descending score and ascending index.

    query (N, 2) int32 on any device; shards: one (prints (t, L, 2) int32,
    lengths (t,) int32) pair a mesh entry, on that entry's device.
    offset_block is the reference's scan block; the port's scan takes no
    such block, so it changes no result and is accepted for the signature."""
    del offset_block
    blocks = []
    for i, ((prints, lengths), dev) in enumerate(zip(shards, mesh.devices)):
        q = query.to(dev)
        if q.shape[0] > prints.shape[1]:
            # As api.match: tracks shorter than the query overlap its head.
            pad = prints.new_zeros((prints.shape[0], q.shape[0] - prints.shape[1], 2))
            prints = torch.cat([prints, pad], dim=1)
        scores, offsets = matcher.score_tracks(q, prints, lengths)
        top = _top_indices(scores, min(top_pool, scores.shape[0]))
        base = i * prints.shape[0]
        blocks.append(torch.stack([scores[top], (top + base).to(torch.int32),
                                   offsets[top]]))
    merged = gather_blocks(blocks, mesh, dim=1)
    return merged[0], merged[1], merged[2]


class ShardedDB:
    """A FingerprintDB laid out over a mesh for matching.

    The track axis is padded to a multiple of the mesh size with empty
    tracks (length 0: they score 0 and the ranking drops them, so one never
    outranks a real track) and split into contiguous shards, shard i on
    mesh entry i, uploaded from the DB's host prints a shard at a time (a
    device-resident FingerprintDB copies its prints to the host once for
    this: db.prints)."""

    def __init__(self, db, mesh: Mesh):
        self.db = db
        self.mesh = mesh
        self.device = mesh.first
        t = db.n_tracks
        t_pad = pad_tracks_to_mesh(t, mesh)
        prints = np.ascontiguousarray(db.prints, dtype=np.uint32).view(np.int32)
        lengths = db.lengths
        if t_pad != t:
            prints = np.concatenate(
                [prints, np.zeros((t_pad - t,) + prints.shape[1:], prints.dtype)])
            lengths = np.concatenate([lengths, np.zeros(t_pad - t, lengths.dtype)])
        self.shards = list(zip(split_tracks(prints, mesh), split_tracks(lengths, mesh)))
        self.n_real = t

    def match(self, query_prints: np.ndarray, *, top_k: int | None = None,
              top_pool: int = 128, offset_block: int = 64):
        """Ranked (track_ids, scores, offsets), the semantics of api.match for
        every track within the top top_pool of its shard."""
        top_k = top_k if top_k is not None else self.db.cfg.top_k
        q = _to_tensor_prints(query_prints, self.device)
        merged = sharded_score(q, self.shards, mesh=self.mesh, top_pool=top_pool,
                               offset_block=offset_block)
        s, idx, off = torch.stack(merged).cpu().numpy()
        real = idx < self.n_real
        s, idx, off = s[real], idx[real], off[real]
        # Descending score, ascending track index on ties: api.match's rank().
        order = np.lexsort((idx, -s))[:top_k]
        return [self.db.track_ids[i] for i in idx[order]], s[order], off[order]
