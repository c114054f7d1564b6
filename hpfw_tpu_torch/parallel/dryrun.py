"""Dry run of every distributed step of the port on a mesh.

Counterpart of __graft_entry__.dryrun_multichip: at the reference's tiny
config (frame_len 512, 49 bins, context 4), the five steps it runs across
devices, each checked by the reference's invariant:

  1. the covariance psum of filter learning: one track a shard, each shard's
     partial moments (learn/pca.py, K1 on a card) summed on the first device;
  2. sharded_score over 2 tracks a shard: an exact excerpt of track 3 wins
     at 64 * N at its offset;
  3. a sharded TwoStageDB.match (2 query phases): a planted excerpt found
     at 64 * N at its offset;
  4. a sharded match_batch of two excerpts on different shards;
  5. the same batch through the two-pass phased prefilter.

    python -c "from hpfw_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"

devices=None takes db_mesh(n_devices), the first n cards; an explicit list
(which may repeat a device) runs logical shards, e.g. ["cpu"] * 8 or
[cuda:0] * 4.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import FingerprintDB
from ..config import HpfwConfig
from ..learn.pca import track_moments
from ..match.scaled import TwoStageDB
from ..match.sharded import ShardedDB, sharded_score
from .mesh import Mesh, db_mesh, gather_blocks


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the five steps on an n_devices mesh; raises on a failed check."""
    mesh = db_mesh(n_devices) if devices is None else Mesh(devices)
    if mesh.size != n_devices:
        raise ValueError(f"need {n_devices} devices, the mesh has {mesh.size}")
    cfg = HpfwConfig(frame_len=512, fmin=1500.0, n_bins=49, hop=128, context_w=4,
                     delta_lag=2)
    rng = np.random.default_rng(0)

    # --- step 1: data-parallel covariance accumulation ---
    n_samples = cfg.min_samples() + 4 * cfg.hop
    pcms = rng.standard_normal((n_devices, n_samples)).astype(np.float32)
    partials = [track_moments(p, cfg, dev)[0] for p, dev in zip(pcms, mesh.devices)]
    cov = gather_blocks([x[None] for x in partials], mesh, dim=0).sum(dim=0)
    d = cfg.context_dim
    if tuple(cov.shape) != (d, d) or not bool(torch.isfinite(cov).all()):
        raise AssertionError(f"covariance {tuple(cov.shape)}, want ({d}, {d}) finite")

    # --- step 2: sharded match + gather top-k merge ---
    t_tracks = 2 * n_devices
    n_q, l_db = 6, 24
    filt = np.zeros((d, cfg.n_filters), np.float32)
    ids = [str(i) for i in range(t_tracks)]
    prints = rng.integers(0, 2 ** 32, (t_tracks, l_db, 2)).astype(np.uint32)
    sdb = ShardedDB(FingerprintDB(cfg, filt, ids, prints, np.full(t_tracks, l_db, np.int32),
                                  device=mesh.first), mesh)
    query = torch.from_numpy(prints[3, 5:5 + n_q].copy().view(np.int32))
    s, idx, off = (x.cpu().numpy() for x in sharded_score(
        query, sdb.shards, mesh=mesh, top_pool=2, offset_block=8))
    best = int(idx[np.argmax(s)])
    if best != 3 or int(s.max()) != 64 * n_q or int(off[np.argmax(s)]) != 5:
        raise AssertionError(f"sharded_score: {best} {int(s.max())} {off[np.argmax(s)]}")

    # --- step 3: two-stage sharded matcher ---
    l_db2 = 96
    prints2 = rng.integers(0, 2 ** 32, (t_tracks, l_db2, 2)).astype(np.uint32)
    # Two planted tracks on different shards, for any n_devices >= 2.
    ta, tb = min(5, t_tracks - 2), t_tracks - 1
    q2 = prints2[ta, 17:17 + 40].copy()
    db = FingerprintDB(cfg, filt, ids, prints2, np.full(t_tracks, l_db2, np.int32),
                       device=mesh.first)
    ts = TwoStageDB(db, stride=4, mesh=mesh, query_phases=2)
    got = ts.match(q2, top_k=1, pool=4, fine_window=8)
    if (got[0][0], int(got[1][0]), int(got[2][0])) != (str(ta), 64 * 40, 17):
        raise AssertionError(f"sharded match: {got}")

    # --- step 4: sharded batched serving ---
    q3 = prints2[tb, 30:30 + 40].copy()
    want = [(str(ta), 64 * 40, 17), (str(tb), 64 * 40, 30)]
    res = ts.match_batch(np.stack([q2, q3]), top_k=1, pool=4, fine_window=8)
    if [(r[0][0], int(r[1][0]), int(r[2][0])) for r in res] != want:
        raise AssertionError(f"sharded match_batch: {res}")

    # --- step 5: two-pass phased coarse under the mesh ---
    res = ts.match_batch(np.stack([q2, q3]), top_k=1, pool=2, fine_window=8, phases=4,
                         prefilter=2, phases1=2)
    if [(r[0][0], int(r[1][0]), int(r[2][0])) for r in res] != want:
        raise AssertionError(f"sharded two-pass match_batch: {res}")
