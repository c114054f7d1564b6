"""Batch identification against a catalog resident on the card: batch's
closed loop of TwoStageDB.match_batch, over a catalog built as a deployment
at this scale builds it, with no host copy of its prints.

The prints are made on the run's device from the seed by catalog.build's
generator streams and chunking, so they are its bits at the same seed and
sizes; the planted tracks are fingerprinted there by the reference. The
system under test is a FingerprintDB over that device tensor and a
TwoStageDB over it. The query pool is batch.queries's, bit for bit, drawn
from the device prints.

The window, the sample of the window's batches, the comparison and its
limits are batch's. Once release has dropped the system (and its index),
the check's reference catalog is built over the same device prints. The
control is batch's: the reference with ties broken the other way.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import synth
from ..catalog import RENDER_BATCH
from ..reference import extract, matcher
from . import batch

window, release = batch.window, batch.release


def build(run) -> dict:
    """catalog.build's catalog left on the device: filters, (T, L, 2) int32
    prints and (T,) int32 lengths on the run's device, the planted rows (host)
    and their score parameters."""
    c, dev = run.config, run.device
    p = c["hpfw"]
    t, l = c["n_tracks"], c["prints_per_track"]
    g = synth.generator(run.seed, 1, dev)
    filters = synth.filters(g, p["n_bins"] * p["context_w"], p["n_filters"], dev)
    prints = torch.empty((t, l, 2), dtype=torch.int32, device=dev)
    for i in range(0, t, 8192):
        prints[i:i + 8192] = synth.random_prints(g, (min(8192, t - i), l, 2), dev)
    lengths = torch.full((t,), l, dtype=torch.int32, device=dev)
    rows = torch.randperm(t, generator=g, device=dev)[:c["planted_tracks"]]
    params = synth.score_params(g, c["planted_tracks"], dev)
    with extract.matmul_precision(False):
        for i in range(0, len(rows), RENDER_BATCH):
            pcm = synth.catalog_tracks(params[i:i + RENDER_BATCH], g, sr=p["sample_rate"],
                                       duration_s=c["track_seconds"], fmin=p["fmin"])
            for row, x in zip(rows[i:i + RENDER_BATCH].tolist(), pcm):
                fp = extract.prints(x, filters, p)
                n = min(fp.shape[0], l)
                prints[row, :n] = fp[:n]
                prints[row, n:] = 0
                lengths[row] = n
    return {"filters": filters, "prints": prints, "lengths": lengths,
            "rows": rows.cpu().numpy(), "params": params}


def queries(run, cat: dict) -> np.ndarray:
    """batch.queries's (query_batches, batch_size, query_prints, 2) uint32
    host query pool, cut from the device prints."""
    c, w, dev = run.config, run.workload, run.device
    g = synth.generator(run.seed, 3, dev)
    nq, n = w["query_batches"] * w["batch_size"], w["query_prints"]
    tracks = torch.randint(0, c["n_tracks"], (nq,), generator=g, device=dev)
    lens = cat["lengths"][tracks]
    starts = (torch.rand(nq, generator=g, device=dev, dtype=torch.float64)
              * (lens - n + 1)).long()
    flips = synth.flip_masks(g, nq, n, w["flip_rate"], dev)
    rows = cat["prints"][tracks]
    qs = torch.stack([synth.noisy_excerpt(r, int(s), n, f)
                      for r, s, f in zip(rows, starts.tolist(), flips)])
    return synth.to_host_u32(qs).reshape(w["query_batches"], w["batch_size"], n, 2)


def reference_catalog(run) -> matcher.Catalog:
    """The plain reference over the same device prints, as run.state's
    ref_catalog (which batch.reference reads)."""
    cat = run.state["catalog"]
    run.state["ref_catalog"] = matcher.Catalog(cat["prints"], cat["lengths"],
                                               run.config["hpfw"])
    return run.state["ref_catalog"]


def setup(run) -> None:
    from hpfw_tpu_torch import FingerprintDB, HpfwConfig, TwoStageDB

    c = run.config
    cat = build(run)
    db = FingerprintDB(HpfwConfig(**c["hpfw"]), cat["filters"].cpu().numpy(),
                       [str(i) for i in range(c["n_tracks"])], cat["prints"], cat["lengths"],
                       device=run.device)
    ts = TwoStageDB(db)
    pool = queries(run, cat)
    for _ in range(2):
        ts.match_batch(pool[0])
    run.state.update(catalog=cat, ts=ts, pool=pool)


def check(run) -> dict:
    reference_catalog(run)
    return batch.check(run)


def control(run) -> dict:
    """The reversed-tie reference's mismatches on check_batches of the pool."""
    run.state["catalog"] = cat = build(run)
    reference_catalog(run)
    pool = queries(run, cat)
    rng = np.random.default_rng(run.seed + 1)
    qs = np.concatenate([pool[i] for i in rng.choice(len(pool), run.workload["check_batches"],
                                                     replace=False)])
    return {"mismatches": float(batch.mismatches(batch.reference(run, qs, reverse_ties=True),
                                                 batch.reference(run, qs)))}
