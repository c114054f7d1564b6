"""Batch identification: a closed loop of TwoStageDB.match_batch calls.

Each call matches batch_size print queries: excerpts of query_prints prints
of catalog rows drawn from the seed, each bit flipped with probability
flip_rate (benchmarks/config4_scale.py's noisy_excerpt). The pool of
query_batches distinct batches is cycled; the next call starts when the last
returned, so match_qps is queries answered over the window's seconds.

The comparison: a sample of the window's batches, drawn from the seed, is
matched again by the plain reference; mismatches counts the (query, rank)
entries whose track, score or offset differ, and the difference of lengths.

The control: the reference matcher taking the higher track index first on
ties (the stated tie rule broken; the matcher states integer-exact results
and no float precision), on check_batches batches of the pool, held to the
reference by mismatches.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import catalog, synth
from ..reference import extract, matcher


def queries(run, cat: dict) -> np.ndarray:
    """(query_batches, batch_size, query_prints, 2) uint32 host query pool."""
    c, w, dev = run.config, run.workload, run.device
    g = synth.generator(run.seed, 3, dev)
    nq, n = w["query_batches"] * w["batch_size"], w["query_prints"]
    tracks = torch.randint(0, c["n_tracks"], (nq,), generator=g, device=dev)
    lens = torch.from_numpy(cat["lengths"]).to(dev)[tracks]
    starts = (torch.rand(nq, generator=g, device=dev, dtype=torch.float64)
              * (lens - n + 1)).long()
    flips = synth.flip_masks(g, nq, n, w["flip_rate"], dev)
    rows = torch.from_numpy(cat["prints"][tracks.cpu().numpy()].view(np.int32)).to(dev)
    qs = torch.stack([synth.noisy_excerpt(r, int(s), n, f)
                      for r, s, f in zip(rows, starts.tolist(), flips)])
    return synth.to_host_u32(qs).reshape(w["query_batches"], w["batch_size"], n, 2)


def setup(run) -> None:
    cat = catalog.build(run)
    ts = catalog.two_stage(run, cat)
    pool = queries(run, cat)
    for _ in range(2):
        ts.match_batch(pool[0])
    run.state.update(catalog=cat, ts=ts, pool=pool)


def window(run) -> None:
    ts, pool = run.state["ts"], run.state["pool"]
    order = np.random.default_rng(run.seed).permutation(len(pool))
    served, t_end = [], None
    t0 = run.window_starts()
    while True:
        b = int(order[len(served) % len(pool)])
        served.append((b, ts.match_batch(pool[b])))
        t_end = time.perf_counter()
        if t_end - t0 >= run.seconds:
            break
    q = len(served) * pool.shape[1]
    run.records.update(attempted=q, failed=0, served=served, window_s=t_end - t0,
                       answered_in_window=q)


def release(run) -> None:
    del run.state["ts"]


def reference(run, queries: np.ndarray, reverse_ties: bool = False) -> list:
    """The plain reference's ranked answers to (B, n, 2) uint32 queries
    (reverse_ties: the lower track index last on ties, the control)."""
    c, dev = run.config, run.device
    p = c["hpfw"]
    with extract.matmul_precision(False):
        out = catalog.reference(run).match(torch.from_numpy(queries.view(np.int32)).to(dev),
                                           reverse_ties)
    return [matcher.rank(o[0], o[1], o[2], p["top_k"], c["n_tracks"]) for o in out]


def mismatches(got: list, want: list) -> int:
    """(query, rank) entries whose track, score or offset differ, and the
    difference of lengths."""
    bad = 0
    for (ids, scores, offs, *_), (tr, sc, of) in zip(got, want):
        mine = [(int(a), int(b), int(o)) for a, b, o in zip(ids, scores, offs)]
        theirs = list(zip(tr.tolist(), sc.tolist(), of.tolist()))
        bad += sum(x != y for x, y in zip(mine, theirs)) + abs(len(mine) - len(theirs))
    return bad


def sample(run, n_served: int) -> list[int]:
    rng = np.random.default_rng(run.seed + 1)
    k = min(run.workload["check_batches"], n_served)
    return [int(i) for i in rng.choice(n_served, size=k, replace=False)]


def control(run) -> dict:
    """The reversed-tie reference's mismatches on check_batches of the pool."""
    cat = catalog.build(run)
    run.state["catalog"] = cat
    pool = queries(run, cat)
    rng = np.random.default_rng(run.seed + 1)
    qs = np.concatenate([pool[i] for i in rng.choice(len(pool), run.workload["check_batches"],
                                                     replace=False)])
    return {"mismatches": float(mismatches(reference(run, qs, reverse_ties=True),
                                           reference(run, qs)))}


def check(run) -> dict:
    r, pool = run.records, run.state["pool"]
    batches = [r["served"][i] for i in sample(run, len(r["served"]))]
    want = reference(run, np.concatenate([pool[b] for b, _ in batches]))
    got = [x for _, res in batches for x in res]
    run.records["checked"] = len(got)
    return {"mismatches": (float(mismatches(got, want) if got else 1),
                           run.workload["limits"]["mismatches"])}
