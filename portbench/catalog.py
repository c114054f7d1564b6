"""A catalog deployment's inputs: filters, catalog prints and live queries.

The catalog holds n_tracks rows of prints_per_track prints: iid random
prints (distractors), except planted_tracks rows, chosen from the seed,
that hold the prints of whole tracks of music, fingerprinted by the plain
reference on the run's device. A live query is a noisy excerpt of a planted
track's music, in tempo or as a rendition.
"""

from __future__ import annotations

import numpy as np
import torch

from . import synth
from .reference import extract, matcher

RENDER_BATCH = 32


def build(run) -> dict:
    """Filters (device), host catalog prints (uint32) and lengths, the planted
    rows and their score parameters."""
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
    return {"filters": filters, "prints": synth.to_host_u32(prints),
            "lengths": lengths.cpu().numpy(), "rows": rows.cpu().numpy(), "params": params}


def two_stage(run, cat: dict):
    """The system under test: hpfw_tpu_torch's TwoStageDB over the catalog,
    built on the run's device as a deployment builds it."""
    from hpfw_tpu_torch import FingerprintDB, HpfwConfig, TwoStageDB

    c = run.config
    db = FingerprintDB(HpfwConfig(**c["hpfw"]), cat["filters"].cpu().numpy(),
                       [str(i) for i in range(c["n_tracks"])], cat["prints"], cat["lengths"],
                       device=run.device)
    return TwoStageDB(db)


def reference(run) -> matcher.Catalog:
    """The plain reference's catalog (made once a run): the same prints, its
    own coarse prints."""
    if "ref_catalog" not in run.state:
        cat, dev = run.state["catalog"], run.device
        run.state["ref_catalog"] = matcher.Catalog(
            torch.from_numpy(cat["prints"].view(np.int32)).to(dev),
            torch.from_numpy(cat["lengths"]).to(dev), run.config["hpfw"])
    return run.state["ref_catalog"]


def live_queries(run, cat: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pool of distinct live queries: ((Q, samples) float32 host PCM, (Q,)
    planted catalog rows, (Q,) bool renditions), in an order drawn from the
    seed. A share rendition_share of the pool are renditions (the score
    pitch_st up at stretch x tempo). Of the queries in tempo, a fixed share
    hard_share are hard: the reference's prints of the query match its own
    track at its own place (the best of three offsets) below the server's
    confidence threshold, so that they escalate. Twice as many candidates in
    tempo as needed are drawn, and the first of each kind taken, so every seed
    offers the same mix; the mix sets how much of the load escalates."""
    c, w, dev = run.config, run.workload, run.device
    p, r = c["hpfw"], c["rendition"]
    sr, q = p["sample_rate"], w["query_pool"]
    n = int(round(c["query_seconds"] * sr))
    n_rend = int(round(w["rendition_share"] * q))
    n_in = q - n_rend
    cand = 2 * n_in
    g = synth.generator(run.seed, 2, dev)
    # Excerpts start where the whole query, at the slower of the two tempos,
    # lies inside the score.
    room = c["track_seconds"] - c["query_seconds"] * max(1.0, r["stretch"]) - 0.5
    which = torch.randint(0, len(cat["rows"]), (cand + n_rend,), generator=g, device=dev)
    start = torch.rand(cand + n_rend, generator=g, device=dev, dtype=torch.float64) * room

    def render(lo: int, hi: int, stretch: float, pitch_st: float) -> list[torch.Tensor]:
        return [synth.add_noise(synth.render(
            cat["params"][which[i:min(i + RENDER_BATCH, hi)]],
            start[i:min(i + RENDER_BATCH, hi)] / stretch, n, sr=sr,
            duration_s=c["track_seconds"], fmin=p["fmin"], pitch_st=pitch_st,
            stretch=stretch), g, c["noise_db"]) for i in range(lo, hi, RENDER_BATCH)]

    in_tempo = render(0, cand, 1.0, 0.0)
    renditions = render(cand, cand + n_rend, r["stretch"], r["pitch_st"])
    planted = torch.from_numpy(cat["prints"][cat["rows"]].view(np.int32)).to(dev)
    lengths = torch.from_numpy(cat["lengths"][cat["rows"]]).to(dev)
    sims = []
    with extract.matmul_precision(False):
        for x, k, s0 in zip(torch.cat(in_tempo), which[:cand].tolist(), start[:cand].tolist()):
            o = int(round(s0 * sr / p["hop"]))
            offs = torch.arange(o - 1, o + 2, device=dev)[None]
            sims.append(int(matcher.similarity(extract.prints(x, cat["filters"], p), planted,
                                               lengths, torch.tensor([k], device=dev),
                                               offs).max()))
    hard = np.array(sims) < c["server"]["threshold"] * 64 * extract.n_prints(p, n)
    hard_idx, easy_idx = np.flatnonzero(hard), np.flatnonzero(~hard)
    h = min(int(round(w["hard_share"] * n_in)), len(hard_idx))
    chosen = list(hard_idx[:h]) + list(easy_idx[:n_in - h])
    chosen += list(hard_idx[h:h + n_in - len(chosen)])            # too few easy ones
    pick = np.array(chosen + list(range(cand, cand + n_rend)), dtype=np.int64)
    pick = pick[torch.randperm(len(pick), generator=g, device=dev).cpu().numpy()]
    pcm = torch.cat(in_tempo + renditions).cpu().numpy()
    is_rend = np.arange(cand + n_rend) >= cand
    return pcm[pick], cat["rows"][which.cpu().numpy()[pick]], is_rend[pick]
