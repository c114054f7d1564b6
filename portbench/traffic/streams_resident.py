"""Broadcast monitoring against a catalog resident on the card: a closed loop
of StreamingPool.feed over `streams` concurrent streams.

Set-up builds batch_resident's catalog (its bits at the same seed and
sizes), a FingerprintDB over the device prints, a TwoStageDB over it and a
StreamingPool with the configuration's `pool` settings, and adds the
streams. Each stream plays the planted tracks' music, rendered again from
their score parameters with white noise noise_db below each track's RMS and
held on the host: stream s starts planted track perm(s) at a seeded point
of its first half, and at a track's end goes on to the next planted track
of a seeded cycle. A feed hands every stream its next chunk_prints x hop
samples; the first hands each the samples of one chunk short of a full
ring, so that the warm_feeds feeds of set-up fill every ring and capture
the top bucket's CUDA graph.

The window: feeds in a closed loop, each starting when the last returned;
match_qps is the stream-queries matched in the window's feeds over its
seconds.

The comparison:
- mismatches: check_feeds of the window's feeds, drawn from the seed, times
  check_streams streams drawn at set-up: each stream's last_hit against the
  plain reference's top-1 of the stream's query (matcher.Catalog over the
  same device prints), track, score and offset.
- bit_diff_share, worst_print_bits: the prints of those queries against the
  reference's prints of the stream's audio at the same print positions: the
  share of all their bits that differ, and the most bits that differ in one
  print. The sample's prints are pooled, as ingest pools a whole track's:
  one bit of a single 128-print query is 1.2e-4, near ingest's limit.
- vote_mismatches: vote_streams streams drawn at set-up. Every hypothesis a
  feed returned them, warm-up included, against reference/streams.py's
  replay of the stream's hits: track, score and offset equal, confidence
  within CONFIDENCE_TOL.

The control: the reference's prints with TF32 products (the configuration
states float32 prints) against its float32 prints, at the print positions
of check_feeds feeds of the first CONTROL_FEEDS after warm-up.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import synth
from ..catalog import RENDER_BATCH
from ..reference import extract, matcher, streams
from . import batch_resident, stream

# Python floats summed in the same order agree to the last bit; this covers
# a reordering of the same sums only.
CONFIDENCE_TOL = 1e-9
CONTROL_FEEDS = 128


class Plan:
    """The streams' audio: per stream its first planted track and start
    sample, and the cycle of planted tracks each moves along."""

    def __init__(self, run, n_planted: int, n_samples: int):
        g = synth.generator(run.seed, 4, run.device)
        n = run.workload["streams"]
        self.pcm_len = n_samples
        self.first = torch.randperm(n_planted, generator=g, device=run.device).cpu().numpy()
        self.first = self.first[np.arange(n) % n_planted]
        starts = torch.rand(n, generator=g, device=run.device, dtype=torch.float64)
        self.start = (starts.cpu().numpy() * (n_samples // 2)).astype(np.int64)
        order = torch.randperm(n_planted, generator=g, device=run.device).cpu().numpy()
        self.next = np.empty(n_planted, dtype=np.int64)
        self.next[order] = np.roll(order, -1)

    def samples(self, pcm: np.ndarray, s: int, lo: int, hi: int) -> np.ndarray:
        """Samples [lo, hi) of stream s."""
        track, at = int(self.first[s]), int(self.start[s]) + lo
        while at >= self.pcm_len:
            at -= self.pcm_len
            track = int(self.next[track])
        parts = []
        while hi > lo:
            take = min(self.pcm_len - at, hi - lo)
            parts.append(pcm[track, at:at + take])
            lo, at, track = lo + take, 0, int(self.next[track])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def music(run, cat: dict) -> np.ndarray:
    """(planted, samples) float32 host PCM of the planted tracks' scores, with
    white noise noise_db below each track's RMS."""
    c, p = run.config, run.config["hpfw"]
    g = synth.generator(run.seed, 5, run.device)
    n = int(round(c["track_seconds"] * p["sample_rate"]))
    params = cat["params"]
    out = np.empty((params.shape[0], n), dtype=np.float32)
    for i in range(0, params.shape[0], RENDER_BATCH):
        b = params[i:i + RENDER_BATCH]
        clean = synth.render(b, torch.zeros(b.shape[0], device=b.device), n,
                             sr=p["sample_rate"], duration_s=c["track_seconds"], fmin=p["fmin"])
        out[i:i + b.shape[0]] = synth.add_noise(clean, g, c["noise_db"]).cpu().numpy()
    return out


class Geometry:
    """Where a stream's prints stand after each feed: every stream is fed the
    same samples, so one count serves all. A stream's extraction takes
    windows of chunk_prints + context_w + delta_lag - 1 frames, chunk_prints
    x hop samples apart, and keeps each window's first chunk_prints prints."""

    def __init__(self, run):
        p, pool = run.config["hpfw"], run.config["pool"]
        self.hop = p["hop"]
        self.chunk_prints, self.query_prints = pool["chunk_prints"], pool["query_prints"]
        self.step = self.chunk_prints * self.hop
        self.window = p["frame_len"] + (self.chunk_prints + p["context_w"] + p["delta_lag"]
                                        - 2) * self.hop
        self.buckets = sorted(pool["query_buckets"])
        self.chunk = run.workload["chunk_prints"] * self.hop
        full = self.query_prints // self.chunk_prints
        self.first = self.window + (full - 2) * self.step

    def fed(self, f: int) -> int:
        """Samples fed to every stream by feeds 0..f."""
        return 0 if f < 0 else self.first + f * self.chunk

    def windows(self, f: int) -> int:
        """Windows extracted by feeds 0..f."""
        total = self.fed(f)
        return 0 if total < self.window else (total - self.window) // self.step + 1

    def query(self, f: int) -> tuple[int, int] | None:
        """(first print, prints) of the query matched in feed f; None where
        feed f matched nothing."""
        e = self.windows(f)
        ring = min(self.query_prints, e * self.chunk_prints)
        fits = [b for b in self.buckets if b <= ring]
        if e == self.windows(f - 1) or not fits:
            return None
        return e * self.chunk_prints - fits[-1], fits[-1]

    def audio(self, p: dict, first: int, n: int) -> tuple[int, int]:
        """The samples [lo, hi) that prints [first, first + n) are made of."""
        lo = first * self.hop
        return lo, lo + p["frame_len"] + (n + p["context_w"] + p["delta_lag"] - 2) * self.hop


def feed(run, f: int) -> None:
    """Feed f: every stream's next samples; the watched streams' hits kept."""
    st = run.state
    geo, plan, pcm, pool = st["geometry"], st["plan"], st["pcm"], st["pool"]
    lo, hi = geo.fed(f - 1), geo.fed(f)
    hyps = pool.feed({sid: plan.samples(pcm, s, lo, hi) for s, sid in enumerate(st["sids"])})
    if geo.query(f) is None:
        return
    for s in st["vote_streams"]:
        sid = st["sids"][s]
        st["votes"][s].append((f, pool.last_hit(sid), hyps[sid]))
    if run.t_window is not None:
        st["kept"].append((f, [(pool.last_hit(st["sids"][s]), pool.query(st["sids"][s]))
                               for s in st["check_streams"]]))


def setup(run) -> None:
    from hpfw_tpu_torch import FingerprintDB, HpfwConfig, StreamingPool, TwoStageDB

    if not all(hasattr(StreamingPool, k) for k in ("last_hit", "query")):
        raise RuntimeError("this StreamingPool has no last_hit or query to check a feed by")
    c, w = run.config, run.workload
    cat = batch_resident.build(run)
    cfg = HpfwConfig(**c["hpfw"])
    db = FingerprintDB(cfg, cat["filters"].cpu().numpy(),
                       [str(i) for i in range(c["n_tracks"])], cat["prints"], cat["lengths"],
                       device=run.device)
    ts = TwoStageDB(db)
    pool = StreamingPool(ts, cat["filters"], cfg, **c["pool"])
    sids = [f"ch{s:03d}" for s in range(w["streams"])]
    for sid in sids:
        pool.add_stream(sid)
    pcm = music(run, cat)
    rng = np.random.default_rng(run.seed + 2)
    watch = rng.permutation(w["streams"])
    run.state.update(catalog=cat, ts=ts, pool=pool, sids=sids, pcm=pcm,
                     plan=Plan(run, pcm.shape[0], pcm.shape[1]),
                     geometry=Geometry(run),
                     check_streams=sorted(watch[:w["check_streams"]].tolist()),
                     vote_streams=sorted(watch[:w["vote_streams"]].tolist()),
                     votes={int(s): [] for s in watch[:w["vote_streams"]]}, kept=[])
    for f in range(w["warm_feeds"]):
        feed(run, f)
    run.state["feeds"] = w["warm_feeds"]


def window(run) -> None:
    st = run.state
    f0 = f = st["feeds"]
    t0 = run.window_starts()
    while True:
        feed(run, f)
        f += 1
        t_end = time.perf_counter()
        if t_end - t0 >= run.seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    geo = st["geometry"]
    q = sum(geo.query(i) is not None for i in range(f0, f)) * len(st["sids"])
    st["feeds"] = f
    run.records.update(attempted=q, failed=0, feeds=f - f0, window_s=t_end - t0,
                       answered_in_window=q)


def release(run) -> None:
    for key in ("pool", "ts"):
        del run.state[key]


def top1(run, queries: list) -> list[tuple[int, int, int]]:
    """The plain reference's top-1 (track, score, offset) of each (n, 2)
    uint32 query, matched in groups of one length."""
    ref, dev = run.state["ref_catalog"], run.device
    out: list = [None] * len(queries)
    for n in sorted({q.shape[0] for q in queries}):
        idx = [i for i, q in enumerate(queries) if q.shape[0] == n]
        qs = np.stack([queries[i] for i in idx]).view(np.int32)
        with extract.matmul_precision(False):
            got = ref.match(torch.from_numpy(qs).to(dev))
        for i, o in zip(idx, got):
            tr, sc, of = matcher.rank(o[0], o[1], o[2], 1, run.config["n_tracks"])
            out[i] = (int(tr[0]), int(sc[0]), int(of[0]))
    return out


def reference_prints(run, entries: list, tf32: bool = False) -> list:
    """The reference's prints of each (stream, first print, prints) entry's
    audio (float32, or TF32: the control)."""
    st, p = run.state, run.config["hpfw"]
    geo, plan, pcm = st["geometry"], st["plan"], st["pcm"]
    out = []
    with extract.matmul_precision(tf32):
        for s, first, n in entries:
            x = plan.samples(pcm, s, *geo.audio(p, first, n))
            out.append(extract.prints(torch.from_numpy(np.ascontiguousarray(x)).to(run.device),
                                      st["catalog"]["filters"], p))
    return out


def differences(run, got: list, want: list) -> tuple[float, int]:
    """(the share of the pooled prints' bits that differ, the most bits that
    differ in one print) of host queries against reference prints."""
    if not got:
        return 1.0, 64
    return stream.differences(run, [np.concatenate(got)], [torch.cat(want)])


def sample(run) -> list[tuple[int, int, tuple, np.ndarray]]:
    """(feed, stream, hit, query) of check_feeds window feeds drawn from the
    seed, each for every check stream."""
    kept = run.state["kept"]
    rng = np.random.default_rng(run.seed + 1)
    picks = sorted(rng.choice(len(kept), size=min(run.workload["check_feeds"], len(kept)),
                              replace=False).tolist())
    return [(kept[i][0], s, hit, q) for i in picks
            for s, (hit, q) in zip(run.state["check_streams"], kept[i][1])]


def vote_mismatches(run, decay: float | None = None) -> int:
    """Hypotheses of the vote streams, every feed that matched them, that
    differ from the reference's replay of their hits (decay: the pool's
    unless given)."""
    pool, geo = run.config["pool"], run.state["geometry"]
    decay = pool["vote_decay"] if decay is None else decay
    bad = 0
    for seq in run.state["votes"].values():
        hits = [(hit[0], hit[1], hit[2], geo.query(f)[1]) for f, hit, _ in seq]
        want = streams.replay(hits, decay, pool["vote_floor"])
        for (_, _, got), ref in zip(seq, want):
            bad += not (got is not None and (got.track_id, got.score, got.offset) == ref[:3]
                        and abs(got.confidence - ref[3]) <= CONFIDENCE_TOL)
    return bad


def check(run) -> dict:
    lim, geo = run.workload["limits"], run.state["geometry"]
    batch_resident.reference_catalog(run)
    entries = sample(run)
    want = top1(run, [q for *_, q in entries])
    bad = sum(hit is None or (int(hit[0]), hit[1], hit[2]) != ref
              for (_, _, hit, _), ref in zip(entries, want))
    share, worst = differences(
        run, [q for *_, q in entries],
        reference_prints(run, [(s, *geo.query(f)) for f, s, _, _ in entries]))
    run.records["checked"] = len(entries)
    return {"mismatches": (float(bad if entries else 1), lim["mismatches"]),
            "bit_diff_share": (share, lim["bit_diff_share"]),
            "worst_print_bits": (float(worst), lim["worst_print_bits"]),
            "vote_mismatches": (float(vote_mismatches(run)), lim["vote_mismatches"])}


def control(run) -> dict:
    """The TF32 reference's prints against its float32 prints at the print
    positions of check_feeds feeds of the first CONTROL_FEEDS after warm-up,
    for check_streams streams."""
    w = run.workload
    cat = batch_resident.build(run)
    pcm = music(run, cat)
    run.state.update(catalog=cat, pcm=pcm, plan=Plan(run, pcm.shape[0], pcm.shape[1]),
                     geometry=Geometry(run))
    geo = run.state["geometry"]
    rng = np.random.default_rng(run.seed + 1)
    feeds = rng.choice(CONTROL_FEEDS, size=w["check_feeds"], replace=False) + w["warm_feeds"]
    picks = np.random.default_rng(run.seed + 2).permutation(w["streams"])[:w["check_streams"]]
    entries = [(int(s), *geo.query(int(f))) for f in feeds for s in picks]
    want = reference_prints(run, entries)
    ctl = [x.cpu().numpy().view(np.uint32) for x in reference_prints(run, entries, tf32=True)]
    share, worst = differences(run, ctl, want)
    return {"bit_diff_share": share, "worst_print_bits": float(worst)}
