"""Batched live-song ID: many concurrent streams on one device.

Counterpart of hpfw_tpu/streaming/pool.py. StreamingPool runs up to
`capacity` streams against one database with

  - ONE batched extraction a tick: the (ready streams, window_samples)
    batch of their windows through api.fingerprint_batch_device, K1 and K2
    on the card;
  - one TwoStageDB.match_batch per query bucket a tick, padded to capacity
    (streams group by their progressive ring bucket; at steady state every
    stream sits in the top bucket and the pool matches in one coarse sweep);
    a ShardedDB matches each query alone through its own match, and a
    dense FingerprintDB through api.match;

while each stream's vote integration, confidence and hypothesis stay those
of a lone StreamingSession fed the same chunks.

Spans (utils/profiling.py, on the caller's thread): `stream.feed` a feed
(`streams` given chunks, `ready` advanced), `stream.extract` a batched
extraction (`rows`), and per bucket `stream.match` (`bucket`, `rows`,
`padded`: the batch as matched) and `stream.vote` (`streams`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import api
from ..config import HpfwConfig
from ..match.scaled import TwoStageDB
from ..utils.profiling import trace
from .session import (StreamHypothesis, default_buckets, integrate_vote,
                      latency_percentiles)


class _StreamState:
    __slots__ = ("buf", "ring", "votes", "last", "best", "hit", "query")

    def __init__(self):
        self.buf = np.zeros(0, dtype=np.float32)
        self.ring = np.zeros((0, 2), dtype=np.uint32)
        self.votes: dict[str, float] = {}
        self.last: dict[str, tuple[int, int]] = {}
        self.best: StreamHypothesis | None = None
        self.hit: tuple[str, int, int] | None = None    # the last match's top hit
        self.query: np.ndarray | None = None            # the prints it matched


class StreamingPool:
    """Up to `capacity` concurrent StreamingSession-equivalent streams,
    batched per tick. add_stream()/remove_stream() manage slots; feed()
    takes {stream_id: pcm chunk} and returns {stream_id: hypothesis}.
    Extraction runs on the database's device."""

    def __init__(self, db, filters, cfg: HpfwConfig | None = None, *,
                 capacity: int = 8, query_prints: int = 128,
                 chunk_prints: int = 32, vote_decay: float = 0.8,
                 vote_floor: float = 0.55, query_buckets: tuple | None = None):
        self.db = db
        self.cfg = cfg if cfg is not None else getattr(db, "cfg", None) or db.db.cfg
        c = self.cfg
        self.capacity = capacity
        self.chunk_prints = chunk_prints
        self.query_prints = query_prints
        self.vote_decay = vote_decay
        self.vote_floor = vote_floor
        if query_buckets is None:
            query_buckets = default_buckets(chunk_prints, query_prints)
        self.query_buckets = tuple(sorted(set(query_buckets)))
        if self.query_buckets[-1] > query_prints:
            raise ValueError("query_buckets must fit within query_prints")
        halo = c.context_w + c.delta_lag - 1
        self.frames_per_step = chunk_prints + halo
        self.window_samples = c.frame_len + (self.frames_per_step - 1) * c.hop
        self.step_samples = chunk_prints * c.hop
        self.device = db.device
        self._filters = api._filters_on(filters, c, self.device)
        self._streams: dict[str, _StreamState] = {}
        self.match_latencies_ms: list[float] = []
        self.tick_latencies_ms: list[float] = []

    # -- stream management --------------------------------------------------

    def add_stream(self, sid: str) -> None:
        if sid in self._streams:
            raise ValueError(f"stream {sid!r} already exists")
        if len(self._streams) >= self.capacity:
            raise ValueError("pool at capacity")
        self._streams[sid] = _StreamState()

    def remove_stream(self, sid: str) -> None:
        self._streams.pop(sid, None)

    @property
    def stream_ids(self):
        return list(self._streams)

    def last_hit(self, sid: str) -> tuple[str, int, int] | None:
        """(track_id, score, offset) of the stream's most recent match's top
        hit, the one its vote took; None before its first match."""
        return self._streams[sid].hit

    def query(self, sid: str) -> np.ndarray | None:
        """A copy of the (n, 2) uint32 prints of the ring the stream's most
        recent match queried; None before its first match."""
        q = self._streams[sid].query
        return None if q is None else q.copy()

    # -- the tick -----------------------------------------------------------

    def feed(self, chunks: dict[str, np.ndarray]) -> dict:
        """Append audio per stream, run the batched extractions the buffers
        allow and at most one batched match per bucket; return {sid:
        StreamHypothesis or None}."""
        t0 = time.perf_counter()
        with trace("stream.feed", streams=len(chunks)) as span:
            unknown = [sid for sid in chunks if sid not in self._streams]
            if unknown:
                raise ValueError(
                    f"unknown stream ids {unknown!r}; add_stream() them first "
                    f"(live: {sorted(self._streams)!r})")
            for sid, pcm in chunks.items():
                st = self._streams[sid]
                st.buf = np.concatenate([st.buf, np.asarray(pcm, dtype=np.float32).reshape(-1)])
            # Drain every full window (batched extraction) so slow feeders cannot
            # stall fast ones, then match at most once per feed call: one vote per
            # feed, as a lone StreamingSession casts.
            advanced: set = set()
            while True:
                ready = [sid for sid, st in self._streams.items()
                         if st.buf.shape[0] >= self.window_samples]
                if not ready:
                    break
                self._extract_tick(ready)
                advanced.update(ready)
            span.attrs["ready"] = len(advanced)
            if advanced:
                self._match_tick(sorted(advanced))
                self.tick_latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return {sid: st.best for sid, st in self._streams.items()}

    def _extract_tick(self, ready: list) -> None:
        """One batched extraction over the ready streams' windows."""
        with trace("stream.extract", rows=len(ready)):
            windows = np.stack([self._streams[sid].buf[:self.window_samples] for sid in ready])
            prints = api._to_numpy_prints(api.fingerprint_batch_device(
                torch.from_numpy(windows).to(self.device), self._filters, self.cfg))
            for slot, sid in enumerate(ready):
                st = self._streams[sid]
                st.ring = np.concatenate([st.ring, prints[slot, :self.chunk_prints]])
                st.ring = st.ring[-self.query_prints:]
                st.buf = st.buf[self.step_samples:]

    def _match_tick(self, ready: list) -> None:
        """Group matchable streams by query bucket; one batched match per group."""
        groups: dict[int, list] = {}
        for sid in ready:
            fits = [b for b in self.query_buckets if b <= self._streams[sid].ring.shape[0]]
            if fits:
                groups.setdefault(max(fits), []).append(sid)
        for bucket, sids in sorted(groups.items()):
            queries = np.stack([self._streams[s].ring[-bucket:] for s in sids])
            t0 = time.perf_counter()
            results = self._match_batch(queries)
            self.match_latencies_ms.append((time.perf_counter() - t0) * 1e3)
            with trace("stream.vote", streams=len(sids)):
                for sid, query, (ids, scores, offs) in zip(sids, queries, results):
                    st = self._streams[sid]
                    st.query, st.hit = query, None
                    if len(ids):
                        st.hit = (ids[0], int(scores[0]), int(offs[0]))
                        st.best = integrate_vote(st.votes, st.last, ids, scores, offs,
                                                 bucket, decay=self.vote_decay,
                                                 floor=self.vote_floor)

    def _match_batch(self, queries: np.ndarray):
        n = queries.shape[0]
        with trace("stream.match", bucket=queries.shape[1], rows=n, padded=n) as span:
            if isinstance(self.db, TwoStageDB):
                # Padded to capacity with the first query, so every bucket has
                # one batch shape; the pad rows are discarded.
                if n < self.capacity:
                    pad = np.broadcast_to(queries[:1], (self.capacity - n,) + queries.shape[1:])
                    queries = np.concatenate([queries, pad])
                    span.attrs["padded"] = self.capacity
                return self.db.match_batch(queries, top_k=1)[:n]
            # A ShardedDB's own match or a dense FingerprintDB's scan: each
            # query alone, no padding.
            if hasattr(self.db, "match"):
                return [self.db.match(q, top_k=1) for q in queries]
            return [api.match(q, self.db, top_k=1) for q in queries]

    def latency_stats(self) -> dict:
        return dict(latency_percentiles(match=self.match_latencies_ms,
                                        tick=self.tick_latencies_ms),
                    n_matches=len(self.match_latencies_ms))
