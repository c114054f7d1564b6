"""Streaming live-song identification, one stream (BASELINE config 3).

Counterpart of hpfw_tpu/streaming/session.py:

- ChunkedExtractor turns each new audio chunk into hashprints, carrying a
  (context_w + delta_lag - 1)-frame halo so that chunked extraction is
  bit-identical to whole-track extraction. Its step is K1 then K2 on one PCM
  window (ops/frontend.py, ops/fingerprint.py) on the filters' device.
- StreamingSession keeps a ring of recent prints as the sliding query,
  matches it against a FingerprintDB (dense) or a TwoStageDB (catalog
  scale) after every print chunk, integrates each window's top hit into a
  decayed vote tally, and records per-step latencies for p50/p99.

Only the rigid path is ported: the tempo and pitch scans (spec_scan, or a
config with stretch_span > 0 or pitch_span_bins > 0) need api.scan_from_spec
and scan_hypotheses, which are not ported yet (ROADMAP A8), and raise.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from .. import api
from ..config import HpfwConfig
from ..ops import fingerprint as fp_ops
from ..ops import frontend


def default_buckets(chunk_prints: int, query_prints: int) -> tuple:
    """Powers of two from max(16, chunk_prints) below query_prints, then
    query_prints: the progressive query lengths of a stream's ring."""
    buckets = []
    b = max(16, chunk_prints)
    while b < query_prints:
        buckets.append(b)
        b *= 2
    buckets.append(query_prints)
    return tuple(buckets)


class ChunkedExtractor:
    """Bit-identical chunked hashprint extraction with halo overlap.

    Emits `chunk_prints` hashprints per step. A step consumes the PCM window
    covering CQT frames [t, t + chunk_prints + halo) where halo = context_w +
    delta_lag - 1; consecutive windows overlap by halo frames worth of
    samples plus (frame_len - hop). Work runs on `device`, else the filters
    tensor's device, else the card when torch sees one.
    """

    def __init__(self, filters, cfg: HpfwConfig, chunk_prints: int = 32, *,
                 frame_ring: int = 0, device: str | torch.device | None = None):
        self.cfg = cfg
        self.chunk_prints = chunk_prints
        self.halo_frames = cfg.context_w + cfg.delta_lag - 1
        self.frames_per_step = chunk_prints + self.halo_frames
        # PCM samples needed to produce frames_per_step frames:
        self.window_samples = cfg.frame_len + (self.frames_per_step - 1) * cfg.hop
        # New samples consumed per step:
        self.step_samples = chunk_prints * cfg.hop
        self.device = api._resolve_device(device, filters)
        self._filters = api._filters_on(filters, cfg, self.device)
        # frame_ring > 0: also retain the most recent `frame_ring` log-mag CQT
        # frames (print i of the print ring was built from frames [i, i + halo]).
        self.frame_ring: deque | None = deque(maxlen=frame_ring) if frame_ring else None
        self._buf = np.zeros(0, dtype=np.float32)

    def _step(self, window: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        spec = frontend.cqt(torch.from_numpy(window).to(self.device), self.cfg)
        return fp_ops.fingerprint_from_spec(spec, self._filters, self.cfg), spec

    def feed(self, pcm: np.ndarray) -> np.ndarray:
        """Append audio; return newly available hashprints (k*chunk, 2) uint32."""
        pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, pcm])
        out = []
        while self._buf.shape[0] >= self.window_samples:
            prints, spec = self._step(np.ascontiguousarray(self._buf[:self.window_samples]))
            out.append(api._to_numpy_prints(prints[:self.chunk_prints]))
            if self.frame_ring is not None:
                # The window's first halo frames re-derive the previous
                # window's halo tail, so drop that tail and append the whole
                # window: ring[-(n + halo):] are the frames of the last n prints.
                for _ in range(min(self.halo_frames, len(self.frame_ring))):
                    self.frame_ring.pop()
                self.frame_ring.extend(spec.cpu().numpy())
            self._buf = self._buf[self.step_samples:]
        if out:
            return np.concatenate(out, axis=0)
        return np.zeros((0, 2), dtype=np.uint32)


class StreamHypothesis(NamedTuple):
    """The session's current best guess. confidence is the normalized vote
    margin (top tally minus runner-up, over top) in [0, 1] — 1.0 when no
    other track has ever won a window."""

    track_id: str
    score: int
    offset: int
    confidence: float


def integrate_vote(votes: dict, last: dict, ids, scores, offs, n: int, *,
                   decay: float, floor: float) -> StreamHypothesis:
    """Cast one window's top hit into a decayed vote tally and return the
    integrated hypothesis. The vote is the score's excess over floor * 64 * n
    (the imposter ceiling), so sub-floor windows add nothing."""
    for k in votes:
        votes[k] *= decay
    excess = max(0.0, float(scores[0]) - floor * 64.0 * n)
    votes[ids[0]] = votes.get(ids[0], 0.0) + excess
    last[ids[0]] = (int(scores[0]), int(offs[0]))
    ranked = sorted(votes.items(), key=lambda kv: -kv[1])
    top, v_top = ranked[0]
    if v_top > 0:
        v_second = ranked[1][1] if len(ranked) > 1 else 0.0
        return StreamHypothesis(top, *last[top], (v_top - v_second) / v_top)
    # No window has cleared the imposter floor yet: the instantaneous best
    # with zero confidence.
    return StreamHypothesis(ids[0], int(scores[0]), int(offs[0]), 0.0)


def latency_percentiles(**series) -> dict:
    """{name_p50_ms, name_p99_ms} for each named list of milliseconds."""
    out = {}
    for name, xs in series.items():
        for p in (50, 99):
            out[f"{name}_p{p}_ms"] = float(np.percentile(xs, p)) if xs else float("nan")
    return out


class StreamingSession:
    """Continuous live-song ID over an audio stream, on the rigid path.

    feed() audio in arbitrary-size chunks; after each print-chunk boundary
    the sliding query is matched against the database and the running best
    hypothesis updates. The query ring grows progressively through
    `query_buckets` (default powers of two from chunk_prints up to
    query_prints): matching starts as soon as the smallest bucket fills,
    with the largest filled bucket as the query. Match latency and
    end-to-end step latency are recorded for p50/p99 reporting. Extraction
    runs on the database's device.
    """

    def __init__(self, db, filters, cfg: HpfwConfig | None = None, *,
                 query_prints: int = 128, chunk_prints: int = 32,
                 match_every: int = 1, vote_decay: float = 0.8,
                 query_buckets: tuple | None = None, vote_floor: float = 0.55,
                 spec_scan: bool | None = None):
        self.db = db                      # FingerprintDB or TwoStageDB
        self.cfg = cfg if cfg is not None else getattr(db, "cfg", None) or db.db.cfg
        if spec_scan or self.cfg.stretch_span > 0.0 or self.cfg.pitch_span_bins > 0:
            raise NotImplementedError(
                "the streaming tempo/pitch scan (spec_scan, stretch_span, "
                "pitch_span_bins) needs api.scan_from_spec, not ported yet (ROADMAP A8)")
        self.extractor = ChunkedExtractor(filters, self.cfg, chunk_prints, device=db.device)
        self.query_prints = query_prints
        self.match_every = match_every
        self.vote_decay = vote_decay
        self.vote_floor = vote_floor
        if query_buckets is None:
            query_buckets = default_buckets(chunk_prints, query_prints)
        self.query_buckets = tuple(sorted(set(query_buckets)))
        if self.query_buckets[-1] > query_prints:
            raise ValueError("query_buckets must fit within query_prints")
        self._votes: dict[str, float] = {}
        self._last: dict[str, tuple[int, int]] = {}   # id -> (score, offset)
        self._ring: deque = deque(maxlen=query_prints)
        self._chunks_seen = 0
        self.match_latencies_ms: list[float] = []
        self.step_latencies_ms: list[float] = []
        self.last_match: tuple[str, int, int] | None = None  # instantaneous
        self.current_best: StreamHypothesis | None = None   # integrated

    def _match_window(self):
        n = max(b for b in self.query_buckets if b <= len(self._ring))
        q = np.array(self._ring, dtype=np.uint32)[-n:]
        t0 = time.perf_counter()
        if hasattr(self.db, "match"):     # TwoStageDB
            ids, scores, offs = self.db.match(q, top_k=1)
        else:                             # dense FingerprintDB
            ids, scores, offs = api.match(q, self.db, top_k=1)
        self.match_latencies_ms.append((time.perf_counter() - t0) * 1e3)
        if len(ids):
            self.last_match = (ids[0], int(scores[0]), int(offs[0]))
            self.current_best = integrate_vote(
                self._votes, self._last, ids, scores, offs, q.shape[0],
                decay=self.vote_decay, floor=self.vote_floor)

    def feed(self, pcm: np.ndarray):
        """Stream in audio; returns the current StreamHypothesis (track_id,
        score, offset, confidence) or None before the first match."""
        t0 = time.perf_counter()
        new_prints = self.extractor.feed(pcm)
        if new_prints.shape[0]:
            self._ring.extend(new_prints)
            n_chunks = new_prints.shape[0] // self.extractor.chunk_prints
            for _ in range(max(n_chunks, 1)):
                self._chunks_seen += 1
                if (len(self._ring) >= self.query_buckets[0]
                        and self._chunks_seen % self.match_every == 0):
                    self._match_window()
                    break  # one match per feed call is enough
        self.step_latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return self.current_best

    def latency_stats(self) -> dict:
        return dict(latency_percentiles(match=self.match_latencies_ms,
                                        step=self.step_latencies_ms),
                    n_matches=len(self.match_latencies_ms))


def extract_chunked(pcm: np.ndarray, filters, cfg: HpfwConfig, *,
                    chunk_prints: int = 256,
                    device: str | torch.device | None = None) -> np.ndarray:
    """Whole-track extraction through the chunked path (unbounded length),
    bit-identical to api.fingerprint(pcm) on the same device."""
    ex = ChunkedExtractor(filters, cfg, chunk_prints, device=device)
    total = cfg.n_hashprints(np.asarray(pcm).shape[0])
    if total <= 0:
        return np.zeros((0, 2), dtype=np.uint32)
    # Pad the tail so the final partial chunk still fills a full window.
    pad = np.zeros(ex.window_samples, np.float32)
    return ex.feed(np.concatenate([np.asarray(pcm, np.float32), pad]))[:total]
