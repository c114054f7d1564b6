"""Query-side tempo and pitch hypothesis grids (NumPy only).

A copy of stretch_grid, pitch_grid, hypothesis_grid and print_variants from
hpfw_tpu/match/stretch.py, which the port cannot import (importing any part
of hpfw_tpu imports jax). tests/test_torch_scaled.py pins the copy
bit-identical to the original. TwoStageDB.match and match_batch re-time the
query with print_variants when a tempo scan is asked for (stretch_span > 0).
"""

from __future__ import annotations

import numpy as np


def stretch_grid(span: float = 0.03, step: float = 0.01) -> list[float]:
    """Symmetric tempo-hypothesis grid: 1±span in `step` increments.

    The identity hypothesis 1.0 is always the center element, so an
    undistorted query scores identically to a scan-free match on that
    variant (the scan can only add competing hypotheses, measured to cost
    <=1 top-1 point at 400 tracks — stretch_study s=1.0 grid column).
    """
    k = int(round(span / step))
    return [round(1.0 + i * step, 6) for i in range(-k, k + 1)]


def pitch_grid(span_bins: int) -> list[int]:
    """Symmetric pitch-hypothesis grid: CQT bin rolls -span..+span.

    At 24 bins/octave one bin = 0.5 semitone, so span_bins=2 covers the
    ±1 st live-key range (BASELINE.json:11 names pitch-shift; the r4
    measurement put the unmitigated hole at 16-24 points of top-1 at
    250k). Roll +r hypothesizes the query is performed r bins HIGH:
    content at catalog bin k sits at query bin k+r, so re-keying gathers
    query bin k+r back to catalog bin k. 0 (the identity key) is always
    the center element.
    """
    return list(range(-int(span_bins), int(span_bins) + 1))


def hypothesis_grid(factors, rolls) -> list[tuple[float, int]]:
    """Product grid of (tempo factor, pitch roll) hypotheses.

    Ordered rolls-major so that with both axes centered (stretch_grid,
    pitch_grid) the combined identity hypothesis (1.0, 0) sits at index
    V//2 — the same center-row invariant the tempo-only scan's callers
    rely on (the identity row of a scan stack is bit-exact plain
    extraction).
    """
    return [(float(s), int(r)) for r in rolls for s in factors]


def print_variants(qprints: np.ndarray, factors) -> np.ndarray:
    """Re-time packed query prints at each hypothesized tempo factor.

    qprints: (N, 2) uint32 or batched (B, N, 2).
    factors: iterable of tempo hypotheses s_h (1.0 = as-is).
    Returns (B, V, N, 2) (B=1 for the unbatched form) — variant v at
    catalog-tempo frame i gathers query frame round(i / s_h), clamped; a
    slower-than-catalog hypothesis (s_h < 1) duplicates the final
    (1 - s_h) fraction of frames at the tail, which scores as a few
    percent of neutral bits rather than corrupting the alignment.
    """
    q = np.asarray(qprints, dtype=np.uint32)
    if q.ndim == 2:
        q = q[None]
    n = q.shape[1]
    base = np.arange(n, dtype=np.float64)
    idx = np.stack([np.clip(np.round(base / s).astype(np.int64), 0, n - 1)
                    for s in factors])                    # (V, N)
    return q[:, idx]                                      # (B, V, N, 2)
