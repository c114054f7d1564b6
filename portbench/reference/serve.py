"""Plain live-ID answers: identity-first matching with a rendition scan.

Each query is extracted and matched as it is (rigid) and ranked top_k deep
(at least 2). The rigid answer is final (confident) when its top score is
at least hi_sim of the 64 n bits, or at least threshold with a relative
margin of `margin` over the runner-up. Otherwise the query escalates: the
prints of every (tempo, pitch) hypothesis of its spectrum are matched, all
their candidates ranked together, and that answer replaces the rigid one
when its top score beats the rigid top score by the relative `override`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import extract, matcher


def confident(scores, n: int, threshold: float, margin: float, hi_sim: float) -> bool:
    if not len(scores):
        return False
    s1 = float(scores[0])
    if s1 >= hi_sim * 64.0 * n:
        return True
    if s1 < threshold * 64.0 * n:
        return False
    s2 = float(scores[1]) if len(scores) > 1 else 0.0
    return (s1 - s2) / max(s1, 1e-9) >= margin


def near_gate(scores, n: int, threshold: float, margin: float, hi_sim: float,
              tol_bits: float) -> bool:
    """Whether a move of tol_bits in each of the rigid top two scores could
    change the gate's decision: the top score within tol_bits of the
    threshold or hi_sim bar, or the margin test within the sum of the moves."""
    if not len(scores):
        return False
    s1 = float(scores[0])
    s2 = float(scores[1]) if len(scores) > 1 else 0.0
    return (abs(s1 - hi_sim * 64.0 * n) <= tol_bits
            or abs(s1 - threshold * 64.0 * n) <= tol_bits
            or abs((1.0 - margin) * s1 - s2) <= (2.0 - margin) * tol_bits)


def overrides(scan_scores, rigid_scores, override: float) -> bool:
    if not len(scan_scores):
        return False
    rigid = float(rigid_scores[0]) if len(rigid_scores) else 0.0
    return float(scan_scores[0]) > (1.0 + override) * rigid


def answers(cat: matcher.Catalog, pcms: list, filters: torch.Tensor, p: dict, s: dict,
            n_real: int):
    """Reference answers of PCM queries: a list of (tracks, scores, offsets,
    escalated, variant prints (V, n, 2), the rigid answer's top two scores).
    p: extraction parameters; s: the server's gate, override, scan grid and
    top_k."""
    hyps = extract.hypotheses(s["span"], p["stretch_step"], s["pitch_span_bins"])
    k = max(2, s["top_k"])
    variants = [extract.scan_prints(x, filters, p, hyps) for x in pcms]
    rigid = torch.stack([v[len(hyps) // 2] for v in variants])        # the identity row
    n = rigid.shape[1]
    ranked = [matcher.rank(r[0], r[1], r[2], k, n_real) for r in cat.match(rigid)]
    esc = [not confident(x[1], n, s["threshold"], s["margin"], s["hi_sim"]) for x in ranked]
    rigid_top = [x[1][:2] for x in ranked]
    low = [i for i, e in enumerate(esc) if e]
    if low:
        stacks = cat.match(torch.cat([variants[i] for i in low]))       # (len(low) V, 3, K)
        for j, i in enumerate(low):
            v = np.moveaxis(stacks[j * len(hyps):(j + 1) * len(hyps)], 0, 1).reshape(3, -1)
            scanned = matcher.rank(v[0], v[1], v[2], k, n_real)         # a query's rows together
            if overrides(scanned[1], ranked[i][1], s["override"]):
                ranked[i] = scanned
    return [tuple(x[:s["top_k"]] for x in r) + (e, v, t)
            for r, e, v, t in zip(ranked, esc, variants, rigid_top)]
