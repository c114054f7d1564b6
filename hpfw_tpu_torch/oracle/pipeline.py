"""Pure-NumPy float64 oracle for the hashprint pipeline: a copy.

A copy of hpfw_tpu/oracle/pipeline.py (the package cannot import hpfw_tpu,
whose import pulls in jax). It is the port's one home of the oracle's
functions at run time: ops/frontend.py takes cqt_kernel_matrix from it,
filters.py fix_eigenvector_signs, io/native.py the uint64 packing, and the
CLI's selfcheck the float64 fingerprint. tests/test_torch_config.py pins
every function to its original.

Pipeline:
  PCM -> framed NDFT CQT -> log magnitude -> context windows -> projection
      -> delta over lag T -> sign -> packed 64-bit hashprints.
"""

from __future__ import annotations

import numpy as np

from ..config import HpfwConfig


# ---------------------------------------------------------------------------
# CQT kernel matrix
# ---------------------------------------------------------------------------

def cqt_kernel_matrix(cfg: HpfwConfig) -> np.ndarray:
    """Dense complex NDFT kernel, shape (frame_len, n_bins).

    CQT expressed as a single GEMM (the "GEMM-native NDFT" formulation,
    PAPERS.md: MelT): spectrogram = |frames @ K|. Bin k's kernel is a
    window-weighted complex exponential of per-bin length
    N_k = ceil(Q * sr / f_k), centered inside the frame and normalized by N_k.
    """
    cfg.validate()
    K = np.zeros((cfg.frame_len, cfg.n_bins), dtype=np.complex128)
    q = cfg.q_factor
    for k in range(cfg.n_bins):
        f_k = cfg.bin_frequency(k)
        n_k = int(np.ceil(q * cfg.sample_rate / f_k))
        n = np.arange(n_k, dtype=np.float64)
        if cfg.window == "hann":
            win = 0.5 - 0.5 * np.cos(2.0 * np.pi * (n + 0.5) / n_k)
        else:  # hamming
            win = 0.54 - 0.46 * np.cos(2.0 * np.pi * (n + 0.5) / n_k)
        phase = np.exp(-2j * np.pi * f_k * n / cfg.sample_rate)
        offset = (cfg.frame_len - n_k) // 2
        K[offset:offset + n_k, k] = win * phase / n_k
    return K


def frame_signal(pcm: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """Slice PCM into overlapping frames, shape (n_frames, frame_len).

    Frame t covers samples [t*hop, t*hop + frame_len). No padding: only
    complete frames are emitted (cfg.n_frames defines the count).
    """
    pcm = np.asarray(pcm, dtype=np.float64).reshape(-1)
    f = cfg.n_frames(pcm.shape[0])
    if f == 0:
        return np.zeros((0, cfg.frame_len), dtype=np.float64)
    idx = np.arange(cfg.frame_len)[None, :] + cfg.hop * np.arange(f)[:, None]
    return pcm[idx]


def cqt(pcm: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """Log-magnitude CQT spectrogram, shape (n_frames, n_bins), float64."""
    frames = frame_signal(pcm, cfg)
    K = cqt_kernel_matrix(cfg)
    spec = np.abs(frames @ K)
    return np.log(cfg.log_eps + spec)


# ---------------------------------------------------------------------------
# Context windows + projection + binarization
# ---------------------------------------------------------------------------

def context_windows(spec: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """Stack w consecutive CQT frames, shape (F-w+1, w*n_bins).

    Layout is time-major: [frame n bins..., frame n+1 bins..., ...]. The
    learned filters use the same layout (context_dim = n_bins * context_w).
    """
    f, b = spec.shape
    w = cfg.context_w
    m = f - w + 1
    if m <= 0:
        return np.zeros((0, cfg.context_dim), dtype=spec.dtype)
    out = np.empty((m, w * b), dtype=spec.dtype)
    for j in range(w):
        out[:, j * b:(j + 1) * b] = spec[j:j + m]
    return out


def features(spec: np.ndarray, filters: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """Project context windows onto filters: y(n) = F^T x(n), shape (M, 64)."""
    x = context_windows(spec, cfg)
    return x @ np.asarray(filters, dtype=np.float64)


def deltas(y: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """d_i(n) = y_i(n) - y_i(n+T); shape (M-T, 64)."""
    t = cfg.delta_lag
    return y[:-t] - y[t:]


def binarize(d: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """Sign threshold -> boolean bits, shape (M-T, 64)."""
    if cfg.tie_break == "gt":
        return d > 0.0
    return d >= 0.0


def pack_bits(bits: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """Pack 64 boolean bits per row into two uint32 words, shape (N, 2).

    bit_order 'lsb0': filter i -> bit (i % 32) of word (i // 32). word 0
    holds filters 0..31. The uint64 view is word0 | (word1 << 32).
    TPU has no native uint64, so the packed uint32 pair is the canonical
    storage format everywhere in this framework.
    """
    bits = np.asarray(bits, dtype=np.uint32)
    n = bits.shape[0]
    out = np.zeros((n, 2), dtype=np.uint32)
    if cfg.bit_order == "lsb0":
        order = np.arange(64)
    else:  # msb0: filter 0 -> MSB of word 0
        order = 63 - np.arange(64)
    for i in range(64):
        pos = order[i]
        out[:, pos // 32] |= bits[:, i] << np.uint32(pos % 32)
    return out


def packed_to_uint64(packed: np.ndarray) -> np.ndarray:
    """(N, 2) uint32 -> (N,) uint64 convenience view for host-side users."""
    p = np.asarray(packed, dtype=np.uint64)
    return p[:, 0] | (p[:, 1] << np.uint64(32))


def uint64_to_packed(h: np.ndarray) -> np.ndarray:
    h = np.asarray(h, dtype=np.uint64)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (h >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=1)


def fingerprint(pcm: np.ndarray, filters: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """Full oracle pipeline: PCM -> packed hashprints, shape (N, 2) uint32."""
    spec = cqt(pcm, cfg)
    y = features(spec, filters, cfg)
    d = deltas(y, cfg)
    return pack_bits(binarize(d, cfg), cfg)


def delta_margins(pcm: np.ndarray, filters: np.ndarray, cfg: HpfwConfig) -> np.ndarray:
    """|delta| per bit, shape (N, 64) — the bit-flip safety margin.

    Used by the tolerance-audit tests (SURVEY.md §7.4.1): a float32 TPU
    pipeline may legitimately flip bits whose float64 margin is ~0; the audit
    exempts those and requires exactness everywhere else.
    """
    spec = cqt(pcm, cfg)
    y = features(spec, filters, cfg)
    return np.abs(deltas(y, cfg))


# ---------------------------------------------------------------------------
# Filter learning (PCA of context windows)
# ---------------------------------------------------------------------------

def learn_filters(corpus: list[np.ndarray], cfg: HpfwConfig) -> np.ndarray:
    """Top-64 eigenvectors of the context-vector covariance, (context_dim, 64).

    Columns are ordered by descending eigenvalue. Sign convention: the
    maximum-|value| component of each eigenvector is made positive, so the
    learned filters are deterministic across LAPACK/backends up to that
    convention.
    """
    d = cfg.context_dim
    cov = np.zeros((d, d), dtype=np.float64)
    mean = np.zeros(d, dtype=np.float64)
    count = 0
    for pcm in corpus:
        x = context_windows(cqt(pcm, cfg), cfg)
        if x.shape[0] == 0:
            continue
        cov += x.T @ x
        mean += x.sum(axis=0)
        count += x.shape[0]
    if count == 0:
        raise ValueError("corpus produced no context windows")
    mean /= count
    cov = cov / count - np.outer(mean, mean)
    evals, evecs = np.linalg.eigh(cov)
    top = evecs[:, ::-1][:, : cfg.n_filters]
    return fix_eigenvector_signs(top)


def fix_eigenvector_signs(filters: np.ndarray) -> np.ndarray:
    """Deterministic sign convention: max-|value| component positive."""
    filters = np.array(filters, copy=True)
    idx = np.argmax(np.abs(filters), axis=0)
    signs = np.sign(filters[idx, np.arange(filters.shape[1])])
    signs[signs == 0] = 1.0
    return filters * signs


# ---------------------------------------------------------------------------
# Matching (XOR + popcount Hamming scan)
# ---------------------------------------------------------------------------

def hamming_similarity(q: np.ndarray, d: np.ndarray) -> int:
    """Sum over aligned prints of (64 - popcount(q XOR d)); packed inputs."""
    x = np.bitwise_xor(np.asarray(q, np.uint32), np.asarray(d, np.uint32))
    pop = np.bitwise_count(x).astype(np.int64).sum()
    return int(64 * q.shape[0] - pop)


def match_track(query: np.ndarray, track: np.ndarray) -> tuple[int, int]:
    """Best (score, offset) of query against one track's print sequence.

    Scans every alignment offset o in [0, len(track) - len(query)]; if the
    track is shorter than the query, offset 0 with truncated query is used
    (partial overlap at the head only — matches the dense TPU matcher).
    """
    nq, nt = query.shape[0], track.shape[0]
    if nt >= nq:
        best_s, best_o = -1, 0
        for o in range(nt - nq + 1):
            s = hamming_similarity(query, track[o:o + nq])
            if s > best_s:
                best_s, best_o = s, o
        return best_s, best_o
    return hamming_similarity(query[:nt], track), 0


def match(query: np.ndarray, tracks: list[np.ndarray], top_k: int = 10):
    """Rank tracks by best-offset Hamming similarity.

    Returns (indices, scores, offsets) sorted by descending score; ties break
    by ascending track index (stable, mirrored by the TPU matcher).
    """
    scored = [match_track(query, t) for t in tracks]
    scores = np.array([s for s, _ in scored], dtype=np.int64)
    offsets = np.array([o for _, o in scored], dtype=np.int64)
    order = np.lexsort((np.arange(len(tracks)), -scores))[:top_k]
    return order, scores[order], offsets[order]
