"""Plain extraction: PCM -> log-magnitude CQT -> packed 64-bit hashprints.

The hashprint method (Tsai, Praetzlich & Mueller) as the configuration
states it, in float32 on the run's device: framing; one GEMM of the frames
by the NDFT CQT basis (computed here in float64 from the configuration and
rounded once); log(log_eps + |X|); context vectors of context_w frames,
time-major; projection onto the filters; deltas over delta_lag; a bit is
d > 0 (tie_break "gt"), filter i to bit i % 32 of word i // 32 (lsb0).
Every float32 product runs with TF32 off, unless a caller asks for TF32
(the control of the comparison).

Also the rendition scan's variants: the spectrum re-timed by a tempo factor
s (catalog frame i <- rendition frame i / s, linear between frames, clamped)
and re-keyed by a bin roll r (catalog bin k <- bin k + r, edge-clamped).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in TF32 (tf32) or in full float32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def cqt_basis(p: dict) -> np.ndarray:
    """(frame_len, 2 * n_bins) float32 [Re | Im] of the NDFT CQT kernel: bin k
    a window of N_k = ceil(Q sr / f_k) samples, centred in the frame, times
    exp(-2 pi i f_k n / sr) / N_k, with Q = 1 / (2^(1/bpo) - 1)."""
    q = 1.0 / (2.0 ** (1.0 / p["bins_per_octave"]) - 1.0)
    k = np.zeros((p["frame_len"], p["n_bins"]), np.complex128)
    for b in range(p["n_bins"]):
        f = p["fmin"] * 2.0 ** (b / p["bins_per_octave"])
        n_k = int(np.ceil(q * p["sample_rate"] / f))
        n = np.arange(n_k, dtype=np.float64)
        a, c = (0.5, 0.5) if p["window"] == "hann" else (0.54, 0.46)
        win = a - c * np.cos(2.0 * np.pi * (n + 0.5) / n_k)
        off = (p["frame_len"] - n_k) // 2
        k[off:off + n_k, b] = win * np.exp(-2j * np.pi * f * n / p["sample_rate"]) / n_k
    return np.concatenate([k.real, k.imag], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _basis_on(key: str, device: torch.device) -> torch.Tensor:
    import json

    return torch.from_numpy(cqt_basis(json.loads(key))).to(device)


def basis(p: dict, device) -> torch.Tensor:
    import json

    return _basis_on(json.dumps(p, sort_keys=True), torch.device(device))


def n_frames(p: dict, n_samples: int) -> int:
    return 0 if n_samples < p["frame_len"] else 1 + (n_samples - p["frame_len"]) // p["hop"]


def n_prints(p: dict, n_samples: int) -> int:
    return max(0, n_frames(p, n_samples) - p["context_w"] + 1 - p["delta_lag"])


def spectrum(pcm: torch.Tensor, p: dict) -> torch.Tensor:
    """(S,) float32 PCM -> (F, n_bins) float32 log-magnitude CQT."""
    frames = pcm.unfold(0, p["frame_len"], p["hop"])
    reim = frames @ basis(p, pcm.device)
    nb = p["n_bins"]
    return torch.log(p["log_eps"] + torch.sqrt(reim[:, :nb] ** 2 + reim[:, nb:] ** 2))


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(N, 64) bool, filter i -> bit i % 32 of word i // 32 -> (N, 2) int32."""
    w = torch.bitwise_left_shift(torch.ones(32, dtype=torch.int64, device=bits.device),
                                 torch.arange(32, device=bits.device))
    words = (bits.reshape(-1, 2, 32).to(torch.int64) * w).sum(dim=2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def encode(spec: torch.Tensor, filters: torch.Tensor, p: dict) -> torch.Tensor:
    """(F, n_bins) spectrum -> (F - context_w + 1 - delta_lag, 2) int32 prints."""
    w, lag = p["context_w"], p["delta_lag"]
    f, nb = spec.shape
    ctx = spec.unfold(0, w, 1).transpose(1, 2).reshape(f - w + 1, w * nb)
    y = ctx @ filters
    d = y[:-lag] - y[lag:]
    return pack(d > 0.0 if p["tie_break"] == "gt" else d >= 0.0)


def prints(pcm: torch.Tensor, filters: torch.Tensor, p: dict) -> torch.Tensor:
    """(S,) PCM -> (N, 2) int32 hashprints."""
    return encode(spectrum(pcm, p), filters, p)


def hypotheses(span: float, step: float, pitch_bins: int) -> list[tuple[float, int]]:
    """The scan's (tempo factor, bin roll) grid, rolls-major, identity in the middle."""
    k = int(round(span / step))
    factors = [round(1.0 + i * step, 6) for i in range(-k, k + 1)] if span > 0 else [1.0]
    return [(float(s), int(r)) for r in range(-pitch_bins, pitch_bins + 1) for s in factors]


def scan_spectra(spec: torch.Tensor, hyps) -> torch.Tensor:
    """(F, nb) spectrum -> (V, F, nb): each hypothesis's re-timed, re-keyed copy."""
    f, nb = spec.shape
    dev = spec.device
    table = torch.tensor(hyps, dtype=torch.float32).to(dev)
    pos = (torch.arange(f, dtype=torch.float32, device=dev)[None] / table[:, :1]).clamp(0.0, f - 1.0)
    cols = (torch.arange(nb, device=dev)[None] + table[:, 1:].long()).clamp(0, nb - 1)[:, None]
    i0 = pos.floor().long()
    i1 = (i0 + 1).clamp(max=f - 1)
    frac = (pos - i0.to(torch.float32))[..., None]
    return spec[i0[..., None], cols] * (1.0 - frac) + spec[i1[..., None], cols] * frac


def scan_prints(pcm: torch.Tensor, filters: torch.Tensor, p: dict, hyps) -> torch.Tensor:
    """(S,) PCM -> (V, N, 2) int32: the prints of every hypothesis."""
    return torch.stack([encode(s, filters, p) for s in scan_spectra(spectrum(pcm, p), hyps)])
