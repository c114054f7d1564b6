"""Deterministic synthetic audio fixtures (numpy only).

Copies of hpfw_tpu/io/synth.py's synth_track, synth_catalog and make_query,
so that the port can make structured test audio where jax is absent (white
noise gives hashprints no spectro-temporal structure to lock on to).
tests/test_torch_config.py pins each copy to its original, bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..config import HpfwConfig


def synth_track(
    seed: int,
    duration_s: float,
    cfg: HpfwConfig,
    *,
    n_partials: int = 6,
    noise_db: float = -30.0,
) -> np.ndarray:
    """One synthetic 'song': slowly-evolving tone stack + chirps + noise.

    float32 mono PCM in [-1, 1] at cfg.sample_rate.
    """
    rng = np.random.default_rng(seed)
    sr = cfg.sample_rate
    n = int(round(duration_s * sr))
    t = np.arange(n, dtype=np.float64) / sr
    out = np.zeros(n, dtype=np.float64)

    # Note-like partials: random pitches from a chromatic grid, each with a
    # random onset/length envelope and gentle vibrato.
    for _ in range(n_partials):
        pitch = cfg.fmin * 2.0 ** (rng.integers(0, 5 * 12) / 12.0)
        vib = 1.0 + 0.002 * np.sin(2 * np.pi * rng.uniform(3, 7) * t + rng.uniform(0, 2 * np.pi))
        onset = rng.uniform(0.0, 0.5) * duration_s
        length = rng.uniform(0.3, 1.0) * duration_s
        env = np.clip((t - onset) / 0.05, 0.0, 1.0) * np.clip((onset + length - t) / 0.2, 0.0, 1.0)
        amp = rng.uniform(0.1, 0.5)
        out += amp * env * np.sin(2 * np.pi * pitch * vib * t + rng.uniform(0, 2 * np.pi))

    # One slow chirp sweeping through the CQT range.
    f0 = cfg.fmin * 2.0 ** rng.uniform(0, 2)
    f1 = f0 * 2.0 ** rng.uniform(1, 3)
    sweep = f0 * (f1 / f0) ** (t / max(duration_s, 1e-9))
    phase = 2 * np.pi * np.cumsum(sweep) / sr
    out += 0.2 * np.sin(phase)

    # Broadband noise floor.
    noise_amp = 10.0 ** (noise_db / 20.0)
    out += noise_amp * rng.standard_normal(n)

    peak = np.max(np.abs(out))
    if peak > 0:
        out = 0.9 * out / peak
    return out.astype(np.float32)


def synth_catalog(n_tracks: int, duration_s: float, cfg: HpfwConfig, *, base_seed: int = 1000):
    """List of n_tracks deterministic synthetic tracks."""
    return [synth_track(base_seed + i, duration_s, cfg) for i in range(n_tracks)]


def make_query(
    track: np.ndarray,
    start_s: float,
    duration_s: float,
    cfg: HpfwConfig,
    *,
    noise_db: float | None = None,
    seed: int = 0,
    gain: float = 1.0,
) -> np.ndarray:
    """Excerpt a query clip from a track, optionally degraded by seeded noise."""
    sr = cfg.sample_rate
    a = int(round(start_s * sr))
    b = a + int(round(duration_s * sr))
    clip = np.array(track[a:b], dtype=np.float64) * gain
    if noise_db is not None:
        rng = np.random.default_rng(seed)
        rms = np.sqrt(np.mean(clip ** 2)) + 1e-12
        noise = rng.standard_normal(clip.shape[0])
        noise *= rms * 10.0 ** (noise_db / 20.0) / (np.sqrt(np.mean(noise ** 2)) + 1e-12)
        clip = clip + noise
    peak = np.max(np.abs(clip))
    if peak > 1.0:
        clip = clip / peak
    return clip.astype(np.float32)
