"""Deterministic synthetic audio fixtures (numpy only).

Copies of hpfw_tpu/io/synth.py's synth_track, synth_catalog,
synth_artist_track, synth_artist_catalog, make_query and pitch_shift, so that
the port can make structured test audio, artist catalogs and renditions where
jax is absent (white noise gives hashprints no spectro-temporal structure to
lock on to). tests/test_torch_config.py pins each copy to its original, bit
for bit.
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


def synth_artist_track(
    artist_seed: int,
    track_seed: int,
    duration_s: float,
    cfg: HpfwConfig,
) -> np.ndarray:
    """A track in a persistent per-artist style (known-artist eval fixtures).

    The artist seed fixes a musical style — a scale (pitch-class subset),
    register, voice count, vibrato depth — shared by all of that artist's
    tracks, so per-artist context-window covariances genuinely differ and
    per-artist filter learning has signal to exploit (SURVEY.md §2.3 step 4).
    The track seed drives the per-track realization.
    """
    arng = np.random.default_rng(100003 * artist_seed + 17)
    scale = np.sort(arng.choice(12, size=arng.integers(5, 8), replace=False))
    octave_lo = int(arng.integers(0, 3))
    n_octaves = int(arng.integers(2, 4))
    n_partials = int(arng.integers(4, 10))
    vib_depth = float(arng.uniform(0.0005, 0.004))
    chirp_amp = float(arng.uniform(0.05, 0.3))

    rng = np.random.default_rng(1_000_000_007 * artist_seed + track_seed)
    sr = cfg.sample_rate
    n = int(round(duration_s * sr))
    t = np.arange(n, dtype=np.float64) / sr
    out = np.zeros(n, dtype=np.float64)
    for _ in range(n_partials):
        pc = int(rng.choice(scale))
        octave = octave_lo + int(rng.integers(0, n_octaves))
        pitch = cfg.fmin * 2.0 ** (octave + pc / 12.0)
        vib = 1.0 + vib_depth * np.sin(
            2 * np.pi * rng.uniform(3, 7) * t + rng.uniform(0, 2 * np.pi))
        onset = rng.uniform(0.0, 0.5) * duration_s
        length = rng.uniform(0.3, 1.0) * duration_s
        env = (np.clip((t - onset) / 0.05, 0.0, 1.0)
               * np.clip((onset + length - t) / 0.2, 0.0, 1.0))
        amp = rng.uniform(0.1, 0.5)
        out += amp * env * np.sin(2 * np.pi * pitch * vib * t + rng.uniform(0, 2 * np.pi))
    f0 = cfg.fmin * 2.0 ** (octave_lo + rng.uniform(0, 1))
    f1 = f0 * 2.0 ** rng.uniform(1, 2)
    sweep = f0 * (f1 / f0) ** (t / max(duration_s, 1e-9))
    out += chirp_amp * np.sin(2 * np.pi * np.cumsum(sweep) / sr)
    out += 10.0 ** (-30.0 / 20.0) * rng.standard_normal(n)
    peak = np.max(np.abs(out))
    if peak > 0:
        out = 0.9 * out / peak
    return out.astype(np.float32)


def synth_artist_catalog(artist_seed: int, n_tracks: int, duration_s: float,
                         cfg: HpfwConfig) -> list[np.ndarray]:
    """n_tracks tracks in one artist's style."""
    return [synth_artist_track(artist_seed, i, duration_s, cfg)
            for i in range(n_tracks)]


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


def pitch_shift(pcm: np.ndarray, semitones: float, cfg: HpfwConfig) -> np.ndarray:
    """Crude pitch shift by resampling (changes tempo too — eval only).

    Used by the robustness eval (BASELINE config 5), not by the pipeline.
    """
    factor = 2.0 ** (semitones / 12.0)
    n = pcm.shape[0]
    src = np.arange(n, dtype=np.float64) * factor
    valid = src < n - 1
    src = src[valid]
    i0 = src.astype(np.int64)
    frac = src - i0
    out = (1.0 - frac) * pcm[i0] + frac * pcm[i0 + 1]
    return out.astype(np.float32)
