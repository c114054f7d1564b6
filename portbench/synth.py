"""Inputs made from the seed: music, noisy excerpts, random prints, filters.

Everything here is made on the run's device by a torch.Generator seeded from
--seed, in a few large calls, so the same seed gives the same inputs.

- The music is a parametric score: per track six note-like partials on a
  chromatic grid (onset and decay envelopes, vibrato) and a log-sweep chirp,
  after io/synth_device.py's arithmetic. It is a function of time, so an
  excerpt is rendered alone, at any start, and a live rendition is the same
  score played at another pitch (every frequency times 2^(st/12)) and tempo
  (score time = rendition time x stretch). Rendered in float64, returned as
  float32.
- Catalog distractors are iid random prints (benchmarks/config4_scale.py's
  synth_print_db), which are easier than real prints.
- noisy_excerpt is config4_scale.py's: a slice of a track's prints with a
  share of bits flipped.
- Filters are benchmarks/common.py's make_filters: Gaussian, scaled by
  1/sqrt(D), each column's largest-magnitude entry made positive.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_PARTIALS = 6
FLOOR_DB = -30.0        # the catalog recording's noise floor, re its RMS
GAIN = 0.2              # keeps the sum of six partials and the chirp within +-1.5


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on device for one named stream of draws of a run."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63 - 1))
    return g


def score_params(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, N_PARTIALS + 1, 7) float64 uniforms: a row a partial, then the chirp's."""
    return torch.rand((n, N_PARTIALS + 1, 7), generator=gen, device=device,
                      dtype=torch.float64)


def render(params: torch.Tensor, t0: torch.Tensor, n_samples: int, *, sr: int,
           duration_s: float, fmin: float, pitch_st: float = 0.0,
           stretch: float = 1.0) -> torch.Tensor:
    """(B, N_PARTIALS + 1, 7) params, (B,) start times in seconds of rendition
    time -> (B, n_samples) float32 clean audio of the score from t0 on."""
    dev = params.device
    t = t0.to(torch.float64)[:, None] + torch.arange(n_samples, device=dev,
                                                     dtype=torch.float64)[None] / sr
    ts = t * stretch                                       # score time
    pf = 2.0 ** (pitch_st / 12.0)
    out = torch.zeros_like(t)
    for p in range(N_PARTIALS):
        u = [params[:, p, i:i + 1] for i in range(7)]
        pitch = fmin * torch.pow(2.0, torch.floor(u[0] * 60.0) / 12.0) * pf
        vib = 1.0 + 0.002 * torch.sin(2 * math.pi * ((3.0 + 4.0 * u[1]) * ts + u[2]))
        onset = 0.5 * u[3] * duration_s
        length = (0.3 + 0.7 * u[4]) * duration_s
        env = (torch.clamp((ts - onset) / 0.05, 0.0, 1.0)
               * torch.clamp((onset + length - ts) / 0.2, 0.0, 1.0))
        out += (0.1 + 0.4 * u[5]) * env * torch.sin(2 * math.pi * (pitch * vib * t + u[6]))
    # The chirp sweeps f0 -> f1 over the score; its phase is the integral of
    # its frequency over rendition time, in closed form.
    c = params[:, N_PARTIALS]
    f0 = fmin * torch.pow(2.0, 2.0 * c[:, 0:1]) * pf
    r = torch.pow(2.0, 1.0 + 2.0 * c[:, 1:2])
    k = stretch * torch.log(r) / duration_s
    phase = 2 * math.pi * f0 * torch.expm1(k * t) / k
    out += 0.2 * torch.sin(torch.remainder(phase, 2 * math.pi))
    return (GAIN * out).to(torch.float32)


def add_noise(clip: torch.Tensor, gen: torch.Generator, noise_db: float) -> torch.Tensor:
    """clip plus white noise noise_db below each row's RMS."""
    noise = torch.randn(clip.shape, generator=gen, device=clip.device, dtype=torch.float32)
    rms = clip.pow(2).mean(dim=1, keepdim=True).sqrt()
    nrms = noise.pow(2).mean(dim=1, keepdim=True).sqrt()
    return clip + noise * (rms * 10.0 ** (noise_db / 20.0) / nrms)


def catalog_tracks(params: torch.Tensor, gen: torch.Generator, *, sr: int,
                   duration_s: float, fmin: float) -> torch.Tensor:
    """Whole tracks of the score, as recorded: (B, duration_s * sr) float32 with
    a noise floor FLOOR_DB below the track's RMS."""
    t0 = torch.zeros(params.shape[0], device=params.device)
    clean = render(params, t0, int(round(duration_s * sr)), sr=sr,
                   duration_s=duration_s, fmin=fmin)
    return add_noise(clean, gen, FLOOR_DB)


def random_prints(gen: torch.Generator, shape, device) -> torch.Tensor:
    """iid random packed prints, int32 words (the bit pattern of uint32)."""
    return torch.randint(-2 ** 31, 2 ** 31, tuple(shape), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def noisy_excerpt(track_prints: torch.Tensor, start: int, n: int, flip: torch.Tensor
                  ) -> torch.Tensor:
    """track_prints[start:start + n] XOR flip, flip an (n, 2) int32 mask."""
    return track_prints[start:start + n] ^ flip


def flip_masks(gen: torch.Generator, count: int, n: int, rate: float, device) -> torch.Tensor:
    """(count, n, 2) int32 masks, each bit set with probability rate."""
    bits = torch.rand((count, n, 2, 32), generator=gen, device=device) < rate
    weights = torch.bitwise_left_shift(torch.ones(32, dtype=torch.int64, device=device),
                                       torch.arange(32, device=device))
    words = (bits.to(torch.int64) * weights).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def filters(gen: torch.Generator, context_dim: int, n_filters: int, device) -> torch.Tensor:
    """(context_dim, n_filters) float32 random projection filters."""
    f = torch.randn((context_dim, n_filters), generator=gen, device=device,
                    dtype=torch.float64) / math.sqrt(context_dim)
    idx = f.abs().argmax(dim=0)
    signs = torch.sign(f[idx, torch.arange(n_filters, device=device)])
    signs[signs == 0] = 1.0
    return (f * signs).to(torch.float32)


def to_host_u32(prints: torch.Tensor) -> np.ndarray:
    """int32 prints on any device -> numpy uint32 with the same bits."""
    return prints.cpu().numpy().view(np.uint32)
