"""Device-side synthetic music for catalog-scale fixtures.

The counterpart of hpfw_tpu/io/synth_jax.py. Tracks are rendered on the
device named by `device=` (default: the card; with no card visible this
raises, as api.default_device() does), a whole batch at a time, so a
catalog of 100,000 tracks is built without a pass of PCM through the host:
render a batch, fingerprint it with api.fingerprint_batch_device, keep the
prints. Nothing of a batch leaves the device unless the caller copies it.

The music is synth_jax.py's: note-like partials on a chromatic grid with
onset/decay envelopes and vibrato, a slow log-sweep chirp and a noise floor;
every 10th track (i % 10 == 3) a cover of track i - 3, a quarter semitone up
with fresh noise. Every track is a deterministic function of (base_seed,
track_id) with the same random draws as the JAX package: io/_threefry.py is
jax.random's threefry2x32 (jax 0.9.0, partitionable, 32-bit mode), bit-exact
for uniform draws. The float32 arithmetic follows synth_jax.py operation by
operation, with three rules of XLA's CPU backend that were measured to move
the audio: the multiply-adds of the sin arguments, the vibrato, the
parameters and the sum over partials round once (fused; done here as an
exact float64 product and one float64 add), a division by a constant is a
product with its float32 reciprocal (t = n / sr above all), and pow is
correctly rounded. What still rounds differently, and the bound
tests/test_torch_synth_device.py states for it:
- the chirp's phase: jnp.cumsum on XLA's CPU sums float32 in its own order,
  where this module sums in float64 and rounds once, on every device alike;
- sin: torch's and XLA's float32 sin differ in the last place on 1-5% of
  arguments, which a partial's phase carries as far as 2 pi f t;
- the noise: normal draws to a few ulp (io/_threefry.py).
Prints built from the two renderings agree up to the oracle's margin audit,
not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import HpfwConfig
from . import _threefry as rng

COVER_PERIOD = 10          # every 10th track (i % 10 == 3) is a cover
COVER_SHIFT_ST = 0.25      # cover pitch shift, semitones
N_PARTIALS = 6
NOISE_DB = -30.0
TWO_PI = 2 * math.pi


def cover_source(track_id: int) -> int | None:
    """The track a given id covers, or None if it is an original."""
    return track_id - 3 if (track_id % COVER_PERIOD == 3 and track_id >= 3) else None


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    from ..api import default_device

    return default_device()


def _ids(track_ids, device) -> torch.Tensor:
    """Track ids as int64 values of int32 ids (jax's track_ids dtype)."""
    ids = np.asarray(track_ids, dtype=np.int32).reshape(-1)
    return torch.from_numpy(ids.astype(np.int64)).to(device)


def _col(x: torch.Tensor) -> torch.Tensor:
    return x.unsqueeze(-1)


def _chirp_phase(sweep: torch.Tensor, sr: int) -> torch.Tensor:
    """2 pi cumsum(sweep) / sr along the last axis: the running sum in float64,
    rounded once to float32."""
    total = torch.cumsum(sweep, dim=-1, dtype=torch.float64).to(torch.float32)
    return _div(TWO_PI * total, sr)


def _fma(a, b, c):
    """a * b + c rounded once, as XLA's CPU backend contracts a multiply
    into the add that consumes it: exact float64 product, one float64 add,
    then float32."""
    return (a.double() * b.double() + torch.as_tensor(c).double()).float()


def _pow(a, b):
    """float32 a ** b, correctly rounded (through float64), as XLA's is
    to within its last place."""
    return torch.pow(torch.as_tensor(a).double(), torch.as_tensor(b).double()).float()


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a constant c as XLA simplifies it: times the float32
    reciprocal of c."""
    return x * float(np.float32(1.0) / np.float32(c))


def _render(keys, pitch_factor, t, ts, duration_s, sr, fmin):
    """synth_jax._render_one over a batch: (B, 2) keys, (B,) pitch factors ->
    (B, N). ts is the score time (t itself for a catalog render, t * stretch
    for a live rendition, as in _render_one_live)."""
    out = torch.zeros((keys.shape[0], t.shape[0]), dtype=torch.float32, device=t.device)
    pf = _col(pitch_factor)
    two_pi = _f32(TWO_PI, t)
    for p in range(N_PARTIALS):
        u = rng.uniform(rng.fold_in(keys, p), (7,))
        u0, u1, u2, u3, u4, u5, u6 = (_col(u[:, i]) for i in range(7))
        semi = torch.floor(u0 * 60.0)
        pitch = fmin * _pow(2.0, _div(semi, 12.0)) * pf
        vib_rate = _fma(_f32(4.0, t), u1, _f32(3.0, t))
        vib = _fma(_f32(0.002, t), torch.sin(_fma(two_pi * vib_rate, ts, two_pi * u2)),
                   _f32(1.0, t))
        onset = 0.5 * u3 * duration_s
        length = _fma(_f32(0.7, t), u4, _f32(0.3, t)) * duration_s
        env = (torch.clamp(_div(ts - onset, 0.05), 0.0, 1.0)
               * torch.clamp(_div(onset + length - ts, 0.2), 0.0, 1.0))
        amp = _fma(_f32(0.4, t), u5, _f32(0.1, t))
        out = _fma(amp * env, torch.sin(_fma(two_pi * pitch * vib, t, two_pi * u6)), out)
    uc = rng.uniform(rng.fold_in(keys, N_PARTIALS), (2,))
    f0 = fmin * _pow(2.0, 2.0 * _col(uc[:, 0])) * pf
    f1 = f0 * _pow(2.0, _fma(_f32(2.0, t), _col(uc[:, 1]), _f32(1.0, t)))
    sweep = f0 * _pow(f1 / f0, _div(ts, duration_s))
    return _fma(_f32(0.2, t), torch.sin(_chirp_phase(sweep, sr)), out)


def _finish(out, noise_keys, n):
    noise_amp = 10.0 ** (NOISE_DB / 20.0)
    out = out + noise_amp * rng.normal(noise_keys, (n,))
    peak = _col(torch.amax(torch.abs(out), dim=-1))
    return torch.where(peak > 0, 0.9 * out / peak, out)


def _catalog_params(tid, base, shift: float = 1.0):
    """Each id's parameter key (a cover's is its source's) and pitch factor."""
    is_cover = (tid % COVER_PERIOD == 3) & (tid >= 3)
    param_id = torch.where(is_cover, tid - 3, tid)
    factor = torch.where(is_cover,
                         torch.tensor(2.0 ** (COVER_SHIFT_ST / 12.0), dtype=torch.float32),
                         torch.tensor(1.0, dtype=torch.float32)).to(tid.device)
    return rng.fold_in(base, param_id), factor * _f32(shift, factor)


def synth_batch(track_ids, duration_s: float, cfg: HpfwConfig, *,
                base_seed: int = 7000,
                device: str | torch.device | None = None) -> torch.Tensor:
    """(B,) int32 track ids -> (B, N) float32 PCM, rendered on device."""
    dev = _device(device)
    tid = _ids(track_ids, dev)
    sr = cfg.sample_rate
    n = int(round(duration_s * sr))
    t = _div(torch.arange(n, dtype=torch.float32, device=dev), sr)
    base = rng.PRNGKey(base_seed, dev)
    keys, factor = _catalog_params(tid, base)
    out = _render(keys, factor, t, t, float(duration_s), sr, cfg.fmin)
    # Noise folds the ACTUAL id, so covers share notes, not samples.
    return _finish(out, rng.fold_in(base, 1_000_003 + tid), n)


def _excerpt(full, starts, noise_seeds, q_samples: int, noise_db: float):
    """synth_jax._excerpt_jit: a q_samples clip of each row from its start
    (clamped into the row, as lax.dynamic_slice clamps), plus noise at
    noise_db below the clip's RMS, scaled down if it peaks above 1."""
    dev = full.device
    starts = torch.clamp(torch.as_tensor(starts, dtype=torch.int64, device=dev),
                         0, full.shape[1] - q_samples)
    idx = starts[:, None] + torch.arange(q_samples, device=dev)[None, :]
    clip = torch.gather(full, 1, idx)
    rms = torch.sqrt(torch.mean(clip ** 2, dim=1, keepdim=True)) + 1e-12
    seeds = torch.as_tensor(noise_seeds, dtype=torch.int64, device=dev) & rng.MASK
    keys = torch.stack([torch.zeros_like(seeds), seeds], dim=-1)
    noise = rng.normal(keys, (q_samples,))
    noise = noise * (rms * 10.0 ** (noise_db / 20.0)
                     / (torch.sqrt(torch.mean(noise ** 2, dim=1, keepdim=True)) + 1e-12))
    clip = clip + noise
    peak = torch.amax(torch.abs(clip), dim=1, keepdim=True)
    return torch.where(peak > 1.0, clip / peak, clip)


def query_batch(track_ids, start_samples, duration_s: float,
                query_seconds: float, cfg: HpfwConfig, *,
                noise_db: float = -10.0, noise_seeds=None,
                base_seed: int = 7000,
                device: str | torch.device | None = None) -> torch.Tensor:
    """Noisy query excerpts of catalog tracks, rendered on device.

    track_ids (B,), start_samples (B,) -> (B, Q) float32: each track rendered
    as synth_batch renders it, so the excerpt is the catalog's audio, then
    noise at noise_db below the excerpt's RMS (seed 77,000 + id unless
    noise_seeds says otherwise).
    """
    ids = np.asarray(track_ids, dtype=np.int32).reshape(-1)
    starts = np.asarray(start_samples, dtype=np.int32).reshape(-1)
    if noise_seeds is None:
        noise_seeds = 77_000 + ids
    nseeds = np.asarray(noise_seeds, dtype=np.int32).reshape(-1).astype(np.int64)
    full = synth_batch(ids, duration_s, cfg, base_seed=base_seed, device=device)
    return _excerpt(full, starts, nseeds,
                    int(round(query_seconds * cfg.sample_rate)), float(noise_db))


def live_query_batch(track_ids, start_samples, duration_s: float,
                     query_seconds: float, cfg: HpfwConfig, *,
                     pitch_st: float = 0.0, stretch: float = 1.0,
                     noise_db: float = -10.0, noise_seeds=None,
                     base_seed: int = 7000,
                     device: str | torch.device | None = None) -> torch.Tensor:
    """Noisy LIVE-RENDITION query excerpts: the catalog track's score played
    pitch_st semitones up or down and at stretch x tempo, then excerpted and
    noised as query_batch does. start_samples are CATALOG positions; the
    excerpt is taken where that content lands in the rendition (start /
    stretch). The render covers the whole score even when the rendition is
    slower (stretch < 1)."""
    dev = _device(device)
    ids = np.asarray(track_ids, dtype=np.int32).reshape(-1)
    starts = np.asarray(np.round(np.asarray(start_samples) / stretch),
                        dtype=np.int32).reshape(-1)
    if noise_seeds is None:
        noise_seeds = 77_000 + ids
    nseeds = np.asarray(noise_seeds, dtype=np.int32).reshape(-1).astype(np.int64)
    sr = cfg.sample_rate
    n = int(round(duration_s * sr / min(float(stretch), 1.0)))
    t = _div(torch.arange(n, dtype=torch.float32, device=dev), sr)
    tid = _ids(ids, dev)
    base = rng.PRNGKey(base_seed, dev)
    keys, factor = _catalog_params(tid, base, 2.0 ** (float(pitch_st) / 12.0))
    ts = t * torch.tensor(float(stretch), dtype=torch.float32, device=dev)
    out = _render(keys, factor, t, ts, float(duration_s), sr, cfg.fmin)
    full = _finish(out, rng.fold_in(base, 1_000_003 + tid), n)
    q_samples = int(round(query_seconds * sr))
    starts = np.minimum(starts, full.shape[1] - q_samples - 1)
    return _excerpt(full, starts, nseeds, q_samples, float(noise_db))


def artist_style(artist_seed: int) -> dict:
    """A persistent per-artist musical style (known-artist fixtures).

    Like io/synth.py's synth_artist_track: the artist seed fixes a scale
    (pitch-class subset), register, voice count, vibrato depth and chirp
    level shared by all of that artist's tracks, so per-artist
    context-window covariances genuinely differ and per-artist filter
    learning has signal to exploit (SURVEY.md §2.3 step 4). Style params
    are host-side (they become static jit args); rendering is on device.
    """
    arng = np.random.default_rng(100003 * artist_seed + 17)
    return {
        "scale": tuple(int(x) for x in
                       np.sort(arng.choice(12, size=arng.integers(5, 8),
                                           replace=False))),
        "octave_lo": int(arng.integers(0, 3)),
        "n_octaves": int(arng.integers(2, 4)),
        "n_partials": int(arng.integers(4, 10)),
        "vib_depth": float(arng.uniform(0.0005, 0.004)),
        "chirp_amp": float(arng.uniform(0.05, 0.3)),
    }


def synth_artist_batch(artist_seed: int, track_ids, duration_s: float,
                       cfg: HpfwConfig, *, base_seed: int = 0,
                       device: str | torch.device | None = None) -> torch.Tensor:
    """(B,) track ids -> (B, N) PCM in one artist's persistent style."""
    dev = _device(device)
    style = artist_style(artist_seed)
    scale = torch.tensor(style["scale"], dtype=torch.float32, device=dev)
    sr = cfg.sample_rate
    duration_s = float(duration_s)
    n = int(round(duration_s * sr))
    t = _div(torch.arange(n, dtype=torch.float32, device=dev), sr)
    two_pi = _f32(TWO_PI, t)
    base = rng.PRNGKey(1_000_000_007 * artist_seed + base_seed, dev)
    keys = rng.fold_in(base, _ids(track_ids, dev))
    out = torch.zeros((keys.shape[0], n), dtype=torch.float32, device=dev)
    for p in range(style["n_partials"]):
        kp = rng.fold_in(keys, p)
        u = rng.uniform(kp, (7,))
        u0, u1, u2, u3, u4, u5, u6 = (_col(u[:, i]) for i in range(7))
        pc = scale[torch.floor(u0 * len(style["scale"])).long()]
        octave = style["octave_lo"] + torch.floor(u1 * style["n_octaves"])
        pitch = cfg.fmin * _pow(2.0, octave + _div(pc, 12.0))
        vib_rate = _fma(_f32(4.0, t), u2, _f32(3.0, t))
        vib = _fma(_f32(style["vib_depth"], t),
                   torch.sin(_fma(two_pi * vib_rate, t, two_pi * u3)), _f32(1.0, t))
        onset = 0.5 * u4 * duration_s
        length = _fma(_f32(0.7, t), u5, _f32(0.3, t)) * duration_s
        env = (torch.clamp(_div(t - onset, 0.05), 0.0, 1.0)
               * torch.clamp(_div(onset + length - t, 0.2), 0.0, 1.0))
        amp = _fma(_f32(0.4, t), _col(rng.uniform(rng.fold_in(kp, 1), ())), _f32(0.1, t))
        out = _fma(amp * env, torch.sin(_fma(two_pi * pitch * vib, t, two_pi * u6)), out)
    uc = rng.uniform(rng.fold_in(keys, 1009), (2,))
    f0 = cfg.fmin * _pow(2.0, style["octave_lo"] + _col(uc[:, 0]))
    f1 = f0 * _pow(2.0, 1.0 + _col(uc[:, 1]))
    sweep = f0 * _pow(f1 / f0, _div(t, duration_s))
    out = _fma(_f32(style["chirp_amp"], t), torch.sin(_chirp_phase(sweep, sr)), out)
    return _finish(out, rng.fold_in(keys, 2_000_003), n)
