"""jax.random's threefry2x32 generator in torch, draw for draw.

io/synth_device.py renders the same catalog as hpfw_tpu/io/synth_jax.py only
if it makes the same random draws, so this module reproduces the generator
that synth_jax.py runs under: jax 0.9.0 with its default implementation
(`jax_default_prng_impl = "threefry2x32"`), in 32-bit mode, with
`jax_threefry_partitionable = True` (the default since jax 0.5). Under that
flag a draw of shape S hashes the 64-bit counter of each element's flat
index, split into (high, low) 32-bit words, and a 32-bit draw is the XOR of
the two output words. fold_in hashes the counter pair (0, data). PRNGKey(s)
is the pair (0, s mod 2**32): in 32-bit mode jax truncates the seed before
splitting it.

Words are held in int64 tensors masked to 32 bits, because torch has no
`>>` for uint32 on the CPU. A key is a (..., 2) int64 tensor; the leading
axes batch independent keys, and a draw of shape S from keys of shape
(..., 2) has shape (...,) + S. uniform is bit-exact to jax.random.uniform.
normal evaluates XLA's float32 erfinv polynomial, each multiply-add rounded
once as XLA's CPU backend fuses it, but with torch's log1p, which can round
differently in the last place: a normal draw can differ from jax's by a few
ulp (99% of them equal; tests/test_torch_synth_device.py states the bound).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under key
    words (k1, k2); every argument an int64 tensor of 32-bit values, all
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x[0], x[1]


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) in 32-bit mode: the (2,) key (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: the hash of the counter pair (0, data) under key.
    data is an int or an integer tensor, taken mod 2**32 as jax's uint32
    cast does; a tensor broadcasts against the key's leading axes."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """jax.random.bits(key, shape) as uint32 values in int64: element i of the
    flat draw hashes the counter (i >> 32, i & MASK)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (y1 ^ y2).reshape(lead + tuple(shape))


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval), bit for bit:
    23 random mantissa bits under the exponent of 1.0, less 1.0, scaled.
    The scaling f * (hi - lo) + lo rounds once, as XLA's CPU backend fuses
    it into one multiply-add (a float64 product of float32 values is
    exact)."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
# XLA's float32 erf_inv: Giles' single-precision polynomials in
# w = -log1p(-x^2), one for w < 5 and one in sqrt(w) beyond.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA computes it (torch.special.erfinv rounds
    differently, up to 64 ulp apart); erfinv(+-1) = +-inf."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    table = torch.tensor((_ERFINV_W_LT_5, _ERFINV_W_GE_5), dtype=torch.float32,
                         device=x.device)
    p = torch.where(lt, table[0, 0], table[1, 0])
    for i in range(1, table.shape[1]):
        # c + p * w rounded once, as XLA's CPU backend fuses it.
        c = torch.where(lt, table[0, i], table[1, i])
        p = (p.double() * w.double() + c.double()).float()
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """jax.random.normal(key, shape, float32): sqrt(2) erfinv(u), u uniform
    on (-1, 1)."""
    return erfinv(uniform(key, shape, _NORMAL_LO, 1.0)) * _SQRT2
