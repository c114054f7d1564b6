"""Hashprint encoder: context projection, lag delta, sign and bit-pack.

Counterpart of hpfw_tpu/ops/fingerprint.py (the plain path) and
hpfw_tpu/ops/pallas_fingerprint.py (the kernel). Prints are (N, 2) int32
tensors holding the bit pattern of hpfw_tpu's (N, 2) uint32 words (torch has
no >> for uint32 on the CPU); word 0 holds filters 0..31 under lsb0. On a
CUDA tensor fingerprint_from_spec launches K2 (csrc/fingerprint.cu); on a
CPU tensor it runs the plain version, fingerprint_from_spec_ref.
"""

from __future__ import annotations

import torch

from ..config import HpfwConfig
from . import _build
from .dot import precise_matmul

# K2 computes a tile of 128 projection rows a cluster, which yields 128 -
# delta_lag prints, and stages at most 128 bins a context frame
# (csrc/fingerprint.cu: ROWS, MAX_LAG, MAX_BINS).
MAX_DELTA_LAG = 64
MAX_BINS = 128


def context_matrix(spec: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """(F, n_bins) spectrum -> (F - w + 1, w * n_bins) context vectors x(n),
    time-major: x(n) is frames n..n+w-1 one after another. Needs F >= w."""
    f, b = spec.shape
    w = cfg.context_w
    return spec.unfold(0, w, 1).transpose(1, 2).reshape(f - w + 1, w * b)


def project_features(spec: torch.Tensor, filters: torch.Tensor,
                     cfg: HpfwConfig) -> torch.Tensor:
    """y(n) = F^T x(n) over context windows, shape (F-w+1, 64).

    filters: (context_dim, 64) time-major (rows j*n_bins:(j+1)*n_bins act on
    spectrum frame n+j).
    """
    if spec.shape[0] < cfg.context_w:
        return spec.new_zeros((0, filters.shape[1]))
    return precise_matmul(context_matrix(spec, cfg), filters)


def delta(y: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """d(n) = y(n) - y(n+T), shape (M-T, 64)."""
    t = cfg.delta_lag
    return y[:-t] - y[t:]


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_bits(bits: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """(N, 64) bool -> (N, 2) int32 packed words, matching oracle.pack_bits."""
    n = bits.shape[0]
    b = bits.to(torch.int64).reshape(n, 2, 32)
    k = torch.arange(32, dtype=torch.int64, device=bits.device)
    if cfg.bit_order == "lsb0":
        weights = torch.bitwise_left_shift(torch.ones_like(k), k)
    else:  # msb0: filter i -> bit (63-i); within each word reverse order
        b = b.flip(1)
        weights = torch.bitwise_left_shift(torch.ones_like(k), 31 - k)
    return _to_int32((b * weights).sum(dim=2))


def unpack_bits(packed: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """(N, 2) int32 -> (N, 64) bool; inverse of pack_bits."""
    n = packed.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    if cfg.bit_order == "msb0":
        bits = bits.flip(1).flip(2)
    return bits.reshape(n, 64).to(torch.bool)


def binarize_and_pack(d: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    bits = d > 0.0 if cfg.tie_break == "gt" else d >= 0.0
    return pack_bits(bits, cfg)


def fingerprint_from_spec_ref(spec: torch.Tensor, filters: torch.Tensor,
                              cfg: HpfwConfig) -> torch.Tensor:
    """Plain version: CQT spectrum -> (N, 2) int32 hashprints."""
    y = project_features(spec, filters, cfg)
    return binarize_and_pack(delta(y, cfg), cfg)


def encoder_kernel(spec: torch.Tensor, filters: torch.Tensor,
                   cfg: HpfwConfig) -> torch.Tensor:
    """K2 on the card: (F, n_bins) f32 spectrum -> (N, 2) int32 hashprints."""
    _build.require(spec, "spec", torch.float32, 2)
    _build.require(filters, "filters", torch.float32, 2, spec.device)
    if spec.shape[1] != cfg.n_bins:
        raise ValueError(f"spec has {spec.shape[1]} bins, config says {cfg.n_bins}")
    if tuple(filters.shape) != (cfg.context_dim, cfg.n_filters):
        raise ValueError(f"filters must be ({cfg.context_dim}, {cfg.n_filters}), "
                         f"got {tuple(filters.shape)}")
    if cfg.n_bins > MAX_BINS:
        raise ValueError(f"the encoder kernel takes at most {MAX_BINS} bins, "
                         f"got {cfg.n_bins}")
    if not 1 <= cfg.delta_lag <= MAX_DELTA_LAG:
        raise ValueError(f"the encoder kernel takes delta_lag in [1, "
                         f"{MAX_DELTA_LAG}], got {cfg.delta_lag}")
    f = spec.shape[0]
    n = max(0, f - cfg.context_w + 1 - cfg.delta_lag)
    out = torch.empty((n, 2), dtype=torch.int32, device=spec.device)
    if n == 0:
        return out
    # The split filters and spectrum (bf16 parts in the kernel's layouts),
    # written by K2's split pass and read by its encoder.
    scratch = torch.empty(_build.library().hpfw_fingerprint_scratch(f, cfg.n_bins,
                                                                    cfg.context_w),
                          dtype=torch.uint8, device=spec.device)
    _build.launch("fingerprint", "hpfw_fingerprint", spec.device,
                  spec.data_ptr(), f, cfg.n_bins, filters.data_ptr(),
                  cfg.context_w, cfg.delta_lag, n, int(cfg.tie_break == "ge"),
                  int(cfg.bit_order == "msb0"), scratch.data_ptr(), out.data_ptr())
    return out


def fingerprint_from_spec(spec: torch.Tensor, filters: torch.Tensor,
                          cfg: HpfwConfig) -> torch.Tensor:
    """CQT spectrum -> packed hashprints (N, 2) int32 on spec's device."""
    if spec.device.type == "cuda":
        return encoder_kernel(spec, filters, cfg)
    if spec.device.type == "cpu":
        return fingerprint_from_spec_ref(spec, filters, cfg)
    raise ValueError(f"no encoder for device {spec.device}")
