"""K2, the hashprint encoder (csrc/fingerprint.cu: its split pass and its
encoder, two kernels a launch), on the spectrum of one track: one product of
the M = F - context_w + 1 context vectors by the (context_w n_bins, 64)
filters, charged against the bf16 dense peak as K1 is. Bytes: the float32
spectrum and filters, the (N, 2) int32 prints."""

from . import bound_s, n_frames

PATTERN = r"\b(split_kernel|encoder_kernel)\b"
LAUNCH_PATTERN = r"\bencoder_kernel\b"


def ops(p: dict, n_samples: int) -> float:
    m = n_frames(p, n_samples) - p["context_w"] + 1
    return 2.0 * m * p["context_w"] * p["n_bins"] * p["n_filters"]


def nbytes(p: dict, n_samples: int) -> float:
    f = n_frames(p, n_samples)
    n = f - p["context_w"] + 1 - p["delta_lag"]
    return 4.0 * (f * p["n_bins"] + p["context_w"] * p["n_bins"] * p["n_filters"] + 2 * n)


def bound(p: dict, n_samples: int) -> float:
    return bound_s(ops(p, n_samples), nbytes(p, n_samples), "bf16_flops_per_s")
