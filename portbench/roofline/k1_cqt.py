"""K1, the CQT filterbank (csrc/frontend.cu), on one track of n_samples: one
float32-exact GEMM of the F frames by the (frame_len, 2 n_bins) NDFT basis,
charged against the bf16 dense peak, the fastest floating-point unit that
could give that precision. Bytes: the PCM, the float32 basis, the (F, n_bins)
float32 spectrum."""

from . import bound_s, n_frames

PATTERN = r"\bcqt_kernel<"


def ops(p: dict, n_samples: int) -> float:
    return 2.0 * n_frames(p, n_samples) * p["frame_len"] * 2 * p["n_bins"]


def nbytes(p: dict, n_samples: int) -> float:
    f = n_frames(p, n_samples)
    return 4.0 * (n_samples + p["frame_len"] * 2 * p["n_bins"] + f * p["n_bins"])


def bound(p: dict, n_samples: int) -> float:
    return bound_s(ops(p, n_samples), nbytes(p, n_samples), "bf16_flops_per_s")
