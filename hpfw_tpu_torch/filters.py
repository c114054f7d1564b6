"""Projection filters: the hand-over from hpfw_tpu.

Filters are plain (context_dim, 64) float32 arrays that both packages share.
Their rows are time-major: rows [j*n_bins, (j+1)*n_bins) act on spectrogram
frame n+j of the context window, so the array is already the per-context-
frame stack of (n_bins, 64) slabs that the encoder kernel streams through
shared memory one frame at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import HpfwConfig


def filters_from_jax(filters_np: np.ndarray, cfg: HpfwConfig,
                     device: str | torch.device) -> torch.Tensor:
    """hpfw_tpu's (w*n_bins, 64) float32 filters -> the port's device tensor.

    The result is contiguous float32 of the same shape and row order; the
    encoder kernel reads it as (context_w, n_bins, 64).
    """
    f = np.asarray(filters_np, dtype=np.float32)
    if f.shape != (cfg.context_dim, cfg.n_filters):
        raise ValueError(f"expected ({cfg.context_dim}, {cfg.n_filters}) filters "
                         f"for this config, got {f.shape}")
    return torch.from_numpy(np.ascontiguousarray(f)).to(device)
