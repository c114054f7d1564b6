"""Extraction pipeline: PCM -> frames view -> CQT -> hashprint encoder.

Counterpart of hpfw_tpu/ops/fused.py. On a CUDA tensor the two stages are
K1 and K2, and the frame matrix is never written: K1 reads the frames
through the strided view of the PCM.
"""

from __future__ import annotations

import torch

from ..config import HpfwConfig
from . import fingerprint as fp_ops
from . import frontend


def fingerprint(pcm: torch.Tensor, filters: torch.Tensor,
                cfg: HpfwConfig) -> torch.Tensor:
    """(S,) PCM -> (N, 2) int32 hashprints on pcm's device."""
    spec = frontend.cqt(pcm, cfg)
    return fp_ops.fingerprint_from_spec(spec, filters, cfg)
