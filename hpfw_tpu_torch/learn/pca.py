"""Projection-filter learning: streaming covariance of context vectors + eigh.

Counterpart of hpfw_tpu/learn/pca.py. Per track, the CQT spectrum (K1 on the
card, its plain version on the CPU) is unfolded into its (M, D) matrix of
time-major context vectors, and X^T X and the column sum are added to a
float32 accumulator, one track at a time; the top-64 eigenvectors of the
covariance, from a float64 eigh on the host, are the filters. X^T X is one
float32 GEMM through ops/dot.py (cuBLAS with TF32 off on the card): in the
reference it is XLA's precise_dot, not a Pallas kernel.

CovarianceState saves the reference's .npz (xtx, xsum, count as int64), so a
state saved by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api import default_device
from ..config import HpfwConfig
from ..oracle.pipeline import fix_eigenvector_signs
from ..ops import frontend
from ..ops.dot import precise_matmul
from ..ops.fingerprint import context_matrix


@dataclasses.dataclass
class CovarianceState:
    """Streaming (sum X^T X, sum X, count) over context vectors."""
    xtx: np.ndarray    # (D, D) float32
    xsum: np.ndarray   # (D,) float32
    count: int

    @classmethod
    def zero(cls, cfg: HpfwConfig) -> "CovarianceState":
        d = cfg.context_dim
        return cls(np.zeros((d, d), np.float32), np.zeros(d, np.float32), 0)

    def save(self, path: str) -> None:
        np.savez_compressed(path, xtx=self.xtx, xsum=self.xsum,
                            count=np.int64(self.count))

    @classmethod
    def load(cls, path: str) -> "CovarianceState":
        with np.load(path) as z:
            return cls(z["xtx"], z["xsum"], int(z["count"]))


def track_moments(pcm: np.ndarray, cfg: HpfwConfig, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """One track's partial moments on device, without a host sync: (X^T X
    (D, D), the column sum (D,), the row count) of its context vectors. The
    track must span at least context_w frames."""
    x = context_matrix(frontend.cqt(torch.from_numpy(pcm).to(device), cfg), cfg)
    return precise_matmul(x.T, x), x.sum(dim=0), x.shape[0]


def accumulate_track(state: CovarianceState, pcm: np.ndarray, cfg: HpfwConfig, *,
                     device: str | torch.device | None = None) -> CovarianceState:
    """Fold one training track into the covariance accumulator; the track's
    work runs on device (default: the card; raises when torch sees none)."""
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    if cfg.n_frames(pcm.shape[0]) < cfg.context_w:
        return state
    dev = torch.device(device) if device is not None else default_device()
    xtx, xsum, n = track_moments(pcm, cfg, dev)
    return CovarianceState(state.xtx + xtx.cpu().numpy(), state.xsum + xsum.cpu().numpy(),
                           state.count + n)


def finalize_filters(state: CovarianceState, cfg: HpfwConfig) -> np.ndarray:
    """Covariance -> top-64 eigenvector filters, deterministic signs.

    eigh runs in float64 on the host, as in the reference, so one state gives
    the same filters in either package.
    """
    if state.count == 0:
        raise ValueError("no context windows accumulated")
    mean = state.xsum.astype(np.float64) / state.count
    cov = state.xtx.astype(np.float64) / state.count - np.outer(mean, mean)
    _, evecs = np.linalg.eigh(cov)
    top = evecs[:, ::-1][:, : cfg.n_filters]
    return fix_eigenvector_signs(top).astype(np.float32)


def learn_filters(corpus: list[np.ndarray], cfg: HpfwConfig, *,
                  device: str | torch.device | None = None) -> np.ndarray:
    """Learn (context_dim, 64) float32 filters from a corpus of PCM tracks."""
    state = CovarianceState.zero(cfg)
    for pcm in corpus:
        state = accumulate_track(state, pcm, cfg, device=device)
    return finalize_filters(state, cfg)
