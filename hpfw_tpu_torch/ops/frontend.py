"""CQT front end: framing, the NDFT filterbank GEMM and its log-magnitude.

Counterpart of hpfw_tpu/ops/frontend.py (the plain path) and
hpfw_tpu/ops/pallas_frontend.py (the kernel). spec = log(log_eps + |frames @
K|), with the complex kernel K held as one real (frame_len, 2 * n_bins)
matrix [Kre | Kim]. On a CUDA tensor this launches K1 (csrc/frontend.cu), which
runs the TPU kernel's split-bf16 products on the tensor cores over the host
split of cqt_kernel_split; on a CPU tensor it runs the plain version,
cqt_from_frames_ref.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import HpfwConfig
from ..oracle.pipeline import cqt_kernel_matrix
from . import _build
from .dot import precise_matmul


@functools.lru_cache(maxsize=8)
def cqt_kernel_arrays(cfg: HpfwConfig) -> tuple[np.ndarray, np.ndarray]:
    """The NDFT kernel as two float32 (frame_len, n_bins) matrices (re, im),
    computed in float64 and rounded once."""
    k = cqt_kernel_matrix(cfg)
    return (np.ascontiguousarray(k.real, dtype=np.float32),
            np.ascontiguousarray(k.imag, dtype=np.float32))


@functools.lru_cache(maxsize=8)
def kernel_matrix(cfg: HpfwConfig, device: torch.device) -> torch.Tensor:
    """[Kre | Kim] as one contiguous (frame_len, 2 * n_bins) float32 tensor."""
    kr, ki = cqt_kernel_arrays(cfg)
    return torch.from_numpy(np.concatenate([kr, ki], axis=1)).to(device)


def bin_pad(cfg: HpfwConfig) -> int:
    """Columns a bank of the split matrix takes: the reference's 128 lanes,
    or n_bins rounded up to K1's 64-bin tiles where n_bins is larger."""
    return max(128, -(-cfg.n_bins // 64) * 64)


@functools.lru_cache(maxsize=8)
def cqt_kernel_split(cfg: HpfwConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact 3-way bf16 split (h, m, l) of the padded (frame_len, 2 * bin_pad)
    NDFT matrix: real bank in columns [0, n_bins), imaginary bank in
    [bin_pad, bin_pad + n_bins), zeros elsewhere. A copy of
    hpfw_tpu.ops.pallas_frontend.cqt_kernel_split, split in float64 (each
    remainder is exact); rounded to bf16 as ml_dtypes rounds (through float32,
    to nearest even)."""
    k = cqt_kernel_matrix(cfg)
    pad = bin_pad(cfg)
    full = np.zeros((cfg.frame_len, 2 * pad), np.float64)
    full[:, :cfg.n_bins] = k.real
    full[:, pad:pad + cfg.n_bins] = k.imag
    full = torch.from_numpy(full)
    kh = full.to(torch.bfloat16)
    rem = full - kh.to(torch.float64)
    km = rem.to(torch.bfloat16)
    kl = (rem - km.to(torch.float64)).to(torch.bfloat16)
    return kh, km, kl


@functools.lru_cache(maxsize=8)
def kernel_split_device(cfg: HpfwConfig, device: torch.device) -> torch.Tensor:
    """K1's operand: the three parts of cqt_kernel_split, each transposed,
    as one contiguous (3, 2 * bin_pad, frame_len) bf16 tensor."""
    return torch.stack([p.t() for p in cqt_kernel_split(cfg)]).contiguous().to(device)


def frame_signal(pcm: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """(S,) PCM -> (F, frame_len) frames, a view with strides (hop, 1).

    Frame t = pcm[t*hop : t*hop + frame_len], identical to the oracle.
    """
    if cfg.n_frames(pcm.shape[0]) == 0:
        return pcm.new_zeros((0, cfg.frame_len))
    return pcm.unfold(0, cfg.frame_len, cfg.hop)


def cqt_from_frames_ref(frames: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """Plain version: one f32 GEMM against [Kre | Kim], then log(eps + |X|)."""
    reim = precise_matmul(frames, kernel_matrix(cfg, frames.device))
    re, im = reim[:, :cfg.n_bins], reim[:, cfg.n_bins:]
    return torch.log(cfg.log_eps + torch.sqrt(re * re + im * im))


def cqt_kernel(frames: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """K1 on the card: (F, frame_len) f32 frames with unit inner stride (an
    unfold view of the PCM or a contiguous matrix) -> (F, n_bins) f32.
    Frames whose start or row stride is not 16-byte aligned are copied first;
    the result does not depend on where a frame lies."""
    if not isinstance(frames, torch.Tensor) or frames.device.type != "cuda":
        raise ValueError("frames must be a CUDA tensor")
    if frames.dtype != torch.float32 or frames.dim() != 2:
        raise ValueError(f"frames must be 2-D float32, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    if frames.shape[1] != cfg.frame_len:
        raise ValueError(f"frames have {frames.shape[1]} samples, config says "
                         f"{cfg.frame_len}")
    if cfg.frame_len % 8:
        raise ValueError(f"K1 needs frame_len % 8 == 0, got {cfg.frame_len}")
    f = frames.shape[0]
    out = torch.empty((f, cfg.n_bins), dtype=torch.float32, device=frames.device)
    if f == 0:
        return out
    if frames.stride(1) != 1 or frames.stride(0) < 0:
        raise ValueError(f"frames need unit inner stride, got {frames.stride()}")
    if frames.data_ptr() % 16 or frames.stride(0) % 4:
        frames = frames.clone(memory_format=torch.contiguous_format)
    k = kernel_split_device(cfg, frames.device)
    _build.launch("cqt", "hpfw_cqt", frames.device,
                  frames.data_ptr(), frames.stride(0), f, cfg.frame_len,
                  k.data_ptr(), cfg.n_bins, bin_pad(cfg), cfg.log_eps, out.data_ptr())
    return out


def cqt_from_frames(frames: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """(F, frame_len) f32 frames -> (F, n_bins) log-magnitude CQT."""
    if frames.device.type == "cuda":
        return cqt_kernel(frames, cfg)
    if frames.device.type == "cpu":
        return cqt_from_frames_ref(frames, cfg)
    raise ValueError(f"no CQT for device {frames.device}")


def cqt(pcm: torch.Tensor, cfg: HpfwConfig) -> torch.Tensor:
    """(S,) PCM -> (F, n_bins) float32 log-magnitude CQT on pcm's device."""
    return cqt_from_frames(frame_signal(pcm.to(torch.float32), cfg), cfg)
