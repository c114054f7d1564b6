"""Load-floor probe: the row sums of an int8 matrix, every byte read once.

Counterpart of the inline Pallas kernel of benchmarks/pass1_tune.py (the
"dma" probe, :97-107): the measured device-memory read floor that the pass-1
coarse sweep is judged against. On a CUDA tensor row_sum launches the probe
kernel (csrc/probe.cu); on a CPU tensor it runs the plain version,
row_sum_ref.
"""

from __future__ import annotations

import torch

from . import _build


def row_sum_ref(db: torch.Tensor) -> torch.Tensor:
    """Plain version: (T, W) int8 -> (T,) int32 row sums."""
    return db.to(torch.int32).sum(dim=1)


def row_sum_kernel(db: torch.Tensor) -> torch.Tensor:
    """The probe kernel on the card: the same contract as row_sum_ref, for
    rows of a multiple of 16 bytes on a 16-byte aligned base."""
    _build.require(db, "db", torch.int8, 2)
    t, w = db.shape
    if w % 16 or db.data_ptr() % 16:
        raise ValueError(f"the probe reads 16-byte chunks: rows of {w} bytes at "
                         f"address {db.data_ptr():#x} are not aligned to them")
    out = torch.empty((t,), dtype=torch.int32, device=db.device)
    if t and w:
        _build.launch("row_sum", "hpfw_row_sum", db.device, db.data_ptr(), t, w,
                      out.data_ptr())
    elif t:
        out.zero_()
    return out


def row_sum(db: torch.Tensor) -> torch.Tensor:
    """(T, W) int8 -> (T,) int32 row sums on db's device."""
    if db.device.type == "cuda":
        return row_sum_kernel(db)
    if db.device.type == "cpu":
        return row_sum_ref(db)
    raise ValueError(f"no row sum for device {db.device}")
