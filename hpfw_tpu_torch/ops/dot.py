"""Precision policy: every float32 product of the port is a true f32 product.

The hashprint contract needs float32-grade GEMMs: a bit is the sign of a
difference of two projections, and TF32's 10-bit mantissa moves the spectra
far past the margin audit (tests/test_torch_fingerprint.py). PyTorch leaves
cuBLAS matmuls in full f32 by default but lets cuDNN use TF32, and either
can be switched by other code in the process, so importing this module pins
all three switches. The kernels in csrc/ never see TF32 (K1 and K2 run
three-way split bf16 products that carry float32 precision); the switches
govern the plain versions that the tests and chip_smoke.py compare them with.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def tf32_disabled() -> bool:
    """True when no float32 product in this process may round to TF32."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def precise_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32, refusing to run if TF32 was switched back on."""
    if not tf32_disabled():
        raise RuntimeError("TF32 was re-enabled; float32 products would lose "
                           "the precision the hashprint contract needs")
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))
