"""Build, load and call the hand-written CUDA kernels in hpfw_tpu_torch/csrc.

At first use, nvcc compiles every csrc/*.cu for sm_90a (Hopper), one
process a source, all started together, and links the objects into one
shared library with a plain C interface, which ctypes loads. The library goes
into build/hpfw_tpu_torch/<hash of sources and flags>/ at the repository
root, so a changed source builds anew and an unchanged one is reused. There
is no fallback: a missing nvcc, a failed build or a failed launch raises.

Each wrapper that launches a kernel adds one to its entry of LAUNCHES, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "hpfw_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libhpfw_kernels.so"

LAUNCHES = {"cqt": 0, "fingerprint": 0, "score_tracks": 0, "coarse_scan": 0,
            "coarse_scan_batch": 0, "coarse_scan_batch_packed": 0, "coarse_rescan": 0,
            "fine_rescan": 0, "row_sum": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default home."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of hpfw_tpu_torch are "
        "compiled at first use and need the CUDA toolkit")


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library unless it is already built."""
    nvcc = find_nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        out, err = proc.communicate()
        log.append(f"== {src.name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit code {proc.returncode}):\n{err[-4000:]}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link (exit code {link.returncode}):\n{link.stderr[-4000:]}")
    (out_dir / "build.log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # Every pointer and the stream are c_void_p: an undeclared argument is
    # passed as a 32-bit int and a device address would be cut.
    lib.hpfw_cqt_splits.argtypes = []
    lib.hpfw_cqt_splits.restype = i32
    lib.hpfw_cqt.argtypes = [ptr, i64, i32, i32, ptr, i32, ctypes.c_float, ptr, ptr,
                             ptr]
    lib.hpfw_fingerprint.argtypes = [ptr, i32, i32, ptr, i32, i32, i32, i32, i32,
                                     ptr, ptr]
    lib.hpfw_score_tracks.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr, ptr, ptr]
    lib.hpfw_coarse_scan.argtypes = [ptr, i32, i32, i32, i32, ptr, i64, i32, ptr, i32,
                                     i32, i32, i32, ptr, ptr, ptr]
    lib.hpfw_fine_rescan.argtypes = [ptr, i32, i32, ptr, i32, i32, ptr, ptr, ptr, i32,
                                     i32, ptr, ptr, ptr]
    lib.hpfw_row_sum.argtypes = [ptr, i64, i64, ptr, ptr]
    for fn in (lib.hpfw_cqt, lib.hpfw_fingerprint, lib.hpfw_score_tracks,
               lib.hpfw_coarse_scan, lib.hpfw_fine_rescan, lib.hpfw_row_sum):
        fn.restype = i32
    lib.hpfw_error_string.argtypes = [i32]
    lib.hpfw_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call a C entry point on device's current stream and count the launch.

    args are the entry point's arguments before the trailing stream.
    """
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn_name)(*args, stream)
    if code != 0:
        msg = lib.hpfw_error_string(code).decode()
        raise RuntimeError(f"{name} kernel failed: {msg} (cudaError {code})")
    LAUNCHES[name] += 1


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device | None = None) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and rank."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
