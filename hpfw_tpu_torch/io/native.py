"""ctypes bindings for the C++ audio decoders and resampler (native/*.cc).

The port's copy of hpfw_tpu/io/native.py: the decode_* entry points,
resample_sinc and ingest_files (file ingestion and load_audio), and the
native CPU pipeline, fingerprint_cpu, resample_linear and match_db (the CLI's
`fingerprint --cpu`), copied verbatim (they take the uint64 packing from the
port's oracle copy). At first use the library is compiled from native/hpfw_native.cc,
hpfw_mp3.cc, hpfw_aac.cc and hpfw_opus.cc with the flags of native/Makefile,
one g++ a source, all started together, into
build/hpfw_tpu_torch/native-<hash of sources and flags>/ at the repository
root (never native/libhpfw_native.so, which hpfw_tpu's own build owns). The
build runs under a file lock and renames its output into place, so that
concurrent processes build once. There is no fallback: a missing compiler,
a failed build or a missing symbol raises (load_library never returns None,
so the copies' `lib is None` checks never fire).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "hpfw_tpu_torch"
SOURCES = ("hpfw_native.cc", "hpfw_mp3.cc", "hpfw_aac.cc", "hpfw_opus.cc")
CXX = "g++"
# native/Makefile's CXXFLAGS: the same code as hpfw_tpu's library.
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native")
LIB_NAME = "libhpfw_native.so"


def build_library() -> Path:
    """Compile the decoders into one shared library unless it is built."""
    digest = hashlib.sha256(" ".join((CXX,) + CXXFLAGS).encode())
    for src in sorted(NATIVE_DIR.glob("*.cc")) + sorted(NATIVE_DIR.glob("*.h")) \
            + sorted(NATIVE_DIR.glob("*.inc")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"native-{digest.hexdigest()[:16]}"
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # another process may be building
        if lib.is_file():
            return lib
        tag = os.getpid()
        objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
        try:
            procs = [subprocess.Popen([CXX, *CXXFLAGS, "-c", "-o", str(obj), src],
                                      cwd=NATIVE_DIR, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for src, obj in zip(SOURCES, objs)]
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler {CXX!r}: {e}") from e
        failed = []
        for src, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src} (exit code {proc.returncode}):\n{err[-4000:]}")
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        if not failed:
            link = subprocess.run([CXX, *CXXFLAGS, "-shared", "-o", str(tmp),
                                   *map(str, objs), "-lpthread"],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(f"link (exit code {link.returncode}):\n{link.stderr[-4000:]}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("building the native audio library failed: "
                               + "\n".join(failed))
        os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    lib = ctypes.CDLL(str(build_library()))
    f32p, i32p, i64p = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_int64))
    for name in ("wav", "flac", "vorbis", "mp3", "aac"):
        fn = getattr(lib, f"hpfw_{name}_decode")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32p, i64p, i32p]
    lib.hpfw_opus_decode.restype = ctypes.c_int
    lib.hpfw_opus_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32p, i64p, i32p,
                                     ctypes.POINTER(ctypes.c_uint32)]
    lib.hpfw_resample_sinc_len.restype = ctypes.c_int64
    lib.hpfw_resample_sinc_len.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.hpfw_resample_sinc.restype = None
    lib.hpfw_resample_sinc.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32, f32p, ctypes.c_int64]
    lib.hpfw_fingerprint.restype = ctypes.c_int
    lib.hpfw_fingerprint.argtypes = [
        f32p, ctypes.c_int64, f32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint64), i64p]
    lib.hpfw_resample_len.restype = ctypes.c_int64
    lib.hpfw_resample_len.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.hpfw_resample_linear.restype = None
    lib.hpfw_resample_linear.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                         ctypes.c_int32, f32p, ctypes.c_int64]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.hpfw_match_db.restype = None
    lib.hpfw_match_db.argtypes = [u64p, ctypes.c_int64, u64p, i64p, ctypes.c_int64,
                                  ctypes.c_int64, i64p, i64p, ctypes.c_int32]
    lib.hpfw_ingest_files.restype = ctypes.c_void_p
    lib.hpfw_ingest_files.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32]
    lib.hpfw_ingest_rc.restype = ctypes.c_int32
    lib.hpfw_ingest_rc.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hpfw_ingest_len.restype = ctypes.c_int64
    lib.hpfw_ingest_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hpfw_ingest_get.restype = ctypes.c_int
    lib.hpfw_ingest_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, f32p]
    lib.hpfw_ingest_free.restype = None
    lib.hpfw_ingest_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Build (at first call) and load the library: True, or the build's
    RuntimeError. The port has no NumPy decoders to fall back to."""
    load_library()
    return True


def _fptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _decode(codec: str, data: bytes) -> tuple[np.ndarray, int]:
    """Two-call decode: the size, then the samples; (mono float32, rate)."""
    fn = getattr(load_library(), f"hpfw_{codec}_decode")
    n = ctypes.c_int64(0)
    rate = ctypes.c_int32(0)
    rc = fn(data, len(data), None, ctypes.byref(n), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"native {codec} decode failed (code {rc})")
    out = np.empty(n.value, dtype=np.float32)
    rc = fn(data, len(data), _fptr(out, ctypes.c_float), ctypes.byref(n), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"native {codec} decode failed (code {rc})")
    return out, int(rate.value)


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV/AIFF bytes -> (mono float32 PCM, sample_rate)."""
    return _decode("wav", data)


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """FLAC bytes -> (mono float32 PCM, sample_rate)."""
    return _decode("flac", data)


def decode_vorbis(data: bytes) -> tuple[np.ndarray, int]:
    """Ogg Vorbis bytes -> (mono float32 PCM, sample_rate)."""
    return _decode("vorbis", data)


def decode_mp3(data: bytes) -> tuple[np.ndarray, int]:
    """MPEG audio bytes -> (mono float32 PCM, sample_rate)."""
    return _decode("mp3", data)


def decode_aac(data: bytes) -> tuple[np.ndarray, int]:
    """ADTS AAC-LC bytes -> (mono float32 PCM, sample_rate)."""
    return _decode("aac", data)


def decode_opus(data: bytes, return_final_range: bool = False):
    """Ogg Opus (CELT) bytes -> (mono float32 PCM, 48000), plus the range
    coder's final state with return_final_range."""
    fn = load_library().hpfw_opus_decode
    n = ctypes.c_int64(0)
    rate = ctypes.c_int32(0)
    fr = ctypes.c_uint32(0)
    rc = fn(data, len(data), None, ctypes.byref(n), ctypes.byref(rate), ctypes.byref(fr))
    if rc != 0:
        raise ValueError(f"native opus decode failed (code {rc})")
    out = np.empty(n.value, dtype=np.float32)
    rc = fn(data, len(data), _fptr(out, ctypes.c_float), ctypes.byref(n),
            ctypes.byref(rate), ctypes.byref(fr))
    if rc != 0:
        raise ValueError(f"native opus decode failed (code {rc})")
    if return_final_range:
        return out, int(rate.value), int(fr.value)
    return out, int(rate.value)


def fingerprint_cpu(pcm: np.ndarray, filters: np.ndarray, cfg,
                    n_threads: int = 0) -> np.ndarray:
    """Full native extraction: PCM -> packed hashprints (N, 2) uint32.

    The reference's C++ fingerprint() surface (SURVEY.md §1.2) — CQT,
    projection, delta, sign, pack entirely in hpfw_native.cc, threaded over
    frames. Float64 like the oracle; equal to oracle.fingerprint except at
    ~zero delta margins (margin-audited in tests/test_native.py).
    """
    from ..oracle.pipeline import uint64_to_packed

    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(pcm, dtype=np.float32)
    f = np.ascontiguousarray(filters, dtype=np.float32)
    assert f.shape == (cfg.context_dim, 64)
    n = ctypes.c_int64(0)
    args = (x.shape[0], _fptr(f, ctypes.c_float),
            cfg.sample_rate, cfg.frame_len, cfg.hop, cfg.n_bins,
            cfg.fmin, cfg.bins_per_octave,
            1 if cfg.window == "hamming" else 0, cfg.log_eps,
            cfg.context_w, cfg.delta_lag,
            1 if cfg.bit_order == "msb0" else 0,
            1 if cfg.tie_break == "ge" else 0, n_threads)
    rc = lib.hpfw_fingerprint(_fptr(x, ctypes.c_float), *args,
                              None, ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"native fingerprint failed (code {rc})")
    out = np.empty(max(n.value, 1), dtype=np.uint64)
    rc = lib.hpfw_fingerprint(_fptr(x, ctypes.c_float), *args,
                              _fptr(out, ctypes.c_uint64), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"native fingerprint failed (code {rc})")
    return uint64_to_packed(out[: n.value])


def resample_linear(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if sr_in == sr_out:
        return np.asarray(pcm, dtype=np.float32)
    x = np.ascontiguousarray(pcm, dtype=np.float32)
    n_out = lib.hpfw_resample_len(x.shape[0], sr_in, sr_out)
    out = np.empty(n_out, dtype=np.float32)
    lib.hpfw_resample_linear(_fptr(x, ctypes.c_float), x.shape[0], sr_in,
                             sr_out, _fptr(out, ctypes.c_float), n_out)
    return out


def match_db(query_packed: np.ndarray, tracks: list[np.ndarray],
             n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Threaded CPU Hamming scan. Inputs are (N, 2)-uint32 packed prints.

    Returns per-track (best_scores, best_offsets), semantics identical to
    oracle.match_track.
    """
    from ..oracle.pipeline import packed_to_uint64

    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    q = np.ascontiguousarray(packed_to_uint64(query_packed))
    lengths = np.array([t.shape[0] for t in tracks], dtype=np.int64)
    max_len = max(int(lengths.max(initial=1)), 1)
    db = np.zeros((len(tracks), max_len), dtype=np.uint64)
    for i, t in enumerate(tracks):
        db[i, : t.shape[0]] = packed_to_uint64(t)
    scores = np.empty(len(tracks), dtype=np.int64)
    offsets = np.empty(len(tracks), dtype=np.int64)
    lib.hpfw_match_db(_fptr(q, ctypes.c_uint64), q.shape[0],
                      _fptr(db, ctypes.c_uint64), _fptr(lengths, ctypes.c_int64),
                      len(tracks), max_len,
                      _fptr(scores, ctypes.c_int64), _fptr(offsets, ctypes.c_int64),
                      n_threads)
    return scores, offsets


def resample_sinc(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase Kaiser-sinc resampler (C++; NumPy twin io/wav.resample_sinc)."""
    if sr_in == sr_out:
        return np.asarray(pcm, dtype=np.float32)
    lib = load_library()
    x = np.ascontiguousarray(pcm, dtype=np.float32)
    n_out = lib.hpfw_resample_sinc_len(x.shape[0], sr_in, sr_out)
    out = np.empty(n_out, dtype=np.float32)
    lib.hpfw_resample_sinc(_fptr(x, ctypes.c_float), x.shape[0], sr_in,
                           sr_out, _fptr(out, ctypes.c_float), n_out)
    return out


def ingest_files(paths: list[str], target_rate: int = 0,
                 n_threads: int = 0) -> list[np.ndarray | None]:
    """Threaded native decode (+ resample to target_rate, 0: keep) of many
    audio files at once: read, magic dispatch, downmix and sinc resample in
    C++ across a thread pool, outside the GIL. One mono float32 array a
    path, or None for a file the batch decoder rejects (callers decode it
    with io/wav.load_audio, as io/ingest.py does)."""
    lib = load_library()
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    h = lib.hpfw_ingest_files(arr, len(paths), target_rate, n_threads)
    if not h:
        raise RuntimeError("native ingest failed to allocate")
    try:
        out: list[np.ndarray | None] = []
        for i in range(len(paths)):
            if lib.hpfw_ingest_rc(h, i) != 0:
                out.append(None)
                continue
            pcm = np.empty(lib.hpfw_ingest_len(h, i), dtype=np.float32)
            rc = lib.hpfw_ingest_get(h, i, _fptr(pcm, ctypes.c_float))
            out.append(pcm if rc == 0 else None)
        return out
    finally:
        lib.hpfw_ingest_free(h)
