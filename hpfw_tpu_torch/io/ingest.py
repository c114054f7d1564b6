"""Batch file ingestion: threaded native decode with a per-file fallback.

The port's copy of hpfw_tpu/io/ingest.py. load_files decodes a list of
audio files through the C++ batch decoder (native/hpfw_native.cc
hpfw_ingest_files: read, magic dispatch, downmix and polyphase sinc
resample, one pass a file, across a std::thread pool, outside the GIL) and
decodes a file the batch decoder rejects (Sun .au, WAV variants its decoder
refuses) with io/wav.load_audio, as hpfw_tpu does. That fallback is the
format's, not the device's: the native library itself is required.
"""

from __future__ import annotations

import numpy as np

from ..config import HpfwConfig
from . import native
from .wav import load_audio


def load_files(paths: list[str], cfg: HpfwConfig | None = None,
               n_threads: int = 0,
               strict: bool = False) -> list[np.ndarray]:
    """Decode many audio files -> list of mono float32 PCM arrays.

    If cfg is given every track is resampled to cfg.sample_rate. A file
    that neither the batch decoder nor load_audio decodes raises; with
    strict=True a file the batch decoder rejects raises at once.
    """
    target = cfg.sample_rate if cfg is not None else 0
    results = native.ingest_files(list(paths), target_rate=target, n_threads=n_threads)
    for i, pcm in enumerate(results):
        if pcm is None:
            if strict:
                raise ValueError(f"native ingest rejected {paths[i]!r}")
            results[i], _sr = load_audio(paths[i], cfg)
    return results  # type: ignore[return-value]
