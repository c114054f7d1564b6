"""hpfw_tpu_torch — the hashprint pipeline in PyTorch, with CUDA kernels for Hopper.

A port of hpfw_tpu (JAX/Pallas) that imports torch and never jax. The main
path PCM -> CQT -> hashprints -> dense match, the catalog-scale two-stage
matcher and the serving and streaming surfaces over it run on an NVIDIA H100
through hand-written CUDA kernels (csrc/), and on the CPU through their
plain PyTorch versions, which the tests hold against hpfw_tpu.

Public surface (the slice of hpfw_tpu's that is ported so far):
    fingerprint(audio)    -> hashprint sequence
    match(query, db)      -> ranked track IDs
    build_db / FingerprintDB.save/load
    TwoStageDB(db).match / match_batch / save / load   (catalog scale)
    MatchServer(ts, n).submit -> future                 (serving)
    StreamingSession / StreamingPool .feed -> hypotheses (live ID, rigid)
    ChunkedExtractor.feed -> hashprints                  (streaming extraction)
"""

from .api import FingerprintDB, build_db, fingerprint, match
from .config import DEFAULT_CONFIG, HpfwConfig
from .match.scaled import TwoStageDB
from .serve import MatchServer, ServerSaturated
from .streaming.pool import StreamingPool
from .streaming.session import ChunkedExtractor, StreamingSession

__version__ = "0.1.0"

__all__ = [
    "FingerprintDB", "TwoStageDB", "build_db", "fingerprint", "match",
    "MatchServer", "ServerSaturated", "StreamingPool", "StreamingSession",
    "ChunkedExtractor", "HpfwConfig", "DEFAULT_CONFIG", "__version__",
]
