"""hpfw_tpu_torch — the hashprint pipeline in PyTorch, with CUDA kernels for Hopper.

A port of hpfw_tpu (JAX/Pallas) that imports torch and never jax. The main
path PCM -> CQT -> hashprints -> dense match, the catalog-scale two-stage
matcher and the serving and streaming surfaces over it run on an NVIDIA H100
through hand-written CUDA kernels (csrc/), and on the CPU through their
plain PyTorch versions, which the tests hold against hpfw_tpu.

Public surface (hpfw_tpu's, less tests/test_torch_surface.py's BY_DESIGN list):
    fingerprint(audio)    -> hashprint sequence
    match(query, db)      -> ranked track IDs
    build_db / FingerprintDB.save/load
    build_db_from_files(paths) -> FingerprintDB          (native decode, io/ingest.py)
    fingerprint_stream(batches) -> hashprints            (staged ahead by a thread)
    TwoStageDB(db).match / match_batch / save / load   (catalog scale)
    TwoStageDB.warmup / bundle_compile_cache            (serving warm-up)
    MatchServer(ts, n).submit -> future                 (serving)
    EscalatingMatchServer(ts, filters, samples).submit   (PCM-in serving with escalation)
    StreamingSession .feed -> hypotheses                 (live ID, tempo/pitch scan)
    StreamingPool .feed -> hypotheses                    (many streams, rigid)
    ChunkedExtractor.feed -> hashprints                  (streaming extraction)
    learn_filters(corpus) -> projection filters
    fingerprint_scan_batch / match_scan_escalating       (rendition scans)
    fingerprint_multi, ArtistDB                          (known-artist mode)
    db_mesh / Mesh, ShardedDB, TwoStageDB(mesh=)         (track-sharded matching)
    graft_entry.entry() -> (forward, args)               (the main path's forward step)
"""

from .api import (FingerprintDB, build_db, build_db_from_files, fingerprint,
                  fingerprint_multi, fingerprint_scan_batch, fingerprint_stream,
                  learn_filters, match, match_scan_escalating, scan_hypotheses)
from .artist import ArtistDB
from .config import DEFAULT_CONFIG, HpfwConfig
from .match.scaled import TwoStageDB
from .match.sharded import ShardedDB
from .parallel.mesh import Mesh, db_mesh
from .serve import EscalatingMatchServer, MatchServer, ServerSaturated
from .streaming.pool import StreamingPool
from .streaming.session import ChunkedExtractor, StreamingSession

__version__ = "0.1.0"

__all__ = [
    "FingerprintDB", "TwoStageDB", "ShardedDB", "Mesh", "db_mesh", "build_db", "build_db_from_files", "fingerprint",
    "fingerprint_stream", "match", "learn_filters", "fingerprint_scan_batch",
    "scan_hypotheses", "match_scan_escalating", "fingerprint_multi", "ArtistDB",
    "MatchServer", "EscalatingMatchServer", "ServerSaturated", "StreamingPool",
    "StreamingSession", "ChunkedExtractor", "HpfwConfig", "DEFAULT_CONFIG", "__version__",
]
