"""Tiny sizes of every cell, for runs of the whole harness on the CPU."""

CATALOG = dict(n_tracks=48, planted_tracks=4, track_seconds=12, prints_per_track=516)
TINY = {
    "catalog100k.live": dict(CATALOG, query_pool=8, rate_qps=4.0, check_requests=4),
    "catalog100k.live_renditions": dict(CATALOG, query_pool=8, rate_qps=4.0, check_requests=4),
    "catalog100k.batch16": dict(CATALOG, query_batches=2, batch_size=4, check_batches=2),
    "ingest240.stream": dict(batch_size=2, track_seconds=12, host_batches=2, check_batches=2),
}


def tiny_run(cell: str, seed: int = 12345678901, seconds: float = 2.0, traced: bool = False,
             **extra):
    """A harness Run of cell at its tiny size on the CPU."""
    import time

    import torch

    from portbench import harness

    return harness.Run(cell, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                       dict(TINY[cell], **extra))
