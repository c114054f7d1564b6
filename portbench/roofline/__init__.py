"""Each kernel's operations and bytes at its shapes, and the peaks they are
held to. A kernel's bound is the larger of its operations over the peak of
the unit that could do them and its bytes over the HBM rate; bytes count each
input read once and each output written once; operations are what the
algorithm needs at these shapes, whatever the implementation makes."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    """The least seconds the card could take: max(ops / peak, bytes / HBM rate)."""
    return max(ops / PEAKS[peak], nbytes / PEAKS["hbm_bytes_per_s"])


def n_frames(p: dict, n_samples: int) -> int:
    return 0 if n_samples < p["frame_len"] else 1 + (n_samples - p["frame_len"]) // p["hop"]
