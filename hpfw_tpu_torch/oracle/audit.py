"""The float64 oracle's margin audit of packed hashprints.

A float32 pipeline may flip a bit whose float64 delta margin is ~0, and
nowhere else. assert_bits_match_with_margin_audit is a copy of the golden
parity tests' audit (tests/test_tpu_pipeline.py, whose module imports jax),
so the card's machine can hold its prints to the oracle. margin_audit_counts
returns the counts that assertion reads, for a caller to log, and the
differing bits that sit off a free bit, which the audit's per-print counts
cannot see. oracle_prints_and_margins gives oracle.fingerprint and
oracle.delta_margins from one float64 spectrum. tests/test_torch_config.py
pins all three to the originals. NumPy only.
"""

from __future__ import annotations

import numpy as np

from ..config import HpfwConfig
from .pipeline import binarize, cqt, deltas, features, pack_bits


def assert_bits_match_with_margin_audit(got_packed, want_packed, margins, *, rel_tol=1e-4):
    """Bit-exact except where the oracle margin is below rel_tol * rms."""
    got = np.asarray(got_packed, dtype=np.uint32)
    want = np.asarray(want_packed, dtype=np.uint32)
    assert got.shape == want.shape
    diff = np.bitwise_xor(got, want)
    bits_diff = np.unpackbits(diff.view(np.uint8)).reshape(got.shape[0], 64)
    margins = np.asarray(margins)
    floor = rel_tol * np.sqrt(np.mean(margins ** 2))
    # Bit layout of unpackbits(view(uint8)) vs our lsb0 packing differs;
    # compare counts per word instead of per-bit positions for the audit.
    n_diff = int(bits_diff.sum())
    n_free = int((margins < floor).sum())
    assert n_free < 0.01 * margins.size, f"margin audit degenerate: {n_free} free bits"
    # Every differing bit must be explainable by a free bit in the same print.
    diff_per_print = np.bitwise_count(diff.astype(np.uint64)).reshape(got.shape[0], 2).sum(1)
    free_per_print = (margins < floor).sum(axis=1)
    bad = diff_per_print > free_per_print
    assert not bad.any(), (
        f"{int(bad.sum())} prints differ beyond margin tolerance "
        f"(total diff bits {n_diff}, free bits {n_free})"
    )


def margin_audit_counts(got_packed, want_packed, margins, *, rel_tol=1e-4,
                        bit_order="lsb0") -> dict:
    """The counts the audit reads: differing bits, free bits (margin below
    rel_tol * rms), the prints whose differing bits outnumber their free
    bits ("over"; the audit passes when 0 and not degenerate), and
    "degenerate" (1% or more of the bits free). Beside them, what the audit
    does not read: "off_free", the differing bits whose own margin is not
    free, found by position (bit_order as in oracle.pack_bits: for lsb0,
    filter i is bit i % 32 of word i // 32), so a flipped bit that a free
    bit elsewhere in its print would excuse still counts."""
    got = np.asarray(got_packed, dtype=np.uint32)
    want = np.asarray(want_packed, dtype=np.uint32)
    if got.shape != want.shape:
        raise ValueError(f"prints {got.shape} against the oracle's {want.shape}")
    margins = np.asarray(margins)
    free = margins < rel_tol * np.sqrt(np.mean(margins ** 2))
    diff = np.bitwise_xor(got, want)
    diff_per_print = np.bitwise_count(diff).sum(axis=1, dtype=np.int64)
    pos = np.arange(64) if bit_order == "lsb0" else 63 - np.arange(64)
    diff_bits = (diff[:, pos // 32] >> (pos % 32).astype(np.uint32)) & 1
    n_free = int(free.sum())
    return {"differing_bits": int(diff_per_print.sum()), "free_bits": n_free,
            "over": int((diff_per_print > free.sum(axis=1)).sum()),
            "degenerate": not n_free < 0.01 * margins.size,
            "off_free": int((diff_bits.astype(bool) & ~free).sum())}


def oracle_prints_and_margins(pcm: np.ndarray, filters: np.ndarray,
                              cfg: HpfwConfig) -> tuple[np.ndarray, np.ndarray]:
    """(oracle.fingerprint, oracle.delta_margins) of pcm from one float64
    spectrum, the oracle's own steps run once instead of twice."""
    d = deltas(features(cqt(pcm, cfg), filters, cfg), cfg)
    return pack_bits(binarize(d, cfg), cfg), np.abs(d)
