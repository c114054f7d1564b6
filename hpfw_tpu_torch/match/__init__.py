"""Matching: the dense Hamming offset scan and host-side ranking."""
