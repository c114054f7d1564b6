"""Tensor stages of the pipeline; each kernel stage dispatches by device."""
