"""Projection-filter learning (pca.py)."""
