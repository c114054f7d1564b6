"""Kernel launches on the card in the traced window over queries answered in it."""

from portbench.metrics._shared import kernels_per_query as read  # noqa: F401
