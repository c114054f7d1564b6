"""The share of the traced window in which no device operation (kernel, copy
or memset) ran."""

from portbench.metrics._shared import idle_share as read  # noqa: F401
