"""Share of the traced training window in which nothing ran on the device."""

from portbench.metrics_common import idle_pct as read  # noqa: F401
