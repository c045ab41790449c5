"""The share of the profiled calls' span in which no kernel, copy or set
ran on the card, in %."""
from portbench.lib.readers import device_idle_pct as read  # noqa: F401
