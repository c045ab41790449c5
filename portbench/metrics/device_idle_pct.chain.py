"""The share of the profiled calls' span in which no kernel, copy or set
ran on the card, in %.

The chained cells' own name: it moves their own rate,
``realisations_per_s.chain``, which their host-bound calls' spread from
run to run gives a bound of its own."""
from portbench.lib.readers import device_idle_pct as read  # noqa: F401
