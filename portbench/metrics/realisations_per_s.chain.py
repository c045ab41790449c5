"""Realisations completed in the window over the window's length (the
window runs from the first call's start to the last call's end).

The chained cells' own name: their host-bound calls spread far more
from run to run than the batched and COLA cells', so they carry their
own bound."""
from portbench.lib.readers import realisations_per_s as read  # noqa: F401
