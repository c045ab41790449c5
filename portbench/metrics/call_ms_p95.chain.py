"""The 95th percentile (nearest rank) of the wall time of all the
window's calls, in ms: from the call to its outputs on the host.

The chained cells' own name: their host-bound calls spread far more
from run to run than the batched and COLA cells', so they carry their
own bound."""
from portbench.lib.readers import call_ms


def read(run):
    return call_ms(run, 95.0)
