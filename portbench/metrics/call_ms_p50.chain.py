"""The median (nearest rank) of the wall times of the traced run's calls
outside the profiled ones, in ms.

The chained cells' own name: it moves their own rate,
``realisations_per_s.chain``, which their host-bound calls' spread from
run to run gives a bound of its own."""
from portbench.lib.readers import call_ms


def read(run):
    return call_ms(run, 50.0)
