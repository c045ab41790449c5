"""The median (nearest rank) of the wall times of the traced run's calls
outside the profiled ones, in ms."""
from portbench.lib.readers import call_ms


def read(run):
    return call_ms(run, 50.0)
