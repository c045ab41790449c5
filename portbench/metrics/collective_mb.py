"""Megabytes (1e6 bytes) this rank sends in its collectives a realisation
(``collective.bytes``)."""
from portbench.lib.trace import per_realisation


def read(run):
    return per_realisation(run, "collective.bytes", 1e-6)
