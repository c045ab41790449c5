"""Host syncs a realisation (``sync.<site>`` counters), as ``host_syncs``;
the chained cells' own name, moving ``realisations_per_s.chain``."""
from portbench.lib.trace import per_realisation


def read(run):
    return per_realisation(run, "sync.")
