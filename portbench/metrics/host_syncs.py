"""Host syncs a realisation: the counted sites where the program reads
the card to the host during a call (``sync.<site>``: the RSD tier and
cover checks, COLA's band picks, the cuSOLVER eigh's status), summed
over the clocked calls over their realisations."""
from portbench.lib.trace import per_realisation


def read(run):
    return per_realisation(run, "sync.")
