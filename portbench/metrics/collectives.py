"""``torch.distributed`` collectives a realisation
(``collective.calls``): the slab FFTs' all-to-all transposes, the
all-reduces and the all-gathers of the batch's outputs."""
from portbench.lib.trace import per_realisation


def read(run):
    return per_realisation(run, "collective.calls")
