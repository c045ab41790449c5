"""The share of COLA engine constructions that found their host plan
built (``colaplan.hit`` of all ``colaplan.*`` counts: the step schedule,
the growth scalars and the k vectors all from their memos; the rest,
``colaplan.miss``, built some of it), %."""
from portbench.lib.trace import share_pct


def read(run):
    return share_pct(run, "colaplan.", "hit")
