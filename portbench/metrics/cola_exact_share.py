"""The share of COLA paints (one a force evaluation, one for the final
paints) that took the exact scatter beyond the widest lattice band
(``cola.exact`` of all ``cola.*`` counts), %."""
from portbench.lib.trace import share_pct


def read(run):
    return share_pct(run, "cola.", "exact")
