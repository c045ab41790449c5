"""The share of RSD remaps that took the exact tier (``rsd.exact`` of
all ``rsd.*`` counts), %; the chained cells' own name."""
from portbench.lib.trace import share_pct


def read(run):
    return share_pct(run, "rsd.", "exact")
