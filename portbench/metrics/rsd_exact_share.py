"""The share of RSD remaps that took the exact tier (the sort and K3)
rather than a banded kernel (``rsd.exact`` of all ``rsd.*`` counts), %."""
from portbench.lib.trace import share_pct


def read(run):
    return share_pct(run, "rsd.", "exact")
