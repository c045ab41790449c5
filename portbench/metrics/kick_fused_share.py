"""The share of COLA kick-drift steps that took the one-pass kernel K12
(``kick.fused`` of all ``kick.*`` counts; the rest, ``kick.plain``, ran
the fourteen PyTorch passes), %."""
from portbench.lib.trace import share_pct


def read(run):
    return share_pct(run, "kick.", "fused")
