"""The share of COLA's lattice paints that took the hand-written kernel
K11a (``latpaint.kernel`` of all ``latpaint.*`` counts; the rest,
``latpaint.plain``, ran the plain roll sums), %."""
from portbench.lib.trace import share_pct


def read(run):
    return share_pct(run, "latpaint.", "kernel")
