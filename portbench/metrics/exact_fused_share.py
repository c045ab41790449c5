"""The share of the COLA exact CIC tier's paint and gather calls that took
the one-pass kernels K13a/K13b (``exactcic.fused`` of all ``exactcic.*``
counts; the rest, ``exactcic.plain``, ran the plain PyTorch passes), %."""
from portbench.lib.trace import share_pct


def read(run):
    return share_pct(run, "exactcic.", "fused")
