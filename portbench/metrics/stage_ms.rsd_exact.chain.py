"""Milliseconds per realisation of the program's 'rsd_exact' stage, the
RSD remaps that took the exact tier (the wrap, a stable sort per line of
sight, the gather and K3; ``timing.StageClock``: CUDA events on the
stream), summed over its marks in a call; the realisations that took a
banded tier count as 0.  None where no remap took that tier, or where
the program does not mark it.  The chained cells' own name."""
from portbench.lib.readers import stage_ms


def read(run):
    return stage_ms(run, "rsd_exact")
