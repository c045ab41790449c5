"""Milliseconds per realisation of the program's 'paint_exact' stage, the
COLA force paints that took the exact ``index_add_`` scatter beyond the
widest lattice band (``timing.StageClock``: CUDA events on the stream),
summed over its marks in a call; None where no paint took that tier."""
from portbench.lib.readers import stage_ms


def read(run):
    return stage_ms(run, "paint_exact")
